"""Large-grid Dirichlet classifier on rank-capped roots (port of
``online_gp_tpu/api/lowrank_classification.py``).

The dense :class:`~online_gp_torch.api.classification.OnlineSKIClassifier`
stops at ``DENSE_GRID_LIMIT`` inducing points (its caches are m x m). This
wrapper runs the same Dirichlet-transform recipe on the batched rank-capped
core (``models/wiski_lowrank.py``, ``wiski_lowrank_*_b``): per-class m x k
roots, k x k solves, structured K_uu products. It runs no hand-written
kernel, as the JAX wrapper runs no Pallas one.

As the rank-capped regression wrapper: ``update`` is a hyper step (Adam at
lr / 10) plus conditioning, and ignores ``update_stem`` with one warning;
``fit`` rebuilds the caches and runs hyper-only epochs at lr against them.
The entry points run on ``device`` ("cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from online_gp_torch.api.regression import _leaves, _step
from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.likelihoods.dirichlet import dirichlet_transform
from online_gp_torch.models.wiski_lowrank import (
    WiskiLowRankModel,
    lowrank_init_params_batched,
    wiski_lowrank_condition_b,
    wiski_lowrank_init_b,
    wiski_lowrank_mll_b,
    wiski_lowrank_predict_b,
)
from online_gp_torch.ops.grid import Grid


class OnlineSKILowRankClassifier:
    def __init__(
        self,
        stem: Stem,
        init_x,
        init_y,
        alpha_eps: float = 0.01,
        lr: float = 0.01,
        grid_size: int = 64,
        grid_bound: float = 1.0,
        num_classes: int = 2,
        rank: int = 256,
        kernel: str | Kernel = "rbf",
        use_toeplitz: bool = True,
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        device="cuda",
        **unused,
    ):
        self.device = torch.device(device)
        self.stem = stem.to(self.device)
        self.cfg = cfg
        self.lr = lr
        self.alpha_eps = alpha_eps
        self.num_classes = num_classes
        init_x = self._inputs(init_x)

        # the JAX stems' init(key): fresh weights, then BatchNorm statistics
        # from the init data
        self.stem.reset_parameters(torch.Generator().manual_seed(seed))
        self.stem.train()
        with torch.no_grad():
            feats = self.stem(init_x)
        self.stem.eval()

        grid_bound = grid_bound + 1e-1
        grid = Grid.create([(-grid_bound, grid_bound)] * stem.output_dim, grid_size, device=self.device)
        if isinstance(kernel, str):
            kernel = make_kernel(kernel)
        # fixed per-class noise, no learnable second noise (the dense wrapper's)
        self.model = WiskiLowRankModel(kernel, grid, rank=rank, learn_additional_noise=False, use_toeplitz=use_toeplitz)
        self.params = lowrank_init_params_batched(self.model, stem.output_dim, num_classes)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.state = self._init_state(feats, *self._transform(init_y))
        self.set_lr(lr)
        self._warned_stem = False

    # -- helpers -----------------------------------------------------------

    def _inputs(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).reshape(-1, self.stem.input_dim)

    def _transform(self, labels):
        labels = torch.as_tensor(labels, device=self.device).reshape(-1)
        targets, _, sigma2 = dirichlet_transform(labels, self.num_classes, self.alpha_eps)
        return targets, sigma2

    def _features(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.stem(x)

    def _init_state(self, feats, targets, sigma2):
        with torch.no_grad():
            return wiski_lowrank_init_b(self.model, feats, targets, sigma2, params=self.params)

    def _loss(self, cfg) -> torch.Tensor:
        return -torch.sum(wiski_lowrank_mll_b(self.model, self.params, self.state, cfg))

    # -- public API --------------------------------------------------------

    def predict(self, inputs) -> torch.Tensor:
        """(n,) class labels: the argmax over classes of the posterior mean."""
        feats = self._features(self._inputs(inputs))
        with torch.no_grad():
            mean, _ = wiski_lowrank_predict_b(
                self.model, self.params, self.state, feats, self.cfg.replace(skip_posterior_variances=True)
            )
        return torch.argmax(mean, dim=0)

    def evaluate(self, inputs, labels) -> float:
        pred = self.predict(inputs)
        labels = torch.as_tensor(labels, device=pred.device).reshape(-1)
        return float(torch.mean((pred == labels).to(torch.float32)))

    def update(self, inputs, labels, update_stem: bool = True, update_gp: bool = True):
        """A GP hyper step on the current state (when ``update_gp``), then
        conditioning on the q new points with the new hypers; the stem is
        not trained. Returns (0.0, gp_loss)."""
        if update_stem and self.stem.has_params and not self._warned_stem:
            self._warned_stem = True  # once per wrapper, not per update
            warnings.warn(
                "low-rank classifier updates are hyper+condition only (see api/lowrank_regression.py): "
                "update_stem is ignored",
                stacklevel=2,
            )
        feats = self._features(self._inputs(inputs))
        targets, sigma2 = self._transform(labels)
        loss = torch.zeros((), dtype=feats.dtype)
        if update_gp:
            loss = self._loss(self.cfg.replace(skip_logdet_forward=True))
            _step(self.gp_opt, _leaves(self.params), loss)
        # the new per-class hypers make a compression, if one fires, kernel-aware
        with torch.no_grad():
            self.state = wiski_lowrank_condition_b(self.model, self.state, feats, targets, sigma2, self.params)
        return 0.0, float(loss.detach())

    def fit(self, inputs, labels, num_epochs: int, test_dataset=None):
        """Hyper-only fit: the caches rebuilt from (inputs, labels) at the
        current hypers, then num_epochs Adam steps at lr on the MLL against
        them (a loop where the JAX package scans). Returns one record per
        epoch; the last has ``test_acc`` when ``test_dataset`` is given."""
        self.state = self._init_state(self._features(self._inputs(inputs)), *self._transform(labels))
        leaves = _leaves(self.params)
        opt = torch.optim.Adam(leaves, lr=self.lr)
        records = []
        for epoch in range(num_epochs):
            loss = self._loss(self.cfg)
            _step(opt, leaves, loss)
            records.append({"epoch": epoch + 1, "train_loss": float(loss.detach())})
        if test_dataset is not None and records:
            records[-1]["test_acc"] = self.evaluate(*test_dataset)
        return records

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """A fresh streaming Adam at gp_lr / 10 (the stem is not trained here)."""
        self.lr = gp_lr
        self.gp_opt = torch.optim.Adam(_leaves(self.params), lr=gp_lr / 10.0)
