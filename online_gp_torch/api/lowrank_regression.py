"""Large-grid WISKI regression wrapper on rank-capped roots (port of
``online_gp_tpu/api/lowrank_regression.py``).

The L5 surface (``fit``, ``update``, ``predict``, ``evaluate``, ``set_lr``,
``.noise``) over :mod:`online_gp_torch.models.wiski_lowrank`, the
``max_root_decomposition_size`` + ``use_toeplitz`` regime for grids where
the dense core's O(m^2) state does not fit (1-D m = 8,192, 2-D 128 x 128).
Multi-output targets run on the batched ``*_b`` core: per-output hypers
and caches over shared inputs.

- ``update``: one GP hyper step on the skip-logdet MLL at lr / 10 (the full
  lr belongs to ``fit``), then conditioning on the new points with the new
  hypers (a compression, when the buffer fills, is kernel-aware). The stem
  is not trained: ``update_stem`` is ignored with one warning, since the
  stem objective needs the dense m x m predictive covariance.
- ``fit``: rebuilds the caches from the fit data and fits the hypers
  against them; the stem stays as it is.
- ``predict`` adds the floored second noise to the variance.

The entry points run on ``device`` ("cuda" unless the caller asks for the
CPU); parameters are float32 and the state follows the inputs' dtype.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from online_gp_torch.api.regression import _leaves, _step
from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.models.wiski_lowrank import (
    WiskiLowRankModel,
    lowrank_init_params_batched,
    lowrank_second_noise,
    wiski_lowrank_condition,
    wiski_lowrank_condition_b,
    wiski_lowrank_init,
    wiski_lowrank_init_b,
    wiski_lowrank_mll,
    wiski_lowrank_mll_b,
    wiski_lowrank_predict,
    wiski_lowrank_predict_b,
)
from online_gp_torch.ops.grid import Grid
from online_gp_torch.utils.metrics import batched_rmse_nll


class OnlineSKILowRankRegression:
    def __init__(
        self,
        stem: Stem,
        init_x,
        init_y,
        lr: float = 0.01,
        grid_size: int = 4096,
        grid_bound: float = 1.0,
        rank: int = 512,
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
        init_x = self._inputs(init_x)
        init_y = torch.as_tensor(init_y, device=self.device)
        if init_y.ndim != 2:
            raise ValueError("targets must have an explicit output dimension")
        self.target_dim = init_y.shape[-1]

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
        self.model = WiskiLowRankModel(kernel, grid, rank=rank, learn_additional_noise=True, use_toeplitz=use_toeplitz)
        if self.target_dim == 1:
            self.params = self.model.init_params(stem.output_dim)
        else:
            self.params = lowrank_init_params_batched(self.model, stem.output_dim, self.target_dim)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.state = self._init_state(feats, init_y)
        self.set_lr(lr)
        self._warned_stem = False

    # -- helpers -----------------------------------------------------------

    def _inputs(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).reshape(-1, self.stem.input_dim)

    def _targets(self, y) -> torch.Tensor:
        return torch.as_tensor(y, device=self.device).reshape(-1, self.target_dim)

    def _features(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.stem(x)

    @property
    def _batched(self) -> bool:
        return self.target_dim > 1

    def _init_state(self, feats, targets):
        init = wiski_lowrank_init_b if self._batched else wiski_lowrank_init
        with torch.no_grad():
            return init(self.model, feats, targets, torch.ones_like(targets), params=self.params)

    def _mll(self, cfg) -> torch.Tensor:
        mll = wiski_lowrank_mll_b if self._batched else wiski_lowrank_mll
        return -torch.sum(mll(self.model, self.params, self.state, cfg))

    # -- public API --------------------------------------------------------

    def update(self, inputs, targets, update_stem: bool = True, update_gp: bool = True):
        """A GP hyper step on the current state, then conditioning on the q
        new points; returns (0.0, gp_loss). ``update_gp`` is accepted for the
        dense wrapper's signature; the step always runs, as in the JAX
        package."""
        if update_stem and self.stem.has_params and not self._warned_stem:
            self._warned_stem = True  # once per wrapper, not per update
            warnings.warn(
                "low-rank core updates are hyper+condition only: the sm_partial_mll stem "
                "objective needs the dense m x m predictive covariance cache the m x k regime "
                "never materializes; update_stem is ignored (pretrain the stem or use the "
                "dense core for online stem adaptation)",
                stacklevel=2,
            )
        x, y = self._inputs(inputs), self._targets(targets)
        feats = self._features(x)
        loss = self._mll(self.cfg.replace(skip_logdet_forward=True))
        _step(self.gp_opt, _leaves(self.params), loss)
        # the new hypers make a compression, if one fires, kernel-aware
        cond = wiski_lowrank_condition_b if self._batched else wiski_lowrank_condition
        with torch.no_grad():
            self.state = cond(self.model, self.state, feats, y, torch.ones_like(y), self.params)
        return 0.0, float(loss.detach())

    def fit(self, inputs, targets, num_epochs: int, test_dataset=None):
        """Hyper-only fit: rebuild the caches from (inputs, targets) at the
        current hypers, then num_epochs Adam steps at lr on the MLL against
        them. Returns one record per epoch."""
        x, y = self._inputs(inputs), self._targets(targets)
        self.state = self._init_state(self._features(x), y)
        leaves = _leaves(self.params)
        opt = torch.optim.Adam(leaves, lr=self.lr)
        records = []
        for epoch in range(num_epochs):
            loss = self._mll(self.cfg)
            _step(opt, leaves, loss)
            records.append({"epoch": epoch + 1, "train_loss": float(loss.detach())})
        if test_dataset is not None and records:
            rmse, nll = self.evaluate(*test_dataset)
            records[-1].update(test_rmse=rmse, test_nll=nll)
        return records

    def predict(self, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictive y-moments (mean, var), each (n, T)."""
        feats = self._features(self._inputs(inputs))
        predict = wiski_lowrank_predict_b if self._batched else wiski_lowrank_predict
        with torch.no_grad():
            mean, var = predict(self.model, self.params, self.state, feats, self.cfg)
            if var is None:
                # skip_posterior_variances: the latent covariance is zero,
                # the observation noise remains
                var = torch.zeros_like(mean)
            var = var + lowrank_second_noise(self.params)[..., None]
        if self._batched:
            return mean.T, var.T
        return mean[:, None], var[:, None]

    def evaluate(self, inputs, targets) -> Tuple[float, float]:
        return batched_rmse_nll(self.predict, self._inputs(inputs), self._targets(targets))

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """A fresh streaming Adam at gp_lr / 10 (the stem is not trained here)."""
        self.lr = gp_lr
        self.gp_opt = torch.optim.Adam(_leaves(self.params), lr=gp_lr / 10.0)

    @property
    def noise(self) -> torch.Tensor:
        return lowrank_second_noise(self.params).detach()
