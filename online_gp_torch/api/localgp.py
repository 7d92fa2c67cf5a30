"""Local GP regression wrapper: a kernel-routed mixture of exact GP experts
(port of ``online_gp_tpu/api/localgp.py``).

``update`` routes each new point to the best expert with room (among the
top half of the ranking), spawning an expert when none has room, then
takes one Adam step on the joint sum-of-experts MLL; ``fit`` takes
``num_epochs`` such steps on the stored experts; ``predict`` and
``evaluate`` read the mixture. The entry points run on ``device`` ("cuda"
unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from online_gp_torch.api.regression import _leaves, _stem_leaves
from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.models.localgp import (
    LocalGPModel,
    localgp_add_point,
    localgp_init,
    localgp_joint_mll,
    localgp_log_prob,
    localgp_predict,
    localgp_route,
)
from online_gp_torch.utils.optim import GroupAdam, adam_step


class OnlineLocalGPRegression:
    def __init__(
        self,
        stem: Stem,
        init_x,
        init_y,
        lr: float = 0.01,
        max_data_per_model: int = 256,
        max_experts: int = 32,
        kernel: str | Kernel = "rbf",
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        device="cuda",
        **unused,
    ):
        self.device = torch.device(device)
        self.stem = stem.to(self.device)
        self.cfg = cfg
        self.lr = lr
        self.target_dim = 1
        init_x = self._inputs(init_x)
        init_y = torch.as_tensor(init_y, device=self.device)
        if init_y.ndim != 2 or init_y.shape[-1] != 1:
            raise ValueError("the local GP takes one output, as (n, 1) targets")
        self.stem.reset_parameters(torch.Generator().manual_seed(seed))
        self.stem.train()
        with torch.no_grad():
            feats = self.stem(init_x)
        self.stem.eval()
        if isinstance(kernel, str):
            kernel = make_kernel(kernel)
        self.model = LocalGPModel(kernel, max_data_per_model, max_experts)
        self.params = self.model.init_params(stem.output_dim, device=self.device)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.state = localgp_init(self.model, feats.cpu().numpy(), init_y.cpu().numpy(), seed, device=self.device)
        self.set_lr(lr)

    def _inputs(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).reshape(-1, self.stem.input_dim)

    def _features(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.stem(x)

    def _mll_step(self) -> float:
        loss = -localgp_joint_mll(self.model, self.params, self.state)
        adam_step(loss, self.opt)
        return float(loss.detach())

    def update(self, inputs, targets, *args, **kwargs):
        """Route (or spawn for) each point, then one joint MLL step."""
        feats = self._features(self._inputs(inputs)).cpu().numpy()
        y = torch.as_tensor(targets, device=self.device).reshape(-1)
        for i in range(len(feats)):
            expert = localgp_route(self.model, self.params, self.state, feats[i])
            if expert < 0:
                free = np.flatnonzero(self.state.active.cpu().numpy() == 0)
                # pool exhausted: the least-filled expert
                expert = int(free[0]) if len(free) else int(np.argsort(self.state.counts.cpu().numpy())[0])
            self.state = localgp_add_point(self.state, expert, torch.as_tensor(feats[i], device=self.device), y[i])
        loss = self._mll_step()
        return loss, loss

    def fit(self, inputs, targets, num_epochs: int, test_dataset=None):
        """``num_epochs`` joint MLL steps on the stored experts (the inputs
        are not read, as in the JAX package)."""
        records = []
        for epoch in range(num_epochs):
            loss = self._mll_step()
            rmse = nll = float("nan")
            if test_dataset is not None:
                rmse, nll = self.evaluate(*test_dataset)
            records.append({"epoch": epoch + 1, "train_loss": loss, "test_rmse": rmse, "test_nll": nll,
                            "noise": float(self.noise)})
        return records

    def predict(self, inputs):
        """The mixture's predictive (mean, var), each (n, 1)."""
        with torch.no_grad():
            mean, var, _ = localgp_predict(self.model, self.params, self.state, self._features(self._inputs(inputs)))
        return mean[:, None], var[:, None]

    def evaluate(self, inputs, targets):
        """(RMSE, NLL under the mixture's exact density) over all the points."""
        y = torch.as_tensor(targets, device=self.device).reshape(-1)
        with torch.no_grad():
            mean, _, stats = localgp_predict(self.model, self.params, self.state, self._features(self._inputs(inputs)))
            rmse = torch.sqrt(torch.mean((mean - y) ** 2))
            nll = -torch.mean(localgp_log_prob(stats, y))
        return float(rmse), float(nll)

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """A fresh Adam at ``gp_lr`` over the GP params and the stem."""
        self.lr = gp_lr
        self.opt = GroupAdam([(_leaves(self.params) + _stem_leaves(self.stem), gp_lr)])

    @property
    def noise(self) -> torch.Tensor:
        return torch.exp(self.params["raw_noise"].detach())

    @property
    def num_experts(self) -> int:
        return int(self.state.active.sum())
