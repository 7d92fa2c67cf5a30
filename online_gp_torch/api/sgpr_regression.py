"""Online SGPR streaming-regression wrapper (port of
``online_gp_tpu/api/sgpr_regression.py``).

- ``fit``: full-batch gradient epochs on the streaming collapsed bound at
  the reference's fit rates (hypers 1e-1, inducing points 1e-2, stem
  1e-2), then the batch is absorbed; fresh optimizers at the wrapper's
  rates after.
- ``update``: hyper movement and rebasing are coupled and periodic. Most
  updates accumulate the information exactly with the hypers frozen;
  every ``rebase_every``-th runs ``num_update_steps`` bound steps and then
  re-expresses the summary in the moved frame (``rebase_every=1`` is the
  reference's every-step behaviour). With a stem that has parameters, a
  bound step pads the new points with 1,024 replayed inputs, so that
  BatchNorm does not normalize a lone point to zero.
- ``predict`` adds the observation noise.

Rates per group: hypers at ``lr``, the inducing points at ``lr / 10``, the
stem at ``lr / 10``. The entry points run on ``device`` ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from online_gp_torch.api.regression import _leaves, _stem_leaves
from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.models.sgpr import (
    SGPRModel,
    SGPRMoments,
    SGPROldState,
    sgpr_absorb,
    sgpr_bound,
    sgpr_moments,
    sgpr_predict,
)
from online_gp_torch.utils.buffers import ReplayBuffer
from online_gp_torch.utils.metrics import batched_rmse_nll
from online_gp_torch.utils.optim import GroupAdam, adam_step

REPLAY = 1024


def _hyper_leaves(params):
    return [t for k, v in params.items() if k != "z" for t in _leaves({k: v})]


class OnlineSGPRegression:
    def __init__(
        self,
        stem: Stem,
        init_x,
        init_y,
        num_inducing: int = 64,
        lr: float = 0.01,
        num_update_steps: int = 1,
        rebase_every: int = 25,
        jitter: float = 1e-4,
        kernel: str | Kernel = "rbf",
        inducing_points=None,
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        device="cuda",
        **unused,
    ):
        self.device = torch.device(device)
        self.stem = stem.to(self.device)
        self.cfg = cfg
        self.lr = lr
        self.num_update_steps = num_update_steps
        self.rebase_every = max(1, rebase_every)
        self._absorbs_since_rebase = 0
        self.target_dim = 1
        init_x = self._inputs(init_x)
        init_y = torch.as_tensor(init_y, device=self.device)
        if init_y.ndim != 2 or init_y.shape[-1] != 1:
            raise ValueError("O-SGPR takes one output, as (n, 1) targets")

        gen = torch.Generator().manual_seed(seed)
        self.stem.reset_parameters(gen)
        self.stem.eval()
        if inducing_points is None:
            inducing_points = torch.rand((num_inducing, stem.output_dim), generator=gen) * 2.0 - 1.0
        if isinstance(kernel, str):
            kernel = make_kernel(kernel)
        self.model = SGPRModel(kernel, jitter=jitter)
        self.params = self.model.init_params(inducing_points, stem.output_dim, device=self.device)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.old: Optional[SGPROldState] = None
        self.moments: Optional[SGPRMoments] = None
        self._make_opts(lr, lr / 10.0, lr / 10.0)
        self.buffer = ReplayBuffer(init_x.cpu().numpy())

    def _make_opts(self, gp_lr: float, z_lr: float, stem_lr: float) -> None:
        """Fresh Adams: the hypers at gp_lr and z at z_lr; the stem at stem_lr."""
        self._rates = (gp_lr, z_lr, stem_lr)
        self.opt = GroupAdam([(_hyper_leaves(self.params), gp_lr), ([self.params["z"]], z_lr)])
        self.stem_opt = GroupAdam([(_stem_leaves(self.stem), stem_lr)])

    def _inputs(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).reshape(-1, self.stem.input_dim)

    def _targets(self, y) -> torch.Tensor:
        return torch.as_tensor(y, device=self.device).reshape(-1, 1)

    def _features(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.stem(x)

    def _bound_step(self, x, y, replay: Optional[torch.Tensor] = None) -> float:
        """One step of both optimizers on -bound, the stem in training mode
        (its running statistics update); ``replay`` pads the batch."""
        self.stem.train()
        if replay is not None:
            feats = self.stem(torch.cat([x, replay]))[: x.shape[0]]
        else:
            feats = self.stem(x)
        self.stem.eval()
        loss = -sgpr_bound(self.model, self.params, self.old, feats, y.reshape(-1))
        adam_step(loss, self.opt, self.stem_opt)
        return float(loss.detach())

    def _absorb(self, x, y, rebase: bool = True) -> None:
        """Absorb (x, y) into the old state and the moments; z stays (the
        JAX wrapper's resample ratio is 0 at every call)."""
        with torch.no_grad():
            _, self.old, self.moments = sgpr_absorb(
                self.model, self.params, self.old, self.moments, self._features(x), y.reshape(-1), rebase=rebase)

    # -- public API -----------------------------------------------------

    def fit(self, inputs, targets, num_epochs: int, test_dataset=None):
        x, y = self._inputs(inputs), self._targets(targets)
        saved = self._rates
        self._make_opts(1e-1, 1e-2, 1e-2)
        records = []
        for epoch in range(num_epochs):
            loss = self._bound_step(x, y)
            rmse = nll = float("nan")
            if test_dataset is not None:
                with torch.no_grad():
                    self.moments = sgpr_moments(self.model, self.params, self.old, self._features(x), y.reshape(-1))
                rmse, nll = self.evaluate(*test_dataset)
            records.append({"epoch": epoch + 1, "train_loss": loss, "test_rmse": rmse, "test_nll": nll,
                            "noise": float(self.noise)})
        self._absorb(x, y)
        self._make_opts(*saved)
        return records

    def update(self, inputs, targets, update_stem: bool = True):
        """Absorb the points, after ``num_update_steps`` bound steps on every
        ``rebase_every``-th call; returns the last step's loss (NaN if
        none)."""
        x, y = self._inputs(inputs), self._targets(targets)
        self._absorbs_since_rebase += 1
        hyper_step = self.num_update_steps > 0 and self._absorbs_since_rebase >= self.rebase_every
        loss = float("nan")
        if hyper_step:
            self._absorbs_since_rebase = 0
            for _ in range(self.num_update_steps):
                replay = None
                if self.stem.has_params:
                    replay = torch.as_tensor(self.buffer.sample(REPLAY), device=self.device)
                loss = self._bound_step(x, y, replay)
        self._absorb(x, y, rebase=hyper_step)
        self.buffer.append(x.cpu().numpy())
        return loss, loss

    def predict(self, inputs):
        """Predictive y-moments (mean, var), each (n, 1)."""
        x = self._inputs(inputs)
        if self.moments is None:
            M = self.params["z"].shape[0]
            self.moments = SGPRMoments(var_mean=torch.zeros((M,), dtype=x.dtype, device=self.device),
                                       var_chol=torch.eye(M, dtype=x.dtype, device=self.device))
        with torch.no_grad():
            mean, var = sgpr_predict(self.model, self.params, self.moments, self._features(x))
            return mean[:, None], (var + self.noise)[:, None]

    def evaluate(self, inputs, targets):
        return batched_rmse_nll(self.predict, self._inputs(inputs), self._targets(targets))

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """Fresh optimizers: hypers at ``gp_lr``, z at ``gp_lr / 10``, the stem
        at ``stem_lr`` (``gp_lr / 10`` by default)."""
        self._make_opts(gp_lr, gp_lr / 10.0, gp_lr / 10.0 if stem_lr is None else stem_lr)

    @property
    def noise(self) -> torch.Tensor:
        return torch.exp(self.params["raw_noise"].detach())
