"""Online SVGP task wrappers, regression and probit classification (port of
``online_gp_tpu/api/svgp.py``).

- Two optimizer groups: the hypers at ``lr``; the variational params
  (inducing points, mean, Cholesky factor) at ``lr / 10``; the stem at
  ``lr / 10``. ``optax.zero_nans`` fronts the GP's and the stem's online
  optimizers (a NaN gradient entry becomes 0, +-Inf passes).
- ``variational_mode="closed_form"`` (variational EM): q(u) moves only
  through the exact streaming update, so the mean and the factor (and, in
  ``update``, z) are left out of the gradient groups; it needs the
  conjugate Gaussian likelihood.
- ``fit``: streaming off, shuffled minibatch ELBO epochs with beta = 1 at
  a cosine rate that counts optimizer steps, as the optax schedule does
  (the variational group and the stem at a tenth of it); under
  ``closed_form`` the exact E-step runs before the epochs and after each.
  The fit optimizers have no NaN guard, as in the JAX package.
- ``update``: snapshot the old variational and prior distributions (or,
  under ``closed_form``, the closed-form E-step, which snapshots itself),
  then ``num_update_steps`` ELBO steps with beta = ``prior_beta`` and, if
  ``streaming``, Bui's streaming correction. With a stem that has
  parameters, each step pads the new points with 1,024 replayed inputs.
- Regression predicts with the observation noise added; classification
  predicts p(y = 1) and the label p >= 0.5.

The entry points run on ``device`` ("cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from online_gp_torch.api.regression import _leaves, _stem_leaves, cosine_lr
from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.likelihoods.bernoulli import bernoulli_probit_predictive
from online_gp_torch.models.svgp import (
    SVGPModel,
    SVGPOldState,
    svgp_closed_form_update,
    svgp_elbo,
    svgp_exact_estep,
    svgp_init_variational_to_prior,
    svgp_predict,
    svgp_snapshot,
    svgp_streaming_correction,
)
from online_gp_torch.utils.batch_stream import BatchStream
from online_gp_torch.utils.buffers import ReplayBuffer
from online_gp_torch.utils.metrics import batched_rmse_nll
from online_gp_torch.utils.optim import GroupAdam, adam_step

REPLAY = 1024
VARIATIONAL = ("z", "var_mean", "var_chol")


def _split(params, frozen=()):
    """(hyper leaves, variational leaves) of the params, ``frozen`` keys left
    out."""
    hyper = [t for k, v in params.items() if k not in VARIATIONAL for t in _leaves({k: v})]
    variational = [params[k] for k in VARIATIONAL if k not in frozen]
    return hyper, variational


class _OnlineSVGPBase:
    likelihood = "gaussian"

    def __init__(
        self,
        stem: Stem,
        init_x,
        init_y,
        num_inducing: int = 64,
        lr: float = 0.01,
        streaming: bool = False,
        prior_beta: float = 1.0,
        online_beta: float = 1.0,
        num_update_steps: int = 1,
        kernel: str | Kernel = "rbf",
        inducing_points=None,
        variational_mode: str = "grad",
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        device="cuda",
        **unused,
    ):
        if variational_mode not in ("grad", "closed_form"):
            raise ValueError(f"variational_mode {variational_mode!r} (grad/closed_form)")
        if variational_mode == "closed_form" and self.likelihood != "gaussian":
            raise ValueError(
                "closed_form variational updates need a conjugate (gaussian) likelihood; the "
                "probit-Bernoulli classifier trains q(u) by gradient"
            )
        self.device = torch.device(device)
        self.stem = stem.to(self.device)
        self.cfg = cfg
        self.lr = lr
        self.streaming = streaming
        self.prior_beta = prior_beta
        self.online_beta = online_beta
        self.num_update_steps = num_update_steps
        self.variational_mode = variational_mode

        gen = torch.Generator().manual_seed(seed)
        self.stem.reset_parameters(gen)
        self.stem.eval()
        if inducing_points is None:
            inducing_points = torch.rand((num_inducing, stem.output_dim), generator=gen) * 2.0 - 1.0
        if isinstance(kernel, str):
            kernel = make_kernel(kernel)
        self.model = SVGPModel(kernel, likelihood=self.likelihood)
        with torch.no_grad():
            params = self.model.init_params(inducing_points, stem.output_dim, device=self.device)
            self.params = svgp_init_variational_to_prior(self.model, params)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.old: Optional[SVGPOldState] = None
        self.set_lr(lr)
        self.buffer = ReplayBuffer(self._inputs(init_x).cpu().numpy())

    def _inputs(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).reshape(-1, self.stem.input_dim)

    def _features(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.stem(x)

    def _set_variational(self, new) -> None:
        """Write a closed-form (z, mean, factor) into the param leaves, in
        place (the optimizers keep them)."""
        with torch.no_grad():
            for k in VARIATIONAL:
                if new[k] is not self.params[k]:
                    self.params[k].copy_(new[k])

    def _train_step(self, x, y, num_data: int, beta: float, use_streaming: bool,
                    replay: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step of the GP's and the stem's optimizers on the negative
        ELBO (plus the streaming correction), the stem in training mode."""
        q = x.shape[0]
        self.stem.train()
        feats = self.stem(torch.cat([x, replay]) if replay is not None else x)[:q]
        self.stem.eval()
        loss = -svgp_elbo(self.model, self.params, feats, y, num_data, beta, self.cfg)
        if use_streaming:
            loss = loss + svgp_streaming_correction(self.model, self.params, self.old, q, self.online_beta, self.cfg)
        adam_step(loss, self.opt, self.stem_opt)
        return loss.detach()

    # -- public API --------------------------------------------------------

    def fit(self, inputs, targets, num_epochs: int, test_dataset=None, batch_size: int = 1024,
            batch_stream: bool = True):
        """Shuffled minibatch ELBO epochs: batches from a numpy
        :class:`BatchStream` (seed 0) with ``batch_stream``, else from one
        permutation an epoch (``np.random.default_rng(0)``)."""
        x = self._inputs(inputs)
        y = torch.as_tensor(targets, device=self.device)
        n = x.shape[0]
        rng = np.random.default_rng(0)
        epochs = max(num_epochs, 1)
        sched = lambda c: cosine_lr(self.lr, epochs, c)
        closed = self.variational_mode == "closed_form"
        hyper, variational = _split(self.params, ("var_mean", "var_chol") if closed else ())
        self.opt = GroupAdam([(hyper, sched), (variational, lambda c: sched(c) / 10.0)])
        self.stem_opt = GroupAdam([(_stem_leaves(self.stem), lambda c: sched(c) / 10.0)])
        bs = min(batch_size, n)

        def estep():
            self._set_variational(svgp_exact_estep(self.model, self.params, self._features(x), y))

        stream = BatchStream(x.cpu().numpy(), y.cpu().numpy(), batch_size=bs, shuffle=True, seed=0) \
            if batch_stream else None
        if closed:
            estep()
        records = []
        for epoch in range(num_epochs):
            perm = None if batch_stream else torch.as_tensor(rng.permutation(n), device=self.device)
            avg_loss, num_batches = 0.0, 0
            for start in range(0, n - bs + 1, bs):
                if stream is not None:
                    xb, yb = (torch.as_tensor(a, device=self.device) for a in stream.next())
                else:
                    idx = perm[start : start + bs]
                    xb, yb = x[idx], y[idx]
                avg_loss += float(self._train_step(xb, yb, n, 1.0, False))
                num_batches += 1
            if closed:
                estep()
            records.append(self._fit_record(epoch, avg_loss / max(num_batches, 1), test_dataset))
        # a fresh GP optimizer at the wrapper's rates; the stem's keeps its
        # schedule and its state, as the JAX wrapper's does
        self.opt = self._gp_opt(self.lr)
        if self.streaming:
            self.old = svgp_snapshot(self.model, self.params)
        return records

    def update(self, inputs, targets, update_stem: bool = True):
        """One streaming step on the q new points; returns (loss, loss)."""
        x = self._inputs(inputs)
        y = torch.as_tensor(targets, device=self.device)
        if self.variational_mode == "closed_form":
            self.closed_form_update(x, y)
        elif self.streaming:
            self.old = svgp_snapshot(self.model, self.params)
        loss = float("nan")
        for _ in range(self.num_update_steps):
            replay = None
            if self.stem.has_params:
                replay = torch.as_tensor(self.buffer.sample(REPLAY), device=self.device)
            loss = float(self._train_step(x, y, x.shape[0], self.prior_beta, self.streaming, replay))
        self.buffer.append(x.cpu().numpy())
        return loss, loss

    def closed_form_update(self, inputs, targets) -> None:
        """Snapshot the old distributions, then the closed-form O-SVGP update
        of q(u) on (inputs, targets)."""
        feats = self._features(self._inputs(inputs))
        y = torch.as_tensor(targets, device=self.device)
        with torch.no_grad():
            self.old = svgp_snapshot(self.model, self.params)
            self._set_variational(svgp_closed_form_update(self.model, self.params, feats, y))

    def _gp_opt(self, lr: float) -> GroupAdam:
        frozen = VARIATIONAL if self.variational_mode == "closed_form" else ()
        hyper, variational = _split(self.params, frozen)
        return GroupAdam([(hyper, lr), (variational, lr / 10.0)], zero_nans=True)

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """Fresh optimizers: the hypers at ``gp_lr``, the variational group at
        ``gp_lr / 10``, the stem at ``(stem_lr or gp_lr) / 10``."""
        self.lr = gp_lr
        self.opt = self._gp_opt(gp_lr)
        self.stem_opt = GroupAdam([(_stem_leaves(self.stem), (gp_lr if stem_lr is None else stem_lr) / 10.0)],
                                  zero_nans=True)

    def _fit_record(self, epoch, loss, test_dataset):
        raise NotImplementedError


class OnlineSVGPRegression(_OnlineSVGPBase):
    likelihood = "gaussian"

    def __init__(self, stem, init_x, init_y, **kw):
        init_y = np.asarray(init_y) if not torch.is_tensor(init_y) else init_y
        if init_y.ndim != 2 or init_y.shape[-1] != 1:
            raise ValueError("O-SVGP regression takes one output, as (n, 1) targets: run one wrapper per output")
        self.target_dim = 1
        super().__init__(stem, init_x, init_y, **kw)

    def predict(self, inputs):
        """Predictive y-moments (mean, var), each (n, 1)."""
        with torch.no_grad():
            mean, var = svgp_predict(self.model, self.params, self._features(self._inputs(inputs)), self.cfg)
            return mean[:, None], (var + self.noise)[:, None]

    def evaluate(self, inputs, targets):
        y = torch.as_tensor(targets, device=self.device).reshape(-1, 1)
        return batched_rmse_nll(self.predict, self._inputs(inputs), y)

    def _fit_record(self, epoch, loss, test_dataset):
        rmse = nll = float("nan")
        if test_dataset is not None:
            rmse, nll = self.evaluate(*test_dataset)
        return {"epoch": epoch + 1, "train_loss": loss, "test_rmse": rmse, "test_nll": nll,
                "noise": float(self.noise)}

    @property
    def noise(self) -> torch.Tensor:
        return torch.exp(self.params["raw_noise"].detach())


class OnlineSVGPClassifier(_OnlineSVGPBase):
    likelihood = "bernoulli"

    def predict(self, inputs):
        """(labels (n,) int32, p(y = 1) (n,))."""
        with torch.no_grad():
            mean, var = svgp_predict(self.model, self.params, self._features(self._inputs(inputs)), self.cfg)
            p = bernoulli_probit_predictive(mean, var)
            return (p >= 0.5).to(torch.int32), p

    def evaluate(self, inputs, labels) -> float:
        pred, _ = self.predict(inputs)
        labels = torch.as_tensor(labels, device=self.device).reshape(-1)
        return float(torch.mean((pred == labels).to(torch.float32)))

    def _fit_record(self, epoch, loss, test_dataset):
        acc = float("nan")
        if test_dataset is not None:
            acc = self.evaluate(*test_dataset)
        return {"epoch": epoch + 1, "train_loss": loss, "test_acc": acc}
