"""Online SKI (WISKI) streaming regression wrapper (port of the dense path
of ``online_gp_tpu/api/regression.py``).

A stateful shell over the functional WISKI core:

- ``fit``: full-cache refit epochs. Each epoch rebuilds the caches from the
  stem's features (gradients reach the stem through the interpolation
  weights and ``wiski_init``) under a cosine learning rate annealed to
  1e-4, then a final cache freeze from detached features.
- ``update`` (the streaming hot path): a stem step on the Sherman-Morrison
  partial MLL with the stem in eval mode, a GP step on the Woodbury MLL
  with ``skip_logdet_forward``, conditioning on the new points (kernel K2
  at q = 1), then a BatchNorm refresh on the new and 1,024 replayed inputs.
- ``predict`` adds the learnable second noise to the variance;
  ``prequential`` (kernels K3 and K1) and ``absorb`` (K1) condition without
  hyper steps.

The grid-space predictive caches are built at the first predict and kept:
conditioned in O(m^2) after a conditioning-only update, dropped whenever
the hypers or the stem move. Q is factored by kernel K6 on the card
wherever it needs no grad: in the hyper step's forward, in the stem
objective's caches and in the predictive caches.

PyTorch runs eagerly, so the JAX package's jitted update is a sequence of
calls here; the optimizers are ``torch.optim.Adam`` (optax's update
formula). Parameters are float32, as in the JAX package; the state follows
the inputs' dtype. The entry points run on ``device`` ("cuda" unless the
caller asks for the CPU).

Above ``cfg.max_cholesky_size`` inducing points (2,048 by default: every
2-D grid from 46 x 46 up) the GP step runs the iterative CG/SLQ MLL, with
new Rademacher probes on each step from :func:`hyper_probes`, keyed on
the stream position as the JAX package's ``fold_in(PRNGKey(7), num_data)``.
Constructing ``OnlineSKIRegression`` with ``low_rank=`` or a grid above
``DENSE_GRID_LIMIT`` returns the rank-capped
:class:`~online_gp_torch.api.lowrank_regression.OnlineSKILowRankRegression`.

A host array handed to a CUDA wrapper reaches the card without a wait
(:func:`stage_host`): it is copied into a pinned host slot and sent from
there behind the work already queued, and the replay buffer keeps the
caller's own array, so an entry point returns once its work is queued
and the next call's launches queue behind this one's. Tensors, lists and
a CPU wrapper's inputs take the plain copy.

Under ``torch.profiler`` each call of ``absorb``, ``update``, ``predict``,
``prequential`` and ``hyper_step`` is one span, ``ogp.<method>``
(``ogp.hyper`` for the stem and GP steps), and each wait on the card one
``ogp.sync.<what>`` span (:mod:`online_gp_torch.logging.timing`).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.logging.timing import span, spanned
from online_gp_torch.models.partial_mll import sm_partial_mll
from online_gp_torch.models.wiski import (
    MllProbes,
    WiskiModel,
    mll_probes,
    wiski_condition,
    wiski_init,
    wiski_mll,
    wiski_pred_cache_condition,
    wiski_predict,
    wiski_prediction_caches,
    wiski_prequential_stream,
    wiski_refresh_roots,
    wiski_slim,
    wiski_stream,
)
from online_gp_torch.ops.grid import Grid
from online_gp_torch.utils.buffers import ReplayBuffer
from online_gp_torch.utils.metrics import batched_rmse_nll

# Above this many inducing points the dense core's m x m caches stop being
# the right regime, and the wrapper routes to the rank-capped core.
DENSE_GRID_LIMIT = 4096

# Pinned host slots a staged input rotates through (for each dtype it comes in)
STAGE_SLOTS = 2


def stage_host(ring: list, arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on the CUDA ``device``, with no wait on the card: copied on the
    host into the oldest of ``ring``'s pinned slots (grown to the largest
    array it has held), then sent from the slot on the current stream with
    ``non_blocking``, behind the work already queued. The caller may reuse
    ``arr`` at once. A slot is written again only once its last copy has
    left it: an event recorded after each copy says so, and a slot whose
    copy is still in flight is waited for in ``ogp.sync.stage_reuse``.

    ``ring`` is a list that the caller keeps for one input and dtype; it
    holds up to :data:`STAGE_SLOTS` slots, ``[pinned buffer, event]``.
    ``stage_host.staged_copies`` counts the arrays staged,
    ``stage_host.stage_waits`` the reuses that found their copy in flight."""
    slot = ring.pop(0) if len(ring) == STAGE_SLOTS else [None, torch.cuda.Event()]
    buf, done = slot
    if not done.query():
        stage_host.stage_waits += 1
        with span("sync.stage_reuse"):
            done.synchronize()
    if buf is None or buf.numel() < arr.size:
        buf = slot[0] = torch.empty(arr.size, dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                                   pin_memory=True)
    np.copyto(buf[: arr.size].numpy().reshape(arr.shape), arr)
    out = buf[: arr.size].view(arr.shape).to(device, non_blocking=True)
    done.record(torch.cuda.current_stream(device))
    ring.append(slot)
    stage_host.staged_copies += 1
    return out


stage_host.staged_copies = 0
stage_host.stage_waits = 0


class StagedInputs:
    """How a dense streaming wrapper (this module's and
    :class:`~online_gp_torch.api.classification.OnlineSKIClassifier`) takes
    its inputs in and keeps them: host arrays bound for the card through
    :func:`stage_host`, the caller's own array in the replay buffer. The
    wrapper sets ``device`` and ``stem``."""

    def __init__(self):
        # the pinned slots of the inputs (x) and the targets or labels (y), by dtype
        self._stage = {"x": {}, "y": {}}

    def _on_device(self, x, which: str) -> torch.Tensor:
        """``x`` as a tensor on the wrapper's device. A host array bound for
        the card is staged through the pinned slots of input ``which``
        (``"x"`` or ``"y"``) without a wait; any other copy between the host
        and the card waits for the card."""
        if torch.is_tensor(x) and x.device.type == self.device.type:
            return x.to(self.device)
        if self.device.type == "cuda" and isinstance(x, np.ndarray):
            with span("input_stage"):
                return stage_host(self._stage[which].setdefault(x.dtype, []), x, self.device)
        if self.device.type == "cpu" and not torch.is_tensor(x):
            return torch.as_tensor(x)  # host to host
        with span("sync.input_copy"):
            return torch.as_tensor(x, device=self.device)

    def _inputs(self, x) -> torch.Tensor:
        return self._on_device(x, "x").reshape(-1, self.stem.input_dim)

    def _replay(self, inputs, x: torch.Tensor) -> np.ndarray:
        """What the replay buffer keeps of a call's inputs: the caller's own
        host array where it passed one, else ``x`` copied back to the host."""
        if isinstance(inputs, np.ndarray):
            return inputs.reshape(-1, self.stem.input_dim)
        with span("sync.host_copy"):
            return x.detach().cpu().numpy()


def hyper_probes(num_data: int, num_outputs: int, m: int, dtype, device) -> MllProbes:
    """The iterative MLL's probes for a GP step at stream position
    ``num_data``: drawn from a CPU generator seeded from (7, num_data), then
    moved to ``device``, so that they do not depend on the device."""
    gen = torch.Generator().manual_seed((7 << 32) + int(num_data))
    return mll_probes(num_outputs, m, gen, dtype, device)


def cosine_lr(lr: float, num_steps: int, step: int) -> float:
    """``optax.cosine_decay_schedule(lr, num_steps, alpha=1e-4 / lr)`` at
    ``step`` (the count before the step's increment)."""
    alpha = 1e-4 / lr
    t = min(step, num_steps)
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / num_steps)) + alpha)


def _leaves(params):
    return [t for v in params.values() for t in (_leaves(v) if isinstance(v, dict) else [v])]


def _step(opt: torch.optim.Optimizer, leaves, loss: torch.Tensor) -> None:
    for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
        p.grad = g
    opt.step()


def _stem_leaves(stem: Stem):
    return list(stem.parameters()) if stem.has_params else []


def _adam(params, stem: Stem, gp_lr: float, stem_lr: float):
    """Fresh Adam optimizers (optax's update formula) for the GP params and
    the stem (None for a stem without parameters)."""
    stem_leaves = _stem_leaves(stem)
    return torch.optim.Adam(_leaves(params), lr=gp_lr), (
        torch.optim.Adam(stem_leaves, lr=stem_lr) if stem_leaves else None)


def _set_bn_momentum(stem: Stem, bn_mom: Optional[float]) -> None:
    if bn_mom is not None and hasattr(stem, "bn"):
        mom = stem.bn.momentum
        stem.bn.momentum = torch.tensor(bn_mom, dtype=mom.dtype, device=mom.device)


def _bn_refresh(stem: Stem, buffer: ReplayBuffer, x: torch.Tensor) -> None:
    """Refresh the stem's BatchNorm running statistics on x and 1,024
    replayed inputs."""
    with span("sync.replay_copy"):
        replay = torch.as_tensor(buffer.sample(1024), device=x.device)
    stem.train()
    with torch.no_grad():
        stem(torch.cat([x, replay]))
    stem.eval()


def _fit_epoch(model: WiskiModel, params, stem: Stem, x, y, noise, cfg: SolverConfig, opts, lr: float):
    """One refit epoch (the JAX wrappers' ``epoch_step``): rate ``lr`` on the
    optimizers ``opts`` (GP, stem or None), the stem's features in training
    mode (batch statistics; the running ones update), the caches rebuilt
    from them with ``wiski_init``, and one step of each optimizer on
    -sum(wiski_mll). Returns the loss."""
    gp_opt, stem_opt = opts
    for opt in (o for o in opts if o is not None):
        for group in opt.param_groups:
            group["lr"] = lr
    stem.train()
    feats = stem(x)
    stem.eval()
    loss = -torch.sum(wiski_mll(model, params, wiski_init(model, feats, y, noise), cfg))
    leaves = _leaves(params) + _stem_leaves(stem)
    for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
        p.grad = g
    gp_opt.step()
    if stem_opt is not None:
        stem_opt.step()
    return loss.detach()


class OnlineSKIRegression(StagedInputs):
    """Streaming-regression wrapper on the dense O(m^2) WISKI core, for grids
    up to ``DENSE_GRID_LIMIT`` inducing points. Constructed with ``low_rank=``
    or a larger grid, it returns an ``OnlineSKILowRankRegression`` instead
    (rank ``low_rank`` or 512)."""

    def __new__(
        cls,
        stem: Stem = None,
        init_x=None,
        init_y=None,
        lr: float = 0.01,
        grid_size: int = 30,
        grid_bound: float = 1.0,
        kernel: str | Kernel = "rbf",
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        refresh_roots_every: int = 0,
        low_rank: Optional[int] = None,
        slim_state: bool = False,
        device="cuda",
        **unused,
    ):
        if cls is OnlineSKIRegression and stem is not None:
            if low_rank is not None or grid_size**stem.output_dim > DENSE_GRID_LIMIT:
                if slim_state or refresh_roots_every:
                    warnings.warn(
                        "slim_state/refresh_roots_every are dense-core options; the low-rank "
                        "core (low_rank= / large grids) manages its m x k roots with amortized "
                        "compression instead; ignoring them",
                        stacklevel=2,
                    )
                from online_gp_torch.api.lowrank_regression import OnlineSKILowRankRegression

                return OnlineSKILowRankRegression(
                    stem, init_x, init_y, lr=lr, grid_size=grid_size, grid_bound=grid_bound,
                    rank=low_rank or 512, kernel=kernel, cfg=cfg, seed=seed, device=device, **unused,
                )
        return super().__new__(cls)

    def __init__(
        self,
        stem: Stem,
        init_x,
        init_y,
        lr: float = 0.01,
        grid_size: int = 30,
        grid_bound: float = 1.0,
        kernel: str | Kernel = "rbf",
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        refresh_roots_every: int = 0,
        low_rank: Optional[int] = None,
        slim_state: bool = False,
        device="cuda",
        **unused,
    ):
        m = grid_size**stem.output_dim
        if m > DENSE_GRID_LIMIT:
            # unreachable through the constructor, which routes big grids to
            # the low-rank core; guards direct subclass construction
            raise ValueError(
                f"SKI grid {grid_size}^{stem.output_dim} = {m} inducing points exceeds the "
                f"dense-core limit {DENSE_GRID_LIMIT}; pass low_rank= (or construct "
                "OnlineSKIRegression, which routes it)"
            )
        self.device = torch.device(device)
        self.stem = stem.to(self.device)
        self.cfg = cfg
        self.lr = lr
        super().__init__()
        host_x, init_x = init_x, self._inputs(init_x)
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
        self.model = WiskiModel(kernel, grid, num_outputs=self.target_dim, learn_additional_noise=True)
        self.params = self.model.init_params(stem.output_dim)
        if hasattr(kernel, "data_init_params"):
            # init-sensitive kernels (the spectral mixture) start from the
            # init data, as gpytorch's initialize_from_data
            self.params["kernel"] = kernel.data_init_params(
                feats, init_y, (self.target_dim,), dtype=torch.float32, device=self.device
            )
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.slim_state = slim_state
        self.state = self._init_state(feats, init_y)

        self.set_lr(lr)
        self.buffer = ReplayBuffer(self._replay(host_x, init_x))
        self.refresh_roots_every = refresh_roots_every
        self._updates_since_refresh = 0
        # grid-space predictive caches (mean, cov): built lazily, reused
        # across predicts, conditioned on hyper-free updates, dropped when
        # the params, the stem or the state move under them
        self._pred_caches = None

    # -- helpers -----------------------------------------------------------

    def _targets(self, y) -> torch.Tensor:
        return self._on_device(y, "y").reshape(-1, self.target_dim)

    def _init_state(self, feats, targets):
        with torch.no_grad():
            state = wiski_init(self.model, feats, targets, torch.ones_like(targets))
        return wiski_slim(state) if self.slim_state else state

    def _features(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.stem(x)

    @spanned("hyper")
    def _hyper(self, x, y, update_stem: bool, update_gp: bool):
        """The stem step, then the GP step, on the current state."""
        s_loss = g_loss = torch.zeros(())
        if self.stem.has_params and update_stem:
            loss = -torch.sum(sm_partial_mll(self.model, self.params, self.state, self.stem(x), y, self.cfg))
            _step(self.stem_opt, _stem_leaves(self.stem), loss)
            s_loss = loss.detach()
        if update_gp:
            cfg_skip = self.cfg.replace(skip_logdet_forward=True)
            m = self.model.grid.num_points
            probes = None
            if m > self.cfg.max_cholesky_size:
                # new probes each step, so that the log-det gradient averages
                # over probe draws instead of chasing one
                probes = hyper_probes(self.state.num_data, self.target_dim, m, self.state.wty.dtype, self.device)
            loss = -torch.sum(wiski_mll(self.model, self.params, self.state, cfg_skip, probes=probes))
            _step(self.gp_opt, _leaves(self.params), loss)
            g_loss = loss.detach()
        return s_loss, g_loss

    def _count_and_refresh(self, n: int) -> None:
        self._updates_since_refresh += n
        if self.refresh_roots_every and self._updates_since_refresh >= self.refresh_roots_every:
            with torch.no_grad():
                self.state = wiski_refresh_roots(self.state)
            self._updates_since_refresh = 0

    def _ensure_pred_caches(self):
        if self._pred_caches is None:
            with torch.no_grad():
                self._pred_caches = wiski_prediction_caches(
                    self.model, self.params, self.state, self.cfg.replace(detach_interp_coeff=True)
                )
        return self._pred_caches

    # -- public API --------------------------------------------------------

    @spanned("predict")
    def predict(self, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictive y-moments (mean, var), each (n, T)."""
        x = self._inputs(inputs)
        caches = self._ensure_pred_caches()
        with torch.no_grad():
            cfg_eval = self.cfg.replace(detach_interp_coeff=True)
            mean, var = wiski_predict(self.model, self.params, self.state, self.stem(x), cfg_eval, caches=caches)
            if var is None:
                # skip_posterior_variances: the latent covariance is zero,
                # the observation noise remains
                var = torch.zeros_like(mean)
            var = var + self.noise[:, None]
        return mean.T, var.T

    def evaluate(self, inputs, targets) -> Tuple[float, float]:
        return batched_rmse_nll(self.predict, self._inputs(inputs), self._targets(targets))

    @spanned("update")
    def update(self, inputs, targets, update_stem: bool = True, update_gp: bool = True):
        """One streaming step on q new points; returns (stem_loss, gp_loss)."""
        x, y = self._inputs(inputs), self._targets(targets)
        if x.shape[0] == 0:
            raise ValueError("update() called with an empty batch")
        s_loss, g_loss = self._hyper(x, y, update_stem, update_gp)
        feats = self._features(x)
        with torch.no_grad():
            self.state = wiski_condition(self.model, self.state, feats, y, torch.ones_like(y))
        hyper_moved = update_gp or (update_stem and self.stem.has_params)
        if hyper_moved or (self._pred_caches is not None and self._pred_caches[1] is None):
            # hyper movement invalidates; mean-only caches cannot be conditioned
            self._pred_caches = None
        elif self._pred_caches is not None:
            # conditioning-only update: O(m^2) exact rank-q conditioning of
            # the predictive caches instead of an O(m^3) rebuild
            with torch.no_grad():
                self._pred_caches = wiski_pred_cache_condition(
                    self.model, self._pred_caches, feats, y, torch.ones_like(y)
                )
        self.buffer.append(self._replay(inputs, x))
        self._count_and_refresh(1)
        if update_stem and self.stem.has_params:
            _bn_refresh(self.stem, self.buffer, x)
        with span("sync.losses"):
            return float(s_loss), float(g_loss)

    @spanned("hyper_step")
    def hyper_step(self, inputs, targets, update_stem: bool = True, update_gp: bool = True):
        """One stem + GP hyperparameter step without conditioning (the
        segment-boundary step of a fused stream that absorbs through
        :meth:`prequential`); ``inputs``/``targets`` feed only the stem
        objective. Returns (stem_loss, gp_loss) like :meth:`update`."""
        x, y = self._inputs(inputs), self._targets(targets)
        s_loss, g_loss = self._hyper(x, y, update_stem, update_gp)
        if update_gp or (update_stem and self.stem.has_params):
            self._pred_caches = None  # hypers moved under the caches
        if update_stem and self.stem.has_params:
            _bn_refresh(self.stem, self.buffer, x)
        with span("sync.losses"):
            return float(s_loss), float(g_loss)

    @spanned("prequential")
    def prequential(self, inputs, targets):
        """Interleaved evaluate-then-condition over a stream, conditioning only:
        each point is predicted from the posterior on all earlier points, then
        absorbed. Returns (mean, var) of shape (n, T), as :meth:`predict`."""
        x, y = self._inputs(inputs), self._targets(targets)
        caches = self._ensure_pred_caches()
        if caches[1] is None:
            raise ValueError(
                "prequential streaming needs posterior variances; unset cfg.skip_posterior_variances"
            )
        feats = self._features(x)
        with torch.no_grad():
            self.state, self._pred_caches, pm, pv = wiski_prequential_stream(
                self.model, self.params, self.state, caches, feats, y, torch.ones_like(y)
            )
            var = pv + self.noise[:, None]
        self.buffer.append(self._replay(inputs, x))
        self._count_and_refresh(x.shape[0])
        return pm.T, var.T

    @spanned("absorb")
    def absorb(self, inputs, targets):
        """Bulk-absorb observations, conditioning only: one exact rank-1 update
        per point through :func:`wiski_stream`'s blocked recursion."""
        x, y = self._inputs(inputs), self._targets(targets)
        feats = self._features(x)
        with torch.no_grad():
            self.state = wiski_stream(self.model, self.state, feats, y, torch.ones_like(y))
        self._pred_caches = None
        self.buffer.append(self._replay(inputs, x))
        self._count_and_refresh(x.shape[0])
        return self.state

    def fit(self, inputs, targets, num_epochs: int, test_dataset=None):
        """Refit epochs on (inputs, targets); returns one record per epoch."""
        x, y = self._inputs(inputs), self._targets(targets)
        noise = torch.ones_like(y)
        opts = _adam(self.params, self.stem, self.lr, self.lr)
        records = []
        for epoch in range(num_epochs):
            lr = cosine_lr(self.lr, max(num_epochs, 1), epoch)
            loss = _fit_epoch(self.model, self.params, self.stem, x, y, noise, self.cfg, opts, lr)
            rmse = nll = float("nan")
            if test_dataset is not None:
                # refresh the caches at the current hypers before evaluating
                self._refresh_state(x, y)
                rmse, nll = self.evaluate(*test_dataset)
            records.append({
                "epoch": epoch + 1,
                "train_loss": float(loss),
                "test_rmse": rmse,
                "test_nll": nll,
                "noise": float(self.noise.mean()),
            })
        # final cache freeze with detached interpolation coefficients
        self._refresh_state(x, y)
        return records

    def _refresh_state(self, x, y) -> None:
        self.state = self._init_state(self._features(x), y)
        self._pred_caches = None

    def set_train_data(self, inputs, targets) -> None:
        self._refresh_state(self._inputs(inputs), self._targets(targets))

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """Fresh Adam optimizers at these rates (and a BatchNorm momentum)."""
        self.gp_opt, self.stem_opt = _adam(self.params, self.stem, gp_lr, gp_lr if stem_lr is None else stem_lr)
        _set_bn_momentum(self.stem, bn_mom)

    @property
    def noise(self) -> torch.Tensor:
        return torch.exp(self.params["raw_second_noise"].detach())

    def mll_value(self) -> float:
        with torch.no_grad():
            return float(torch.sum(wiski_mll(self.model, self.params, self.state, self.cfg)))
