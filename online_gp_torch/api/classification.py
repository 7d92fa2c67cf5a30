"""Dirichlet-GP streaming classification on the WISKI core (port of
``online_gp_tpu/api/classification.py``).

Integer labels are Dirichlet-transformed into per-class regression targets
with per-class heteroscedastic noise
(:mod:`online_gp_torch.likelihoods.dirichlet`), a batched WISKI GP with
B = num_classes outputs regresses them, and prediction is the argmax of the
class posterior means. The online ``update`` is a stem step (targets
y / sigma^2) -> a GP hyper step -> conditioning with the transformed noise
(kernel K2 at q = 1, each class its own noise) -> a BatchNorm refresh.
``absorb`` conditions in bulk (K1); Q of the prediction caches and of the
stem objective is factored by K6, one per class.

Inputs reach the card as the regression wrapper's do
(:class:`~online_gp_torch.api.regression.StagedInputs`): a host array of
points or labels through pinned slots with no wait, the caller's own
array into the replay buffer. Under ``torch.profiler`` each call of
``absorb``, ``update`` and ``predict`` is one span ``ogp.<method>``, and
each wait on the card one ``ogp.sync.<what>`` span.

Constructing ``OnlineSKIClassifier`` with ``low_rank=`` or a grid above
``DENSE_GRID_LIMIT`` returns the rank-capped
:class:`~online_gp_torch.api.lowrank_classification.OnlineSKILowRankClassifier`.
The entry points run on ``device`` ("cuda" unless the caller asks for the
CPU); parameters are float32 and the state follows the features' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from online_gp_torch.api.regression import (
    DENSE_GRID_LIMIT,
    StagedInputs,
    _adam,
    _bn_refresh,
    _fit_epoch,
    _leaves,
    _set_bn_momentum,
    _stem_leaves,
    _step,
    cosine_lr,
)
from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.likelihoods.dirichlet import dirichlet_transform
from online_gp_torch.logging.timing import span, spanned
from online_gp_torch.models.partial_mll import sm_partial_mll
from online_gp_torch.models.wiski import (
    WiskiModel,
    wiski_condition,
    wiski_init,
    wiski_mll,
    wiski_predict,
    wiski_stream,
)
from online_gp_torch.ops.grid import Grid
from online_gp_torch.utils.buffers import ReplayBuffer

# a grid beyond this many points is out of reach even of the rank-capped core
MAX_GRID_POINTS = 65536


class OnlineSKIClassifier(StagedInputs):
    """Dirichlet-transform SKI classifier on the dense O(m^2) core, for grids
    up to ``DENSE_GRID_LIMIT`` points; with ``low_rank=`` or a larger grid
    the constructor returns an ``OnlineSKILowRankClassifier`` (rank
    ``low_rank`` or 512)."""

    def __new__(
        cls,
        stem: Stem = None,
        init_x=None,
        init_y=None,
        alpha_eps: float = 0.01,
        lr: float = 0.01,
        grid_size: int = 30,
        grid_bound: float = 1.0,
        num_classes: int = 2,
        kernel: str | Kernel = "rbf",
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        low_rank: Optional[int] = None,
        device="cuda",
        **unused,
    ):
        if cls is OnlineSKIClassifier and stem is not None:
            if low_rank is not None or grid_size**stem.output_dim > DENSE_GRID_LIMIT:
                from online_gp_torch.api.lowrank_classification import OnlineSKILowRankClassifier

                return OnlineSKILowRankClassifier(
                    stem, init_x, init_y, alpha_eps=alpha_eps, lr=lr, grid_size=grid_size,
                    grid_bound=grid_bound, num_classes=num_classes, rank=low_rank or 512, kernel=kernel,
                    cfg=cfg, seed=seed, device=device, **unused,
                )
        return super().__new__(cls)

    def __init__(
        self,
        stem: Stem,
        init_x,
        init_y,
        alpha_eps: float = 0.01,
        lr: float = 0.01,
        grid_size: int = 30,
        grid_bound: float = 1.0,
        num_classes: int = 2,
        kernel: str | Kernel = "rbf",
        cfg: SolverConfig = DEFAULT_CONFIG,
        seed: int = 0,
        low_rank: Optional[int] = None,
        device="cuda",
        **unused,
    ):
        self.device = torch.device(device)
        self.stem = stem.to(self.device)
        self.cfg = cfg
        self.lr = lr
        self.alpha_eps = alpha_eps
        self.num_classes = num_classes
        super().__init__()
        host_x, init_x = init_x, self._inputs(init_x)

        # the JAX stems' init(key): fresh weights, then BatchNorm statistics
        # from the init data
        self.stem.reset_parameters(torch.Generator().manual_seed(seed))
        self.stem.train()
        with torch.no_grad():
            feats = self.stem(init_x)
        self.stem.eval()

        m = grid_size**stem.output_dim
        if m > MAX_GRID_POINTS:
            raise ValueError(
                f"SKI grid {grid_size}^{stem.output_dim} = {m} inducing points is infeasible; use a "
                "dimensionality-reducing stem (e.g. LinearStem/MLPStem with feature_dim<=3) or a smaller grid"
            )
        grid_bound = grid_bound + 1e-1
        grid = Grid.create([(-grid_bound, grid_bound)] * stem.output_dim, grid_size, device=self.device)
        if isinstance(kernel, str):
            kernel = make_kernel(kernel)
        # a fixed-noise GP over the transformed targets: the per-class noise
        # sigma2 is the noise term, with no learnable second noise
        self.model = WiskiModel(kernel, grid, num_outputs=num_classes, learn_additional_noise=False)
        self.params = self.model.init_params(stem.output_dim)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.state = self._init_state(feats, *self._transform(init_y))
        self.set_lr(lr)
        self.buffer = ReplayBuffer(self._replay(host_x, init_x))

    # -- helpers -----------------------------------------------------------

    def _transform(self, labels):
        """(targets, sigma2), each (n, C), of integer labels."""
        labels = self._on_device(labels, "y").reshape(-1)
        targets, _, sigma2 = dirichlet_transform(labels, self.num_classes, self.alpha_eps)
        return targets, sigma2

    def _features(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.stem(x)

    def _init_state(self, feats, targets, sigma2):
        with torch.no_grad():
            return wiski_init(self.model, feats, targets, sigma2)

    # -- public API --------------------------------------------------------

    @spanned("predict")
    def predict(self, inputs) -> torch.Tensor:
        """(n,) class labels: the argmax over classes of the posterior mean
        (the first class of a tie, as ``jnp.argmax``)."""
        feats = self._features(self._inputs(inputs))
        cfg = self.cfg.replace(detach_interp_coeff=True, skip_posterior_variances=True)
        with torch.no_grad():
            mean, _ = wiski_predict(self.model, self.params, self.state, feats, cfg)
        return torch.argmax(mean, dim=0)

    def evaluate(self, inputs, labels) -> float:
        pred = self.predict(inputs)
        labels = self._on_device(labels, "y").reshape(-1)
        return float(torch.mean((pred == labels).to(torch.float32)))

    @spanned("absorb")
    def absorb(self, inputs, labels):
        """Bulk-absorb a labelled stream, conditioning only: one exact
        rank-1 update per point through :func:`wiski_stream`."""
        x = self._inputs(inputs)
        targets, sigma2 = self._transform(labels)
        with torch.no_grad():
            self.state = wiski_stream(self.model, self.state, self._features(x), targets, sigma2)
        self.buffer.append(self._replay(inputs, x))
        return self.state

    @spanned("update")
    def update(self, inputs, labels, update_stem: bool = True, update_gp: bool = True):
        """One streaming step on q new labelled points: the stem step on the
        partial MLL of targets / sigma2, the GP step on the skip-logdet MLL,
        conditioning on the stem's new features, a BatchNorm refresh.
        Returns (stem_loss, gp_loss)."""
        x = self._inputs(inputs)
        if x.shape[0] == 0:
            raise ValueError("update() called with an empty batch")
        targets, sigma2 = self._transform(labels)
        s_loss = g_loss = torch.zeros(())
        if self.stem.has_params and update_stem:
            loss = -torch.sum(sm_partial_mll(self.model, self.params, self.state, self.stem(x), targets / sigma2,
                                             self.cfg))
            _step(self.stem_opt, _stem_leaves(self.stem), loss)
            s_loss = loss.detach()
        if update_gp:
            cfg_skip = self.cfg.replace(skip_logdet_forward=True)
            loss = -torch.sum(wiski_mll(self.model, self.params, self.state, cfg_skip))
            _step(self.gp_opt, _leaves(self.params), loss)
            g_loss = loss.detach()
        feats = self._features(x)
        with torch.no_grad():
            self.state = wiski_condition(self.model, self.state, feats, targets, sigma2)
        self.buffer.append(self._replay(inputs, x))
        if update_stem and self.stem.has_params:
            _bn_refresh(self.stem, self.buffer, x)
        with span("sync.losses"):
            return float(s_loss), float(g_loss)

    def fit(self, inputs, labels, num_epochs: int, test_dataset=None):
        """Refit epochs under a cosine rate annealed to 1e-4, each rebuilding
        the caches from the stem's features; then the caches are frozen from
        detached features. Returns one record per epoch (``test_acc`` on
        ``test_dataset``, after refreshing the caches, else NaN)."""
        x = self._inputs(inputs)
        targets, sigma2 = self._transform(labels)
        opts = _adam(self.params, self.stem, self.lr, self.lr)
        records = []
        for epoch in range(num_epochs):
            lr = cosine_lr(self.lr, max(num_epochs, 1), epoch)
            loss = _fit_epoch(self.model, self.params, self.stem, x, targets, sigma2, self.cfg, opts, lr)
            test_acc = float("nan")
            if test_dataset is not None:
                self.state = self._init_state(self._features(x), targets, sigma2)
                test_acc = self.evaluate(*test_dataset)
            records.append({"epoch": epoch + 1, "train_loss": float(loss), "test_acc": test_acc})
        self.state = self._init_state(self._features(x), targets, sigma2)
        return records

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """Fresh Adam optimizers at these rates (and a BatchNorm momentum)."""
        self.gp_opt, self.stem_opt = _adam(self.params, self.stem, gp_lr, gp_lr if stem_lr is None else stem_lr)
        _set_bn_momentum(self.stem, bn_mom)
