"""Online exact-GP wrappers, regression and Dirichlet classification (port
of ``online_gp_tpu/api/exact.py``).

- ``OnlineExactRegression``: ScaleKernel(RBF-ARD) exact GP with a learned
  noise per output. ``update`` appends the points and takes one Adam step
  on -sum(MLL) over the GP params and the stem jointly, then refreshes the
  stored features from the updated stem; ``fit`` rebuilds the buffer from
  the inputs and takes ``num_epochs`` such steps (at a constant rate, as
  the JAX package).
- ``OnlineExactClassifier``: a fixed-noise exact GP over
  ``dirichlet_transform`` targets, one output per class; predictions are
  the argmax of the posterior means.

The stem's features come from its eval mode (running BatchNorm
statistics) in every step, as in the JAX package. The entry points run
on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from online_gp_torch.api.regression import _leaves, _stem_leaves
from online_gp_torch.api.stems import Stem
from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel, make_kernel
from online_gp_torch.likelihoods.dirichlet import dirichlet_transform
from online_gp_torch.models.exact_online import (
    ExactGPData,
    ExactGPModel,
    exact_data_append,
    exact_data_init,
    exact_gp_mll,
    exact_gp_posterior,
)
from online_gp_torch.utils.metrics import batched_rmse_nll
from online_gp_torch.utils.optim import GroupAdam, adam_step


class _ExactBase:
    def __init__(self, stem: Stem, init_x, lr: float, model: ExactGPModel, seed: int, device):
        self.device = torch.device(device)
        self.stem = stem.to(self.device)
        self.lr = lr
        self.model = model
        self.stem.reset_parameters(torch.Generator().manual_seed(seed))
        self.stem.eval()
        self.params = model.init_params(stem.output_dim, device=self.device)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.set_lr(lr)
        self._raw = self._inputs(init_x)

    def _inputs(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).reshape(-1, self.stem.input_dim)

    def _features(self, x, train: bool = False) -> torch.Tensor:
        """The stem's features, without gradient; ``train`` normalizes with
        the batch's statistics and updates the running ones."""
        self.stem.train(train)
        with torch.no_grad():
            feats = self.stem(x)
        self.stem.eval()
        return feats

    def _grad_step(self, data: ExactGPData) -> float:
        """One Adam step on -sum(MLL) with the features recomputed from the
        raw inputs through the stem, then the stored features refreshed
        from the updated stem."""
        cap = data.x.shape[0]
        raw = torch.zeros((cap, self._raw.shape[1]), dtype=self._raw.dtype, device=self.device)
        raw[: self._raw.shape[0]] = self._raw
        loss = -torch.sum(exact_gp_mll(self.model, self.params, data._replace(x=self.stem(raw))))
        adam_step(loss, self.opt)
        feats = self._features(raw)
        self.data = data._replace(x=torch.where(data.mask[:, None] > 0, feats, data.x))
        return float(loss.detach())

    def set_lr(self, gp_lr: float, stem_lr: Optional[float] = None, bn_mom: Optional[float] = None) -> None:
        """A fresh Adam at ``gp_lr`` over the GP params and the stem (the
        JAX wrapper's; ``stem_lr`` and ``bn_mom`` are ignored, as there)."""
        self.lr = gp_lr
        self.opt = GroupAdam([(_leaves(self.params) + _stem_leaves(self.stem), gp_lr)])


class OnlineExactRegression(_ExactBase):
    def __init__(self, stem: Stem, init_x, init_y, lr: float = 0.01, kernel: str | Kernel = "rbf",
                 cfg: SolverConfig = DEFAULT_CONFIG, seed: int = 0, device="cuda", **unused):
        init_y = torch.as_tensor(init_y, device=device)
        if init_y.ndim != 2:
            raise ValueError("targets must have an explicit output dimension")
        self.target_dim = init_y.shape[-1]
        if isinstance(kernel, str):
            kernel = make_kernel(kernel)
        model = ExactGPModel(kernel, num_outputs=self.target_dim, learn_noise=True)
        super().__init__(stem, init_x, lr, model, seed, device)
        self.data = exact_data_init(self._features(self._raw, train=True), init_y)

    def _targets(self, y) -> torch.Tensor:
        return torch.as_tensor(y, device=self.device).reshape(-1, self.target_dim)

    def update(self, inputs, targets, update_stem: bool = True, update_gp: bool = True):
        x, y = self._inputs(inputs), self._targets(targets)
        self._raw = torch.cat([self._raw, x])
        self.data = exact_data_append(self.data, self._features(x), y)
        loss = self._grad_step(self.data) if update_gp else 0.0
        return loss, loss

    def fit(self, inputs, targets, num_epochs: int, test_dataset=None):
        x, y = self._inputs(inputs), self._targets(targets)
        self._raw = x
        self.data = exact_data_init(self._features(x, train=True), y)
        records = []
        for epoch in range(num_epochs):
            loss = self._grad_step(self.data)
            rmse = nll = float("nan")
            if test_dataset is not None:
                rmse, nll = self.evaluate(*test_dataset)
            records.append({"epoch": epoch + 1, "train_loss": loss, "test_rmse": rmse, "test_nll": nll,
                            "noise": float(self.noise.mean())})
        return records

    def predict(self, inputs):
        """Predictive y-moments (mean, var), each (n, T)."""
        with torch.no_grad():
            mean, var = exact_gp_posterior(self.model, self.params, self.data, self._features(self._inputs(inputs)))
            return mean.T, (var + self.noise[:, None]).T

    def evaluate(self, inputs, targets):
        return batched_rmse_nll(self.predict, self._inputs(inputs), self._targets(targets))

    @property
    def noise(self) -> torch.Tensor:
        return torch.exp(self.params["raw_noise"].detach())


class OnlineExactClassifier(_ExactBase):
    """Fixed-noise exact GP over Dirichlet-transformed labels."""

    def __init__(self, stem: Stem, init_x, init_y, alpha_eps: float = 0.01, lr: float = 0.01,
                 num_classes: int = 2, kernel: str | Kernel = "rbf", cfg: SolverConfig = DEFAULT_CONFIG,
                 seed: int = 0, device="cuda", **unused):
        self.alpha_eps = alpha_eps
        self.num_classes = num_classes
        if isinstance(kernel, str):
            kernel = make_kernel(kernel)
        model = ExactGPModel(kernel, num_outputs=num_classes, learn_noise=False)
        super().__init__(stem, init_x, lr, model, seed, device)
        targets, _, sigma2 = dirichlet_transform(self._labels(init_y), num_classes, alpha_eps)
        self.data = exact_data_init(self._features(self._raw, train=True), targets, sigma2)

    def _labels(self, y) -> torch.Tensor:
        return torch.as_tensor(y, device=self.device).to(torch.int32).reshape(-1)

    def update(self, inputs, labels, update_stem: bool = True, update_gp: bool = True):
        x = self._inputs(inputs)
        targets, _, sigma2 = dirichlet_transform(self._labels(labels), self.num_classes, self.alpha_eps)
        self._raw = torch.cat([self._raw, x])
        self.data = exact_data_append(self.data, self._features(x), targets, sigma2)
        loss = self._grad_step(self.data) if update_gp else 0.0
        return loss, loss

    def fit(self, inputs, labels, num_epochs: int, test_dataset=None):
        x = self._inputs(inputs)
        targets, _, sigma2 = dirichlet_transform(self._labels(labels), self.num_classes, self.alpha_eps)
        self._raw = x
        self.data = exact_data_init(self._features(x, train=True), targets, sigma2)
        records = []
        for epoch in range(num_epochs):
            loss = self._grad_step(self.data)
            acc = float("nan")
            if test_dataset is not None:
                acc = self.evaluate(*test_dataset)
            records.append({"epoch": epoch + 1, "train_loss": loss, "test_acc": acc})
        return records

    def predict(self, inputs) -> torch.Tensor:
        """The predicted class of each point, (n,)."""
        with torch.no_grad():
            mean, _ = exact_gp_posterior(self.model, self.params, self.data, self._features(self._inputs(inputs)))
            return torch.argmax(mean, dim=0)

    def evaluate(self, inputs, labels) -> float:
        pred = self.predict(inputs)
        return float(torch.mean((pred == self._labels(labels)).to(torch.float32)))
