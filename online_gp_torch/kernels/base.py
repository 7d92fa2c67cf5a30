"""Kernel functions as parameter dicts plus pure apply functions (port of
``online_gp_tpu/kernels/base.py``: RBF, the product Matern and the radial
Matern; :func:`make_kernel` builds one by name, the spectral mixture of
:mod:`online_gp_torch.kernels.spectral_mixture` included).

- Parameters are plain dicts of raw tensors; positivity comes from a
  reparametrization, ``exp`` by default or a sigmoid interval
  (``IntervalTransform``).
- Every kernel is a product across input dimensions times an output
  scale, the family whose grid Gram matrix is a Kronecker product.
- Batched hyperparameters (one set per output) are leading dims on the
  param tensors; every apply function broadcasts over them.

Parameters:
  ``raw_lengthscale``: (..., D) raw lengthscales (ARD).
  ``raw_outputscale``: (...,) raw output scale.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


class ExpTransform(NamedTuple):
    """Unbounded positivity reparam: constrained = exp(raw) (the default)."""

    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        return torch.exp(raw)

    def inverse(self, value: float) -> float:
        return math.log(value)


class IntervalTransform(NamedTuple):
    """Bounded reparam: constrained = lower + (upper-lower)*sigmoid(raw)."""

    lower: float
    upper: float

    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        return self.lower + (self.upper - self.lower) * torch.sigmoid(raw)

    def inverse(self, value: float) -> float:
        u = (value - self.lower) / (self.upper - self.lower)
        if not 0.0 < u < 1.0:
            raise ValueError(
                f"init value {value} outside interval ({self.lower}, {self.upper})"
            )
        return math.log(u) - math.log1p(-u)


class Kernel:
    """Stationary product kernel: k(x, z) = s^2 * prod_d k_d(|x_d - z_d| / l_d)."""

    name = "base"

    def __init__(self):
        self.transforms = {
            "raw_lengthscale": ExpTransform(),
            "raw_outputscale": ExpTransform(),
        }

    def constrain(
        self,
        lengthscale_bounds: Optional[Tuple[float, float]] = None,
        outputscale_bounds: Optional[Tuple[float, float]] = None,
    ) -> "Kernel":
        """Bound hyperparameters to an interval (returns self for chaining)."""
        if lengthscale_bounds is not None:
            self.transforms["raw_lengthscale"] = IntervalTransform(*lengthscale_bounds)
        if outputscale_bounds is not None:
            self.transforms["raw_outputscale"] = IntervalTransform(*outputscale_bounds)
        return self

    def lengthscale(self, params: Params) -> torch.Tensor:
        """Constrained lengthscales (..., D)."""
        return self.transforms["raw_lengthscale"].forward(params["raw_lengthscale"])

    def outputscale(self, params: Params) -> torch.Tensor:
        """Constrained output scale (...,)."""
        return self.transforms["raw_outputscale"].forward(params["raw_outputscale"])

    def init_params(
        self,
        num_dims: int,
        batch_shape=(),
        lengthscale: float = 0.693,
        outputscale: float = 1.0,
        dtype=torch.float32,
        device="cuda",
    ) -> Params:
        raw_ls = self.transforms["raw_lengthscale"].inverse(lengthscale)
        raw_os = self.transforms["raw_outputscale"].inverse(outputscale)
        return {
            "raw_lengthscale": torch.full(
                tuple(batch_shape) + (num_dims,), raw_ls, dtype=dtype, device=device
            ),
            "raw_outputscale": torch.full(tuple(batch_shape), raw_os, dtype=dtype, device=device),
        }

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        """k_d(r) for nonnegative scaled distance r (unit lengthscale)."""
        raise NotImplementedError

    def matrix(self, params: Params, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """Dense kernel matrix (..., n1, n2) for x1 (n1, D), x2 (n2, D)."""
        ls = self.lengthscale(params)
        scale = self.outputscale(params)
        diff = x1[:, None, :] - x2[None, :, :]
        r = torch.abs(diff) / ls[..., None, None, :]
        k = torch.prod(self.profile(r), dim=-1)
        return scale[..., None, None] * k

    def factor_1d(self, params: Params, d: int, g: torch.Tensor, include_scale: bool) -> torch.Tensor:
        """Per-dimension grid factor T_d = k_d(g, g): (..., m_d, m_d)."""
        ls = self.lengthscale(params)[..., d]
        r = torch.abs(g[:, None] - g[None, :]) / ls[..., None, None]
        t = self.profile(r)
        if include_scale:
            t = self.outputscale(params)[..., None, None] * t
        return t

    def factor_col(self, params: Params, d: int, g: torch.Tensor, include_scale: bool) -> torch.Tensor:
        """First column of the (Toeplitz) grid factor: (..., m_d)."""
        ls = self.lengthscale(params)[..., d]
        r = torch.abs(g - g[0]) / ls[..., None]
        c = self.profile(r)
        if include_scale:
            c = self.outputscale(params)[..., None] * c
        return c


class RBFKernel(Kernel):
    """Squared-exponential; the ARD product form is exact."""

    name = "rbf"

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        return torch.exp(-0.5 * r * r)


def _matern_profile(nu: float, r: torch.Tensor) -> torch.Tensor:
    if nu == 0.5:
        return torch.exp(-r)
    if nu == 1.5:
        s = _SQRT3 * r
        return (1.0 + s) * torch.exp(-s)
    s = _SQRT5 * r
    return (1.0 + s + s * s / 3.0) * torch.exp(-s)


class MaternKernel(Kernel):
    """Per-dimension product Matern (nu in {0.5, 1.5, 2.5}): the grid-structured
    family the SKI path runs; the radial one is :class:`RadialMaternKernel`."""

    name = "matern"

    def __init__(self, nu: float = 2.5):
        super().__init__()
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError(f"unsupported nu={nu}")
        self.nu = nu

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        return _matern_profile(self.nu, r)


class RadialMaternKernel(Kernel):
    """ARD Matern on the Euclidean radius (non-separable), for exact-GP
    baselines: it has no Kronecker grid structure, so it is not valid inside
    the SKI/grid path."""

    name = "radial_matern"

    def __init__(self, nu: float = 2.5):
        super().__init__()
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError(f"unsupported nu={nu}")
        self.nu = nu

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("radial kernel has no per-dim profile")

    def matrix(self, params: Params, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        ls = self.lengthscale(params)
        scale = self.outputscale(params)
        diff = (x1[:, None, :] - x2[None, :, :]) / ls[..., None, None, :]
        r = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=1e-30))
        return scale[..., None, None] * _matern_profile(self.nu, r)


def _make_sm(num_mixtures: int):
    from online_gp_torch.kernels.spectral_mixture import SpectralMixtureKernel

    return SpectralMixtureKernel(num_mixtures)


_REGISTRY = {
    "rbf": RBFKernel,
    "matern12": lambda: MaternKernel(0.5),
    "matern32": lambda: MaternKernel(1.5),
    "matern52": lambda: MaternKernel(2.5),
    "radial_matern12": lambda: RadialMaternKernel(0.5),
    "radial_matern32": lambda: RadialMaternKernel(1.5),
    "radial_matern52": lambda: RadialMaternKernel(2.5),
    "sm2": lambda: _make_sm(2),
    "sm3": lambda: _make_sm(3),
    "sm4": lambda: _make_sm(4),
    "spectral_mixture": lambda: _make_sm(3),
}


def make_kernel(name: str) -> Kernel:
    """A fresh kernel by the JAX package's names: ``rbf``,
    ``matern12/32/52``, ``radial_matern12/32/52``, and the spectral mixtures
    ``sm2``, ``sm3``, ``sm4`` and ``spectral_mixture`` (3 components)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; known: {sorted(_REGISTRY)}") from None
    return factory()
