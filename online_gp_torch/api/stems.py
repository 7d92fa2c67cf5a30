"""Feature-extractor stems: Identity, Linear, MLP (port of
``online_gp_tpu/api/stems.py``).

Every learned stem ends in an affine-free BatchNorm followed by
``tanh(x/2)``, squashing features into the SKI grid bounds [-1, 1]. Here a
stem is an ``nn.Module``: its parameters are ``nn.Linear`` layers (named as
the JAX params: ``lin`` or ``lin0``, ``lin1``, ...) and its BatchNorm
running statistics are buffers. In training mode (``stem.train()``) a
forward pass normalizes with the batch's statistics and updates the running
ones; in eval mode it uses the running ones.

Dtypes follow the JAX package's promotion: float32 weights applied to
float64 inputs compute in float64, and the running statistics take the
dtype of the first update, as the JAX state does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class Stem(nn.Module):
    input_dim: int
    output_dim: int

    @property
    def has_params(self) -> bool:
        return True

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh weights drawn from ``generator`` and fresh BatchNorm statistics
        (the JAX stems' ``init(key)``)."""


class IdentityStem(Stem):
    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = input_dim

    @property
    def has_params(self) -> bool:
        return False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _BatchNorm(nn.Module):
    """Affine-free BatchNorm1d: normalize with the batch's biased variance,
    track the unbiased one in the running statistics, ``momentum`` 0.1 (a
    0-dim buffer: ``set_lr(bn_mom=)`` changes it), eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("momentum", torch.tensor(0.1))

    def reset(self) -> None:
        f = dict(dtype=torch.float32, device=self.running_mean.device)
        self.running_mean = torch.zeros(self.running_mean.shape, **f)
        self.running_var = torch.ones(self.running_var.shape, **f)
        self.momentum = torch.tensor(0.1, **f)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return (h - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        mu = torch.mean(h, dim=0)
        var = torch.var(h, dim=0, unbiased=False)
        n = h.shape[0]
        unbiased = var * n / max(n - 1, 1)
        mom = self.momentum
        with torch.no_grad():
            self.running_mean = (1 - mom) * self.running_mean + mom * mu.detach()
            self.running_var = (1 - mom) * self.running_var + mom * unbiased.detach()
        return (h - mu) / torch.sqrt(var + self.eps)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _reset_linear(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """U(-1/sqrt(d_in), 1/sqrt(d_in)) for the weight and the bias, the JAX
    package's ``_linear_init`` (and ``nn.Linear``'s own default)."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        for p in (layer.weight, layer.bias):
            p.copy_(torch.empty(p.shape, dtype=p.dtype).uniform_(-bound, bound, generator=generator))


class LinearStem(Stem):
    """Linear -> BatchNorm(affine=False) -> tanh(x/2)."""

    def __init__(self, input_dim: int, feature_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = feature_dim
        self.lin = nn.Linear(input_dim, feature_dim)
        self.bn = _BatchNorm(feature_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_linear(self.lin, generator)
        self.bn.reset()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.bn(_linear(self.lin, x)) / 2.0)


class MLPStem(Stem):
    """depth x (Linear, ReLU) -> Linear -> BatchNorm -> tanh(x/2), times
    ``output_scale``."""

    def __init__(
        self,
        input_dim: int,
        feature_dim: int,
        depth: int = 2,
        hidden_dims: Sequence[int] | str = (64, 64),
        output_scale: float = 1.0,
    ):
        super().__init__()
        if isinstance(hidden_dims, str):
            hidden_dims = [int(d) for d in hidden_dims.split(",")]
        hidden_dims = list(hidden_dims)
        if len(hidden_dims) < depth:
            hidden_dims = hidden_dims + [hidden_dims[-1]] * (depth - len(hidden_dims))
        self.input_dim = input_dim
        self.output_dim = feature_dim
        self.depth = depth
        self.hidden_dims = hidden_dims
        self.output_scale = output_scale
        dims = [input_dim] + hidden_dims[:depth] + [feature_dim]
        for i in range(len(dims) - 1):
            setattr(self, f"lin{i}", nn.Linear(dims[i], dims[i + 1]))
        self.bn = _BatchNorm(feature_dim)

    def _layers(self):
        return [getattr(self, f"lin{i}") for i in range(self.depth + 1)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self._layers():
            _reset_linear(layer, generator)
        self.bn.reset()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        layers = self._layers()
        for i, layer in enumerate(layers):
            h = _linear(layer, h)
            if i < len(layers) - 1:
                h = torch.relu(h)
        return self.output_scale * torch.tanh(self.bn(h) / 2.0)


def make_stem(name: str, input_dim: int, feature_dim: Optional[int] = None, **kw) -> Stem:
    feature_dim = feature_dim or input_dim
    if name in ("eye", "identity"):
        return IdentityStem(input_dim)
    if name == "linear":
        return LinearStem(input_dim, feature_dim)
    if name == "mlp":
        return MLPStem(input_dim, feature_dim, **kw)
    raise ValueError(f"unknown stem {name!r}")
