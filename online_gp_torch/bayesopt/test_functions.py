"""Synthetic optimization test functions (port of
``online_gp_tpu/bayesopt/test_functions.py``).

The reference takes these from botorch: Ackley, DixonPrice, Griewank,
Levy, Michalewicz, Rastrigin, Rosenbrock, StyblinskiTang. Each is written
out here, *negated* (the maximization convention of the reference's
``negate=True``), with its default bounds and the optimum of the negated
function.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class TestFunction(NamedTuple):
    name: str
    dim: int
    bounds: torch.Tensor  # (d, 2)
    optimal_value: float  # of the negated (maximized) function

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _EVALS[self.name](x)

    def noisy(self, x: torch.Tensor, noise_std: float, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latent + noise_std * eps, latent); eps is drawn from ``generator``
        on its own device (the CPU for a CPU generator) and moved to x's, so
        that a run on the card and its CPU twin draw the same noise."""
        latent = self(x)
        eps = torch.randn(latent.shape, generator=generator, dtype=latent.dtype, device=generator.device)
        return latent + noise_std * eps.to(latent.device), latent


def _ackley(x):
    a, b, c = 20.0, 0.2, 2 * math.pi
    s1 = torch.sqrt(torch.mean(x**2, dim=-1))
    s2 = torch.mean(torch.cos(c * x), dim=-1)
    return -(-a * torch.exp(-b * s1) - torch.exp(s2) + a + math.e)


def _dixon_price(x):
    d = x.shape[-1]
    i = torch.arange(2, d + 1, dtype=x.dtype, device=x.device)
    term = i * (2 * x[..., 1:] ** 2 - x[..., :-1]) ** 2
    return -((x[..., 0] - 1) ** 2 + torch.sum(term, dim=-1))


def _griewank(x):
    i = torch.sqrt(torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device))
    return -(torch.sum(x**2, dim=-1) / 4000.0 - torch.prod(torch.cos(x / i), dim=-1) + 1.0)


def _levy(x):
    w = 1.0 + (x - 1.0) / 4.0
    t1 = torch.sin(math.pi * w[..., 0]) ** 2
    t2 = torch.sum((w[..., :-1] - 1) ** 2 * (1 + 10 * torch.sin(math.pi * w[..., :-1] + 1) ** 2), dim=-1)
    t3 = (w[..., -1] - 1) ** 2 * (1 + torch.sin(2 * math.pi * w[..., -1]) ** 2)
    return -(t1 + t2 + t3)


def _michalewicz(x):
    m = 10.0
    i = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)
    return torch.sum(torch.sin(x) * torch.sin(i * x**2 / math.pi) ** (2 * m), dim=-1)


def _rastrigin(x):
    d = x.shape[-1]
    return -(10.0 * d + torch.sum(x**2 - 10.0 * torch.cos(2 * math.pi * x), dim=-1))


def _rosenbrock(x):
    return -torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (x[..., :-1] - 1) ** 2, dim=-1)


def _styblinski_tang(x):
    return -0.5 * torch.sum(x**4 - 16 * x**2 + 5 * x, dim=-1)


_EVALS = {
    "Ackley": _ackley,
    "DixonPrice": _dixon_price,
    "Griewank": _griewank,
    "Levy": _levy,
    "Michalewicz": _michalewicz,
    "Rastrigin": _rastrigin,
    "Rosenbrock": _rosenbrock,
    "StyblinskiTang": _styblinski_tang,
}

_BOUNDS = {
    "Ackley": (-32.768, 32.768),
    "DixonPrice": (-10.0, 10.0),
    "Griewank": (-600.0, 600.0),
    "Levy": (-10.0, 10.0),
    "Michalewicz": (0.0, math.pi),
    "Rastrigin": (-5.12, 5.12),
    "Rosenbrock": (-5.0, 10.0),
    "StyblinskiTang": (-5.0, 5.0),
}

_OPTIMA = {
    "Ackley": 0.0,
    "DixonPrice": 0.0,
    "Griewank": 0.0,
    "Levy": 0.0,
    "Michalewicz": None,
    "Rastrigin": 0.0,
    "Rosenbrock": 0.0,
    "StyblinskiTang": None,  # 39.166 * d
}

TEST_FUNCTIONS = sorted(_EVALS)


def make_test_function(name: str, dim: int, device="cuda") -> TestFunction:
    """The negated function with its (dim, 2) float32 bounds on ``device``."""
    if name not in _EVALS:
        raise ValueError(f"unknown test function {name!r}; known: {TEST_FUNCTIONS}")
    lo, hi = _BOUNDS[name]
    bounds = torch.tensor([[lo, hi]] * dim, dtype=torch.float32, device=device)
    opt = _OPTIMA[name]
    if name == "StyblinskiTang":
        opt = 39.16599 * dim
    return TestFunction(name, dim, bounds, opt if opt is not None else float("nan"))
