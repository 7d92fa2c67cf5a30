"""Regular inducing grids for SKI (port of ``online_gp_tpu/ops/grid.py``).

- a Cartesian product of per-dimension uniform 1-D grids,
- each 1-D grid is padded by two spacings beyond the user bounds so every
  query inside the bounds has a full 4-point cubic stencil,
- row-major flattening (dimension 0 slowest), the ordering the
  Kronecker-factored grid kernel uses.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


class Grid:
    """A static Cartesian inducing grid.

    Attributes:
      sizes: per-dimension grid sizes (python ints).
      mins: (D,) first grid point per dimension.
      spacings: (D,) grid spacing per dimension.
    """

    def __init__(self, sizes: Tuple[int, ...], mins: torch.Tensor, spacings: torch.Tensor):
        self.sizes = tuple(int(s) for s in sizes)
        self.mins = mins
        self.spacings = spacings

    @staticmethod
    def create(
        grid_bounds,
        grid_size,
        pad: int = 2,
        dtype=torch.float32,
        device="cuda",
    ) -> "Grid":
        """Build a grid covering ``grid_bounds`` with a stencil-safe margin.

        Args:
          grid_bounds: sequence of (lo, hi) pairs, one per input dimension.
          grid_size: int or sequence of ints, grid points per dimension.
          pad: extra grid points beyond each bound (2: the cubic stencil
            fits for any query inside the bounds).
          device: where ``mins``/``spacings`` live; the grid's queries
            must be on the same device.
        """
        bounds = [(float(lo), float(hi)) for lo, hi in grid_bounds]
        ndim = len(bounds)
        if isinstance(grid_size, int):
            sizes = (grid_size,) * ndim
        else:
            sizes = tuple(int(g) for g in grid_size)
        if len(sizes) != ndim:
            raise ValueError(f"grid_size {sizes} does not match {ndim} dims")
        mins, spacings = [], []
        for (lo, hi), m in zip(bounds, sizes):
            if m < 2 * pad + 2:
                raise ValueError(f"grid size {m} too small for pad {pad}")
            h = (hi - lo) / (m - 1 - 2 * pad)
            mins.append(lo - pad * h)
            spacings.append(h)
        return Grid(
            sizes,
            torch.tensor(mins, dtype=dtype, device=device),
            torch.tensor(spacings, dtype=dtype, device=device),
        )

    @staticmethod
    def from_data(x: torch.Tensor, grid_size, margin: float = 0.1, dtype=torch.float32, device=None) -> "Grid":
        """A grid over the data's bounds widened by ``margin`` on each side,
        on ``x``'s device unless ``device`` is given."""
        lo = torch.amin(x, dim=0) - margin
        hi = torch.amax(x, dim=0) + margin
        bounds = [(float(a), float(b)) for a, b in zip(lo, hi)]
        return Grid.create(bounds, grid_size, dtype=dtype, device=x.device if device is None else device)

    @property
    def ndim(self) -> int:
        return len(self.sizes)

    @property
    def num_points(self) -> int:
        return math.prod(self.sizes)

    @property
    def device(self) -> torch.device:
        return self.mins.device

    @property
    def strides(self) -> Tuple[int, ...]:
        """Row-major strides: dimension 0 slowest."""
        strides = []
        acc = 1
        for s in reversed(self.sizes):
            strides.append(acc)
            acc *= s
        return tuple(reversed(strides))

    def points_1d(self, d: int) -> torch.Tensor:
        """(sizes[d],) grid points along dimension d."""
        ar = torch.arange(self.sizes[d], dtype=self.mins.dtype, device=self.mins.device)
        return self.mins[d] + self.spacings[d] * ar

    def full_points(self) -> torch.Tensor:
        """(num_points, D) all grid points, row-major order."""
        mesh = torch.meshgrid(*(self.points_1d(d) for d in range(self.ndim)), indexing="ij")
        return torch.stack([m.reshape(-1) for m in mesh], dim=-1)

    def __repr__(self):
        return f"Grid(sizes={self.sizes})"
