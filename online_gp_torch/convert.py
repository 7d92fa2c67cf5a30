"""Carry grids, params and states across from numpy.

The port reads nothing of the JAX package; a caller who has JAX arrays
maps them through ``np.asarray`` and hands the numpy arrays here. Dtypes
are kept; ``device`` says where the tensors go.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from online_gp_torch.models.wiski import WiskiState
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.root_update import RootCache


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def grid_from_numpy(sizes, mins, spacings, device="cuda") -> Grid:
    """A :class:`Grid` from its sizes and its (D,) mins and spacings."""
    return Grid(tuple(int(s) for s in sizes), _tensor(mins, device), _tensor(spacings, device))


def params_from_numpy(params: Dict, device="cuda") -> Dict:
    """The nested dict of numpy arrays (``kernel/raw_lengthscale``,
    ``kernel/raw_outputscale``, ``raw_second_noise``) as torch tensors
    under the same keys."""
    return {
        key: params_from_numpy(val, device) if isinstance(val, dict) else _tensor(val, device)
        for key, val in params.items()
    }


def state_from_numpy(
    wty,
    ydy,
    mat: Optional[np.ndarray],
    root,
    inv_root,
    d_logdet,
    num_data,
    device="cuda",
) -> WiskiState:
    """A :class:`WiskiState` from its fields; ``mat`` is None for a slim
    state."""
    return WiskiState(
        wty=_tensor(wty, device),
        ydy=_tensor(ydy, device),
        roots=RootCache(
            mat=None if mat is None else _tensor(mat, device),
            root=_tensor(root, device),
            inv_root=_tensor(inv_root, device),
        ),
        d_logdet=_tensor(d_logdet, device),
        num_data=int(num_data),
    )
