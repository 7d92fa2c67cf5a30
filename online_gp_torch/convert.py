"""Carry grids, params, states and stems across from numpy.

The port reads nothing of the JAX package; a caller who has JAX arrays
maps them through ``np.asarray`` and hands the numpy arrays here. Dtypes
are kept; ``device`` says where the tensors go.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from online_gp_torch.api.regression import _leaves
from online_gp_torch.api.stems import Stem
from online_gp_torch.models.wiski import WiskiState
from online_gp_torch.models.wiski_lowrank import WiskiLowRankState
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.root_update import RootCache


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def grid_from_numpy(sizes, mins, spacings, device="cuda") -> Grid:
    """A :class:`Grid` from its sizes and its (D,) mins and spacings."""
    return Grid(tuple(int(s) for s in sizes), _tensor(mins, device), _tensor(spacings, device))


def params_from_numpy(params: Dict, device="cuda") -> Dict:
    """The nested dict of numpy arrays (``kernel/raw_lengthscale`` and
    ``kernel/raw_outputscale``, or a spectral mixture's
    ``kernel/raw_sm_weights``, ``raw_sm_means`` and ``raw_sm_scales``;
    ``raw_second_noise``) as torch tensors under the same keys."""
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


def lowrank_state_from_numpy(wty, ydy, root, used, d_logdet, num_data, device="cuda") -> WiskiLowRankState:
    """A :class:`WiskiLowRankState` from its fields (with or without a
    leading output dim); ``used`` and ``num_data`` become Python ints (one
    value: every output absorbs the same inputs)."""
    used, num_data = np.unique(np.asarray(used)), np.unique(np.asarray(num_data))
    if used.size != 1 or num_data.size != 1:
        raise ValueError(f"outputs disagree on used={used} or num_data={num_data}")
    return WiskiLowRankState(
        wty=_tensor(wty, device),
        ydy=_tensor(ydy, device),
        root=_tensor(root, device),
        used=int(used[0]),
        d_logdet=_tensor(d_logdet, device),
        num_data=int(num_data[0]),
    )


def stem_from_numpy(stem: Stem, params: Dict, bn_state: Dict, device="cuda") -> Stem:
    """Load a stem's weights and BatchNorm statistics, in the JAX stems'
    layout, into ``stem`` (in place; it is returned, on ``device``).

    ``params`` maps each layer's name (``lin``, or ``lin0``, ``lin1``, ...)
    to ``{"w": (d_in, d_out), "b": (d_out,)}``: ``w`` is the transpose of
    ``nn.Linear.weight``. ``bn_state`` is ``{"bn": {"mean", "var",
    "momentum"}}`` (``{}`` for a stem without one). The parameter objects
    stay the same, so optimizers built on them keep working.
    """
    stem.to(device)
    for name, layer in params.items():
        lin = getattr(stem, name)
        lin.weight.data = _tensor(np.asarray(layer["w"]).T, device)
        lin.bias.data = _tensor(layer["b"], device)
    if bn_state:
        bn = bn_state["bn"]
        stem.bn.running_mean = _tensor(bn["mean"], device)
        stem.bn.running_var = _tensor(bn["var"], device)
        stem.bn.momentum = _tensor(bn["momentum"], device)
    return stem


def load_wrapper(wrapper, params: Dict, stem_params: Dict, bn_state: Dict, state: Dict, device=None) -> None:
    """Start an L5 wrapper (``OnlineSKIRegression``, ``OnlineSKIClassifier``
    or a rank-capped one) from numpy arrays, in place, on ``device`` (the
    wrapper's by default):

    - ``params``: the GP params, as :func:`params_from_numpy` takes them;
      they become the wrapper's leaves in the arrays' dtypes, and its
      optimizers are made anew on them (``set_lr`` at the wrapper's rate);
    - ``stem_params``, ``bn_state``: as :func:`stem_from_numpy` (ignored
      for a stem without parameters);
    - ``state``: the state's fields by name, those of
      :func:`state_from_numpy` or, with ``used``, of
      :func:`lowrank_state_from_numpy`.
    """
    device = wrapper.device if device is None else device
    if wrapper.stem.has_params:
        stem_from_numpy(wrapper.stem, stem_params, bn_state, device)
    wrapper.params = params_from_numpy(params, device)
    for leaf in _leaves(wrapper.params):
        leaf.requires_grad_(True)
    wrapper.set_lr(wrapper.lr)
    make = lowrank_state_from_numpy if "used" in state else state_from_numpy
    wrapper.state = make(**state, device=device)
