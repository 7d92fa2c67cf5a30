"""Carry grids, params, states and stems across from numpy.

The port reads nothing of the JAX package; a caller who has JAX arrays
maps them through ``np.asarray`` and hands the numpy arrays here. Dtypes
are kept; ``device`` says where the tensors go.

The WISKI wrappers load through :func:`load_wrapper`; the baselines
through one loader each (:func:`load_exact`, :func:`load_localgp`,
:func:`load_sgpr`, :func:`load_svgp`), over the state records
``exact_data_from_numpy``, ``localgp_state_from_numpy``,
``sgpr_old_state_from_numpy``, ``sgpr_moments_from_numpy`` and
``svgp_old_state_from_numpy``. Every loader gives the wrapper fresh
optimizers at its rates (the optimizers' state is not carried).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from online_gp_torch.api.regression import _leaves
from online_gp_torch.api.stems import Stem
from online_gp_torch.models.exact_online import ExactGPData
from online_gp_torch.models.localgp import LocalGPState
from online_gp_torch.models.sgpr import SGPRMoments, SGPROldState
from online_gp_torch.models.svgp import SVGPOldState
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


def exact_data_from_numpy(x, y, noise, mask, count, device="cuda") -> ExactGPData:
    """An online exact GP's masked buffer from its fields."""
    return ExactGPData(_tensor(x, device), _tensor(y, device), _tensor(noise, device), _tensor(mask, device),
                       int(count))


def localgp_state_from_numpy(x, y, mask, counts, active, centers, device="cuda") -> LocalGPState:
    """A local-GP mixture's batched expert buffers from their fields."""
    return LocalGPState(*(_tensor(a, device) for a in (x, y, mask, counts, active, centers)))


def sgpr_old_state_from_numpy(z, var_mean, kernel_params, C, c, device="cuda") -> SGPROldState:
    """An O-SGPR old state (``kernel_params`` a dict of arrays)."""
    return SGPROldState(_tensor(z, device), _tensor(var_mean, device), params_from_numpy(kernel_params, device),
                        _tensor(C, device), _tensor(c, device))


def sgpr_moments_from_numpy(var_mean, var_chol, device="cuda") -> SGPRMoments:
    return SGPRMoments(_tensor(var_mean, device), _tensor(var_chol, device))


def svgp_old_state_from_numpy(z, var_mean, var_cov, prior_mean, prior_cov, device="cuda") -> SVGPOldState:
    """An O-SVGP snapshot for the streaming correction."""
    return SVGPOldState(*(_tensor(a, device) for a in (z, var_mean, var_cov, prior_mean, prior_cov)))


def _load_params(wrapper, params: Dict, stem_params: Dict, bn_state: Dict, device) -> None:
    """The stem (if it has parameters) and the GP params, in the arrays'
    dtypes, as leaves that take gradients; then fresh optimizers."""
    if wrapper.stem.has_params:
        stem_from_numpy(wrapper.stem, stem_params, bn_state, device)
    wrapper.params = params_from_numpy(params, device)
    for leaf in _leaves(wrapper.params):
        leaf.requires_grad_(True)
    wrapper.set_lr(wrapper.lr)


def load_exact(wrapper, params: Dict, stem_params: Dict, bn_state: Dict, data: Dict, raw_x, device=None) -> None:
    """Start ``OnlineExactRegression`` or ``OnlineExactClassifier`` from
    numpy arrays: its params, stem, buffer (the fields of
    :func:`exact_data_from_numpy`) and the raw inputs the stem's features
    are recomputed from."""
    device = wrapper.device if device is None else device
    _load_params(wrapper, params, stem_params, bn_state, device)
    wrapper.data = exact_data_from_numpy(**data, device=device)
    wrapper._raw = _tensor(raw_x, device)


def load_localgp(wrapper, params: Dict, stem_params: Dict, bn_state: Dict, state: Dict, device=None) -> None:
    """Start ``OnlineLocalGPRegression`` from numpy arrays: its params, stem
    and experts (the fields of :func:`localgp_state_from_numpy`)."""
    device = wrapper.device if device is None else device
    _load_params(wrapper, params, stem_params, bn_state, device)
    wrapper.state = localgp_state_from_numpy(**state, device=device)


def load_sgpr(wrapper, params: Dict, stem_params: Dict, bn_state: Dict, old: Optional[Dict] = None,
              moments: Optional[Dict] = None, absorbs_since_rebase: int = 0, device=None) -> None:
    """Start ``OnlineSGPRegression`` from numpy arrays: its params, stem, old
    state and moments (None before the first absorb) and its count of
    absorbs since the last rebase."""
    device = wrapper.device if device is None else device
    _load_params(wrapper, params, stem_params, bn_state, device)
    wrapper.old = None if old is None else sgpr_old_state_from_numpy(**old, device=device)
    wrapper.moments = None if moments is None else sgpr_moments_from_numpy(**moments, device=device)
    wrapper._absorbs_since_rebase = int(absorbs_since_rebase)


def load_svgp(wrapper, params: Dict, stem_params: Dict, bn_state: Dict, old: Optional[Dict] = None,
              device=None) -> None:
    """Start ``OnlineSVGPRegression`` or ``OnlineSVGPClassifier`` from numpy
    arrays: its params, stem and streaming snapshot (None before one)."""
    device = wrapper.device if device is None else device
    _load_params(wrapper, params, stem_params, bn_state, device)
    wrapper.old = None if old is None else svgp_old_state_from_numpy(**old, device=device)
