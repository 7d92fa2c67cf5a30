"""The system under test for a configuration whose ``wrapper.factory`` is
``online_ski_regression``: the port's public streaming wrapper,
``online_gp_torch.api.OnlineSKIRegression``, made from the seed's points
with the drawn hyperparameters set as its parameters.

A wrapper file is one of the only files of the benchmark that import the
program, and it imports it inside its functions.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch


def build() -> None:
    """Build (or find built) every CUDA library of the port, in parallel."""
    from online_gp_torch.ops import _build

    _build.build_all()


def make(config: Dict, hypers, seed_x: np.ndarray, seed_y: np.ndarray, device):
    from online_gp_torch.api import IdentityStem, OnlineSKIRegression

    w = config["wrapper"]
    if w["stem"] != "identity":
        raise ValueError(f"no stem {w['stem']!r} in this factory")
    reg = OnlineSKIRegression(IdentityStem(config["input_dim"]), seed_x, seed_y, grid_size=w["grid_size"],
                              grid_bound=w["grid_bound"], kernel=w["kernel"], device=device)
    kp = reg.params["kernel"]
    with torch.no_grad():
        kp["raw_lengthscale"].copy_(torch.log(torch.tensor(hypers.lengthscale)).to(kp["raw_lengthscale"]))
        kp["raw_outputscale"].fill_(math.log(hypers.outputscale))
        reg.params["raw_second_noise"].fill_(math.log(hypers.noise))
    return reg


class Final(NamedTuple):
    """What the program left once the window closed, as the check reads it."""

    root: torch.Tensor  # (B, m, m) each output's root L
    wty: torch.Tensor  # (B, m)


def final(reg) -> Final:
    st = reg.state
    return Final(st.roots.root, st.wty[:, :, 0])
