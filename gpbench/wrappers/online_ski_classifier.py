"""The system under test for a configuration whose ``wrapper.factory`` is
``online_ski_classifier``: the port's Dirichlet-GP streaming classifier,
``online_gp_torch.api.OnlineSKIClassifier``, made from the seed's points
and labels with the drawn lengthscale and outputscale set as every class's
kernel parameters. Its state has one output a class, each conditioned on
the Dirichlet noises of the configuration's ``alpha_eps``; there is no
second noise.

A wrapper file is one of the only files of the benchmark that import the
program, and it imports it inside its functions.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from gpbench.wrappers.online_ski_regression import Final, build, final  # noqa: F401  the same build and state


def make(config: Dict, hypers, seed_x: np.ndarray, seed_labels: np.ndarray, device):
    from online_gp_torch.api import IdentityStem, OnlineSKIClassifier

    w = config["wrapper"]
    if w["stem"] != "identity":
        raise ValueError(f"no stem {w['stem']!r} in this factory")
    clf = OnlineSKIClassifier(IdentityStem(config["input_dim"]), seed_x, seed_labels, grid_size=w["grid_size"],
                              grid_bound=w["grid_bound"], alpha_eps=config["alpha_eps"],
                              num_classes=config["num_outputs"], kernel=w["kernel"], device=device)
    kp = clf.params["kernel"]
    with torch.no_grad():
        kp["raw_lengthscale"].copy_(torch.log(torch.tensor(hypers.lengthscale)).to(kp["raw_lengthscale"]))
        kp["raw_outputscale"].fill_(math.log(hypers.outputscale))
    return clf
