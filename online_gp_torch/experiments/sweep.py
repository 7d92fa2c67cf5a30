"""Multi-trial sweep runner (the port of ``online_gp_tpu/experiments/sweep.py``,
its sequential mode).

The reference farms independent trials as separate processes
(``scripts/launch_jobs.sh``, Hydra submitit launchers, one GPU per
trial). ``mode=seq`` runs the trials one after another in one process,
trial ``t`` with ``trial_id=t`` and ``seed=t`` (the bash-loop equivalent).
The JAX package's ``mode=mesh`` (trials batched and sharded over a device
mesh in one program) is not ported yet and raises.

Usage:
    python -m online_gp_torch.experiments.sweep num_trials=4 mode=seq \\
        model=wiski_gp_regression dataset=friedman stem=linear ...
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np


def run_sweep(num_trials: int, mode: str, overrides: List[str]) -> List[Dict]:
    if mode == "mesh":
        raise NotImplementedError(
            "sweep mode=mesh (trials batched and sharded over a device mesh) waits for the port of the "
            "parallel layer (ROADMAP Queue 1 item 4); use mode=seq"
        )
    if mode != "seq":
        raise ValueError(f"unknown sweep mode {mode!r} (seq/mesh)")
    from online_gp_torch.experiments.classification import classification_trial
    from online_gp_torch.experiments.config import parse_config
    from online_gp_torch.experiments.regression import regression_trial

    results = []
    for trial in range(num_trials):
        cfg = parse_config(overrides + [f"trial_id={trial}", f"seed={trial}"])
        np.random.seed(trial)
        if cfg["model"]["type"] == "classification":
            results.append(classification_trial(cfg))
        else:
            results.append(regression_trial(cfg))
    return results


def main():
    args = sys.argv[1:]
    num_trials, mode, overrides = 2, "seq", []
    for a in args:
        k, v = a.split("=", 1)
        if k == "num_trials":
            num_trials = int(v)
        elif k == "mode":
            mode = v
        else:
            overrides.append(a)
    results = run_sweep(num_trials, mode, overrides)
    for r in results:
        print(r)


if __name__ == "__main__":
    main()
