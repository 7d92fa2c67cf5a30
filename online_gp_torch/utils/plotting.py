"""Cross-trial metric aggregation (reference ``online_gp/utils/plotting.py``:
median + credible region over trial CSVs for plotting); the port's own
copy of ``online_gp_tpu/utils/plotting.py`` (numpy and csv only)."""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict

import numpy as np


def read_table(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    out = {}
    for k in rows[0]:
        try:
            out[k] = np.asarray([float(r[k]) for r in rows])
        except (TypeError, ValueError):
            out[k] = np.asarray([r[k] for r in rows])
    return out


def aggregate_trials(
    pattern: str,
    table: str = "online_metrics",
    metric: str = "test_rmse",
    lo: float = 0.25,
    hi: float = 0.75,
) -> Dict[str, np.ndarray]:
    """Aggregate a metric across trial directories matching ``pattern``.

    Returns {"step", "median", "lo", "hi", "num_trials"} with per-step
    median and credible band — the reference's credible-region CSV
    aggregation, minus the pandas dependency.
    """
    tables = []
    for d in sorted(glob.glob(pattern)):
        path = os.path.join(d, f"{table}.csv")
        if os.path.exists(path):
            t = read_table(path)
            if metric in t:
                tables.append(t)
    if not tables:
        return {}
    n_steps = min(len(t[metric]) for t in tables)
    vals = np.stack([t[metric][:n_steps] for t in tables])  # (T, S)
    return {
        "step": tables[0]["step"][:n_steps],
        "median": np.median(vals, axis=0),
        "lo": np.quantile(vals, lo, axis=0),
        "hi": np.quantile(vals, hi, axis=0),
        "num_trials": np.asarray(len(tables)),
    }
