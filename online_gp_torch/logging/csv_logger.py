"""CSV metrics logger with the reference's `upcycle` table API (the port's
own copy of ``online_gp_tpu/logging/csv_logger.py``: the same calls write
the same bytes).

The reference logs through the external ``upcycle`` package
(``DataFrameLogger``/``S3Logger``; API used at
``experiments/regression.py:45,68-81``): ``add_table(name)``,
``log(metrics_dict, step, table_name)``, ``write_csv()``,
``write_hydra_yaml(cfg)``. Table names (``online_metrics``,
``batch_metrics``, ``pretrain_metrics``) are kept so downstream analysis
(``online_gp/utils/plotting.py`` credible-region aggregation) stays
portable.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List


class CSVLogger:
    def __init__(self, log_dir: str = "./logs", run_name: str = "run"):
        self.log_dir = os.path.join(log_dir, run_name)
        self.tables: Dict[str, List[dict]] = {}

    def add_table(self, name: str):
        self.tables.setdefault(name, [])

    def log(self, metrics: dict, step: int, table_name: str):
        self.add_table(table_name)
        row = {"step": step}
        row.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        self.tables[table_name].append(row)

    def write_csv(self):
        os.makedirs(self.log_dir, exist_ok=True)
        for name, rows in self.tables.items():
            if not rows:
                continue
            keys: List[str] = []
            for r in rows:
                for k in r:
                    if k not in keys:
                        keys.append(k)
            path = os.path.join(self.log_dir, f"{name}.csv")
            with open(path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=keys)
                writer.writeheader()
                writer.writerows(rows)

    def write_config(self, config: dict):
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
