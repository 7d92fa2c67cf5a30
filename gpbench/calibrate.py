"""The readings the limits of ``correct`` are set from, and the control.

    python3 -m gpbench.calibrate --workload <cell> --seeds 101 102 ... \
        --control 3 --seconds <s> [--out chiprun_out/calib-<cell>.jsonl]

In one process, it runs the cell as ``python3 -m gpbench`` does (set-up,
a window of ``--seconds``, the check) once for each seed, and prints one
JSON line a seed with every number the check computes (``numbers``). For
the first ``--control`` seeds it also replays the same requests in float32
with TF32 on (the control: the reference in the program's place, in the
precision below the configuration's) and prints what the check reads of
it (``control``). The lower reading of a number is the largest the
program gives, its upper reading the smallest the control gives
(``gpbench/limits/<cell>.json`` keeps both beside each limit).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from gpbench import run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device; this machine has none", file=sys.stderr)
        return 2
    lines = []
    for i, seed in enumerate(args.seeds):
        out = run.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                           control=i < args.control)
        line = {"cell": cell.name, "seed": seed, "correct": out["correct"], "attempted": out["attempted"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "memory_peak_bytes": out["device"]["memory_peak_bytes"], "setup_phases": out["setup_phases"],
                "numbers": out["numbers"], "control": out.get("control")}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    for name in lines[0]["numbers"]:
        lower = max(line["numbers"][name] for line in lines)
        ctrl = [line["control"][name] for line in lines if line["control"] and name in line["control"]]
        upper = min(ctrl) if ctrl else float("nan")
        print(f"{name}: lower {lower!r} upper {upper!r} ratio {upper / lower if lower else float('inf'):.3g}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
