"""Time the strict absorb and the prequential stream of two checkouts of the
port on the card, in pairs, as ``chip_smoke.py``'s phase 3 runs them:
bench.py's width (30 x 30 grid, m = 900, one output), a WISKI state seeded
with 256 points, then ``wiski_stream`` of 16,384 points in chunks of 128
(updates/s) and, from the state it leaves, ``wiski_prequential_stream`` of
4,096 points (points/s). Both streams end every chunk in K1's apply, the
prequential stream also in K3's.

    python3 scripts/compare_stream_rates.py OTHER_CHECKOUT [--pairs N] [--reps R]

Each checkout runs in a process of its own, with its own ``build/``. A
pair is one process of each, the other checkout first in even pairs and
this one first in odd ones (default N = 10 pairs). A process builds the
kernels, runs one warm-up of each stream, then R timed runs (default 3)
from the same start (the roots cloned, the prediction caches rebuilt,
outside the timed span), and prints one JSON line with each run's rate
and their median. Last, for each stream: both checkouts' medians over the
pairs, this one's change, the pairs it wins, the other's interquartile
spread, and whether that is a gain (wins in at least nine tenths of the
pairs, medians apart by more than the spread).
"""

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json
import sys
import time
import numpy as np
import torch
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models.wiski import (
    WiskiModel,
    wiski_init,
    wiski_prediction_caches,
    wiski_prequential_stream,
    wiski_slim,
    wiski_stream,
)
from online_gp_torch.ops import _build
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import RootCache

tag, reps = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
with f32_matmul_precision():
    _build.build_all()
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    grid = Grid.create([(-1.1, 1.1)] * 2, 30, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(2)

    def points(n):
        x = torch.tensor(rng.uniform(-1, 1, (n, 2)), **f32)
        y = torch.sin(3 * x[:, :1])
        return x, y, torch.ones_like(y)

    x0, y0, n0 = points(256)
    start = wiski_slim(wiski_init(model, x0, y0, n0))
    xs, ys, ns = points(16384)
    xp, yp, npr = points(4096)
    fresh = lambda st: st._replace(roots=RootCache(None, st.roots.root.clone(), st.roots.inv_root.clone()))
    absorb, preq = [], []
    for rep in range(1 + reps):  # the first of each is a warm-up
        state = fresh(start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = wiski_stream(model, state, xs, ys, ns, block_size=128)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        caches = wiski_prediction_caches(model, params, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wiski_prequential_stream(model, params, state, caches, xp, yp, npr, block_size=128)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if rep:
            absorb.append(16384 / (t1 - t0))
            preq.append(4096 / (t3 - t2))
    print(json.dumps(dict(run=tag, absorb_updates_per_s=absorb, prequential_points_per_s=preq,
                          absorb_median=float(np.median(absorb)), prequential_median=float(np.median(preq)))),
          flush=True)
'''


def run(tag: str, root: Path, reps: int) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, tag, str(reps)], cwd=root, check=True, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(root)))
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def main() -> int:
    other, this = Path(sys.argv[1]).resolve(), Path(__file__).resolve().parents[1]
    arg = lambda name, default: int(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv else default
    pairs, reps = arg("--pairs", 10), arg("--reps", 3)
    runs = []
    for i in range(pairs):
        order = [("other", other), ("this", this)]
        runs.append({tag: run(tag, root, reps) for tag, root in (order if i % 2 == 0 else order[::-1])})
    summary = {}
    for key in ("absorb_median", "prequential_median"):
        o, t = [r["other"][key] for r in runs], [r["this"][key] for r in runs]
        q1, _, q3 = statistics.quantiles(o, n=4)
        med_o, med_t = statistics.median(o), statistics.median(t)
        wins = sum(b > a for a, b in zip(o, t))
        summary[key] = dict(other=med_o, this=med_t, change=med_t / med_o - 1, wins=wins, pairs=pairs,
                            other_spread=q3 - q1, gain=wins >= 0.9 * pairs and med_t - med_o > q3 - q1)
    print(json.dumps(dict(summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
