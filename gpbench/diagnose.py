"""Two faults of the program that keep cells out of the benchmark, shown
against the plain reference (float64), one JSON line a run:

    python3 -m gpbench.diagnose refresh --grid 64 --seeds 31 34 --points 65536 --repeat 2 \\
        [--long 1048576]
    python3 -m gpbench.diagnose prequential --grid 64 --seeds 21 22 --max-points 1048576 --repeat 2

``refresh``: absorb ``--points`` stream points in calls of 128 (the refresh
mix's step), then ``predict()`` 4,096 fixed queries, which rebuilds the
exact caches in float32. It reads, in units of the reference's predictive
sd (relative for variances and caches):

  mean, var, cache_mean  the program's predictions and mean cache
  state_mean             the program's own root and W y through the
                         reference's float64 algebra (the state, not the
                         cache build)
  f64_mean               the program's functional core run in float64 on its
                         own state cast up (another path of the program)
  zero_mean              what a prediction of all zeros would read
  stale_mean, stale_var  what the reference one absorb call (128 points)
                         earlier would read: a skipped rebuild

With ``--long``, it absorbs on in calls of 4,096 to that many points and
reads ``predict()`` again (``long_*``).

``prequential``: ``prequential()`` calls of 1,024 points from the caches
built on the seed points; every 16 calls it reads the least diagonal entry
of the covariance cache that K3 downdates in place. It stops at a NaN or at
``--max-points``, then rebuilds the caches from the roots and predicts.

The same data, hyperparameters and grid as the cells'
(``traffic/absorb-4096.json``'s stream, ``configs/wiski-grid30.json`` at
``--grid``).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch
from torch.utils._pytree import tree_map

from gpbench import check, spec
from gpbench import reference as R
from gpbench.traffic import draw_hypers, make_inputs, sync


def setup(grid: int, seed: int, pool: int, device):
    config = copy.deepcopy(spec.load_json(spec.HERE / "configs" / "wiski-grid30.json"))
    config["wrapper"]["grid_size"] = grid
    mix = copy.deepcopy(spec.load_json(spec.HERE / "traffic" / "absorb-4096.json"))
    mix.update(pool_points=pool, queries=4096)
    inputs = make_inputs(mix, config["input_dim"], seed, device)
    hypers = draw_hypers(config, seed)
    system = spec.wrapper(config)
    if torch.device(device).type == "cuda":
        system.build()
    reg = system.make(config, hypers, inputs.seed_x, inputs.seed_y, device)
    return config, inputs, hypers, reg


def ref_moments(ref: check.Replay, inputs):
    post = R.posterior(ref.K, ref.root()[0], ref.data.wty[0])
    return post, R.predict(ref.grid, post, ref.t(inputs.queries), ref.hypers.noise)


def core_f64(reg, queries):
    """The program's functional core in float64 on its own state."""
    from online_gp_torch.models.wiski import wiski_predict, wiski_prediction_caches

    up = lambda t: t.double() if torch.is_tensor(t) and t.dtype == torch.float32 else t  # noqa: E731
    state, params = tree_map(up, reg.state), tree_map(up, reg.params)
    cfg = reg.cfg.replace(detach_interp_coeff=True)
    with torch.no_grad():
        caches = wiski_prediction_caches(reg.model, params, state, cfg)
        mean, var = wiski_predict(reg.model, params, state, queries.double(), cfg, caches=caches)
    return mean[0], var[0] + reg.noise[0].double()


def refresh(args, seed: int, device) -> dict:
    pool = max(args.points, args.long or 0)
    config, inputs, hypers, reg = setup(args.grid, seed, pool, device)
    q = inputs.queries_dev
    for s in range(0, args.points, 128):
        reg.absorb(inputs.pool_x[s:s + 128], inputs.pool_y[s:s + 128])
    mean, var = reg.predict(q)
    sync(device)
    out = {"mode": "refresh", "grid": args.grid, "seed": seed, "hypers": hypers._asdict(), "points": args.points}
    with torch.no_grad(), R.precision(False):
        ref = check.Replay(config, hypers, inputs, device, control=False)
        ref.absorb(inputs.pool_x[:args.points - 128], inputs.pool_y[:args.points - 128])
        _, (sm, sv) = ref_moments(ref, inputs)
        ref.absorb(inputs.pool_x[args.points - 128:args.points], inputs.pool_y[args.points - 128:args.points])
        post, (rm, rv) = ref_moments(ref, inputs)
        L, wty = reg.state.roots.root[0].double(), reg.state.wty[0, :, 0].double()
        own = R.predict(ref.grid, R.posterior(ref.K, L, wty), ref.t(inputs.queries), hypers.noise)
        out["mean"], out["var"] = check.moments(mean[:, 0], var[:, 0], rm, rv)
        out["cache_mean"] = check._rel(reg._pred_caches[0][0, :, 0], post.mean)
        out["state_mean"], out["state_var"] = check.moments(*own, rm, rv)
        out["f64_mean"], out["f64_var"] = check.moments(*core_f64(reg, q), rm, rv)
        out["zero_mean"] = check.moments(torch.zeros_like(rm), rv, rm, rv)[0]
        out["stale_mean"], out["stale_var"] = check.moments(sm, sv, rm, rv)
        out["sd_min"], out["sd_max"] = float(rv.min().sqrt()), float(rv.max().sqrt())
        if args.long:
            for s in range(args.points, args.long, 4096):
                reg.absorb(inputs.pool_x[s:s + 4096], inputs.pool_y[s:s + 4096])
            lm, lv = reg.predict(q)
            ref.absorb(inputs.pool_x[args.points:args.long], inputs.pool_y[args.points:args.long])
            _, (rm, rv) = ref_moments(ref, inputs)
            out["long_points"] = args.long
            out["long_finite"] = bool(torch.isfinite(lm).all() and torch.isfinite(lv).all())
            out["long_mean"], out["long_var"] = check.moments(lm[:, 0], lv[:, 0], rm, rv)
            out["long_zero_mean"] = check.moments(torch.zeros_like(rm), rv, rm, rv)[0]
    return out


def prequential(args, seed: int, device) -> dict:
    config, inputs, hypers, reg = setup(args.grid, seed, args.max_points, device)
    out = {"mode": "prequential", "grid": args.grid, "seed": seed, "hypers": hypers._asdict(),
           "first_negative": None, "first_nan": None, "least_diag": []}
    n = 0
    while n + 1024 <= args.max_points:
        reg.prequential(inputs.pool_x[n:n + 1024], inputs.pool_y[n:n + 1024])
        n += 1024
        if n % (16 * 1024) == 0 or n + 1024 > args.max_points:
            least = float(torch.diagonal(reg._pred_caches[1][0]).min())
            out["least_diag"].append([n, least])
            if least < 0 and out["first_negative"] is None:
                out["first_negative"] = n
            if least != least:
                out["first_nan"] = n
                break
    out["points"] = n
    with torch.no_grad(), R.precision(False):
        ref = check.Replay(config, hypers, inputs, device, control=False)
        ref.absorb(inputs.pool_x[:n], inputs.pool_y[:n])
        post, (rm, rv) = ref_moments(ref, inputs)
        out["ref_least_diag"] = float(torch.diagonal(post.cov).min())
        reg._pred_caches = None  # a rebuild from the roots
        mean, var = reg.predict(inputs.queries_dev)
        out["rebuild_finite"] = bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
        out["rebuild_mean"], out["rebuild_var"] = check.moments(mean[:, 0], var[:, 0], rm, rv)
        out["zero_mean"] = check.moments(torch.zeros_like(rm), rv, rm, rv)[0]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpbench.diagnose")
    p.add_argument("mode", choices=("refresh", "prequential"))
    p.add_argument("--grid", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--points", type=int, default=65536)
    p.add_argument("--long", type=int, default=0)
    p.add_argument("--max-points", type=int, default=1 << 20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run = refresh if args.mode == "refresh" else prequential
    for seed in args.seeds:
        for r in range(args.repeat):
            t0 = time.perf_counter()
            out = run(args, seed, args.device)
            out.update(repeat=r, seconds=time.perf_counter() - t0)
            print(json.dumps(out), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
