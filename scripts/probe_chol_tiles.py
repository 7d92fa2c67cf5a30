"""Time K6's trailing update on the card panel by panel at each tile size,
the data ``cuda_chol.trail_tile``'s rule was chosen from.

    python3 scripts/probe_chol_tiles.py [--out chiprun_out/probe_chol_tiles.json]

(a) For m = 1,936 and 4,096, Bd = 1 and 2, and each tile T of 32, 64 and
    128: K6 on a seeded SPD batch with every panel's trailing update forced
    onto T, look-ahead off; torch.profiler's duration of each trailing
    launch, the mean over the last REPS calls of a window, by the panel's
    trailing width n, with programmatic dependent launch off (so that a
    duration holds no wait for the kernel before); the factor's and the
    solve's beside them. Printed: each n's times and the fastest T.
(b) The device span of one call (``chip_smoke.device_span_ms``) on the
    rule's plan with look-ahead on and off, on the plan that takes each
    panel's fastest T from (a), and with every panel at 32 (the parent's
    kernels), beside ``torch.linalg.cholesky``'s span.
(c) For each T, the least-squares fit of (a)'s launch times to
    a + b cdiv(blocks, SMs) microseconds: ``cuda_chol.TRAIL_COST_US``.

Every call is also held bit for bit against the all-32 plan's factor.
"""

import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from online_gp_torch.ops import _build, cuda_chol  # noqa: E402
from online_gp_torch.ops.cuda_chol import CholPlan, PanelPlan, lower_tiles  # noqa: E402
from online_gp_torch.ops.precision import f32_matmul_precision  # noqa: E402

REPS = 5
TILES = (32, 64, 128)


def forced_plan(m, Bd, tiles, lookahead=False):
    """A plan with panel p's update on tiles[p] (the next block on 64, or 32
    where the rest is on 32, under look-ahead)."""
    panels = []
    for p, tile in enumerate(tiles):
        lo = p * 128
        n = m - lo - 128
        if not lookahead:
            panels.append(PanelPlan(lo, n, tile, lower_tiles(n, tile)))
            continue
        side = max(-(-n // tile) - 128 // tile, 0)
        nxt = min(tile, 64)
        panels.append(PanelPlan(lo, n, tile, side * (side + 1) // 2, nxt, -(-n // nxt) * (128 // nxt)))
    return CholPlan(m, Bd, lookahead, tuple(panels))


def factor(q, plan):
    out, info = torch.empty_like(q), torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    cuda_chol._launch(q, out, info, plan)
    return out


def panel_times(q, plan):
    """{stage: mean ms of each panel's launch} of the factor, the solve and
    the trailing update (look-ahead off: one a panel), each kernel's own
    duration: programmatic dependent launch off, so that no kernel's time
    holds its wait for the one before."""
    stages = {"factor": ("chol_factor_kernel",), "solve": ("chol_solve_kernel",),
              "trail": tuple(cuda_chol.TRAIL_KERNELS.values())}
    npan = len(plan.panels)
    cuda_chol.PROGRAMMATIC_LAUNCH = False
    try:
        factor(q, plan)
        torch.cuda.synchronize()
        for _ in range(cs.PROFILE_ATTEMPTS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(cs.PROFILE_PAD_S)
                for _ in range(REPS + cs.PROFILE_EXTRA_CALLS):
                    torch.cuda._sleep(cs.SPIN_CYCLES)
                    factor(q, plan)
                    torch.cuda.synchronize()
            out = {}
            for stage, names in stages.items():
                ev = sorted((e.time_range.start, e.time_range.end - e.time_range.start) for e in prof.events()
                            if e.device_type == DeviceType.CUDA and any(f"::{k}(" in e.name for k in names))
                per_call = npan + (stage == "factor")
                if len(ev) < REPS * per_call:
                    break
                ev = ev[-REPS * per_call:]
                out[stage] = [sum(ev[c * per_call + p][1] for c in range(REPS)) / REPS / 1e3 for p in range(npan)]
            else:
                return out
    finally:
        cuda_chol.PROGRAMMATIC_LAUNCH = True
    raise AssertionError("no profile recorded every launch")


def main() -> int:
    out_path = Path(sys.argv[sys.argv.index("--out") + 1]) if "--out" in sys.argv else None
    dev = torch.device("cuda", 0)
    sms = _build.card_sms(dev)
    res = dict(card=torch.cuda.get_device_name(0), sms=sms, per_panel={}, spans={})
    with f32_matmul_precision():
        _build.build_all()
        g = torch.Generator().manual_seed(3)
        for m in (1936, 4096):
            for Bd in (1, 2):
                a = torch.randn((Bd, m, m), generator=g).to(dev)
                q = (a @ a.mT / m + torch.eye(m, device=dev)).contiguous()
                npan = -(-m // 128) - 1
                ref = factor(q, forced_plan(m, Bd, [32] * npan))
                times, chain = {}, None
                for T in TILES:
                    plan = forced_plan(m, Bd, [T] * npan)
                    if not torch.equal(factor(q, plan), ref):
                        raise AssertionError(f"T = {T} at (Bd, m) = ({Bd}, {m}) is not the 32 x 32 plan's bits")
                    stages = panel_times(q, plan)
                    times[T], chain = stages["trail"], chain or stages
                ns = [m - 128 * (p + 1) for p in range(npan)]
                best = [min(TILES, key=lambda T: times[T][p]) for p in range(npan)]
                rule = [pp.tile for pp in cuda_chol.cholesky_plan(m, Bd, sms).panels]
                key = f"bd{Bd}_m{m}"
                res["per_panel"][key] = [dict(n=n, ms={T: times[T][p] for T in TILES}, best=best[p], rule=rule[p],
                                              factor_ms=chain["factor"][p], solve_ms=chain["solve"][p])
                                         for p, n in enumerate(ns)]
                for p, n in enumerate(ns):
                    print(f"{key} n={n}: " + " ".join(f"T{T} {times[T][p]:.4f}" for T in TILES)
                          + f" best {best[p]} rule {rule[p]}; factor {chain['factor'][p]:.4f} solve "
                          f"{chain['solve'][p]:.4f}", flush=True)
                spans = {}
                arms = [("rule", cuda_chol.cholesky_plan(m, Bd, sms, True)),
                        ("rule_lookahead_off", cuda_chol.cholesky_plan(m, Bd, sms, False)),
                        ("best", forced_plan(m, Bd, best, True)), ("best_lookahead_off", forced_plan(m, Bd, best)),
                        ("all32", forced_plan(m, Bd, [32] * npan))]
                for name, plan in arms:
                    if not torch.equal(factor(q, plan), ref):
                        raise AssertionError(f"plan {name} at (Bd, m) = ({Bd}, {m}) is not the 32 x 32 plan's bits")
                    spans[name] = cs.device_span_ms(lambda: factor(q, plan), lambda: ())[0]
                spans["library"] = cs.device_span_ms(lambda: torch.linalg.cholesky(q), lambda: ())[0]
                res["spans"][key] = spans
                print(f"{key} spans: {json.dumps(spans)}", flush=True)
    res["cost_fit_us"] = fit_costs(res["per_panel"], sms)
    print(f"fitted (a, b) of a + b cdiv(blocks, SMs), microseconds: {json.dumps(res['cost_fit_us'])} "
          f"(cuda_chol.TRAIL_COST_US: {json.dumps(cuda_chol.TRAIL_COST_US)})")
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(res, indent=1))
    print(json.dumps(res["spans"]))
    return 0


def fit_costs(per_panel, sms):
    """Least-squares (a, b) of a launch's microseconds = a + b w at each
    tile, w = cdiv(blocks, sms), over every panel of (a)."""
    out = {}
    for T in TILES:
        xs, ys = [], []
        for key, rows in per_panel.items():
            Bd = int(key.split("_")[0][2:])
            for row in rows:
                xs.append(-(-Bd * lower_tiles(row["n"], T) // sms))
                ys.append(1e3 * row["ms"][T])
        X = torch.tensor([[1.0, x] for x in xs], dtype=torch.float64)
        coef = torch.linalg.lstsq(X, torch.tensor(ys, dtype=torch.float64)[:, None]).solution[:, 0]
        out[T] = [round(float(coef[0]), 2), round(float(coef[1]), 2)]
    return out


if __name__ == "__main__":
    sys.exit(main())
