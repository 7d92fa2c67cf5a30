"""Hold K1's and K3's recursions of two checkouts of the port against each
other on the card, and time them in turns.

    python3 scripts/compare_recursion_builds.py OTHER_CHECKOUT [--time] [--pairs N]

(a) Each checkout, in a process of its own with its own ``build/``, runs
    the same inputs (made from one seed in each process: random roots,
    covariance and mean caches, stencils over [0, m) of 16 points a row,
    k = 128, Bd = 1 and 2) through ``blocked_chunk`` and ``chunk_factors``
    (K1), ``blocked_chunk(sub=32)`` (K5 sub) and ``pred_chunk`` and
    ``pred_factors`` (K3) at m = 256, 900, 1,120, 2,500, 3,136, 4,096,
    6,016 and 9,000 (K1 spread over the card). Each K1 call records
    whether its recursion ran by the carried kernel (``cluster_launches``
    less ``grid_cluster_launches``), each K5 sub call whether it ran its
    fused kernel (``sub_cluster_launches``). Where both checkouts take the
    same route (K1 wherever neither or both run the carried kernel, K5 sub
    on its fused kernel, and K3 on one cluster of 8 or 16, m <= 6,016, at
    k = 128) they must agree bit for bit; where one runs the carried kernel
    and the other does not, and K5 sub one sub-block at a time (whose
    one-cluster sub-blocks a checkout with K1's two-exchange one-cluster
    kernel runs there), within 1e-5 of the output's scale (its largest
    entry, at least 1); exit 1 otherwise. Elsewhere the largest difference
    is printed.
(b) With ``--time``, N pairs (default 1) of processes, each pair run as
    other, this, this, other: the device ms (``chip_smoke.device_ms`` of
    that checkout, torch.profiler, over every kernel the call launches but
    the copies that make its inputs) of ``blocked_chunk``, ``pred_chunk``,
    ``chunk_factors`` and ``pred_factors`` at m = 4,096, Bd = 1, with each
    kernel's share (the recursion's among them); then phase 6's dense
    wrapper, ``OnlineSKIRegression(LinearStem(2, 2), grid_size=64)``
    seeded with 256 points of sin(3 x0): ``prequential`` of 512 points and
    ``absorb`` of 1,024, host clock around synchronised work, three fresh
    wrappers after a warm-up, the median. One JSON line a process, then
    each number's medians over the two checkouts' processes.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

INPUTS = r'''
import torch


def inputs(m, Bd, dev, k=128):
    """The same inputs in every process: seeded on the CPU, moved to dev."""
    g = torch.Generator().manual_seed(1000 * m + Bd)
    L = torch.randn((Bd, m, m), generator=g) / m**0.5 + torch.eye(m)
    B = torch.randn((Bd, m, m), generator=g) / m**0.5 + torch.eye(m)
    idx = torch.randint(0, m, (k, 16), generator=g, dtype=torch.int32)
    w = torch.rand((k, 16), generator=g)
    w = w / w.sum(1, keepdim=True)
    wv = w[None] * torch.tensor([1.0, 1.3][:Bd])[:, None, None]
    G = torch.randn((Bd, m, 64), generator=g)
    mu = torch.randn((Bd, m), generator=g)
    y = torch.randn((Bd, k), generator=g)
    t = lambda x: x.to(dev).contiguous()
    G = t(G)
    C = (G @ G.mT / 64 + 0.1 * torch.eye(m, device=dev)).contiguous()
    return dict(L=t(L), B=t(B), idx=t(idx), w=t(w), wv=t(wv), C=C, mu=t(mu), y=t(y), nz=torch.ones((Bd, k), device=dev))
'''

RUN = INPUTS + r'''
import sys
from online_gp_torch.ops import _build
from online_gp_torch.ops.cuda_pred_stream import pred_chunk, pred_factors
from online_gp_torch.ops.cuda_root_update import blocked_chunk, chunk_factors
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import stencil_rows

dev = torch.device("cuda", 0)
out = {}
with f32_matmul_precision():
    _build.build_all()
    carried = lambda: tuple(f.cluster_launches - f.grid_cluster_launches for f in (blocked_chunk, chunk_factors))
    routes = {}
    for m in (256, 900, 1120, 2500, 3136, 4096, 6016, 9000):
        for Bd in (1, 2):
            a = inputs(m, Bd, dev)
            tag = f"m{m}_bd{Bd}"
            before = carried()
            out[f"k1_root_{tag}"], out[f"k1_inv_root_{tag}"] = blocked_chunk(a["L"].clone(), a["B"].clone(), a["idx"],
                                                                               a["wv"])
            p0 = torch.einsum("bkp,bkpm->bkm", a["wv"], a["B"][:, a["idx"].long()]).contiguous()
            for name, f in zip("UPR", chunk_factors(p0)):
                out[f"k1_factors_{name}_{tag}"] = f
            ran = [x - y for x, y in zip(carried(), before)]
            for key in (f"k1_root_{tag}", f"k1_inv_root_{tag}"):
                routes[key] = "carried" if ran[0] else "other"
            for name in "UPR":
                routes[f"k1_factors_{name}_{tag}"] = "carried" if ran[1] else "other"
            fused = blocked_chunk.sub_cluster_launches
            out[f"k5sub_root_{tag}"], out[f"k5sub_inv_root_{tag}"] = blocked_chunk(a["L"].clone(), a["B"].clone(),
                                                                                     a["idx"], a["wv"], sub=32)
            for key in (f"k5sub_root_{tag}", f"k5sub_inv_root_{tag}"):
                routes[key] = "fused" if blocked_chunk.sub_cluster_launches > fused else "per sub-block"
            C, mu, pm, pv = pred_chunk(a["C"].clone(), a["mu"].clone(), a["idx"], a["w"], a["y"], a["nz"])
            out[f"k3_cov_{tag}"], out[f"k3_mean_{tag}"], out[f"k3_pm_{tag}"], out[f"k3_pv_{tag}"] = C, mu, pm, pv
            S = stencil_rows(a["idx"], a["w"], m)
            for name, f in zip(("Z", "r", "pm", "pv"), pred_factors(a["idx"], a["w"], (S @ a["C"]).contiguous(),
                                                                  (a["mu"] @ S.mT).contiguous(), a["y"], a["nz"])):
                out[f"k3_factors_{name}_{tag}"] = f
    torch.cuda.synchronize()
    torch.save(dict(out={key: v.cpu() for key, v in out.items()}, routes=routes), sys.argv[1])
'''

TIME = INPUTS + r'''
import json
import re
import sys
import time
import warnings
import numpy as np
import chip_smoke as cs
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from online_gp_torch.api import LinearStem, OnlineSKIRegression
from online_gp_torch.ops import _build
from online_gp_torch.ops.cuda_pred_stream import pred_chunk, pred_factors
from online_gp_torch.ops.cuda_root_update import blocked_chunk, chunk_factors
from online_gp_torch.ops.precision import f32_matmul_precision
from online_gp_torch.ops.root_update import stencil_rows


def kernels_of(fn, make, calls=4):
    """{kernel: 1} for the port's kernels that fn(*make()) launches (each
    once a call at Bd = 1), seen in a window of a few calls opened
    cs.PROFILE_PAD_S before them (torch.profiler may lose a window's first
    records); PyTorch's own kernels, the copies make launches, aside."""
    args = [make() for _ in range(calls)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(cs.PROFILE_PAD_S)
        for a in args:
            fn(*a)
        torch.cuda.synchronize()
    names = {hit.group(1): 1 for e in prof.events() if e.device_type == DeviceType.CUDA
             and "_kernel(" in e.name and "at::" not in e.name and (hit := re.search(r"::(\w+)\(", e.name))}
    if not names:
        raise AssertionError(f"no kernel of {fn.__name__} recorded in {calls} calls")
    return names


tag = sys.argv[1]
dev = torch.device("cuda", 0)
res = dict(run=tag)
with f32_matmul_precision():
    _build.build_all()
    m = 4096
    a = inputs(m, 1, dev)
    p0 = torch.einsum("bkp,bkpm->bkm", a["wv"], a["B"][:, a["idx"].long()]).contiguous()
    S = stencil_rows(a["idx"], a["w"], m)
    c0w, mu0w = (S @ a["C"]).contiguous(), (a["mu"] @ S.mT).contiguous()
    calls = {
        "blocked_chunk": (blocked_chunk, lambda: (a["L"].clone(), a["B"].clone(), a["idx"], a["wv"])),
        "pred_chunk": (pred_chunk, lambda: (a["C"].clone(), a["mu"].clone(), a["idx"], a["w"], a["y"], a["nz"])),
        "chunk_factors": (chunk_factors, lambda: (p0,)),
        "pred_factors": (pred_factors, lambda: (a["idx"], a["w"], c0w, mu0w, a["y"], a["nz"])),
    }
    for name, (fn, make) in calls.items():
        ms, stages = cs.device_ms(fn, make, kernels_of(fn, make))
        res[f"{name}_ms"], res[f"{name}_stages_ms"] = ms, stages

    rng = np.random.default_rng(0)

    def points(n):
        x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        return x, np.sin(3 * x[:, :1])

    x0, y0 = points(256)
    xp, yp = points(512)
    xa, ya = points(1024)
    preq, absorb = [], []
    for rep in range(4):  # the first is a warm-up
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reg = OnlineSKIRegression(LinearStem(2, 2), x0, y0, lr=1e-2, grid_size=64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg.prequential(xp, yp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reg.absorb(xa, ya)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if rep:
            preq.append(1e3 * (t1 - t0))
            absorb.append(1e3 * (t2 - t1))
    res.update(prequential_ms=float(np.median(preq)), prequential_runs_ms=preq, absorb_ms=float(np.median(absorb)),
               absorb_runs_ms=absorb)
print(json.dumps(res), flush=True)
'''


def run(root: Path, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", RUN, str(out)], cwd=root, env=env, check=True)
    return torch.load(out)


def held(key: str, routes_a: dict, routes_b: dict) -> str:
    """What a result is held to: "bitwise" where both checkouts take the
    same route (K1 unless one of them ran the carried kernel, K5 sub on its
    fused kernel, K3 on one cluster), "1e-5" where only one ran the carried
    kernel and for K5 sub one sub-block at a time, "" (none) elsewhere."""
    if key.startswith("k3"):
        return "bitwise" if int(key.split("_m")[-1].split("_")[0]) <= 6016 else ""
    if key.startswith("k5sub"):
        return "bitwise" if routes_a[key] == routes_b[key] == "fused" else "1e-5"
    return "bitwise" if routes_a.get(key, "other") == routes_b.get(key, "other") else "1e-5"


def main() -> int:
    other, this = Path(sys.argv[1]).resolve(), Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as tmp:
        ra, rb = run(other, Path(tmp) / "other.pt"), run(this, Path(tmp) / "this.pt")
    a, b = ra["out"], rb["out"]
    tally = {"bitwise": [0, 0], "1e-5": [0, 0]}
    differ = []
    for k in b:
        d = float((a[k] - b[k]).abs().max())
        scale = max(float(a[k].abs().max()), 1.0)
        rule = held(k, ra["routes"], rb["routes"])
        ok = torch.equal(a[k], b[k]) if rule == "bitwise" else (d <= 1e-5 * scale if rule else True)
        if rule:
            tally[rule][0] += ok
            tally[rule][1] += 1
        if not ok:
            differ.append(k)
        same = "bitwise equal" if torch.equal(a[k], b[k]) else ("DIFFERS" if not ok else "differs")
        print(f"{k}: {same} (held {rule or 'to nothing'}), max |d| {d:.3e} ({d / scale:.3e} of the scale)")
    print(json.dumps({f"{rule} held": dict(ok=n, of=of) for rule, (n, of) in tally.items()}))
    if "--time" in sys.argv[2:]:
        pairs = int(sys.argv[sys.argv.index("--pairs") + 1]) if "--pairs" in sys.argv else 1
        runs = {"other": [], "this": []}
        for _ in range(pairs):
            for tag, root in (("other", other), ("this", this), ("this", this), ("other", other)):
                out = subprocess.run([sys.executable, "-c", TIME, tag], cwd=root, check=True, capture_output=True,
                                     text=True, env=dict(os.environ, PYTHONPATH=str(root)))
                line = out.stdout.strip().splitlines()[-1]
                print(line, flush=True)
                runs[tag].append(json.loads(line))
        keys = [k for k, v in runs["this"][0].items() if isinstance(v, float)]
        print(json.dumps({"medians": {k: {tag: statistics.median(r[k] for r in runs[tag]) for tag in runs}
                                      for k in keys}}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
