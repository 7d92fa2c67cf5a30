"""Hold K6 (``blocked_cholesky``) of two checkouts of the port against each
other on the card, and time them in turns.

    python3 scripts/compare_chol_builds.py OTHER_CHECKOUT [--time] [--pairs N]

(a) One process of this checkout makes the inputs: SPD matrices
    a a^T / m + I (a from a seeded generator) at m = 130, 256, 900, 1,000,
    1,936, 2,048, 2,049, 4,096 and 4,097, Bd = 1 and 2, a (2, 2, 900, 900)
    batch, and Q = I + L^T K_uu L of two WISKI states built as
    ``chip_smoke.py`` builds phase 3's (30 x 30 grid, m = 900, 256 seed
    points and 64 conditions) and phase 6's (64 x 64 grid, m = 4,096, 1,024
    seed points). Each checkout, in a process of its own with its own
    ``build/``, factors every input with ``blocked_cholesky_ex``, and this
    checkout twice more: with look-ahead at every shape
    (``cuda_chol.LOOKAHEAD_MIN_BD_M = 0``) and with none
    (``cuda_chol.LOOKAHEAD = False``). Every factor and flag of the three
    must be the other checkout's bit for bit (exit 1 otherwise).
(b) With ``--time``, N pairs (default 1) of processes, each pair run as
    other, this, this, other: the device span of ``blocked_cholesky_ex``
    (``chip_smoke.device_span_ms`` of that checkout, behind a spin kernel)
    at the paths' shapes, this checkout also with look-ahead off; and the
    trailing update's and the factor's and solve's summed kernel times
    with look-ahead and programmatic dependent launch off (each kernel's
    own duration). One JSON line a process, then each number's medians
    over the processes of each checkout.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

SHAPES = [(Bd, m) for m in (130, 256, 900, 1000, 1936, 2048, 2049, 4096, 4097) for Bd in (1, 2)]

MAKE = r'''
import sys
import numpy as np
import torch
import chip_smoke as cs
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models.wiski import WiskiModel, wiski_condition, wiski_init
from online_gp_torch.ops import _build
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.precision import f32_matmul_precision

SHAPES = %r
dev = torch.device("cuda", 0)
out = {}
with f32_matmul_precision():
    _build.build_all()
    g = torch.Generator().manual_seed(17)
    for Bd, m in SHAPES + [((2, 2), 900)]:
        shape = Bd if isinstance(Bd, tuple) else (Bd,)
        a = torch.randn(shape + (m, m), generator=g, dtype=torch.float64)
        q = (a @ a.mT / m + torch.eye(m, dtype=torch.float64)).float()
        out["spd_" + "x".join(map(str, shape)) + f"_m{m}"] = q
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    for tag, side, seeds, conds in (("phase3", 30, 256, 64), ("phase6", 64, 1024, 0)):
        grid = Grid.create([(-1.1, 1.1)] * 2, side, device=dev)
        model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
        params = model.init_params(2)
        x0 = torch.tensor(rng.uniform(-1, 1, (seeds, 2)), **f32)
        state = wiski_init(model, x0, torch.sin(3 * x0[:, :1]), torch.ones((seeds, 1), **f32))
        xc = torch.tensor(rng.uniform(-1, 1, (max(conds, 1), 2)), **f32)
        for i in range(conds):
            state = wiski_condition(model, state, xc[i : i + 1], torch.sin(3 * xc[i : i + 1, :1]),
                                    torch.ones((1, 1), **f32))
        out[f"q_{tag}_m{side * side}"] = cs.q_matrix(model, params, state).cpu()
torch.save(out, sys.argv[1])
'''

RUN = r'''
import sys
import torch
from online_gp_torch.ops import _build, cuda_chol
from online_gp_torch.ops.precision import f32_matmul_precision

dev = torch.device("cuda", 0)
inputs = torch.load(sys.argv[1])
arm = sys.argv[3]
out = {}
with f32_matmul_precision():
    _build.build_all()
    if arm == "lookahead_on":  # at every shape
        cuda_chol.LOOKAHEAD, cuda_chol.LOOKAHEAD_MIN_BD_M = True, 0
    elif arm == "lookahead_off":
        cuda_chol.LOOKAHEAD = False
    for key, q in inputs.items():
        L, info = cuda_chol.blocked_cholesky_ex(q.to(dev).contiguous())
        out[key + "_L"], out[key + "_info"] = L, info
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[2])
'''

TIME = r'''
import json
import sys
import torch
import chip_smoke as cs
from online_gp_torch.ops import _build, cuda_chol
from online_gp_torch.ops.precision import f32_matmul_precision

TIMED = [(1, 256), (8, 256), (1, 900), (2, 900), (4, 900), (1, 1000), (1, 1936), (2, 1936), (1, 4096), (2, 4096)]


def stage_kernels(Bd, m):
    """{CUDA kernel: launches a call}: the plan's where the checkout has
    one, else one 32 x 32 trailing update a panel."""
    if hasattr(cuda_chol, "cholesky_plan"):
        return cuda_chol.stage_launches(cuda_chol.cholesky_plan(m, Bd, _build.card_sms(dev)))
    nb = -(-m // 128)
    return {"chol_init_kernel": 1, "chol_factor_kernel": nb, "chol_solve_kernel": nb - 1, "chol_syrk_kernel": nb - 1}


tag = sys.argv[1]
dev = torch.device("cuda", 0)
res = dict(run=tag)
with f32_matmul_precision():
    _build.build_all()
    g = torch.Generator().manual_seed(5)
    arms = [("", None)] + ([("lookahead_off_", False)] if tag == "this" else [])
    for Bd, m in TIMED:
        a = torch.randn((Bd, m, m), generator=g).to(dev)
        q = (a @ a.mT / m + torch.eye(m, device=dev)).contiguous()
        for key, la in arms:
            if la is not None:
                cuda_chol.LOOKAHEAD = la
            try:
                res[f"{key}bd{Bd}_m{m}_ms"] = cs.device_span_ms(cuda_chol.blocked_cholesky_ex, lambda: (q,),
                                                                stage_kernels(Bd, m))[0]
            finally:
                if la is not None:
                    cuda_chol.LOOKAHEAD = True
        # the stages alone: no look-ahead, no programmatic dependent launch
        cuda_chol.PROGRAMMATIC_LAUNCH, cuda_chol.LOOKAHEAD = False, False
        try:
            stages = cs.device_span_ms(cuda_chol.blocked_cholesky_ex, lambda: (q,), stage_kernels(Bd, m))[1]
        finally:
            cuda_chol.PROGRAMMATIC_LAUNCH, cuda_chol.LOOKAHEAD = True, True
        trail = [k for k in stages if k not in ("chol_init_kernel", "chol_factor_kernel", "chol_solve_kernel")]
        res[f"bd{Bd}_m{m}_trailing_ms"] = sum(stages[k] for k in trail)
        res[f"bd{Bd}_m{m}_factor_solve_ms"] = stages["chol_factor_kernel"] + stages["chol_solve_kernel"]
        res[f"library_bd{Bd}_m{m}_ms"] = cs.device_span_ms(lambda q: torch.linalg.cholesky(q), lambda: (q,))[0]
print(json.dumps(res), flush=True)
'''


def run(root: Path, script: str, *args: str, capture: bool = False):
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run([sys.executable, "-c", script, *args], cwd=root, env=env, check=True,
                          capture_output=capture, text=capture)


def main() -> int:
    other, this = Path(sys.argv[1]).resolve(), Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.pt"
        run(this, MAKE % (SHAPES,), str(inputs))
        outs = {}
        for tag, root in (("other", other), ("this", this), ("lookahead_on", this), ("lookahead_off", this)):
            run(root, RUN, str(inputs), str(Path(tmp) / f"{tag}.pt"), tag)
            outs[tag] = torch.load(Path(tmp) / f"{tag}.pt")
    a = outs["other"]
    differ = []
    arms = ("this", "lookahead_on", "lookahead_off")
    for tag in arms:
        for k in a:
            same = torch.equal(a[k], outs[tag][k])
            if not same:
                differ.append(f"{tag}:{k}")
            print(f"{tag} {k}: {'bitwise equal' if same else 'DIFFERS'}, max |d| "
                  f"{float((a[k].double() - outs[tag][k].double()).abs().max()):.3e}")
    print(json.dumps(dict(bitwise_equal=len(arms) * len(a) - len(differ), of=len(arms) * len(a), differ=differ)))
    if "--time" in sys.argv[2:]:
        pairs = int(sys.argv[sys.argv.index("--pairs") + 1]) if "--pairs" in sys.argv else 1
        runs = {"other": [], "this": []}
        for _ in range(pairs):
            for tag, root in (("other", other), ("this", this), ("this", this), ("other", other)):
                line = run(root, TIME, tag, capture=True).stdout.strip().splitlines()[-1]
                print(line, flush=True)
                runs[tag].append(json.loads(line))
        keys = sorted({k for r in runs["this"] + runs["other"] for k, v in r.items() if isinstance(v, float)})
        print(json.dumps({"medians": {k: {tag: statistics.median(r[k] for r in runs[tag]) for tag in runs
                                          if all(k in r for r in runs[tag])} for k in keys}}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
