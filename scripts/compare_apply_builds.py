"""Run the applies of two checkouts of the port on the same inputs on the
card and compare their results: K3 (``pred_chunk`` on a WISKI state's
prediction caches at bench.py's width, 30 x 30 grid, m = 900, Bd = 1 and 2,
four chunks of 128 in a row; ``pred_apply_rows`` on row shards at m = 900,
4,096 and 98, aligned and not) must agree bit for bit; K1
(``blocked_chunk`` on the same state's roots, four chunks, and
``chunk_apply_rows`` at m = 4,096) is compared and its largest difference
printed, since a design that sums in another order may differ by rounding.

    python3 scripts/compare_apply_builds.py OTHER_CHECKOUT
    python3 scripts/compare_apply_builds.py OTHER_CHECKOUT --time

Each checkout runs in a process of its own, with its own ``build/``. Exits
non-zero when a K3 result differs. With ``--time`` it then times both
checkouts' applies (``chunk_apply_rows``, ``pred_apply_rows``) at the
shapes of ``chip_smoke.py``'s phase 13, k = 128, in turns (other, this,
this, other): the device ms of each apply's CUDA kernels from
torch.profiler (``chip_smoke.device_ms`` of that checkout), one JSON line
a shape and run.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

RUN = r'''
import sys
import numpy as np
import torch
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.models.wiski import WiskiModel, wiski_init, wiski_prediction_caches
from online_gp_torch.ops import _build
from online_gp_torch.ops.cuda_pred_stream import pred_apply_rows, pred_chunk
from online_gp_torch.ops.cuda_root_update import blocked_chunk, chunk_apply_rows
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import interp_coeffs
from online_gp_torch.ops.precision import f32_matmul_precision

dev = torch.device("cuda", 0)
with f32_matmul_precision():
    _build.build_all()
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    grid = Grid.create([(-1.1, 1.1)] * 2, 30, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(2)
    x0 = torch.tensor(rng.uniform(-1, 1, (256, 2)), **f32)
    state = wiski_init(model, x0, torch.sin(3 * x0[:, :1]), torch.ones((256, 1), **f32))
    mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    xs = torch.tensor(rng.uniform(-1, 1, (512, 2)), **f32)
    idx, w = interp_coeffs(grid, xs)
    idx = idx.to(torch.int32).contiguous()
    out = {}
    for Bd in (1, 2):
        C = torch.cat([cov_cache, 0.9 * cov_cache])[:Bd].contiguous()
        mu = torch.cat([mean_cache[..., 0], -mean_cache[..., 0]])[:Bd].contiguous()
        L = torch.cat([state.roots.root, 1.1 * state.roots.root])[:Bd].contiguous()
        B = torch.cat([state.roots.inv_root, 0.9 * state.roots.inv_root])[:Bd].contiguous()
        y = torch.sin(3 * xs[:, :1]).T.expand(Bd, -1).contiguous()
        for c in range(4):
            sl = slice(128 * c, 128 * (c + 1))
            i, wc = idx[sl].contiguous(), w[sl].contiguous()
            C, mu, pm, pv = pred_chunk(C, mu, i, wc, y[:, sl].contiguous(), torch.ones((Bd, 128), **f32))
            out[f"k3_pred_mean_bd{Bd}_c{c}"], out[f"k3_pred_var_bd{Bd}_c{c}"] = pm.clone(), pv.clone()
            wv = (wc[None] * torch.tensor([1.0, 1.3][:Bd], **f32)[:, None, None]).contiguous()
            L, B = blocked_chunk(L, B, i, wv)
        out[f"k3_cov_bd{Bd}"], out[f"k3_mean_bd{Bd}"] = C, mu
        out[f"k1_root_bd{Bd}"], out[f"k1_inv_root_bd{Bd}"] = L, B
    for m, rows, row0 in ((900, 450, 450), (4096, 2048, 2048), (98, 49, 49), (900, 900, 0)):
        k = 128
        Cr = torch.tensor(rng.normal(size=(1, rows, m)), **f32)
        mur = torch.tensor(rng.normal(size=(1, rows)), **f32)
        Z = torch.tensor(rng.normal(size=(1, k, m)) / np.sqrt(k), **f32)
        r = torch.tensor(rng.normal(size=(1, k)), **f32)
        Cr, mur = pred_apply_rows(Cr, mur, Z, r, row0)
        out[f"k3_apply_rows_m{m}_r{row0}"], out[f"k3_apply_mu_m{m}_r{row0}"] = Cr, mur
    X = torch.tensor(rng.normal(size=(2, 2048, 4096)), **f32)
    F = [torch.tensor(rng.normal(size=(2, 128, 4096)) / np.sqrt(128 * 4096), **f32) for _ in range(3)]
    out["k1_apply_rows_m4096_L"], out["k1_apply_rows_m4096_B"] = chunk_apply_rows(X.clone(), X.clone(), *F)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[1])
'''


TIME = r'''
import json
import sys
import numpy as np
import torch
import chip_smoke as cs
from online_gp_torch.ops import _build
from online_gp_torch.ops import cuda_pred_stream as ps
from online_gp_torch.ops import cuda_root_update as ru
from online_gp_torch.ops.precision import f32_matmul_precision

tag = sys.argv[1]
new = hasattr(cs, "k1_apply_kernels")  # a checkout whose applies have kernels of their own
dev = torch.device("cuda", 0)
with f32_matmul_precision():
    _build.build_all()
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    k = 128
    for m in (256, 900, 4096):
        for rows in (m, m // 2):
            for Bd in (1, 2):
                L, B, C = (torch.tensor(rng.normal(size=(Bd, rows, m)), **f32) for _ in range(3))
                U, Pm, R = (torch.tensor(rng.normal(size=(Bd, k, m)) / np.sqrt(m * k), **f32) for _ in range(3))
                mu, r = torch.tensor(rng.normal(size=(Bd, rows)), **f32), torch.tensor(rng.normal(size=(Bd, k)), **f32)
                Z = torch.tensor(rng.normal(size=(Bd, k, m)) / np.sqrt(k), **f32)
                k1 = cs.k1_apply_kernels(k, rows, m) if new else {"chunk_apply_t_kernel": 1, "chunk_apply_x_kernel": 1}
                k3 = cs.k3_apply_kernels(Bd, rows, m) if new else {"pred_apply_kernel": 1}
                ms1, _ = cs.device_ms(ru.chunk_apply_rows, lambda: (L.clone(), B.clone(), U, Pm, R), k1)
                ms3, _ = cs.device_ms(ps.pred_apply_rows, lambda: (C.clone(), mu.clone(), Z, r, 0), k3)
                print(json.dumps(dict(run=tag, m=m, rows=rows, Bd=Bd, k=k, chunk_apply_ms=ms1, pred_apply_ms=ms3)),
                      flush=True)
'''


def run(root: Path, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", RUN, str(out)], cwd=root, env=env, check=True)
    return torch.load(out)


def main() -> int:
    other, this = Path(sys.argv[1]).resolve(), Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = run(other, Path(tmp) / "other.pt"), run(this, Path(tmp) / "this.pt")
    differ = [k for k in b if k.startswith("k3") and not torch.equal(a[k], b[k])]
    for k in b:
        d = float((a[k] - b[k]).abs().max())
        scale = max(float(a[k].abs().max()), 1.0)
        same = "bitwise equal" if torch.equal(a[k], b[k]) else ("DIFFERS" if k in differ else "differs")
        print(f"{k}: {same}, max |d| {d:.3e} ({d / scale:.3e} of the scale)")
    if "--time" in sys.argv[2:]:
        for tag, root in (("other", other), ("this", this), ("this", this), ("other", other)):
            subprocess.run([sys.executable, "-c", TIME, tag], cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                           check=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
