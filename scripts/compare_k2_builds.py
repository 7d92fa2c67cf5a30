"""Run the rank-1 root-update kernels of two checkouts of the port on the
same inputs on the card and compare their results bit for bit: K2
(``rank1_apply``, through 64 single-point ``wiski_condition`` calls on a
WISKI state at bench.py's width, 30 x 30 grid, m = 900) and K4
(``rank1_update``, full and slim, 16 updates each). Both kernels share the
row kernel of ``csrc/root_update.cu``.

    python3 scripts/compare_k2_builds.py OTHER_CHECKOUT

Each checkout runs in a process of its own, with its own ``build/``. Exits
non-zero when a result differs.
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
from online_gp_torch.models.wiski import WiskiModel, wiski_condition, wiski_init
from online_gp_torch.ops import _build
from online_gp_torch.ops.cuda_root_update import rank1_update
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import dense_w, interp_coeffs
from online_gp_torch.ops.precision import f32_matmul_precision

dev = torch.device("cuda", 0)
with f32_matmul_precision():
    _build.build_all()
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    grid = Grid.create([(-1.1, 1.1)] * 2, 30, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    x0 = torch.tensor(rng.uniform(-1, 1, (256, 2)), **f32)
    state = wiski_init(model, x0, torch.sin(3 * x0[:, :1]), torch.ones((256, 1), **f32))
    start = [t.clone() for t in state.roots]
    xc = torch.tensor(rng.uniform(-1, 1, (64, 2)), **f32)
    for i in range(64):
        state = wiski_condition(model, state, xc[i : i + 1], torch.sin(3 * xc[i : i + 1, :1]), torch.ones((1, 1), **f32))
    out = {"k2_root": state.roots.root, "k2_inv_root": state.roots.inv_root}
    idx, w = interp_coeffs(grid, xc[:16])
    cols = dense_w(idx, w, grid.num_points)
    for name, A in (("full", start[0].clone()), ("slim", None)):
        L, B = start[1].clone(), start[2].clone()
        for i in range(16):
            L, B, A = rank1_update(L, B, A, cols[None, :, i : i + 1].contiguous())
        out.update({f"k4_{name}_root": L, f"k4_{name}_inv_root": B})
        if A is not None:
            out[f"k4_{name}_mat"] = A
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[1])
'''


def run(root: Path, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", RUN, str(out)], cwd=root, env=env, check=True)
    return torch.load(out)


def main() -> int:
    other, this = Path(sys.argv[1]).resolve(), Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = run(other, Path(tmp) / "other.pt"), run(this, Path(tmp) / "this.pt")
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    for k in b:
        print(f"{k}: {'bitwise equal' if k not in differ else 'DIFFERS'}, max |d| {float((a[k] - b[k]).abs().max()):.3e}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
