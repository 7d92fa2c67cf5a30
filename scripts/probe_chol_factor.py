"""Split K6's panel factor (``chol_factor_kernel``) into its stages on the
card, from the kernel's own clock64 stamps.

    python3 scripts/probe_chol_factor.py

Builds ``online_gp_torch/csrc/chol.cu`` as it stands with ``OGP_STAMPS``
defined (``OGP_STAMP`` in ``csrc/common.cuh``: thread 0 of each block
writes clock64() at each stage boundary), factors a seeded SPD matrix at
m = 4,096 and 900 with K6's wrapper on that library (programmatic
dependent launch off, so that no stage holds a wait for the kernel
before), and prints the mean cycles of each stage over the panels: the
tile's load, each inner panel's warp factor (wf) and inner update (iu),
and the store with the flag and the inverses, over the panels of 128
whole columns. Cycles become microseconds at the SM clock ``nvidia-smi``
reads just after.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from online_gp_torch.ops import _build, cuda_chol  # noqa: E402
from online_gp_torch.ops.precision import f32_matmul_precision  # noqa: E402

STAMPED = r"""
#define OGP_STAMPS
#include "chol.cu"

extern "C" int probe_set_stamps(long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(ogp::stamps, &p, sizeof(p)));
}
"""
SLOTS = 12  # ogp::kStampSlots
STAGES = ("load", "wf0", "iu0", "wf1", "iu1", "wf2", "iu2", "wf3", "iu3", "store, flag, W")


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "probe_chol_factor.cu"
    src.write_text(STAMPED)
    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_set_stamps.argtypes = [vp]
    lib.ogp_blocked_cholesky.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp, vp, i32, vp]
    lib.ogp_blocked_cholesky.restype = i32
    lib.ogp_chol_trail_smem.argtypes = [i32]
    lib.ogp_chol_trail_smem.restype = i32
    return lib


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def main() -> int:
    dev = torch.device("cuda", 0)
    lib = build()
    cuda_chol._lib = lib  # the wrapper launches the stamped library
    res = dict(card=torch.cuda.get_device_name(0))
    with f32_matmul_precision():
        for m in (4096, 900):
            g = torch.Generator().manual_seed(m)
            a = torch.randn((1, m, m), generator=g).to(dev)
            q = (a @ a.mT / m + torch.eye(m, device=dev)).contiguous()
            nb = -(-m // cuda_chol.KERNEL_BLOCK)
            stamps = torch.zeros(nb * SLOTS, dtype=torch.int64, device=dev)
            if lib.probe_set_stamps(ctypes.c_void_p(stamps.data_ptr())) != 0:
                raise RuntimeError("could not set the stamp buffer")
            cuda_chol.PROGRAMMATIC_LAUNCH = False
            try:
                for _ in range(3):  # the last call's stamps are read
                    cuda_chol.blocked_cholesky(q)
                torch.cuda.synchronize()
                mhz = sm_clock_mhz()
            finally:
                cuda_chol.PROGRAMMATIC_LAUNCH = True
            full = m // cuda_chol.KERNEL_BLOCK  # panels of four whole inner panels (a ragged one stamps fewer)
            st = stamps.view(nb, SLOTS)[:full, : len(STAGES) + 1].double().cpu()
            cycles = (st[:, 1:] - st[:, :-1]).mean(0)
            res[f"m{m}"] = dict(sm_clock_mhz=mhz, panels=full,
                                cycles={n: round(float(c), 1) for n, c in zip(STAGES, cycles)},
                                total_cycles=float((st[:, -1] - st[:, 0]).mean()),
                                total_us=float((st[:, -1] - st[:, 0]).mean()) / mhz)
            print(f"m={m}: {json.dumps(res[f'm{m}'])}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
