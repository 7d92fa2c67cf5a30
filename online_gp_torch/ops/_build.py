"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``online_gp_torch/csrc/*.cu`` compiles, at first use, into its own
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/online_gp_torch/<name>-<hash>.so <name>.cu

under ``build/`` at the repository root (git-ignored). The file name
carries a hash of the source, the shared headers and the flags, so a
changed source is rebuilt and a stale library is never loaded. Sources
that need building are compiled in parallel, one ``nvcc`` each. A failed
build raises with the compiler's output.

The wrappers call each C entry with ``ctypes``: pointers and the stream
(``torch.cuda.current_stream().cuda_stream``) as ``c_void_p``, sizes as
``c_int``. Every entry returns ``cudaGetLastError()`` after its launches
(or -1 when a cluster launch finds that the card cannot hold the
clusters it asks for at once) and :func:`launch_check` raises if that is not 0.

This module also holds the argument checks the kernel wrappers share
(:func:`check_grid` among them), the shape rules of the kernels that run
on thread-block clusters (:func:`cluster_plan`, :func:`spread_plan`) and
the one place K1's and K3's launches are decided, once a shape
(:func:`route`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "online_gp_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and at /usr/local/cuda/bin/nvcc); "
            "the CUDA kernels of online_gp_torch cannot be built"
        )
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None, verbose: bool = False) -> Dict[str, str]:
    """Compile the named sources (all by default) whose library is missing,
    in parallel. ``verbose`` adds ``-Xptxas -v`` (registers, shared memory
    and spills per kernel). Returns the compiler output by source name."""
    names = sources() if names is None else list(names)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_all(verbose: bool = False):
    """Build every source; returns (seconds, compiler output by source)."""
    t0 = time.perf_counter()
    logs = build(verbose=verbose)
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


# The recursion kernels that run on a thread-block cluster (K1, K3) split an
# output's m columns over the cluster's blocks; these mirror the constants
# of csrc/common.cuh that their shared-memory layouts depend on.
CLUSTER_THREADS = 512  # kClusterThreads
CLUSTER_COLS = 4 * CLUSTER_THREADS  # kClusterRegs * kClusterThreads: columns a block may own
CLUSTER_SIZE = 8  # blocks per cluster: the portable cluster size
WIDE_CLUSTER_SIZE = 16  # the largest non-portable cluster size (K3 past 8 blocks)
MAX_GRID_CLUSTERS = 8  # clusters per output K1's grid recursion is planned on (ogp::kMaxGridClusters)
MAX_SPREAD_CLUSTERS = 16  # clusters per output of the spread recursions, K1's and K3's (ogp::kMaxSpreadClusters)
MAX_SHARED_BYTES = 232448  # dynamic shared memory one block may use
NO_CLUSTER = -1  # kNoCluster: the card cannot hold the launch's clusters at once
MAX_GRID_YZ = 65535  # a launch grid's y and z extents


def check_grid(Bd: int, per_output: int = 1) -> None:
    """Raise ValueError for a batch of Bd outputs past the launch grid,
    where a kernel puts ``per_output`` blocks an output along its y or z
    (K1's and K2's 2: L and B). The kernels form 64-bit element offsets, so
    no size of the operands is refused."""
    if Bd * per_output > MAX_GRID_YZ:
        raise ValueError(f"Bd = {Bd} exceeds the launch grid ({MAX_GRID_YZ // per_output})")


class ClusterPlan(NamedTuple):
    """A recursion on clusters: ``clusters`` clusters of ``cluster`` blocks
    per output, each block owning ``cols`` columns and using
    ``shared_bytes`` of shared memory. With ``clusters`` > 1 (K1's grid
    recursion) the clusters of an output exchange sums through device
    memory and must all be resident at once."""

    cluster: int
    cols: int
    shared_bytes: int
    clusters: int = 1


def col_split(cols: int):
    """(column tiles, row groups) of a column pass over ``cols`` columns
    (``ogp::col_split``)."""
    tiles = -(-cols // 32)
    return tiles, max(1, (CLUSTER_THREADS // 32) // tiles)


def cluster_plan(floats_of, sizes=(CLUSTER_SIZE,), clusters=(1,)) -> Optional[ClusterPlan]:
    """The first plan, by clusters per output G in ``clusters`` and then by
    cluster size C in ``sizes``, whose block holds its part, given
    ``floats_of(C, G) -> (cols, floats per block)``; None if none does."""
    for G in clusters:
        for C in sizes:
            cols, floats = floats_of(C, G)
            if cols <= CLUSTER_COLS and 4 * floats <= MAX_SHARED_BYTES:
                return ClusterPlan(C, cols, 4 * floats, G)
    return None


class SpreadPlan(NamedTuple):
    """A recursion spread over the card (K1's and K3's past their cluster
    plans): ``clusters`` clusters of ``cluster`` blocks per output, as many
    as the card holds at once (all resident: their sums meet in device
    memory), each block owning ``cols`` columns with ``shared_bytes`` of
    shared memory, ``slices`` of its operands kept there (K1: 3 = its
    columns of U, P, R; 1 = of U; 0 = none; K3: 2 = of Z and its stencil
    entries; 1 = the stencil entries; 0 = none), the rest in device memory."""

    cluster: int
    cols: int
    shared_bytes: int
    clusters: int
    slices: int


def spread_plan(floats_of, capacity_of, slices=(3, 1, 0)) -> Optional[SpreadPlan]:
    """The plan of a recursion spread over clusters of CLUSTER_SIZE blocks:
    the first slice count in ``slices`` (most in shared memory first) with
    a G <= MAX_SPREAD_CLUSTERS whose block holds its part and whose G
    clusters the card holds at once, at the largest such G (the narrowest
    slices, and the most SMs and L2 bandwidth an output). ``floats_of(C, G,
    slices) -> (cols, floats per block)``; ``capacity_of(C, G, slices)``:
    the clusters the card holds at once at that layout (a negative value,
    minus a CUDA error, raises RuntimeError). None where no layout fits or
    the card holds none of them."""
    C = CLUSTER_SIZE
    for sl in slices:
        for G in range(MAX_SPREAD_CLUSTERS, 0, -1):
            cols, floats = floats_of(C, G, sl)
            if cols > CLUSTER_COLS or 4 * floats > MAX_SHARED_BYTES:
                break  # fewer clusters give each block more columns
            if occupancy(capacity_of(C, G, sl), "the spread recursion") >= G:
                return SpreadPlan(C, cols, 4 * floats, G, sl)
    return None


def occupancy(cap: int, what: str) -> int:
    """An occupancy query's answer, the clusters the card holds at once;
    raises RuntimeError for a failed one (minus a cudaError)."""
    if cap < 0:
        raise RuntimeError(f"{what}: the occupancy query failed with cudaError {-cap}")
    return cap


class Rules(NamedTuple):
    """A recursion family's shape rules and its library's queries, which
    :func:`route` decides a chunk's launch from (K1's
    ``cuda_root_update.K1``, K3's ``cuda_pred_stream.K3``). The shape is
    (k, m, P); a layout is C blocks a cluster, G clusters an output and, on
    the spread kernel, ``slices`` in shared memory."""

    name: str
    max_chunk: int  # the largest k of the spread kernel
    slices: tuple  # the spread layouts, most in shared memory first
    cluster_plan: Callable  # (k, m, P) -> Optional[ClusterPlan]
    spread_floats: Callable  # (k, m, P, C, G, slices) -> (cols, floats per block)
    cluster_smem: Callable  # (lib, k, m, P, C, G) -> bytes of a block, from the library
    grid_capacity: Callable  # (lib, k, m, P, C, G) -> clusters at once of a plan on G > 1 clusters
    spread_smem: Callable  # (lib, k, m, P, C, G, slices) -> bytes of a block
    spread_capacity: Callable  # (lib, k, m, P, C, G, slices) -> clusters at once
    apply: Callable  # (lib, Bd, k, rows, m, device) -> (apply plan or None, its argument, its layout's bytes)


class Route(NamedTuple):
    """How a K1 or K3 call of one shape launches, decided once by
    :func:`route`: the recursion's ``plan`` (None for an apply alone) on
    ``G`` clusters of ``plan.cluster`` blocks an output, in waves of
    ``wave`` outputs, ``spread`` the spread kernel's slices in shared
    memory (-1 on the cluster kernels, where G = 1 is K1's carried kernel);
    the apply's ``aplan`` and its argument ``apply`` (K1: the blocks of its
    clusters, 0 for the tiled kernels; K3: its tile rows)."""

    plan: object
    G: int
    wave: int
    spread: int
    aplan: object
    apply: int

    @property
    def C(self) -> int:
        return self.plan.cluster

    def slots(self, Bd: int, k: int, device, n: int = 1) -> Optional[torch.Tensor]:
        """The zeroed words of the cross-cluster sums of ``n`` recursions,
        new for each launch (two buffers of the G clusters' sums an output,
        ``ogp::GridExchange`` in csrc/common.cuh); None on one cluster."""
        if self.G == 1 and self.spread < 0:
            return None
        return torch.zeros((n, Bd, 2, self.G, k + 1), dtype=torch.int64, device=device)


_routes: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # library -> {shape: Route}


def route(lib, rules: Rules, Bd: int, k: int, m: int, device, P: int = 0, rows: Optional[int] = None,
          recursion: bool = True) -> Route:
    """The :class:`Route` of a call on Bd outputs at (k, m, P) with
    ``lib``, its recursion (unless ``recursion`` is False) and its apply on
    ``rows`` rows (None: none), kept with the library by shape and device:
    the queries below run once for each.

    The recursion: the cluster plan where it holds the chunk, its layout
    checked against the library's; on G > 1 clusters the card's capacity
    for them sets the wave, and a card that cannot hold one output's G
    clusters at once (they would wait on each other forever) sends the
    chunk spread over the card, as every chunk past the cluster plan goes:
    the spread plan, its layout checked, its capacity setting the wave. The
    apply's plan is checked against its kernel's layout. Raises ValueError
    where no kernel takes k, RuntimeError where a plan is not its kernel's
    layout or the card holds no spread clusters."""
    routes = _routes.setdefault(lib, {})
    key = (rules.name, Bd, k, m, P, rows, recursion, device)
    if key in routes:
        return routes[key]
    what = f"{rules.name} chunk (k={k}, m={m}{f', P={P}' if P else ''})"
    plan, G, wave, spread = None, 1, Bd, -1
    if recursion:
        plan = rules.cluster_plan(k, m, P)
        if plan is not None:
            C, G = plan.cluster, plan.clusters
            check_layout(plan, rules.cluster_smem(lib, k, m, P, C, G), what)
            if G > 1:
                wave = min(Bd, occupancy(rules.grid_capacity(lib, k, m, P, C, G), what) // G)
                plan = plan if wave else None
        if plan is None:
            if k > rules.max_chunk:
                raise ValueError(f"{what} exceeds what the {rules.name} recursion kernels take: "
                                 f"k <= {rules.max_chunk}")
            plan = spread_plan(lambda C, G, sl: rules.spread_floats(k, m, P, C, G, sl),
                               lambda C, G, sl: rules.spread_capacity(lib, k, m, P, C, G, sl), rules.slices)
            if plan is None:
                raise RuntimeError(f"{what}: the card holds no clusters of {CLUSTER_SIZE} blocks of the spread "
                                   f"recursion at once, or no layout of it fits a block")
            C, G, spread = plan.cluster, plan.clusters, plan.slices
            check_layout(plan, rules.spread_smem(lib, k, m, P, C, G, spread), f"{what}, spread")
            wave = min(Bd, rules.spread_capacity(lib, k, m, P, C, G, spread) // G)
    aplan, apply = None, 0
    if rows is not None:
        aplan, apply, nbytes = rules.apply(lib, Bd, k, rows, m, device)
        if aplan is not None:
            check_layout(aplan, nbytes, f"{what}'s apply (rows={rows})")
    routes[key] = Route(plan, G, wave, spread, aplan, apply)
    return routes[key]


def count_recursion(wrapper, r: Route) -> None:
    """Counts a recursion launched on route ``r`` on ``wrapper``: spread
    over the card (``spread_launches``), else on clusters
    (``cluster_launches``; those on G > 1 clusters, K1's, also in
    ``grid_cluster_launches``, those of 16 blocks, K3's, in
    ``wide_cluster_launches``). A K1 recursion on one cluster, by the
    carried kernel, is one of ``cluster_launches`` less
    ``grid_cluster_launches``."""
    if r.spread >= 0:
        wrapper.spread_launches += 1
        return
    wrapper.cluster_launches += 1
    if r.G > 1:
        wrapper.grid_cluster_launches += 1
    if r.C == WIDE_CLUSTER_SIZE:
        wrapper.wide_cluster_launches += 1


def check_layout(plan, cuda_bytes: int, what: str) -> None:
    """Raise unless the CUDA layout of one block (``cuda_bytes``, from the
    built library) is the plan's: the Python shape rule mirrors it."""
    if cuda_bytes != plan.shared_bytes:
        raise RuntimeError(f"{what}: the shape rule plans {plan.shared_bytes} bytes of shared memory a "
                           f"block, the kernel's layout takes {cuda_bytes}; they must be changed together")


def launch_check(rc: int, what: str, *plans) -> None:
    """Raise unless ``rc`` is 0. ``plans``: the cluster plans of the call's
    launches (None for a launch without one), named when the card could not
    hold a cluster."""
    plans = [p for p in plans if p is not None]
    if rc == NO_CLUSTER and plans:
        shapes = " or ".join(f"{'one cluster' if getattr(p, 'clusters', 1) == 1 else f'{p.clusters} clusters'} "
                             f"of {p.cluster} blocks with {p.shared_bytes} bytes of shared memory each"
                             for p in plans)
        raise RuntimeError(f"{what}: the card cannot hold {shapes}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_sms(device: torch.device) -> int:
    """The SMs of the CUDA device (read once a card). K3's apply picks its
    tile so that each gets a block."""
    return _card_sms(torch.cuda.current_device() if device.index is None else device.index)


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the plain version runs."""
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda_args(plain: str, *, ints=(), **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    that needs no grad, float32 (int32 for the names in ``ints``). The
    kernels take nothing else; ``plain`` names the plain version to call
    instead."""
    device = None
    for name, t in tensors.items():
        want = torch.int32 if name in ints else torch.float32
        problem = None
        if t.device.type != "cuda":
            problem = f"is on {t.device}, not on a CUDA device"
        elif device is not None and t.device != device:
            problem = f"is on {t.device}, the other arguments on {device}"
        elif t.dtype != want:
            problem = f"has dtype {t.dtype}, the kernel takes {want}"
        elif t.requires_grad:
            problem = "requires grad, and the kernel has no autograd rule"
        elif not t.is_contiguous():
            problem = "is not contiguous"
        if problem:
            raise TypeError(f"CUDA kernel argument {name!r} {problem}; use {plain} instead")
        device = t.device
