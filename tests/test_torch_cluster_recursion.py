"""The K1 and K3 recursions on thread-block clusters, held on the CPU.

- The shape rules ``chunk_cluster_plan`` (K1's recursion, and K5 sub's
  fused one on the same layout) and ``pred_cluster_plan``: which
  chunks run on a cluster, within the shared memory of one block, that
  every chunk the single-block kernels took still has a kernel, and that
  the wrappers refuse a plan that is not the kernel's layout.
- The cluster kernels' order of summation, emulated in float32 torch
  (``cluster_chunk_factors``, ``cluster_pred_factors``): each output's m
  columns split over C blocks, each block's partial sums added in rank
  order, and for K1 g = (U p) / s in one reduction. Held against the
  Pallas kernels they replace, in interpret mode as the JAX package's own
  tests run them (K1 1e-5 as tests/test_torch_root_update.py, K3 2e-4 as
  tests/test_torch_pred_stream.py), and against the plain recursions at
  float64, at m = 64, k = 16, C in {2, 4}, on a random chunk and on one
  whose points repeat or nearly repeat (near-dependent rows of p0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops import root_update as jru
from online_gp_tpu.ops.pallas_pred_stream import pad_cache_to_tile, pallas_pred_chunk
from online_gp_tpu.ops.pallas_root_update import pallas_blocked_chunk_batched
from online_gp_torch.ops import _build
from online_gp_torch.ops import cuda_pred_stream as tcps
from online_gp_torch.ops import cuda_root_update as tcru
from online_gp_torch.ops.pred_stream import pred_chunk_factors
from online_gp_torch.ops.root_update import blocked_factors, stencil_rows

M, K, P = 64, 16, 4


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def _rank_sum(parts):
    """The partials of the C blocks added in rank order."""
    return functools.reduce(lambda x, y: x + y, parts)


def _slices(m, C):
    W = -(-m // C)
    return [slice(r * W, min((r + 1) * W, m)) for r in range(C)]


def cluster_chunk_factors(p0, C):
    """K1's cluster recursion in its order of summation: (U, P, R) of p0
    (Bd, k, m). Block r owns the columns of slice r; a, U p and |p|^2 are
    rank-order sums of the blocks' partials; g = (U p) inv_s."""
    Bd, k, m = p0.shape
    cols = _slices(m, C)
    U, Pm, R = (torch.zeros_like(p0) for _ in range(3))
    for t in range(k):
        q = p0[:, t]
        a = _rank_sum([(Pm[:, :t, c] @ q[:, c, None])[..., 0] for c in cols])
        p = q + (U[:, :t].mT @ a[..., None])[..., 0]
        s2 = _rank_sum([torch.sum(p[:, c] * p[:, c], dim=-1) for c in cols])[:, None]
        Up = _rank_sum([(U[:, :t, c] @ p[:, c, None])[..., 0] for c in cols])
        s = torch.sqrt(s2)
        inv_s = torch.where(s > 1e-20, 1.0 / torch.clamp(s, min=1e-20), torch.zeros_like(s))
        c_, d_ = torch.sqrt(s2 + 1.0) - 1.0, 1.0 / torch.sqrt(s2 + 1.0) - 1.0
        g = Up * inv_s
        u = p * inv_s
        U[:, t] = u
        Pm[:, t] = d_ * (u + (Pm[:, :t].mT @ g[..., None])[..., 0])
        R[:, t] = c_ * (u + (R[:, :t].mT @ g[..., None])[..., 0])
    return U, Pm, R


def cluster_pred_factors(S, c0w, mu0w, y, nz, C):
    """K3's cluster recursion in its order of summation: (Z, r, pred_mean,
    pred_var). ct = c0w[t] - Z^T a on each block's columns with its rows
    in row groups (added in order); the owners' partials of a (one step
    ahead, row t - 1 as ct unscaled, then times inv) and of pv, added in
    rank order."""
    Bd, k, m = c0w.shape
    cols = _slices(m, C)
    groups = _build.col_split(cols[0].stop - cols[0].start)[1]
    Z = torch.zeros_like(c0w)
    r = torch.zeros_like(mu0w)
    a = torch.zeros_like(mu0w)
    pms, pvs = [], []
    for t in range(k):
        ct = c0w[:, t] - _rank_sum([(Z[:, g:t:groups].mT @ a[:, g:t:groups, None])[..., 0]
                                     for g in range(groups)])
        pv = _rank_sum([ct[:, c] @ S[t, c] for c in cols])
        pm = mu0w[:, t] + torch.sum(r[:, :t] * a[:, :t], dim=-1)
        inv = torch.rsqrt(torch.clamp(pv + nz[:, t], min=1e-20))
        r[:, t] = (y[:, t] - pm) * inv
        pms.append(pm)
        pvs.append(pv)
        if t + 1 < k:
            rows = torch.cat([Z[:, :t], ct[:, None]], dim=1)
            a = torch.zeros_like(mu0w)
            a[:, : t + 1] = _rank_sum([rows[:, :, c] @ S[t + 1, c] for c in cols])
            a[:, t] = a[:, t] * inv
        Z[:, t] = ct * inv[:, None]
    return Z, r, torch.stack(pms, dim=-1), torch.stack(pvs, dim=-1)


def _roots(rng, Bd, m, dtype):
    W = rng.normal(size=(Bd, m, m))
    L = np.linalg.cholesky(W @ np.swapaxes(W, -1, -2) / m + np.eye(m))
    return L.astype(dtype), np.swapaxes(np.linalg.inv(L), -1, -2).astype(dtype)


def _stencil(rng, k, m, repeats):
    """(idx, w) of k points, P entries each; with ``repeats`` point 2t+1
    repeats point 2t, its weights exactly or to 1e-4 (alternately)."""
    idx = rng.integers(0, m, (k, P))
    w = rng.uniform(-0.5, 1.0, (k, P))
    if repeats:
        idx[1::2] = idx[0::2]
        w[1::2] = w[0::2]
        w[3::4] += 1e-4 * rng.normal(size=w[3::4].shape)
    return idx, w


# --------------------------------------------------------------------------
# (a) the shape rules
# --------------------------------------------------------------------------

SHAPES = [(k, m) for k in (1, 8, 16, 32, 64, 128, 256, 512, 1024)
          for m in (36, 64, 100, 400, 900, 1600, 2200, 2300, 2500, 4096, 9000, 16384, 20000)]


def _old_k1_takes(k, m):
    return k <= tcru.MAX_CHUNK and (2 * m + 2 * k + 32) * 4 <= tcru.MAX_SHARED_BYTES


def _old_k3_takes(k, m):
    return k <= tcps.MAX_CHUNK and (m + 2 * k + 1) * 4 <= tcps.MAX_SHARED_BYTES


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_cluster_plans_fit_one_block_and_leave_no_chunk_without_a_kernel(which):
    for k, m in SHAPES:
        if which == "K1":
            plan, old, slices = tcru.chunk_cluster_plan(k, m), _old_k1_takes(k, m), 3 * k
        else:
            plan, old, slices = tcps.pred_cluster_plan(k, m, 16), _old_k3_takes(k, m), k
        if plan is None:
            # None only where the slices of a cluster of 8 (with at most 63
            # columns of padding, the vectors and the partials) may not fit a
            # block, or a block would own more columns than it keeps in
            # registers; such chunks go to the single-block kernel
            W8 = -(-m // 8)
            upper = 4 * ((slices + 3) * (W8 + 64) + 40 * k + 4200)
            assert W8 > _build.CLUSTER_COLS or upper > _build.MAX_SHARED_BYTES, (k, m)
            continue
        assert plan.cluster == _build.CLUSTER_SIZE == 8
        assert plan.cols == -(-m // plan.cluster) <= _build.CLUSTER_COLS
        assert 4 * slices * plan.cols <= plan.shared_bytes <= _build.MAX_SHARED_BYTES == 232448, (k, m, plan)


class _SizeQueries:
    """Stands in for the built libraries' shared-memory queries
    (csrc/root_update.cu, csrc/pred_stream.cu): the single-block kernels',
    and one cluster block's layout, which is the shape rule's plus ``skew``
    bytes."""

    def __init__(self, skew=0):
        self.skew = skew

    @staticmethod
    def ogp_blocked_chunk_smem(k, m):
        return (2 * m + 2 * k + 32) * 4

    @staticmethod
    def ogp_pred_chunk_smem(k, m):
        return (m + 2 * k + 1) * 4

    def ogp_chunk_cluster_smem(self, k, m, C):
        return 4 * tcru._chunk_cluster_floats(k, m, C)[1] + self.skew

    def ogp_pred_cluster_smem(self, k, m, P, C):
        return 4 * tcps._pred_cluster_floats(k, m, P, C)[1] + self.skew

    @staticmethod
    def ogp_chunk_apply_smem(k, m, C):  # K1's apply, which every K1 and K5 chunk ends with
        return 4 * tcru._chunk_apply_floats(k, m, C)[1]


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_wrapper_dispatch_admits_every_chunk_the_single_block_kernel_took(which):
    """The wrappers' route by shape: the cluster plan where there is one,
    else the single-block kernel; ValueError only where neither takes the
    chunk, and so never for a chunk the single-block kernel took before."""
    lib = _SizeQueries()
    for k, m in SHAPES:
        if which == "K1":
            plan, old = tcru.chunk_cluster_plan(k, m), _old_k1_takes(k, m)
            route = lambda: tcru._recursion_plan(lib, k, m, "chunk")
        else:
            plan, old = tcps.pred_cluster_plan(k, m, 16), _old_k3_takes(k, m)
            route = lambda: tcps._pred_plan(lib, k, m, 16)
        if plan is None and not old:
            with pytest.raises(ValueError, match="exceeds what the K[13] recursion kernels take"):
                route()
            continue
        got_plan, cluster = route()
        assert got_plan == plan and cluster == (0 if plan is None else plan.cluster)


@pytest.mark.parametrize("k,m,cluster,nbytes", [
    (128, 900, 8, 192036),  # the main path's chunk: 113 columns a block
    (32, 900, 8, 62356),  # K5-sub's sub-blocks at m = 900
    (128, 1120, 8, 228740),  # the envelope's edge at k = 128
    (128, 1121, None, None),
    (128, 2500, None, None),  # chip_smoke's chunk outside the envelope (50 x 50 grid)
])
def test_chunk_cluster_plan_at_the_smoke_shapes(k, m, cluster, nbytes):
    plan = tcru.chunk_cluster_plan(k, m)
    if cluster is None:
        assert plan is None and _old_k1_takes(k, m)
    else:
        assert plan == _build.ClusterPlan(cluster, -(-m // cluster), nbytes)


@pytest.mark.parametrize("k,m", [(128, 900), (32, 900)])
def test_pred_cluster_plan_picks_a_cluster_at_the_main_path_shapes(k, m):
    plan = tcps.pred_cluster_plan(k, m, 16)
    assert plan is not None and plan.cluster == 8 and plan.cols == 113
    assert plan.shared_bytes <= 232448


@pytest.mark.parametrize("k,m,inside", [
    (128, 3136, True),  # the envelope's edge at k = 128, P = 16
    (128, 3137, False),
    (512, 900, False),  # chip_smoke's chunk outside the envelope
])
def test_pred_cluster_plan_at_the_envelope_edge(k, m, inside):
    plan = tcps.pred_cluster_plan(k, m, 16)
    assert (plan is not None) == inside
    if not inside:
        assert _old_k3_takes(k, m)
        assert tcps._pred_plan(_SizeQueries(), k, m, 16) == (None, 0)


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_wrappers_refuse_a_plan_that_is_not_the_kernel_layout(which):
    """The Python shape rule mirrors the CUDA layout of one block; the
    wrappers ask the library for the layout's bytes before each cluster
    launch and raise if the two have drifted apart."""
    for skew in (4, -4):
        with pytest.raises(RuntimeError, match="they must be changed together"):
            if which == "K1":
                tcru._recursion_plan(_SizeQueries(skew), 128, 900, "chunk")
            else:
                tcps._pred_plan(_SizeQueries(skew), 128, 900, 16)


def test_no_cluster_raises_naming_the_cluster():
    plan = _build.ClusterPlan(8, 113, 184792)
    with pytest.raises(RuntimeError, match="cannot hold one cluster of 8 blocks with 184792 bytes"):
        _build.launch_check(_build.NO_CLUSTER, "blocked_chunk", plan)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.launch_check(1, "blocked_chunk", plan)
    _build.launch_check(0, "blocked_chunk", plan)


def _layout(k, m, C):
    """chunk_cluster_layout of csrc/root_update.cu, written out: (ld, floats)."""
    W = -(-m // C)
    Sr = max(s for s in (1, 2, 4, 8, 16, 32) if s == 1 or s * k <= 512)
    ld = W if Sr == 32 else next(x for x in range(W, W + 2 * Sr) if x % (2 * Sr) == Sr)
    CT = -(-W // 32)
    S = max(1, 16 // CT)
    return ld, 4 + 3 * k * ld + ld + 2 * k + 2 * C * (k + 1) + 2 * S * CT * 32 + 1


@pytest.mark.parametrize("k,sub,m", [(128, 32, 900), (128, 16, 900), (128, 64, 900), (64, 8, 400), (128, 32, 1120),
                                     (32, 16, 100), (256, 32, 300)])
def test_sub_cluster_floats_are_the_layout_formula(k, sub, m):
    """K5 sub's fused kernel runs on K1's layout. A sub-block boundary sums
    its coefficients in the step's buffers (from p to the end of the
    layout: cap coefficients and a block's share of their sums, as
    boundary_update takes them), in rounds of rows; one row of its widest
    round, the collapse's 2 J coefficients for J = k - sub, always fits."""
    W, floats = tcru._chunk_cluster_floats(k, m, 8)
    ld, want = _layout(k, m, 8)
    assert W == -(-m // 8) and floats == want
    nbnd = floats - (4 + 3 * k * ld)
    cap = (nbnd - 1) * 8 // 9
    assert cap + -(-cap // 8) <= nbnd and cap >= 2 * (k - sub)


@pytest.mark.parametrize("k,sub,m,nbytes", [
    (128, 32, 900, 192036),  # chip_smoke's K5-sub chunk: the fused cluster kernel
    (128, 32, 1024, 216676),  # chip_smoke's K5-sub chunk inside the envelope's upper part
    (128, 32, 1120, 228740),  # the envelope's edge, K1's
    (128, 32, 2500, None),  # chip_smoke's K5-sub chunk outside the envelope
])
def test_chunk_sub_cluster_plan_at_the_smoke_shapes(k, sub, m, nbytes):
    plan = tcru.chunk_cluster_plan(k, m)
    if nbytes is None:
        assert plan is None
    else:
        assert plan == _build.ClusterPlan(8, -(-m // 8), nbytes) and 4 * _layout(k, m, 8)[1] == nbytes


class _SubLib(_SizeQueries):
    """Records which K5-sub entry a call of _chunk_sub reaches."""

    def __init__(self, skew=0):
        super().__init__(skew)
        self.calls = []

    def ogp_blocked_chunk_sub_cluster(self, *args):
        self.calls.append(("fused", args[-2]))
        return 0

    def ogp_blocked_chunk_sub(self, *args):
        self.calls.append(("per sub-block", args[-2]))
        return 0


@pytest.mark.parametrize("m,route,cluster", [(900, "fused", 8), (1120, "fused", 8), (2500, "per sub-block", 8),
                                             (20000, "per sub-block", 0)])
def test_k5_sub_takes_the_fused_kernel_inside_its_envelope(monkeypatch, m, route, cluster):
    """(128, 32, 900) and (128, 32, 1120), K1's edge, run the fused cluster
    kernel; (128, 32, 2500) one sub-block at a time, each on K1's cluster
    kernel at k = 32, and m = 20,000 on its single-block kernel: every shape
    taken before still runs."""
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    k, sub, P = 128, 32, 16
    meta = dict(device="meta", dtype=torch.float32)
    L = torch.empty((1, m, m), **meta)
    idx, wv = torch.empty((k, P), device="meta", dtype=torch.int32), torch.empty((1, k, P), **meta)
    lib = _SubLib()
    before = (tcru.blocked_chunk.sub_launches, tcru.blocked_chunk.sub_cluster_launches)
    try:
        tcru._chunk_sub(lib, L, L, idx, wv, sub)
        assert lib.calls == [(route, cluster)]
        fused = route == "fused"
        assert (tcru.blocked_chunk.sub_launches - before[0], tcru.blocked_chunk.sub_cluster_launches - before[1]) == (1, fused)
    finally:
        tcru.blocked_chunk.sub_launches, tcru.blocked_chunk.sub_cluster_launches = before


def test_k5_sub_refuses_a_plan_that_is_not_the_kernel_layout(monkeypatch):
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    meta = dict(device="meta", dtype=torch.float32)
    L = torch.empty((1, 900, 900), **meta)
    idx, wv = torch.empty((128, 16), device="meta", dtype=torch.int32), torch.empty((1, 128, 16), **meta)
    for skew in (4, -4):
        lib = _SubLib(skew)
        with pytest.raises(RuntimeError, match="they must be changed together"):
            tcru._chunk_sub(lib, L, L, idx, wv, 32)
        assert lib.calls == []


# --------------------------------------------------------------------------
# (b) K1's summation order
# --------------------------------------------------------------------------


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("repeats", [False, True])
def test_k1_cluster_order_matches_pallas_and_the_plain_recursion(C, repeats):
    rng = np.random.default_rng(30 + C + 10 * repeats)
    Bd = 2
    L, B = _roots(rng, Bd, M, np.float32)
    idx, w = _stencil(rng, K, M, repeats)
    wv = (w[None] * np.array([1.0, 0.7])[:, None, None]).astype(np.float32)
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv[b]), M)) for b in range(Bd)])
    p0 = torch.einsum("bkp,bkpm->bkm", torch.tensor(wv), torch.tensor(B)[:, torch.tensor(idx)])
    U, Pm, R = cluster_chunk_factors(p0, C)
    tL = torch.tensor(L) + (torch.tensor(L) @ R.mT) @ U
    tB = torch.tensor(B) + (torch.tensor(B) @ Pm.mT) @ U
    jL, jB = pallas_blocked_chunk_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(S), interpret=True)
    _close(jL, tL, 1e-5)
    _close(jB, tB, 1e-5)
    # at float64 the reassociation is the plain recursion's to rounding
    p0d = p0.double()
    for a, b in zip(blocked_factors(p0d), cluster_chunk_factors(p0d, C)):
        _close(a, b, 1e-9)
    # and at float32, within the chunk tolerance of the plain version
    for a, b in zip(blocked_factors(p0), (U, Pm, R)):
        _close(a, b, 1e-5)


# --------------------------------------------------------------------------
# (c) K3's summation order
# --------------------------------------------------------------------------


def _pred_problem(rng, Bd, repeats):
    G = rng.normal(size=(Bd, M, M))
    C = (G @ np.swapaxes(G, -1, -2) / M).astype(np.float32)
    mu = rng.normal(size=(Bd, M)).astype(np.float32)
    idx, w = _stencil(rng, K, M, repeats)
    y = rng.normal(size=(Bd, K)).astype(np.float32)
    nz = rng.uniform(0.3, 0.7, (Bd, K)).astype(np.float32)
    return C, mu, idx, w.astype(np.float32), y, nz


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("repeats", [False, True])
def test_k3_cluster_order_matches_pallas_and_the_plain_recursion(C, repeats):
    rng = np.random.default_rng(40 + C + 10 * repeats)
    Cm, mu, idx, w, y, nz = _pred_problem(rng, 1, repeats)
    S = stencil_rows(torch.tensor(idx), torch.tensor(w), M)
    Ct, mut = torch.tensor(Cm), torch.tensor(mu)
    c0w, mu0w = S @ Ct, mut @ S.mT
    Z, r, pm, pv = cluster_pred_factors(S, c0w, mu0w, torch.tensor(y), torch.tensor(nz), C)
    newC, newmu = Ct - Z.mT @ Z, mut + (Z.mT @ r[..., None])[..., 0]
    Sj = jnp.pad(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(w), M), ((0, 0), (0, 128 - M)))
    C_p, mu_p, _ = pad_cache_to_tile(jnp.asarray(Cm), jnp.asarray(mu))
    Cj, muj, pmj, pvj = pallas_pred_chunk(C_p[0], mu_p[0], Sj, jnp.asarray(y[0]), jnp.asarray(nz[0]), interpret=True)
    _close(np.asarray(Cj)[:M, :M], newC[0], 2e-4)
    _close(np.asarray(muj)[:M], newmu[0], 2e-4)
    _close(pmj, pm[0], 2e-4)
    _close(pvj, pv[0], 2e-4)
    # at float64 the reassociation is the plain recursion's to rounding
    args64 = [t.double() for t in (S, c0w, mu0w, torch.tensor(y), torch.tensor(nz))]
    for a, b in zip(pred_chunk_factors(*args64), cluster_pred_factors(*args64, C)):
        _close(a, b, 1e-9)
