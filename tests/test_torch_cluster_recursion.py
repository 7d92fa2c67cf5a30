"""The K1 and K3 recursions on thread-block clusters, held on the CPU (and,
marked ``cuda``, on a card).

- The shape rules ``chunk_cluster_plan`` (K1's recursion on one cluster of
  8 blocks, a flat chunk there by the carried kernel, or on G = 2 to 8 of
  them past what one holds, and K5 sub's
  fused one on the one-cluster layout), ``pred_cluster_plan`` (K3's, on 8
  blocks or 16) and, past them, ``chunk_spread_plan`` and
  ``pred_spread_plan`` (the recursions spread over as many clusters of 8
  as the card holds at once, the factor slices in shared memory where
  they fit): which chunks run on which clusters, within the shared memory
  of one block, that every chunk at every k <= 1,024 and m (past 2^31
  elements of the roots) has a kernel, and that the wrappers refuse a
  plan that is not the kernel's layout; K1's grid and spread launches
  through a stand-in library (G, waves within the card's capacity,
  counters, a grid plan the card cannot hold taking the spread route, a
  card that holds none raising), and each shape's route decided once
  (``_build.route``): a second chunk asks the library nothing, and a
  fresh library whose layout drifted raises after a sound one kept the
  shape.
- The cluster kernels' order of summation, emulated in float32 torch
  (``cluster_chunk_factors``, ``cluster_pred_factors``): each output's m
  columns split over the C G blocks of G clusters, each block's partial
  sums added in rank order within its cluster and the G cluster sums in
  cluster order, and for K1 g = (U p) / s in one reduction. Held against
  the Pallas kernels they replace, in interpret mode as the JAX package's
  own tests run them (K1 1e-5 as tests/test_torch_root_update.py, K3 2e-4
  as tests/test_torch_pred_stream.py), and against the plain recursions at
  float64, at m = 64, k = 16, C in {2, 4} and G in {1, 2, 3} (K3 also one
  cluster of 16), on a random chunk and on one whose points repeat or
  nearly repeat (near-dependent rows of p0). The spread kernels sum in the
  same two levels over N = C G blocks: emulated at float64 with N = 3, 7
  and 16 against the JAX package's ``blocked_factors_xla`` and
  ``pred_chunk_factors`` (1e-10), and at float32 against the Pallas
  kernels in interpret mode. The carried kernel's order
  (``carried_chunk_factors``: the dots with P carried in the raw rows, one
  rank-order sum of k dots a step) on one cluster of C = 2, 4 and 8, held
  the same way, and over a 32-chunk stream at m = 256 within 1.5 times
  the deviation of the cluster kernel's order from float64.
- The kernels against their plain versions on the card at m = 4,096 (K1 on
  4 clusters, Bd = 1 and 2; K3 on 16 blocks), at m = 256 and 900 (K1's
  carried kernel, Bd = 1 and 2), at the envelopes' edges and
  past them on the spread route, K5 sub one sub-block at a time at
  m = 2,500 (each sub-block by the carried kernel), bitwise the same on a
  second call;
  skipped without one (``-m cuda``; the JAX imports sit inside the CPU
  tests, so ``pytest --noconftest -m cuda`` runs this file on a machine
  without JAX).
"""

import collections
import functools

import numpy as np
import pytest
import torch

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


def _cluster_sum(parts, C):
    """The partials of the blocks of G clusters (block r of cluster g at
    g C + r): each cluster's C in rank order, then the G cluster sums in
    cluster order (ogp::GridExchange). At G = 1, _rank_sum."""
    return _rank_sum([_rank_sum(parts[g : g + C]) for g in range(0, len(parts), C)])


def _slices(m, C, G=1):
    W = -(-m // (C * G))
    return [slice(r * W, min((r + 1) * W, m)) for r in range(C * G)]


def cluster_chunk_factors(p0, C, G=1):
    """K1's cluster recursion in its order of summation: (U, P, R) of p0
    (Bd, k, m) on G clusters of C blocks. Block g C + r owns the columns of
    slice g C + r; a, U p and |p|^2 are two-level sums of the blocks'
    partials (_cluster_sum); g = (U p) inv_s."""
    Bd, k, m = p0.shape
    cols = _slices(m, C, G)
    U, Pm, R = (torch.zeros_like(p0) for _ in range(3))
    for t in range(k):
        q = p0[:, t]
        a = _cluster_sum([(Pm[:, :t, c] @ q[:, c, None])[..., 0] for c in cols], C)
        p = q + (U[:, :t].mT @ a[..., None])[..., 0]
        s2 = _cluster_sum([torch.sum(p[:, c] * p[:, c], dim=-1) for c in cols], C)[:, None]
        Up = _cluster_sum([(U[:, :t, c] @ p[:, c, None])[..., 0] for c in cols], C)
        s = torch.sqrt(s2)
        inv_s = torch.where(s > 1e-20, 1.0 / torch.clamp(s, min=1e-20), torch.zeros_like(s))
        c_, d_ = torch.sqrt(s2 + 1.0) - 1.0, 1.0 / torch.sqrt(s2 + 1.0) - 1.0
        g = Up * inv_s
        u = p * inv_s
        U[:, t] = u
        Pm[:, t] = d_ * (u + (Pm[:, :t].mT @ g[..., None])[..., 0])
        R[:, t] = c_ * (u + (R[:, :t].mT @ g[..., None])[..., 0])
    return U, Pm, R


def carried_chunk_factors(p0, C):
    """K1's carried recursion (``chunk_recursion_carried_kernel``) in its
    order of summation, on one cluster of C blocks: the raw rows past t
    carry their dots with P, r += (d inv_s r . p) u_t after step t, so p is
    row t as it stands; one rank-order sum a step of the blocks' dots of
    the k rows U_j (j < t), p and r (j > t) with p; P^T v and R^T v scaled
    by inv_s after their sums."""
    Bd, k, m = p0.shape
    cols = _slices(m, C)
    rows = p0.clone()
    U, Pm, R = (torch.zeros_like(p0) for _ in range(3))
    for t in range(k):
        p = rows[:, t].clone()
        every = torch.cat([U[:, :t], p[:, None], rows[:, t + 1 :]], dim=1)
        v = _rank_sum([(every[:, :, c] @ p[:, c, None])[..., 0] for c in cols])
        s2 = v[:, t : t + 1]
        s = torch.sqrt(s2)
        inv_s = torch.where(s > 1e-20, 1.0 / torch.clamp(s, min=1e-20), torch.zeros_like(s))
        c_, d_ = torch.sqrt(s2 + 1.0) - 1.0, 1.0 / torch.sqrt(s2 + 1.0) - 1.0
        u = p * inv_s
        U[:, t] = u
        Pm[:, t] = d_ * (u + inv_s * (Pm[:, :t].mT @ v[:, :t, None])[..., 0])
        R[:, t] = c_ * (u + inv_s * (R[:, :t].mT @ v[:, :t, None])[..., 0])
        rows[:, t + 1 :] = torch.addcmul(rows[:, t + 1 :], ((d_ * inv_s) * v[:, t + 1 :])[..., None], u[:, None, :])
    return U, Pm, R


def cluster_pred_factors(S, c0w, mu0w, y, nz, C, G=1):
    """K3's cluster recursion in its order of summation: (Z, r, pred_mean,
    pred_var). ct = c0w[t] - Z^T a on each block's columns with its rows
    in row groups (added in order); the owners' partials of a (one step
    ahead, row t - 1 as ct unscaled, then times inv) and of pv, added in
    rank order (in two levels over G clusters, as K1's: _cluster_sum; the
    kernel runs one cluster of 8 or 16)."""
    Bd, k, m = c0w.shape
    cols = _slices(m, C, G)
    groups = _build.col_split(cols[0].stop - cols[0].start)[1]
    Z = torch.zeros_like(c0w)
    r = torch.zeros_like(mu0w)
    a = torch.zeros_like(mu0w)
    pms, pvs = [], []
    for t in range(k):
        ct = c0w[:, t] - _rank_sum([(Z[:, g:t:groups].mT @ a[:, g:t:groups, None])[..., 0]
                                     for g in range(groups)])
        pv = _cluster_sum([ct[:, c] @ S[t, c] for c in cols], C)
        pm = mu0w[:, t] + torch.sum(r[:, :t] * a[:, :t], dim=-1)
        inv = torch.rsqrt(torch.clamp(pv + nz[:, t], min=1e-20))
        r[:, t] = (y[:, t] - pm) * inv
        pms.append(pm)
        pvs.append(pv)
        if t + 1 < k:
            rows = torch.cat([Z[:, :t], ct[:, None]], dim=1)
            a = torch.zeros_like(mu0w)
            a[:, : t + 1] = _cluster_sum([rows[:, :, c] @ S[t + 1, c] for c in cols], C)
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
        # the widest plan: 8 clusters of 8 blocks (K1), one of 16 (K3)
        widest = 64 if which == "K1" else 16
        if plan is None:
            # None only where the slices of the widest plan (with at most 63
            # columns of padding, the vectors and the partials) may not fit a
            # block, or a block would own more columns than it keeps in
            # registers; such chunks go to the spread route
            W8 = -(-m // widest)
            upper = 4 * ((slices + 3) * (W8 + 64) + 40 * k + 4200)
            assert W8 > _build.CLUSTER_COLS or upper > _build.MAX_SHARED_BYTES, (k, m)
            continue
        if which == "K1":
            assert plan.cluster == _build.CLUSTER_SIZE == 8 and 1 <= plan.clusters <= _build.MAX_GRID_CLUSTERS == 8
        else:
            assert plan.cluster in (8, 16) and plan.clusters == 1
        assert plan.cols == -(-m // (plan.cluster * plan.clusters)) <= _build.CLUSTER_COLS
        assert 4 * slices * plan.cols <= plan.shared_bytes <= _build.MAX_SHARED_BYTES == 232448, (k, m, plan)


def _h100_clusters(nbytes):
    """Clusters of 8 blocks of 512 threads with ``nbytes`` of shared memory
    each that an H100 SXM holds at once, as a model: blocks a SM by its
    233,472 bytes (1 KB reserved a block) and 2,048 threads, 15 clusters of
    8 at one block a SM (cudaOccupancyMaxActiveClusters at m = 4,096)."""
    return 15 * min(233472 // (nbytes + 1024), 4)


class _SizeQueries:
    """Stands in for the built libraries' shared-memory and capacity
    queries (csrc/root_update.cu, csrc/pred_stream.cu): one cluster
    block's layout, which is the shape rule's plus ``skew`` bytes, the
    spread kernels' layouts written out (``_layout``, ``_pred_layout``)
    plus ``skew``, and an H100 SXM's capacity for each
    (``_h100_clusters``)."""

    def __init__(self, skew=0):
        self.skew = skew

    def ogp_chunk_grid_capacity(self, k, m, C, G):
        return _h100_clusters(4 * _layout(k, m, C, G)[1])

    def ogp_chunk_spread_smem(self, k, m, C, G, slices):
        return 4 * _layout(k, m, C, G, slices)[1] + self.skew

    @staticmethod
    def ogp_chunk_spread_capacity(k, m, C, G, slices):
        return _h100_clusters(4 * _layout(k, m, C, G, slices)[1])

    def ogp_pred_spread_smem(self, k, m, P, C, G, slices):
        return 4 * _pred_layout(k, m, P, C, G, slices) + self.skew

    @staticmethod
    def ogp_pred_spread_capacity(k, m, P, C, G, slices):
        return _h100_clusters(4 * _pred_layout(k, m, P, C, G, slices))

    def ogp_chunk_cluster_smem(self, k, m, C, G):  # K1's and K5 sub's, on G clusters of C blocks
        return 4 * tcru._chunk_cluster_floats(k, m, C, G)[1] + self.skew

    def ogp_pred_cluster_smem(self, k, m, P, C):
        return 4 * tcps._pred_cluster_floats(k, m, P, C)[1] + self.skew

    @staticmethod
    def ogp_chunk_apply_smem(k, m, C):  # K1's apply, which every K1 and K5 chunk ends with
        return 4 * tcru._chunk_apply_floats(k, m, C)[1]


def _route(lib, which, k, m, P=16):
    """(plan, blocks a cluster) of the route of a K1 or K3 recursion of one
    output at (k, m, P, the K3 stencil's) on ``lib``."""
    r = _build.route(lib, tcru.K1, 1, k, m, None) if which == "K1" else _build.route(lib, tcps.K3, 1, k, m, None, P)
    return r.plan, r.C


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_wrapper_dispatch_admits_every_chunk_the_single_block_kernel_took(which):
    """The wrappers' route by shape: the cluster plan where there is one
    (and, for K1's grid plans, the card holds its clusters), else the
    spread plan; never a ValueError, so never for a chunk the single-block
    kernel took before either."""
    lib = _SizeQueries()
    for k, m in SHAPES:
        if which == "K1":
            plan = tcru.chunk_cluster_plan(k, m)
        else:
            plan = tcps.pred_cluster_plan(k, m, 16)
        got_plan, cluster = _route(lib, which, k, m)
        if plan is None:
            assert isinstance(got_plan, _build.SpreadPlan), (k, m)
        else:
            assert got_plan == plan, (k, m)
        assert cluster == got_plan.cluster


@pytest.mark.parametrize("k,m,cluster,nbytes", [
    (128, 900, 8, 192036),  # the main path's chunk: 113 columns a block
    (32, 900, 8, 62356),  # K5-sub's sub-blocks at m = 900
    (128, 1120, 8, 228740),  # the one-cluster envelope's edge at k = 128
    (128, 1121, None, None),
    (128, 2500, None, None),  # chip_smoke's chunk outside the one-cluster envelope (50 x 50 grid)
])
def test_chunk_cluster_plan_at_the_smoke_shapes(k, m, cluster, nbytes):
    """Inside one cluster's envelope the plans are as they were; past it
    (cluster None), where the single-block kernel ran, G > 1 clusters of 8
    take the chunk."""
    plan = tcru.chunk_cluster_plan(k, m)
    if cluster is None:
        assert plan.cluster == 8 and plan.clusters > 1 and _old_k1_takes(k, m)
    else:
        assert plan == _build.ClusterPlan(cluster, -(-m // cluster), nbytes)


def _layout(k, m, C, G=1, slices=3):
    """chunk_cluster_layout of csrc/root_update.cu, written out: (ld, floats)."""
    W = -(-m // (C * G))
    Sr = max(s for s in (1, 2, 4, 8, 16, 32) if s == 1 or s * k <= 512)
    ld = W if Sr == 32 else next(x for x in range(W, W + 2 * Sr) if x % (2 * Sr) == Sr)
    CT = -(-W // 32)
    S = max(1, 16 // CT)
    return ld, 4 + slices * k * ld + ld + 2 * k + 2 * C * (k + 1) + 2 * S * CT * 32 + 1


def _pred_layout(k, m, P, C, G=1, slices=2):
    """pred_cluster_layout of csrc/pred_stream.cu, written out: floats."""
    W = -(-m // (C * G))
    CT = -(-W // 32)
    S = max(1, 16 // CT)
    z, stencil = (k * W if slices == 2 else 0), (2 * k * P + k if slices else 0)
    return 4 + z + W + 2 * k + 2 * C * (k + 1) + 4 * k + S * CT * 32 + stencil + 2


@pytest.mark.parametrize("k,m,G,nbytes", [
    (128, 1121, 2, 4 * _layout(128, 1121, 8, 2)[1]),  # past one cluster: the first grid plan
    (128, 2048, 2, 4 * _layout(128, 2048, 8, 2)[1]),
    (128, 2240, 2, 228740),  # the edges of G = 2, 3 and 4 at k = 128
    (128, 2241, 3, 4 * _layout(128, 2241, 8, 3)[1]),
    (128, 3360, 3, 228740),
    (128, 3361, 4, 4 * _layout(128, 3361, 8, 4)[1]),
    (128, 4096, 4, 216676),  # bench.py's 64 x 64 grid: 128 columns a block, 32 SMs an output
    (128, 4480, 4, 228740),  # the G = 4 envelope's edge, where 4 clusters were the most
    (128, 4481, 5, 4 * _layout(128, 4481, 8, 5)[1]),  # past it: G = 5, where the single-block kernel ran
    (128, 8960, 8, 228740),  # the grid envelope's edge at G = 8
    (128, 8961, None, None),  # past it: the spread route
    (32, 4096, 1, 4 * _layout(32, 4096, 8)[1]),  # K5 sub's sub-blocks at m = 4,096: one cluster
])
def test_chunk_grid_plan_at_its_envelope_edges(k, m, G, nbytes):
    plan = tcru.chunk_cluster_plan(k, m)
    if G is None:
        assert plan is None and _old_k1_takes(k, m)
        splan, C = _route(_SizeQueries(), "K1", k, m)
        assert isinstance(splan, _build.SpreadPlan) and C == 8 and splan.clusters > 8
        return
    assert plan == _build.ClusterPlan(8, -(-m // (8 * G)), nbytes, G)
    assert _route(_SizeQueries(), "K1", k, m) == (plan, 8)
    # the C layout of the grid kernel, through its query, is the rule's
    assert 4 * _layout(k, m, 8, G)[1] == nbytes == _SizeQueries().ogp_chunk_cluster_smem(k, m, 8, G)


@pytest.mark.parametrize("k,m", [(128, 900), (32, 900)])
def test_pred_cluster_plan_picks_a_cluster_at_the_main_path_shapes(k, m):
    plan = tcps.pred_cluster_plan(k, m, 16)
    assert plan is not None and plan.cluster == 8 and plan.cols == 113
    assert plan.shared_bytes <= 232448


@pytest.mark.parametrize("k,m,inside", [
    (128, 3136, True),  # the 8-block envelope's edge at k = 128, P = 16
    (128, 3137, False),
    (512, 900, False),  # chip_smoke's chunk outside the envelope
])
def test_pred_cluster_plan_at_the_envelope_edge(k, m, inside):
    """``inside``: inside the 8-block envelope, as the plan was. Outside it,
    where the single-block kernel ran, 16 blocks take the chunk when they
    hold it (m = 3,137), else the spread route does (k = 512 at m = 900)."""
    plan = tcps.pred_cluster_plan(k, m, 16)
    assert (plan is not None and plan.cluster == 8) == inside
    if not inside:
        assert _old_k3_takes(k, m)
        got, C = _route(_SizeQueries(), "K3", k, m)
        if plan is None:
            assert isinstance(got, _build.SpreadPlan) and C == 8 and got.clusters > 1
        else:
            assert (got, C) == (plan, 16) and (plan.cluster, plan.clusters) == (16, 1)


@pytest.mark.parametrize("k,m,cluster,nbytes", [
    (128, 3137, 16, 139948),  # past 8 blocks: one cluster of 16
    (128, 4096, 16, 170648),  # bench.py's 64 x 64 grid: 256 columns a block
    (128, 6016, 16, 232056),  # the 16-block envelope's edge
    (128, 6017, None, None),  # past it: the spread route
    (342, 900, 8, None),  # the 8-block envelope's edge in k at m = 900
    (343, 900, 16, None),
])
def test_pred_wide_cluster_plan_at_its_envelope_edges(k, m, cluster, nbytes):
    plan = tcps.pred_cluster_plan(k, m, 16)
    if cluster is None:
        assert plan is None and _old_k3_takes(k, m)
        return
    assert (plan.cluster, plan.clusters, plan.cols) == (cluster, 1, -(-m // cluster))
    assert plan.shared_bytes == 4 * tcps._pred_cluster_floats(k, m, 16, cluster)[1] <= 232448
    assert nbytes is None or plan.shared_bytes == nbytes


# every k the wrappers take, at every m of SHAPES and at the sizes the port
# once refused: K1's single-block kernel past m = 28,912 (k = 128), 2^31
# elements of one (m, m) output past m = 46,340, K3's single-block kernel
# past m = 57,855 (k = 128), and the row-sharded streams' 65,536
ROUTE_KS = (1, 8, 32, 128, 512, 1024)
ROUTE_MS = sorted({m for _, m in SHAPES} | {28913, 46341, 57856, 65536})


@pytest.mark.parametrize("which", ["K1", "K3"])
@pytest.mark.parametrize("k", ROUTE_KS)
def test_every_chunk_has_a_recursion_kernel(which, k):
    """Every (k, m) gets a plan, never ValueError: the cluster plan where it
    holds the chunk, else the spread plan, whose layout fits a block (the
    written-out one of the stand-in), whose columns cover m, and whose G
    clusters the card holds at once; the most slices in shared memory
    first, at the most clusters the card holds."""
    lib = _SizeQueries()
    for m in ROUTE_MS:
        cluster_plan = tcru.chunk_cluster_plan(k, m) if which == "K1" else tcps.pred_cluster_plan(k, m, 16)
        plan, C = _route(lib, which, k, m)
        assert C == plan.cluster and plan.shared_bytes <= _build.MAX_SHARED_BYTES, (k, m)
        assert plan.cols <= _build.CLUSTER_COLS and plan.cols * plan.cluster * plan.clusters >= m, (k, m)
        if cluster_plan is not None:
            assert plan == cluster_plan, (k, m)
            continue
        assert isinstance(plan, _build.SpreadPlan) and plan.cluster == 8, (k, m)
        assert 1 <= plan.clusters <= _build.MAX_SPREAD_CLUSTERS == 16, (k, m)
        if which == "K1":
            nbytes, cap = lib.ogp_chunk_spread_smem(k, m, 8, plan.clusters, plan.slices), \
                lib.ogp_chunk_spread_capacity(k, m, 8, plan.clusters, plan.slices)
            more = [sl for sl in (3, 1, 0) if sl > plan.slices]
            fits = lambda sl: 4 * _layout(k, m, 8, plan.clusters, sl)[1] <= _build.MAX_SHARED_BYTES
        else:
            nbytes, cap = lib.ogp_pred_spread_smem(k, m, 16, 8, plan.clusters, plan.slices), \
                lib.ogp_pred_spread_capacity(k, m, 16, 8, plan.clusters, plan.slices)
            more = [sl for sl in (2, 1, 0) if sl > plan.slices]
            fits = lambda sl: 4 * _pred_layout(k, m, 16, 8, plan.clusters, sl) <= _build.MAX_SHARED_BYTES
        assert nbytes == plan.shared_bytes and cap >= plan.clusters, (k, m, plan)
        # no slice count kept more in shared memory at any G the card holds
        assert not any(fits(sl) for sl in more) or plan.clusters < 16, (k, m, plan)


@pytest.mark.parametrize("k,m,slices,G", [
    (128, 8961, 3, 15),  # past the grid envelope: U, P, R in shared memory on 15 clusters (120 SMs)
    (128, 16384, 3, 15),
    (128, 32400, 1, 15),  # a 180 x 180 grid: U alone in shared memory, P and R (33 MB) in device memory
    (128, 46656, 1, 15),
    (128, 65536, 0, 16),  # none in shared memory: two blocks a SM, 16 clusters
    (1024, 2000, 1, 15),  # the widest chunk: U alone in shared memory
])
def test_chunk_spread_plan_at_the_smoke_shapes(k, m, slices, G):
    plan, C = _route(_SizeQueries(), "K1", k, m)
    assert isinstance(plan, _build.SpreadPlan) and (plan.slices, plan.clusters, C) == (slices, G, 8)
    assert plan.cols == -(-m // (8 * G)) and plan.shared_bytes == 4 * _layout(k, m, 8, G, slices)[1]


@pytest.mark.parametrize("k,m,P,slices,G", [
    (128, 6017, 16, 2, 16),  # past 16 blocks: Z and the stencil in shared memory on 16 clusters
    (128, 16384, 16, 2, 16),
    (128, 65536, 16, 1, 16),  # the row-sharded stream's width: Z in device memory
    (512, 900, 16, 2, 15),  # K3's wide chunk at the main path's m
    (512, 900, 64, 0, 16),  # a 3-D stencil: its k P entries read from device memory
])
def test_pred_spread_plan_at_the_smoke_shapes(k, m, P, slices, G):
    plan, C = _route(_SizeQueries(), "K3", k, m, P)
    assert isinstance(plan, _build.SpreadPlan) and (plan.slices, plan.clusters, C) == (slices, G, 8)
    assert plan.cols == -(-m // (8 * G)) and plan.shared_bytes == 4 * _pred_layout(k, m, P, 8, G, slices)


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_spread_plan_that_is_not_the_kernel_layout_raises(which):
    for skew in (4, -4):
        with pytest.raises(RuntimeError, match="they must be changed together"):
            _route(_SizeQueries(skew), which, 128, 32400 if which == "K1" else 16384)


# (Bd, rows, m) past 2^31 elements of L (or C), where the parent refused
BIG = [(1, 46341, 46341), (2, 32768, 32768), (1, 23328, 93312)]


@pytest.mark.parametrize("Bd,rows,m", BIG)
def test_size_checks_take_every_size_the_card_holds(card, Bd, rows, m):
    """The kernels form 64-bit offsets: K1, K2, K3, K4 and the row-shard
    stages take roots and caches of 2^31 elements and more (meta tensors:
    nothing is allocated), each launching its entry once."""
    assert Bd * rows * m >= 2**31
    k, P = 128, 16
    X, F = _meta(Bd, rows, m), _meta(Bd, k, m)
    idx, wv, y = _meta(k, P, dtype=torch.int32), _meta(Bd, k, P), _meta(Bd, k)
    tcru.rank1_apply_rows(X, X, _meta(Bd, m))
    tcru.chunk_gather_rows(X, idx, wv, 0)
    tcru.chunk_factors(F)
    tcru.chunk_apply_rows(X, X, F, F, F)
    tcps.pred_gather_rows(X, _meta(Bd, rows), idx, _meta(k, P), 0)
    tcps.pred_factors(idx, _meta(k, P), F, y, y, y)
    tcps.pred_apply_rows(X, _meta(Bd, rows), F, y, 0)
    calls = ["ogp_rank1_apply_rows", "ogp_chunk_gather_rows", "ogp_chunk_factors", "ogp_chunk_apply_rows",
             "ogp_pred_gather_rows", "ogp_pred_factors", "ogp_pred_apply_rows"]
    if rows == m:
        L = _meta(Bd, m, m)
        tcru.rank1_apply(L, L, _meta(Bd, m))
        tcru.rank1_update(L, L, L, _meta(Bd, m, 1))
        tcru.blocked_chunk(L, L, idx, wv)
        tcps.pred_chunk(L, _meta(Bd, m), idx, _meta(k, P), y, y)
        calls += ["ogp_rank1_apply", "ogp_rank1_update", "ogp_blocked_chunk", "ogp_pred_chunk"]
    got = [name for name, _ in card.calls if name != "ogp_rank1_update_tiles"]
    assert got == calls
    assert tcru.chunk_factors.spread_launches == 1 and tcps.pred_factors.spread_launches == 1


def test_size_checks_still_refuse_a_batch_past_the_launch_grid(card):
    """The launch grid's y and z extents still bound Bd: 2 Bd for K1's and
    K2's kernels (L and B), Bd for K3's; the wrappers raise before any
    launch."""
    _build.check_grid(_build.MAX_GRID_YZ // 2, 2)
    _build.check_grid(_build.MAX_GRID_YZ)
    k, P, m = 8, 4, 16
    idx = _meta(k, P, dtype=torch.int32)
    Bd = _build.MAX_GRID_YZ // 2 + 1
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        tcru.rank1_apply(_meta(Bd, m, m), _meta(Bd, m, m), _meta(Bd, m))
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        tcru.chunk_factors(_meta(Bd, k, m))
    Bd = _build.MAX_GRID_YZ + 1
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        tcps.pred_factors(idx, _meta(k, P), _meta(Bd, k, m), *(_meta(Bd, k) for _ in range(3)))
    assert card.calls == []


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_wrappers_refuse_a_plan_that_is_not_the_kernel_layout(which):
    """The Python shape rule mirrors the CUDA layout of one block; the
    route asks the library for the layout's bytes before a shape's first
    launch and raises if the two have drifted apart."""
    for skew in (4, -4):
        with pytest.raises(RuntimeError, match="they must be changed together"):
            _route(_SizeQueries(skew), which, 128, 900)


def test_no_cluster_raises_naming_the_cluster():
    plan = _build.ClusterPlan(8, 113, 184792)
    with pytest.raises(RuntimeError, match="cannot hold one cluster of 8 blocks with 184792 bytes"):
        _build.launch_check(_build.NO_CLUSTER, "blocked_chunk", plan)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.launch_check(1, "blocked_chunk", plan)
    _build.launch_check(0, "blocked_chunk", plan)


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
    if nbytes is None:  # a grid plan, which the fused kernel does not take
        assert plan.clusters > 1
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
        self.calls.append(("per sub-block", args[-3], args[-2]))  # C, then the spread slices
        return 0


@pytest.mark.parametrize("m,route,cluster", [(900, "fused", 8), (1120, "fused", 8), (2500, "per sub-block", 8),
                                             (20000, "per sub-block", 8)])
def test_k5_sub_takes_the_fused_kernel_inside_its_envelope(monkeypatch, m, route, cluster):
    """(128, 32, 900) and (128, 32, 1120), K1's edge, run the fused cluster
    kernel; (128, 32, 2500) one sub-block at a time, each on K1's cluster
    kernel at k = 32, and m = 20,000 one sub-block at a time on K1's route
    at k = 32, G = 8 clusters of 8 (where the single-block kernel ran):
    every shape taken before still runs."""
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    k, sub, P = 128, 32, 16
    meta = dict(device="meta", dtype=torch.float32)
    L = torch.empty((1, m, m), **meta)
    idx, wv = torch.empty((k, P), device="meta", dtype=torch.int32), torch.empty((1, k, P), **meta)
    lib = _SubLib()
    before = (tcru.blocked_chunk.sub_launches, tcru.blocked_chunk.sub_cluster_launches)
    try:
        tcru._chunk_sub(lib, L, L, idx, wv, sub)
        assert lib.calls == [(route, cluster) if route == "fused" else (route, cluster, -1)]
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


class _Card(_SizeQueries):
    """Stands in for the libraries on a card that holds ``capacity``
    clusters of 8 of K1's grid kernel and of the spread kernels at once:
    the layout and capacity queries answer, and every other C entry is
    recorded with its arguments."""

    def __init__(self, capacity=16, skew=0):
        super().__init__(skew)
        self.capacity = capacity
        self.calls = []

    def ogp_chunk_grid_capacity(self, k, m, C, G):
        return self.capacity

    def ogp_chunk_spread_capacity(self, k, m, C, G, slices):
        return self.capacity

    def ogp_pred_spread_capacity(self, k, m, P, C, G, slices):
        return self.capacity

    @staticmethod
    def ogp_chunk_apply_smem(k, m, C):
        return 4 * tcru._chunk_apply_floats(k, m, C)[1]

    @staticmethod
    def ogp_pred_apply_smem(AM):
        return 4 * 3 * 16 * (AM + 128)

    def __getattr__(self, name):
        if not name.startswith("ogp_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.fixture
def card(monkeypatch):
    """The wrappers' CUDA branch on meta tensors, routed to a _Card: the
    plan, the waves and the counters, with no kernel."""
    lib = _Card()
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(_build, "card_sms", lambda device: 132)
    monkeypatch.setattr(tcru, "_root_update_lib", lambda: lib)
    monkeypatch.setattr(tcps, "_pred_stream_lib", lambda: lib)
    for fn in (tcru.blocked_chunk, tcru.chunk_factors):
        for attr in ("launches", "cluster_launches", "grid_cluster_launches", "spread_launches"):
            monkeypatch.setattr(fn, attr, 0)
    for fn in (tcps.pred_chunk, tcps.pred_factors):
        for attr in ("launches", "cluster_launches", "wide_cluster_launches", "spread_launches"):
            monkeypatch.setattr(fn, attr, 0)
    monkeypatch.setattr(tcru.chunk_apply_plan, "shapes", collections.Counter())
    monkeypatch.setattr(tcps.pred_apply_plan, "shapes", collections.Counter())
    return lib


# Bd -> the outputs a wave of K1's grid recursion launches at m = 4,096 (G = 4)
# on a card holding 16 clusters of 8 at once: 4, in as many waves as that
# takes (6 outputs: 4, then 2)
@pytest.mark.parametrize("Bd,wave", [(1, 1), (2, 2), (6, 4)])
def test_k1_chunk_at_m4096_takes_the_grid_kernel_in_waves(card, Bd, wave):
    k, P, m = 128, 16, 4096
    L = _meta(Bd, m, m)
    tcru.blocked_chunk(L, L, _meta(k, P, dtype=torch.int32), _meta(Bd, k, P))
    tcru.chunk_factors(_meta(Bd, k, m))
    (name, args), (fname, fargs) = card.calls
    # the slots of the cross-cluster sums, then (Bd, k, P, m, G, wave, AC, C)
    assert name == "ogp_blocked_chunk" and args[9] is not None and args[10:18] == (Bd, k, P, m, 4, wave, 8, 8)
    assert fname == "ogp_chunk_factors" and fargs[4] is not None and fargs[5:11] == (Bd, k, m, 4, wave, 8)
    assert args[18] == fargs[11] == -1  # not spread: G = 4 is the grid kernel
    for fn in (tcru.blocked_chunk, tcru.chunk_factors):
        assert (fn.launches, fn.cluster_launches, fn.grid_cluster_launches, fn.spread_launches) == (1, 1, 1, 0)


def test_k1_chunk_inside_one_cluster_is_launched_as_before(card):
    """m = 900: one cluster of 8, G = 1, no slots, no grid launch; by the
    carried kernel (G = 1, spread -1), on the one-cluster layout."""
    k, P, m, Bd = 128, 16, 900, 2
    L = _meta(Bd, m, m)
    tcru.blocked_chunk(L, L, _meta(k, P, dtype=torch.int32), _meta(Bd, k, P))
    (name, args), = card.calls
    assert name == "ogp_blocked_chunk" and args[9] is None and args[10:18] == (Bd, k, P, m, 1, Bd, 8, 8)
    assert args[18:] == (-1, None)  # spread -1, then the stream
    assert (tcru.blocked_chunk.cluster_launches, tcru.blocked_chunk.grid_cluster_launches) == (1, 0)


@pytest.mark.parametrize("m,G,spread", [(256, 1, -1), (900, 1, -1), (1120, 1, -1), (1121, 2, -1), (4096, 4, -1),
                                        (20000, 16, 1)])
@pytest.mark.parametrize("Bd", [1, 2])
def test_k1_carried_launches_count_with_cluster_launches(card, m, G, spread, Bd):
    """blocked_chunk and chunk_factors hand their entries G = 1 and no
    spread, the carried kernel's route, wherever one cluster of 8 holds the
    chunk (m <= 1,120 at k = 128, the layout of chunk_cluster_plan), and
    count it in cluster_launches and not in grid_cluster_launches; G > 1
    clusters (grid_cluster_launches) and the spread route (spread_launches)
    keep their kernels."""
    k, P = 128, 16
    L = _meta(Bd, m, m)
    tcru.blocked_chunk(L, L, _meta(k, P, dtype=torch.int32), _meta(Bd, k, P))
    tcru.chunk_factors(_meta(Bd, k, m))
    (name, args), (fname, fargs) = card.calls
    assert (name, fname) == ("ogp_blocked_chunk", "ogp_chunk_factors")
    assert args[14] == fargs[8] == G and args[18] == fargs[11] == spread
    for fn in (tcru.blocked_chunk, tcru.chunk_factors):
        assert (fn.launches, fn.cluster_launches, fn.grid_cluster_launches, fn.spread_launches) == \
            (1, spread < 0, G > 1 and spread < 0, spread >= 0)


def test_k1_carried_route_refuses_a_plan_that_is_not_the_kernel_layout(monkeypatch):
    """The carried kernel runs on chunk_cluster_layout: a library whose
    layout query drifts from the plan raises before anything launches."""
    lib = _Card(skew=4)
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(tcru, "_root_update_lib", lambda: lib)
    monkeypatch.setattr(tcru.blocked_chunk, "cluster_launches", 0)
    k, P, m = 128, 16, 256
    with pytest.raises(RuntimeError, match="they must be changed together"):
        tcru.blocked_chunk(_meta(1, m, m), _meta(1, m, m), _meta(k, P, dtype=torch.int32), _meta(1, k, P))
    with pytest.raises(RuntimeError, match="they must be changed together"):
        tcru.chunk_factors(_meta(1, k, m))
    assert lib.calls == [] and tcru.blocked_chunk.cluster_launches == 0


@pytest.mark.parametrize("capacity", [3, 0])
def test_k1_grid_plan_the_card_cannot_hold_raises_naming_it(card, capacity):
    """G = 4 clusters of one output that do not fit the card at once would
    wait on each other forever, so the route never takes that plan. It
    takes the spread route on the G <= 3 clusters the card holds; a card
    that holds none raises, naming the spread clusters it lacks, and
    launches nothing."""
    card.capacity = capacity
    k, P, m = 128, 16, 4096
    plan = tcru.chunk_cluster_plan(k, m)
    assert plan.clusters == 4
    L = _meta(1, m, m)
    if capacity == 0:
        for _ in range(2):  # a failed route is not kept: the second call raises too
            with pytest.raises(RuntimeError, match="holds no clusters of 8 blocks of the spread recursion"):
                tcru.blocked_chunk(L, L, _meta(k, P, dtype=torch.int32), _meta(1, k, P))
        assert card.calls == [] and tcru.blocked_chunk.launches == 0
        return
    assert _route(card, "K1", k, m)[0] != plan
    tcru.blocked_chunk(L, L, _meta(k, P, dtype=torch.int32), _meta(1, k, P))
    (name, args), = card.calls
    # U alone in shared memory (3 slices of 171 columns do not fit a block)
    assert name == "ogp_blocked_chunk" and args[10:19] == (1, k, P, m, 3, 1, 8, 8, 1)
    assert (tcru.blocked_chunk.spread_launches, tcru.blocked_chunk.cluster_launches) == (1, 0)


def test_k1_grid_plan_that_is_not_the_kernel_layout_raises():
    for skew in (4, -4):
        with pytest.raises(RuntimeError, match="they must be changed together"):
            _route(_SizeQueries(skew), "K1", 128, 4096)


def test_no_grid_cluster_raises_naming_the_clusters():
    plan = tcru.chunk_cluster_plan(128, 4096)
    with pytest.raises(RuntimeError, match="cannot hold 4 clusters of 8 blocks with 216676 bytes"):
        _build.launch_check(_build.NO_CLUSTER, "blocked_chunk", plan)


class _Queries(_Card):
    """A _Card that counts its layout and capacity queries."""

    def __init__(self, skew=0):
        super().__init__(skew=skew)
        self.queries = 0

    def __getattribute__(self, name):
        if name.endswith(("_smem", "_capacity")):
            object.__getattribute__(self, "__dict__")["queries"] += 1
        return object.__getattribute__(self, name)


def _chunk(which, m, Bd=2, k=128, P=16):
    """One K1 (blocked_chunk) or K3 (pred_chunk) chunk on meta tensors."""
    idx = _meta(k, P, dtype=torch.int32)
    if which == "K1":
        tcru.blocked_chunk(_meta(Bd, m, m), _meta(Bd, m, m), idx, _meta(Bd, k, P))
    else:
        tcps.pred_chunk(_meta(Bd, m, m), _meta(Bd, m), idx, _meta(k, P), _meta(Bd, k), _meta(Bd, k))


@pytest.mark.parametrize("which,m", [("K1", 256), ("K1", 900), ("K1", 4096), ("K1", 20000), ("K3", 900),
                                     ("K3", 4096), ("K3", 6017)])
def test_a_second_chunk_of_a_shape_asks_the_library_nothing(card, monkeypatch, which, m):
    """A shape's route is decided at its first chunk, layout and capacity
    queries included (one cluster, G > 1 clusters in waves, spread over the
    card; the apply's layout), and kept: the second chunk asks the library
    nothing and launches the entry again."""
    lib = _Queries()
    monkeypatch.setattr(tcru, "_root_update_lib", lambda: lib)
    monkeypatch.setattr(tcps, "_pred_stream_lib", lambda: lib)
    _chunk(which, m)
    first = lib.queries
    _chunk(which, m)
    assert first >= 2 and lib.queries == first and len(lib.calls) == 2
    assert lib.calls[0][0] == lib.calls[1][0] and lib.calls[0][1][-9:] == lib.calls[1][1][-9:]


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_a_fresh_skewed_library_raises_after_a_sound_one_kept_the_shape(card, monkeypatch, which):
    """Routes are kept with their library: a sound library's route of a
    shape does not stand for a fresh library's, whose layout drifted from
    the plan, which raises before it launches anything."""
    _chunk(which, 900)
    for skew in (4, -4):
        skewed = _Card(skew=skew)
        monkeypatch.setattr(tcru, "_root_update_lib", lambda: skewed)
        monkeypatch.setattr(tcps, "_pred_stream_lib", lambda: skewed)
        with pytest.raises(RuntimeError, match="they must be changed together"):
            _chunk(which, 900)
        assert skewed.calls == []
    assert len(card.calls) == 1


@pytest.mark.parametrize("m,cluster,wide", [(900, 8, 0), (4096, 16, 1)])
def test_k3_chunk_takes_its_cluster(card, m, cluster, wide):
    k, P, Bd = 128, 16, 1
    y = _meta(Bd, k)
    tcps.pred_chunk(_meta(Bd, m, m), _meta(Bd, m), _meta(k, P, dtype=torch.int32), _meta(k, P), y, y)
    tcps.pred_factors(_meta(k, P, dtype=torch.int32), _meta(k, P), _meta(Bd, k, m), y, y, y)
    (name, args), (fname, fargs) = card.calls
    # (Cl, G, wave, spread, stream) end both entries' arguments
    assert name == "ogp_pred_chunk" and args[-5:-1] == (cluster, 1, Bd, -1)
    assert fname == "ogp_pred_factors" and fargs[-5:-1] == (cluster, 1, Bd, -1)
    for fn in (tcps.pred_chunk, tcps.pred_factors):
        assert (fn.launches, fn.cluster_launches, fn.wide_cluster_launches, fn.spread_launches) == (1, 1, wide, 0)


# --------------------------------------------------------------------------
# (b) K1's summation order
# --------------------------------------------------------------------------


# (C, G): one cluster of C blocks (the ids of the first cases), or G of them
ORDERS = [(2, 1), (4, 1), (2, 2), (4, 2), (2, 3), (4, 3)]
ORDER_IDS = ["2", "4", "2-G2", "4-G2", "2-G3", "4-G3"]


@pytest.mark.parametrize("C,G", ORDERS, ids=ORDER_IDS)
@pytest.mark.parametrize("repeats", [False, True])
def test_k1_cluster_order_matches_pallas_and_the_plain_recursion(C, G, repeats):
    import jax.numpy as jnp
    from online_gp_tpu.ops import root_update as jru
    from online_gp_tpu.ops.pallas_root_update import pallas_blocked_chunk_batched

    rng = np.random.default_rng(30 + C + 10 * repeats + 100 * (G - 1))
    Bd = 2
    L, B = _roots(rng, Bd, M, np.float32)
    idx, w = _stencil(rng, K, M, repeats)
    wv = (w[None] * np.array([1.0, 0.7])[:, None, None]).astype(np.float32)
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv[b]), M)) for b in range(Bd)])
    p0 = torch.einsum("bkp,bkpm->bkm", torch.tensor(wv), torch.tensor(B)[:, torch.tensor(idx)])
    U, Pm, R = cluster_chunk_factors(p0, C, G)
    tL = torch.tensor(L) + (torch.tensor(L) @ R.mT) @ U
    tB = torch.tensor(B) + (torch.tensor(B) @ Pm.mT) @ U
    jL, jB = pallas_blocked_chunk_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(S), interpret=True)
    _close(jL, tL, 1e-5)
    _close(jB, tB, 1e-5)
    # at float64 the reassociation is the plain recursion's to rounding
    p0d = p0.double()
    for a, b in zip(blocked_factors(p0d), cluster_chunk_factors(p0d, C, G)):
        _close(a, b, 1e-9)
    # and at float32, within the chunk tolerance of the plain version
    for a, b in zip(blocked_factors(p0), (U, Pm, R)):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("repeats", [False, True])
def test_k1_carried_order_matches_pallas_and_the_plain_recursion(C, repeats):
    """The carried kernel's order (the dots with P carried in the raw rows, one
    sum a step) on the cases of the cluster order's test, on one cluster."""
    import jax.numpy as jnp
    from online_gp_tpu.ops import root_update as jru
    from online_gp_tpu.ops.pallas_root_update import pallas_blocked_chunk_batched

    rng = np.random.default_rng(30 + C + 10 * repeats)
    Bd = 2
    L, B = _roots(rng, Bd, M, np.float32)
    idx, w = _stencil(rng, K, M, repeats)
    wv = (w[None] * np.array([1.0, 0.7])[:, None, None]).astype(np.float32)
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv[b]), M)) for b in range(Bd)])
    p0 = torch.einsum("bkp,bkpm->bkm", torch.tensor(wv), torch.tensor(B)[:, torch.tensor(idx)])
    U, Pm, R = carried_chunk_factors(p0, C)
    tL = torch.tensor(L) + (torch.tensor(L) @ R.mT) @ U
    tB = torch.tensor(B) + (torch.tensor(B) @ Pm.mT) @ U
    jL, jB = pallas_blocked_chunk_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(S), interpret=True)
    _close(jL, tL, 1e-5)
    _close(jB, tB, 1e-5)
    p0d = p0.double()
    for a, b in zip(blocked_factors(p0d), carried_chunk_factors(p0d, C)):
        _close(a, b, 1e-9)
    for a, b in zip(blocked_factors(p0), (U, Pm, R)):
        _close(a, b, 1e-5)


def test_k1_carried_order_keeps_a_stream_as_close_as_the_cluster_order():
    """32 chunks of 128 points at m = 256 in float32, on one cluster of 8:
    the largest deviation of L L^T from the float64 stream's, over its
    largest entry, in the carried order is within 1.5 times the cluster
    kernel's order."""
    rng = np.random.default_rng(0)
    m, k = 256, 128
    L, B = (torch.tensor(x) for x in _roots(rng, 1, m, np.float64))
    chunks = [_stencil(rng, k, m, False) for _ in range(32)]
    roots = {}
    for name, factors, dtype in (("float64", blocked_factors, torch.float64),
                                 ("cluster", lambda p: cluster_chunk_factors(p, 8), torch.float32),
                                 ("carried", lambda p: carried_chunk_factors(p, 8), torch.float32)):
        Lc, Bc = L.to(dtype), B.to(dtype)
        for idx, w in chunks:
            p0 = torch.einsum("kp,bkpm->bkm", torch.tensor(w, dtype=dtype), Bc[:, torch.tensor(idx)])
            U, Pm, R = factors(p0)
            Lc, Bc = Lc + (Lc @ R.mT) @ U, Bc + (Bc @ Pm.mT) @ U
        roots[name] = Lc.double() @ Lc.double().mT
    A = roots["float64"]
    dev = {name: float((roots[name] - A).abs().max() / A.abs().max()) for name in ("cluster", "carried")}
    assert dev["carried"] <= 1.5 * dev["cluster"], dev


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


@pytest.mark.parametrize("C,G", ORDERS + [(16, 1)], ids=ORDER_IDS + ["16"])
@pytest.mark.parametrize("repeats", [False, True])
def test_k3_cluster_order_matches_pallas_and_the_plain_recursion(C, G, repeats):
    import jax.numpy as jnp
    from online_gp_tpu.ops import root_update as jru
    from online_gp_tpu.ops.pallas_pred_stream import pad_cache_to_tile, pallas_pred_chunk

    rng = np.random.default_rng(40 + C + 10 * repeats + 100 * (G - 1))
    Cm, mu, idx, w, y, nz = _pred_problem(rng, 1, repeats)
    S = stencil_rows(torch.tensor(idx), torch.tensor(w), M)
    Ct, mut = torch.tensor(Cm), torch.tensor(mu)
    c0w, mu0w = S @ Ct, mut @ S.mT
    Z, r, pm, pv = cluster_pred_factors(S, c0w, mu0w, torch.tensor(y), torch.tensor(nz), C, G)
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
    for a, b in zip(pred_chunk_factors(*args64), cluster_pred_factors(*args64, C, G)):
        _close(a, b, 1e-9)


# --------------------------------------------------------------------------
# (c2) the spread kernels' summation order
# --------------------------------------------------------------------------

# N blocks an output: one cluster of 3 or 7 (N < 8), else N / 8 clusters of 8,
# each block's partials added in rank order within its cluster and the
# clusters' sums in cluster order (the spread kernels' two levels)
SPREAD_BLOCKS = [3, 7, 16]


def _spread_split(N):
    C = min(N, _build.CLUSTER_SIZE)
    return C, N // C


@pytest.mark.parametrize("N", SPREAD_BLOCKS)
@pytest.mark.parametrize("repeats", [False, True])
def test_k1_spread_order_matches_jax_and_pallas(N, repeats):
    import jax.numpy as jnp
    from online_gp_tpu.ops import root_update as jru
    from online_gp_tpu.ops.pallas_root_update import pallas_blocked_chunk_batched

    rng = np.random.default_rng(60 + N + 10 * repeats)
    Bd, (C, G) = 2, _spread_split(N)
    L, B = _roots(rng, Bd, M, np.float64)
    idx, w = _stencil(rng, K, M, repeats)
    wv = w[None] * np.array([1.0, 0.7])[:, None, None]
    p0 = torch.einsum("bkp,bkpm->bkm", torch.tensor(wv), torch.tensor(B)[:, torch.tensor(idx)])
    got = cluster_chunk_factors(p0, C, G)
    for b in range(Bd):
        for want, g in zip(jru.blocked_factors_xla(jnp.asarray(p0[b].numpy())), got):
            _close(want, g[b], 1e-10)
    # at float32, the chunk against the Pallas kernel in interpret mode
    L32, B32, wv32 = L.astype(np.float32), B.astype(np.float32), wv.astype(np.float32)
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv32[b]), M))
                  for b in range(Bd)])
    p32 = torch.einsum("bkp,bkpm->bkm", torch.tensor(wv32), torch.tensor(B32)[:, torch.tensor(idx)])
    U, Pm, R = cluster_chunk_factors(p32, C, G)
    jL, jB = pallas_blocked_chunk_batched(jnp.asarray(L32), jnp.asarray(B32), jnp.asarray(S), interpret=True)
    _close(jL, torch.tensor(L32) + (torch.tensor(L32) @ R.mT) @ U, 1e-5)
    _close(jB, torch.tensor(B32) + (torch.tensor(B32) @ Pm.mT) @ U, 1e-5)


@pytest.mark.parametrize("N", SPREAD_BLOCKS)
@pytest.mark.parametrize("repeats", [False, True])
def test_k3_spread_order_matches_jax_and_pallas(N, repeats):
    import jax.numpy as jnp
    from online_gp_tpu.ops import pred_stream as jps
    from online_gp_tpu.ops import root_update as jru
    from online_gp_tpu.ops.pallas_pred_stream import pad_cache_to_tile, pallas_pred_chunk

    rng = np.random.default_rng(70 + N + 10 * repeats)
    C, G = _spread_split(N)
    Cm, mu, idx, w, y, nz = _pred_problem(rng, 1, repeats)
    S = stencil_rows(torch.tensor(idx), torch.tensor(w, dtype=torch.float64), M)
    Ct, mut = torch.tensor(Cm, dtype=torch.float64), torch.tensor(mu, dtype=torch.float64)
    args64 = (S, S @ Ct, mut @ S.mT, torch.tensor(y, dtype=torch.float64), torch.tensor(nz, dtype=torch.float64))
    got = cluster_pred_factors(*args64, C, G)
    want = jps.pred_chunk_factors(*(jnp.asarray(a.numpy()[0] if a.dim() > 1 and a is not S else a.numpy())
                                    for a in args64))
    for wj, g in zip(want, got):
        _close(wj, g[0], 1e-10)
    # at float32, the chunk against the Pallas kernel in interpret mode
    S32 = stencil_rows(torch.tensor(idx), torch.tensor(w), M)
    c0w, mu0w = S32 @ torch.tensor(Cm), torch.tensor(mu) @ S32.mT
    Z, r, pm, pv = cluster_pred_factors(S32, c0w, mu0w, torch.tensor(y), torch.tensor(nz), C, G)
    Sj = jnp.pad(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(w), M), ((0, 0), (0, 128 - M)))
    C_p, mu_p, _ = pad_cache_to_tile(jnp.asarray(Cm), jnp.asarray(mu))
    Cj, muj, pmj, pvj = pallas_pred_chunk(C_p[0], mu_p[0], Sj, jnp.asarray(y[0]), jnp.asarray(nz[0]), interpret=True)
    _close(np.asarray(Cj)[:M, :M], (torch.tensor(Cm) - Z.mT @ Z)[0], 2e-4)
    _close(np.asarray(muj)[:M], (torch.tensor(mu) + (Z.mT @ r[..., None])[..., 0])[0], 2e-4)
    _close(pmj, pm[0], 2e-4)
    _close(pvj, pv[0], 2e-4)


# --------------------------------------------------------------------------
# (d) on the card
# --------------------------------------------------------------------------


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the recursion kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bitwise(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b)), "two calls on the same inputs differ"


def _card_roots(rng, Bd, m, dev):
    """(L, B) float32 on the card: L the Cholesky factor of W W^T / m + I,
    B = L^-T, formed in float64."""
    W = torch.tensor(rng.normal(size=(Bd, m, m)), dtype=torch.float64, device=dev)
    L = torch.linalg.cholesky(W @ W.mT / m + torch.eye(m, dtype=torch.float64, device=dev))
    B = torch.linalg.inv(L).mT
    return L.float().contiguous(), B.float().contiguous()


def _card_stencil(rng, k, m, dev):
    """(idx (k, 16) int32, w (k, 16)) with weights positive, summing to 1."""
    w = rng.uniform(0.0, 1.0, (k, 16))
    return (torch.tensor(rng.integers(0, m, (k, 16)), dtype=torch.int32, device=dev),
            torch.tensor(w / w.sum(1, keepdims=True), dtype=torch.float32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("Bd,m,G", [(1, 4096, 4), (2, 4096, 4), (1, 1120, 1), (1, 1121, 2), (1, 4480, 4),
                                    (1, 4481, 5), (1, 8960, 8), (1, 8961, 0), (1, 16384, 0), (2, 16384, 0),
                                    (1, 32400, 0), (1, 256, 1), (2, 256, 1), (1, 900, 1), (2, 900, 1)])
def test_k1_chunk_kernel_matches_its_plain_version(gpu, Bd, m, G):
    """K1 at k = 128 on G clusters of 8 (0: spread over the card, as many
    clusters as it holds; G = 1 by the carried kernel) at m = 256, 900 and
    4,096, the envelopes' edges and past them, to 1e-5 (allclose) of the
    plain version, bitwise the same on a second call; with chunk_factors
    on the chunk's p0 at 1e-5 of its own plain version."""
    rng = np.random.default_rng(Bd + m)
    k = 128
    L, B = _card_roots(rng, Bd, m, gpu)
    idx, w = _card_stencil(rng, k, m, gpu)
    wv = (w[None] * torch.tensor([1.0, 0.7][:Bd], device=gpu)[:, None, None]).contiguous()
    plan = tcru.chunk_cluster_plan(k, m)
    assert (0 if plan is None else plan.clusters) == G
    carried = G == 1
    # carried launches: cluster_launches less grid_cluster_launches
    counts = lambda: (tcru.blocked_chunk.launches, tcru.blocked_chunk.grid_cluster_launches,
                      tcru.blocked_chunk.spread_launches,
                      tcru.blocked_chunk.cluster_launches - tcru.blocked_chunk.grid_cluster_launches,
                      tcru.chunk_factors.cluster_launches - tcru.chunk_factors.grid_cluster_launches)
    before = counts()
    got = tcru.blocked_chunk(L.clone(), B.clone(), idx, wv)
    again = tcru.blocked_chunk(L.clone(), B.clone(), idx, wv)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2 * (G > 1), 2 * (G == 0), 2 * carried, 0)
    _bitwise(got, again)
    for g, want in zip(got, tcru.blocked_chunk_plain(L, B, idx, wv)):
        assert torch.allclose(g, want, rtol=1e-5, atol=1e-5), float((g - want).abs().max())
    p0 = torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()]).contiguous()
    got, again = tcru.chunk_factors(p0), tcru.chunk_factors(p0)
    torch.cuda.synchronize()
    assert counts()[-1] - before[-1] == 2 * carried
    _bitwise(got, again)
    for g, want in zip(got, tcru.chunk_factors_plain(p0)):
        scale = max(float(want.abs().max()), 1.0)
        assert float((g - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("Bd", [1, 2])
def test_k5_sub_per_sub_block_chunk_matches_its_plain_version(gpu, Bd):
    """K5 sub at k = 128, sub = 32, m = 2,500, past its fused kernel's one
    cluster: one sub-block at a time, each sub-block's recursion on one
    cluster of 8 by the carried kernel (chunk_cluster_plan(32, 2500)), to
    1e-5 (allclose) of the plain version, bitwise the same on a second
    call."""
    rng = np.random.default_rng(Bd + 2500)
    k, sub, m = 128, 32, 2500
    assert tcru.chunk_cluster_plan(k, m).clusters > 1 and tcru.chunk_cluster_plan(sub, m).clusters == 1
    L, B = _card_roots(rng, Bd, m, gpu)
    idx, w = _card_stencil(rng, k, m, gpu)
    wv = (w[None] * torch.tensor([1.0, 0.7][:Bd], device=gpu)[:, None, None]).contiguous()
    before = (tcru.blocked_chunk.sub_launches, tcru.blocked_chunk.sub_cluster_launches)
    got = tcru.blocked_chunk(L.clone(), B.clone(), idx, wv, sub=sub)
    again = tcru.blocked_chunk(L.clone(), B.clone(), idx, wv, sub=sub)
    torch.cuda.synchronize()
    assert (tcru.blocked_chunk.sub_launches - before[0], tcru.blocked_chunk.sub_cluster_launches - before[1]) == (2, 0)
    _bitwise(got, again)
    for g, want in zip(got, tcru.blocked_chunk_plain(L, B, idx, wv, sub=sub)):
        assert torch.allclose(g, want, rtol=1e-5, atol=1e-5), float((g - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("Bd,m,cluster", [(1, 4096, 16), (2, 4096, 16), (1, 3136, 8), (1, 3137, 16),
                                          (1, 6016, 16), (1, 6017, 0), (2, 8192, 0), (1, 16384, 0)])
def test_k3_chunk_kernel_matches_its_plain_version(gpu, Bd, m, cluster):
    """K3 at k = 128, P = 16 on a cluster of 8 or 16 blocks (0: spread over
    the card), to 2e-4 (allclose) of the plain version, bitwise the same on
    a second call; pred_factors on the chunk's partials too."""
    rng = np.random.default_rng(Bd + m + 1)
    k = 128
    f32 = dict(dtype=torch.float32, device=gpu)
    G = torch.tensor(rng.normal(size=(Bd, m, 64)), **f32)
    C = (G @ G.mT / 64 + 0.1 * torch.eye(m, device=gpu)).contiguous()
    mu = torch.tensor(rng.normal(size=(Bd, m)), **f32)
    idx, w = _card_stencil(rng, k, m, gpu)
    y = torch.tensor(rng.normal(size=(Bd, k)), **f32)
    nz = torch.ones((Bd, k), **f32)
    plan = tcps.pred_cluster_plan(k, m, 16)
    assert (0 if plan is None else plan.cluster) == cluster
    before = tcps.pred_chunk.spread_launches
    got = tcps.pred_chunk(C.clone(), mu.clone(), idx, w, y, nz)
    again = tcps.pred_chunk(C.clone(), mu.clone(), idx, w, y, nz)
    torch.cuda.synchronize()
    assert tcps.pred_chunk.spread_launches - before == 2 * (cluster == 0)
    _bitwise(got, again)
    for g, want in zip(got, tcps.pred_chunk_stencil_plain(C, mu, idx, w, y, nz)):
        assert torch.allclose(g, want, rtol=2e-4, atol=2e-4), float((g - want).abs().max())
    S = stencil_rows(idx, w, m)
    args = (idx, w, (S @ C).contiguous(), (mu @ S.mT).contiguous(), y, nz)
    got, again = tcps.pred_factors(*args), tcps.pred_factors(*args)
    torch.cuda.synchronize()
    _bitwise(got, again)
    for g, want in zip(got, tcps.pred_factors_plain(*args)):
        assert torch.allclose(g, want, rtol=2e-4, atol=2e-4), float((g - want).abs().max())
