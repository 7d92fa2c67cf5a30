"""K1's and K3's applies, held on the CPU (and, marked ``cuda``, on a card).

K1's apply (X += (X A^T) U for (X, A) = (L, R), (B, P)) runs on
thread-block clusters, ``chunk_apply_cluster_kernel`` in
``csrc/root_update.cu``; K3's (C -= Z^T Z, mu += Z^T r) on 128 x 128 or
64 x 128 tiles of C, ``pred_apply128_kernel`` / ``pred_apply64_kernel`` in
``csrc/pred_stream.cu``.

- (a) The shape rules ``chunk_apply_plan`` and ``pred_apply_plan``: which
  shapes run where, within one block's shared memory, the values at the
  shapes ``chip_smoke.py`` times, that the wrappers refuse a plan that is
  not the kernel's layout, and that every wrapper whose call ends in an
  apply hands the C entry the plan's route and counts the launch.
- (b) K1's new order of summation, emulated in torch: per output and row
  tile, the partial T_r = X[:, cols_r] A[:, cols_r]^T of each of the 8
  blocks' column slices, added in rank order, then X + T U. Held at Bd = 2,
  on whole roots and row shards and at an m that leaves a block without
  columns, against the Pallas kernel it replaces in interpret mode (a
  whole chunk, float32, 1e-5, as
  tests/test_torch_root_update.py), and against ``chunk_apply_rows_plain``
  in float64 (1e-9). Within a slice the emulation sums by
  matmul where the kernel runs one fmaf chain in column order: the two
  differ by float32 rounding only. K3's apply keeps the tiled GEMM's
  order entry for entry (bitwise, on the card).
- (c) Each apply against its plain version on the card, bitwise the same
  on a second call; skipped without one (``-m cuda``; no JAX import at the
  top of this file, so ``pytest --noconftest`` runs it on a machine
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
from online_gp_torch.ops.root_update import blocked_factors

MAX = 232448
SMS = 132  # an H100 SXM's SMs: the card the smoke shapes' tiles were chosen on


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _apply_layout(k, m, C):
    """chunk_apply_layout of csrc/root_update.cu, written out: (W, floats).
    T is 64 x ldt, its cluster sums a C-th of that, and each of the three
    ring slots holds 64 x 32 floats of X and 32 x (128 + 4) of A^T."""
    W = 4 * _cdiv(_cdiv(m, C), 4)
    ldt = 32 * _cdiv(k, 32)
    return W, 64 * ldt + 64 * ldt // C + 3 * (64 * 32 + 32 * 132)


# --------------------------------------------------------------------------
# (a) the shape rules
# --------------------------------------------------------------------------

SIZES = (1, 7, 64, 100, 256, 450, 900, 1089, 1120, 2048, 2500, 4096)


@pytest.mark.parametrize("k", [1, 32, 128, 544, 576, 1024])
def test_chunk_apply_plan_takes_every_shape_within_one_block(k):
    """Every (k, rows, m) the wrappers take has a route: the cluster plan
    where one block holds its slice, T and the ring in 232,448 bytes, the
    tiled kernels elsewhere; a plan's 8 slices of W columns cover m."""
    for m in SIZES:
        for rows in sorted({1, max(1, m // 2), m}):
            plan = tcru.chunk_apply_plan(k, rows, m)
            W, floats = _apply_layout(k, m, 8)
            if 4 * floats > MAX:
                assert plan is None, (k, rows, m)
                continue
            assert plan == tcru.ApplyPlan(8, 64, W, 4 * floats, 16 * _cdiv(rows, 64)), (k, rows, m)
            assert W % 4 == 0 and 8 * W >= m
            assert plan.shared_bytes <= _build.MAX_SHARED_BYTES == MAX


@pytest.mark.parametrize("k,rows,m,want", [
    (128, 900, 900, (8, 64, 116, 112128, 240)),  # the main path's chunk: 240 blocks at Bd = 1
    (128, 450, 900, (8, 64, 116, 112128, 128)),  # a row shard of it
    (128, 256, 256, (8, 64, 32, 112128, 64)),
    (128, 128, 256, (8, 64, 32, 112128, 32)),
    (128, 4096, 4096, (8, 64, 512, 112128, 1024)),
    (128, 2048, 4096, (8, 64, 512, 112128, 512)),
    (32, 900, 900, (8, 64, 116, 84480, 240)),  # K5 sub's per-sub-block rank
    (544, 900, 900, (8, 64, 116, 231936, 240)),  # the largest k
    (576, 900, 900, None),  # the tiled kernels
    (1024, 900, 900, None),  # chip_smoke's shape on the tiled kernels
])
def test_chunk_apply_plan_at_the_smoke_shapes(k, rows, m, want):
    plan = tcru.chunk_apply_plan(k, rows, m)
    assert plan == (None if want is None else tcru.ApplyPlan(*want))


@pytest.mark.parametrize("sms", [SMS, 114])  # an H100 SXM's; an H100 PCIe's
def test_pred_apply_plan_gives_every_sm_a_block_where_it_can(sms):
    for Bd in (1, 2):
        for m in SIZES:
            for rows in sorted({1, max(1, m // 2), m}):
                plan = tcps.pred_apply_plan(Bd, rows, m, sms)
                tall = Bd * _cdiv(rows, 128) * _cdiv(m, 128)
                assert plan.tile_rows == (128 if tall >= sms else 64)
                assert plan.blocks == Bd * _cdiv(rows, plan.tile_rows) * _cdiv(m, 128)
                assert plan.shared_bytes == 4 * 3 * 16 * (plan.tile_rows + 128) <= 48 * 1024


@pytest.mark.parametrize("Bd,rows,m,want", [
    (1, 900, 900, (64, 128, 36864, 120)),  # 64 blocks of 128 rows would leave SMs idle
    (2, 900, 900, (64, 128, 36864, 240)),
    (1, 450, 900, (64, 128, 36864, 64)),
    (1, 256, 256, (64, 128, 36864, 8)),
    (1, 4096, 4096, (128, 128, 49152, 1024)),
    (1, 2048, 4096, (128, 128, 49152, 512)),
])
def test_pred_apply_plan_at_the_smoke_shapes(Bd, rows, m, want):
    assert tcps.pred_apply_plan(Bd, rows, m, SMS) == tcps.PredApplyPlan(*want)


class _Layouts:
    """Stands in for the built libraries' layout queries, each the shape
    rule's plus ``skew`` bytes."""

    def __init__(self, skew=0):
        self.skew = skew

    def ogp_chunk_apply_smem(self, k, m, C):
        return 4 * _apply_layout(k, m, C)[1] + self.skew

    def ogp_pred_apply_smem(self, bm):
        return 4 * 3 * 16 * (bm + 128) + self.skew

    def ogp_chunk_cluster_smem(self, k, m, C, G):
        return 4 * tcru._chunk_cluster_floats(k, m, C, G)[1]

    @staticmethod
    def ogp_chunk_grid_capacity(k, m, C, G):  # an H100 SXM's clusters of 8 at m = 4,096
        return 15

    def ogp_chunk_spread_smem(self, k, m, C, G, slices):
        return 4 * tcru._chunk_cluster_floats(k, m, C, G, slices)[1]

    @staticmethod
    def ogp_chunk_spread_capacity(k, m, C, G, slices):  # as the grid kernel's
        return 15

    def ogp_pred_cluster_smem(self, k, m, P, C):
        return 4 * tcps._pred_cluster_floats(k, m, P, C)[1]


@pytest.mark.parametrize("skew", [4, -4])
def test_wrappers_refuse_an_apply_plan_that_is_not_the_kernel_layout(skew, monkeypatch):
    monkeypatch.setattr(_build, "card_sms", lambda device: SMS)
    apply_route = lambda rules, k: _build.route(_Layouts(skew), rules, 1, k, 900, "meta", rows=900, recursion=False)
    with pytest.raises(RuntimeError, match="they must be changed together"):
        apply_route(tcru.K1, 128)
    with pytest.raises(RuntimeError, match="they must be changed together"):
        apply_route(tcps.K3, 128)
    # the tiled branch has no layout to check
    assert apply_route(tcru.K1, 1024)[-2:] == (None, 0)


class _Entries(_Layouts):
    """Records the C entries a wrapper calls, with their arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ogp_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0

    @staticmethod
    def ogp_blocked_chunk_coord_splits():
        return 4

    @staticmethod
    def ogp_blocked_chunk_coord_smem(k):
        return (3 * k * k + 3 * k + 32) * 4


@pytest.fixture
def fake_card(monkeypatch):
    """Routes the wrappers' CUDA branch to an _Entries library on meta
    tensors of a card of SMS SMs: the plan, the scratch and the counters,
    with no kernel."""
    lib = _Entries()
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "card_sms", lambda device: SMS)
    monkeypatch.setattr(_build, "check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(tcru, "_root_update_lib", lambda: lib)
    monkeypatch.setattr(tcps, "_pred_stream_lib", lambda: lib)
    counters = [(tcru.chunk_apply_plan, "launches"), (tcru.chunk_apply_plan, "tiled_launches"),
                (tcps.pred_apply_plan, "launches"), (tcru.chunk_apply_rows, "launches"),
                (tcps.pred_apply_rows, "launches")]
    for fn, attr in counters:
        monkeypatch.setattr(fn, attr, 0)
    for fn in (tcru.chunk_apply_plan, tcps.pred_apply_plan):
        monkeypatch.setattr(fn, "shapes", collections.Counter())
    return lib


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("k,rows,m,route", [(128, 450, 900, 8), (128, 900, 900, 8), (1024, 900, 900, 0),
                                            (576, 2048, 4096, 0), (32, 1, 7, 8)])
def test_chunk_apply_rows_hands_the_plan_to_its_entry(fake_card, k, rows, m, route):
    """AC is the plan's cluster size; the tiled branch (AC = 0) gets its T
    scratch, (Bd, 2, rows, k), the cluster branch none."""
    Bd = 2
    X, F = _meta(Bd, rows, m), _meta(Bd, k, m)
    tcru.chunk_apply_rows(X, X, F, F, F)
    (name, args), = fake_card.calls
    assert name == "ogp_chunk_apply_rows" and args[6:11] == (Bd, k, rows, m, route)
    assert (args[5] is None) == (route > 0)
    assert (tcru.chunk_apply_plan.launches, tcru.chunk_apply_plan.tiled_launches) == ((1, 0) if route else (0, 1))
    assert tcru.chunk_apply_plan.shapes == {(Bd, rows, m, k): 1}
    assert tcru.chunk_apply_rows.launches == 1


@pytest.mark.parametrize("k,sub,mode,m,entry,AC,applies", [
    (128, None, "flat", 900, "ogp_blocked_chunk", 8, 1),
    (128, None, "flat", 4096, "ogp_blocked_chunk", 8, 1),
    (128, 32, "flat", 900, "ogp_blocked_chunk_sub_cluster", 8, 1),  # one apply at rank k
    (128, 32, "flat", 2500, "ogp_blocked_chunk_sub", 8, 4),  # one apply a sub-block, at rank 32
    (128, None, "coord", 900, "ogp_blocked_chunk_coord", 8, 1),
    (1024, None, "flat", 900, "ogp_blocked_chunk", 0, 1),
])
def test_every_k1_chunk_hands_its_apply_the_plan(fake_card, k, sub, mode, m, entry, AC, applies):
    P, Bd = 16, 1
    L = _meta(Bd, m, m)
    tcru.blocked_chunk(L, L, _meta(k, P, dtype=torch.int32), _meta(Bd, k, P), sub=sub, mode=mode)
    (name, args), = fake_card.calls
    assert name == entry
    # AC sits before the recursion's C (absent for coord) and, where the
    # recursion may be spread, its spread slices, then the stream
    at = {"ogp_blocked_chunk_coord": -2, "ogp_blocked_chunk_sub_cluster": -3}
    assert args[at.get(entry, -4)] == AC
    counts = (tcru.chunk_apply_plan.launches, tcru.chunk_apply_plan.tiled_launches)
    assert counts == ((applies, 0) if AC else (0, applies))
    assert tcru.chunk_apply_plan.shapes == {(Bd, m, m, k // applies): applies}


@pytest.mark.parametrize("Bd,rows,m,row0,tile", [(1, 450, 900, 450, 64), (1, 2048, 4096, 2048, 128),
                                                  (2, 900, 900, 0, 64)])
def test_pred_applies_hand_their_entry_the_tile(fake_card, Bd, rows, m, row0, tile):
    k = 128
    tcps.pred_apply_rows(_meta(Bd, rows, m), _meta(Bd, rows), _meta(Bd, k, m), _meta(Bd, k), row0)
    (name, args), = fake_card.calls
    assert name == "ogp_pred_apply_rows" and args[4:10] == (Bd, k, rows, m, row0, tile)
    if rows == m:
        y = _meta(Bd, k)
        tcps.pred_chunk(_meta(Bd, m, m), _meta(Bd, m), _meta(k, 16, dtype=torch.int32), _meta(k, 16), y, y)
        name, args = fake_card.calls[-1]
        # the tile, then the recursion's Cl, G, wave and spread slices, then the stream
        assert name == "ogp_pred_chunk" and args[-6] == tile
    assert tcps.pred_apply_plan.launches == 1 + (rows == m)
    assert tcps.pred_apply_plan.shapes == {(Bd, rows, m, k): 1 + (rows == m)}


@pytest.mark.parametrize("sms,tile", [(64, 128), (SMS, 64)])
def test_pred_apply_tile_follows_the_card_sm_count(fake_card, monkeypatch, sms, tile):
    """m = 900, Bd = 1: 64 tiles of 128 rows give a 64-SM card a block
    on every SM, and leave 68 of an H100 SXM's 132 idle."""
    monkeypatch.setattr(_build, "card_sms", lambda device: sms)
    k, m = 128, 900
    tcps.pred_apply_rows(_meta(1, m, m), _meta(1, m), _meta(1, k, m), _meta(1, k), 0)
    (name, args), = fake_card.calls
    assert name == "ogp_pred_apply_rows" and args[9] == tile


# --------------------------------------------------------------------------
# (b) K1's summation order
# --------------------------------------------------------------------------


def cluster_apply(X, A, U, C=_build.CLUSTER_SIZE):
    """K1's cluster apply in its order of summation: X + T U, with T the
    rank-order sum of the blocks' partials X[:, cols_r] A[:, cols_r]^T over
    column slices of W = cdiv(m, C) rounded up to 4 (the last slices may be
    short or empty)."""
    m = X.shape[-1]
    W = 4 * _cdiv(_cdiv(m, C), 4)
    parts = [X[..., r * W : (r + 1) * W] @ A[..., r * W : (r + 1) * W].mT for r in range(C) if r * W < m]
    T = functools.reduce(lambda x, y: x + y, parts)
    return X + T @ U


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol, atol=tol)


def _roots(rng, Bd, m):
    W = rng.normal(size=(Bd, m, m))
    L = np.linalg.cholesky(W @ np.swapaxes(W, -1, -2) / m + np.eye(m))
    return L, np.swapaxes(np.linalg.inv(L), -1, -2)


@pytest.mark.parametrize("m,rows", [(100, 100), (100, 50), (64, 64)])
def test_k1_cluster_apply_order_matches_the_plain_apply(m, rows):
    """In float64, at Bd = 2, k = 16, on the whole roots and on a row shard,
    the emulated order is the plain apply's product to 1e-9 of the scale:
    the emulation computes the apply itself, whatever its order (m = 100
    leaves the eighth block without columns, W = 16; m = 64 gives each
    8). The float32 order is held against the Pallas kernel below."""
    rng = np.random.default_rng(60 + m + rows)
    Bd, k = 2, 16
    L, B = _roots(rng, Bd, m)
    L, B = L[:, :rows], B[:, :rows]
    U, Pm, R = (rng.normal(size=(Bd, k, m)) / np.sqrt(m) for _ in range(3))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    want = tcru.chunk_apply_rows_plain(t(L), t(B), t(U), t(Pm), t(R))
    got = (cluster_apply(t(L), t(R), t(U)), cluster_apply(t(B), t(Pm), t(U)))
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1.0)
        _close(w, g, 1e-9 * scale)


@pytest.mark.parametrize("m,rows,repeats", [(64, 64, False), (64, 64, True), (100, 100, False),
                                            (100, 50, False), (64, 32, True)])
def test_k1_chunk_with_the_cluster_apply_matches_pallas(m, rows, repeats):
    """A whole chunk at Bd = 2, k = 16: the plain recursion's factors, then
    the cluster apply's order on the first ``rows`` rows of the roots,
    against those rows of pallas_blocked_chunk_batched in interpret mode,
    to 1e-5. m = 100 leaves the eighth block without columns;
    rows < m is a row shard (the apply of ``chunk_apply_rows``)."""
    import jax.numpy as jnp

    from online_gp_tpu.ops import root_update as jru
    from online_gp_tpu.ops.pallas_root_update import pallas_blocked_chunk_batched

    rng = np.random.default_rng(70 + m + rows + repeats)
    Bd, k, P = 2, 16, 4
    L, B = (x.astype(np.float32) for x in _roots(rng, Bd, m))
    idx = rng.integers(0, m, (k, P))
    w = rng.uniform(-0.5, 1.0, (k, P))
    if repeats:  # point 2t + 1 repeats point 2t: near-dependent rows of p0
        idx[1::2], w[1::2] = idx[0::2], w[0::2]
    wv = (w[None] * np.array([1.0, 0.7])[:, None, None]).astype(np.float32)
    S = np.stack([np.asarray(jru.stencil_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(wv[b]), m)) for b in range(Bd)])
    p0 = torch.einsum("bkp,bkpm->bkm", torch.tensor(wv), torch.tensor(B)[:, torch.tensor(idx)])
    U, Pm, R = blocked_factors(p0)
    tL = cluster_apply(torch.tensor(L[:, :rows]), R, U)
    tB = cluster_apply(torch.tensor(B[:, :rows]), Pm, U)
    jL, jB = pallas_blocked_chunk_batched(jnp.asarray(L), jnp.asarray(B), jnp.asarray(S), interpret=True)
    for j, t in ((jL, tL), (jB, tB)):
        j = np.asarray(j)[:, :rows]
        _close(j, t, 1e-5)


# --------------------------------------------------------------------------
# (c) on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the applies' kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bitwise(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b)), "two calls on the same inputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows,m", [(128, 900, 900), (128, 450, 900), (32, 256, 256), (128, 49, 98),
                                      (1024, 300, 300), (128, 2048, 4096)])
def test_chunk_apply_rows_kernel_matches_its_plain_version(card, k, rows, m):
    """m = 98 copies 4 bytes at a time; k = 1,024 takes the tiled kernels."""
    rng = np.random.default_rng(k + rows + m)
    Bd = 2
    f32 = dict(dtype=torch.float32, device=card)
    L, B = (torch.tensor(rng.normal(size=(Bd, rows, m)), **f32) for _ in range(2))
    U, Pm, R = (torch.tensor(rng.normal(size=(Bd, k, m)) / np.sqrt(m * k), **f32) for _ in range(3))
    want = tcru.chunk_apply_rows_plain(L, B, U, Pm, R)
    got = tcru.chunk_apply_rows(L.clone(), B.clone(), U, Pm, R)
    again = tcru.chunk_apply_rows(L.clone(), B.clone(), U, Pm, R)
    torch.cuda.synchronize()
    _bitwise(got, again)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("Bd,rows,m,row0", [(1, 900, 900, 0), (1, 450, 900, 450), (2, 128, 256, 128),
                                            (1, 2048, 4096, 0), (1, 49, 98, 49)])
def test_pred_apply_rows_kernel_matches_its_plain_version(card, Bd, rows, m, row0):
    """row0 = 450 and m = 98 copy 4 bytes at a time."""
    rng = np.random.default_rng(Bd + rows + m + row0)
    k = 128
    f32 = dict(dtype=torch.float32, device=card)
    C = torch.tensor(rng.normal(size=(Bd, rows, m)), **f32)
    mu = torch.tensor(rng.normal(size=(Bd, rows)), **f32)
    Z = torch.tensor(rng.normal(size=(Bd, k, m)) / np.sqrt(k), **f32)
    r = torch.tensor(rng.normal(size=(Bd, k)), **f32)
    want = tcps.pred_apply_rows_plain(C, mu, Z, r, row0)
    got = tcps.pred_apply_rows(C.clone(), mu.clone(), Z, r, row0)
    again = tcps.pred_apply_rows(C.clone(), mu.clone(), Z, r, row0)
    torch.cuda.synchronize()
    _bitwise(got, again)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=2e-4, atol=2e-4)
