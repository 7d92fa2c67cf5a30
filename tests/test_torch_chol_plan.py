"""K6's trailing-update plan (``cuda_chol.cholesky_plan``), held on the CPU
(and, marked ``cuda``, K6 on a card at the wide shapes).

K6 factors each panel of 128 columns, then updates the trailing lower
triangle on tiles of 32, 64 or 128 a side (``csrc/chol.cu``: the 32 x 32
``chol_syrk_kernel``, ``chol_trail_kernel<64>`` and ``<128>``). With
look-ahead each panel's update splits into the next panel's column block,
on a stream of its own beside the factor and the solve, and the rest.

- (a) The plan: with look-ahead on and off, at m = 130 ... 4,097 and
  ragged last panels, the launches it asks for (emulated as the C entry
  and the kernels turn them into tiles: ``launch_trail``, ``trail_tile``)
  cover every element on and below the diagonal of each panel's trailing
  matrix exactly once; the order the C entry's streams and events impose
  gives every element its panels' updates in panel order, and each factor
  and solve only after every update of its columns; the tile sizes at the
  shapes ``chip_smoke.py`` times; the wrapper hands its C entry the plan
  and refuses a plan whose layout is not the kernel's, or that the entry
  refuses. The plain version against ``numpy.linalg.cholesky`` at a
  multi-panel ragged shape.
- (b) On the card (``-m cuda``; no JAX import in this file, so
  ``pytest --noconftest`` runs it on a machine without JAX): K6 at
  m = 1,936, 2,049, 4,096 and 4,097, Bd = 1 and 2, against its plain
  version and ``torch.linalg.cholesky`` (relative 5e-4, ``check_k6``'s
  bound in chip_smoke.py), the strict upper triangle exactly 0, the same
  bits with look-ahead on and off, and the failure flag on an indefinite
  matrix.
"""

import numpy as np
import pytest
import torch

from online_gp_torch.ops import _build
from online_gp_torch.ops import cuda_chol

SMS = 132  # an H100 SXM's SMs: the card the smoke shapes' tiles were chosen on
KB = cuda_chol.KERNEL_BLOCK
CELL = 32  # the smallest tile: coverage is counted on 32 x 32 cells


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _launch_tiles(n, tile, j0, jn):
    """The tiles (I, J) of one launch_trail(tile, j0, jn) on a trailing
    matrix of width n, as the C entry sizes its grid and trail_tile maps
    each block (blocks that own nothing dropped); and the grid's blocks."""
    nt = _cdiv(n, tile)
    side = nt - j0
    blocks = nt * jn if jn > 0 else (side * (side + 1) // 2 if side > 0 else 0)
    tiles = []
    for t in range(blocks):
        if jn > 0:
            I, J = divmod(t, jn)
            if J <= I:
                tiles.append((I, J))
        else:
            I = int((np.sqrt(np.float32(8 * t + 1)) - 1) * 0.5)
            while I * (I + 1) // 2 > t:
                I -= 1
            while (I + 1) * (I + 2) // 2 <= t:
                I += 1
            tiles.append((I + j0, t - I * (I + 1) // 2 + j0))
    return tiles, blocks


def _launches(plan):
    """[(panel, part, tile, tiles)] of a plan in the C entry's order: per
    panel the whole update, or under look-ahead the rest then the next block."""
    out = []
    for p, pp in enumerate(plan.panels):
        if not plan.lookahead:
            tiles, blocks = _launch_tiles(pp.n, pp.tile, 0, 0)
            assert blocks == pp.blocks
            out.append((p, "all", pp.tile, tiles))
            continue
        tiles, blocks = _launch_tiles(pp.n, pp.tile, KB // pp.tile, 0)
        assert blocks == pp.blocks
        out.append((p, "rest", pp.tile, tiles))
        tiles, blocks = _launch_tiles(pp.n, pp.next_tile, 0, KB // pp.next_tile)
        assert blocks == pp.next_blocks
        out.append((p, "next", pp.next_tile, tiles))
    return out


def _cells(n, tile, I, J):
    """The 32 x 32 cells (of the trailing matrix, width n) that tile (I, J)
    writes: on a diagonal tile those on or below the diagonal."""
    k = tile // CELL
    nc = _cdiv(n, CELL)
    return [(i, j) for i in range(I * k, min((I + 1) * k, nc)) for j in range(J * k, min((J + 1) * k, nc))
            if I != J or j <= i]


PLAN_SHAPES = [(m, Bd) for m in (130, 256, 300, 600, 900, 1000, 1936, 2048, 2049, 3000, 4096, 4097)
               for Bd in (1, 2)] + [(256, 8), (900, 4)]


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("m,Bd", PLAN_SHAPES)
def test_plan_covers_every_lower_tile_once(m, Bd, lookahead):
    plan = cuda_chol.cholesky_plan(m, Bd, SMS, lookahead)
    assert (plan.m, plan.Bd) == (m, Bd)
    assert [pp.lo for pp in plan.panels] == list(range(0, m - KB, KB))
    assert [pp.n for pp in plan.panels] == [m - lo - KB for lo in range(0, m - KB, KB)]
    counts = [np.zeros((_cdiv(pp.n, CELL),) * 2, dtype=int) for pp in plan.panels]
    for p, _, tile, tiles in _launches(plan):
        assert tile in cuda_chol.TRAIL_KERNELS
        for I, J in tiles:
            assert J <= I
            for i, j in _cells(plan.panels[p].n, tile, I, J):
                counts[p][i, j] += 1
    for c in counts:
        assert np.array_equal(c, np.tril(np.ones_like(c))), "a lower cell updated other than once"


def _column_blocks(p, tile, tiles):
    """The 128-column blocks of the matrix that one launch of panel p writes
    (its trailing matrix starts at block p + 1)."""
    return {p + 1 + J * tile // KB for _, J in tiles}


@pytest.mark.parametrize("m", [600, 1936, 4097])
def test_lookahead_order_keeps_every_update_in_panel_order(m, monkeypatch):
    """The C entry's order under look-ahead, as a happens-before relation:
    the chain stream runs factor, solve, [record], [wait rest_done], next;
    the caller's stream [wait chain_done], rest, [record rest_done]. Every
    column block's updates by panels p < p' precede those of p', and the
    factor and solve of panel q follow every update of block q. (Look-ahead
    at every m, and a card of 4 SMs, so that most updates are on wide
    tiles.)"""
    monkeypatch.setattr(cuda_chol, "LOOKAHEAD_MIN_BD_M", 0)
    plan = cuda_chol.cholesky_plan(m, 1, 4, True)
    assert plan.lookahead
    nb = _cdiv(m, KB)
    # happens-before by construction: (stream order) + (event edges)
    chain, caller, edges = [], [], set()
    for p in range(nb):
        chain += [("factor", p)]
        if p == len(plan.panels):
            break
        chain += [("solve", p)]
        edges.add((("solve", p), ("rest", p)))
        caller += [("rest", p)]
        if p > 0:
            edges.add((("rest", p - 1), ("next", p)))
        chain += [("next", p)]
    for s in (chain, caller):
        edges |= {(a, b) for a, b in zip(s, s[1:])}
    nodes = set(chain) | set(caller)
    after = {a: set() for a in nodes}
    for a, b in edges:
        after[a].add(b)
    # transitive closure
    reach = {}
    for a in nodes:
        seen, stack = set(), [a]
        while stack:
            for b in after[stack.pop()]:
                if b not in seen:
                    seen.add(b)
                    stack.append(b)
        reach[a] = seen
    writes = {}  # column block -> [(panel, node)]
    for p, part, tile, tiles in _launches(plan):
        for blk in _column_blocks(p, tile, tiles):
            writes.setdefault(blk, []).append((p, (part, p)))
    assert sorted(writes) == list(range(1, nb))
    for blk, ws in writes.items():
        for p, a in ws:
            for q, b in ws:
                if p < q:
                    assert b in reach[a], f"panel {p}'s update of block {blk} does not precede panel {q}'s"
            assert ("factor", blk) in reach[a], f"panel {p}'s update of block {blk} does not precede its factor"


@pytest.mark.parametrize("m,Bd,first,last", [
    (256, 1, 32, 32), (256, 8, 32, 32), (900, 1, 64, 32), (900, 2, 64, 32), (1000, 1, 64, 32),
    (1936, 1, 128, 32), (1936, 2, 128, 32), (4096, 1, 128, 32), (4096, 2, 128, 32), (4097, 1, 128, 32),
])
def test_plan_tiles_at_the_smoke_shapes(m, Bd, first, last):
    """The first panel's tile and the last's on a card of 132 SMs, and
    look-ahead from Bd m = LOOKAHEAD_MIN_BD_M on; every tile the cheapest
    of the cost model."""
    plan = cuda_chol.cholesky_plan(m, Bd, SMS)
    assert plan.panels[0].tile == first and plan.panels[-1].tile == last
    assert plan.lookahead == (Bd * m >= cuda_chol.LOOKAHEAD_MIN_BD_M)
    for pp in plan.panels:
        costs = {t: cuda_chol.trail_cost(Bd * cuda_chol.lower_tiles(pp.n, t), t, SMS) for t in cuda_chol.TRAIL_KERNELS}
        assert costs[pp.tile] == min(costs.values())


def test_stage_launches_count_every_kernel_of_a_call():
    plan = cuda_chol.cholesky_plan(4096, 1, SMS, True)
    got = cuda_chol.stage_launches(plan)
    assert got["chol_init_kernel"] == 1 and got["chol_factor_kernel"] == 32 and got["chol_solve_kernel"] == 31
    trail = sum(v for k, v in got.items() if k in cuda_chol.TRAIL_KERNELS.values())
    assert trail == sum(bool(pp.blocks) + bool(pp.next_blocks) for pp in plan.panels)
    off = cuda_chol.stage_launches(cuda_chol.cholesky_plan(4096, 1, SMS, False))
    assert sum(v for k, v in off.items() if k in cuda_chol.TRAIL_KERNELS.values()) == 31


# --------------------------------------------------------------------------
# the wrapper and its C entry, on a fake card
# --------------------------------------------------------------------------


class _Entry:
    """Records K6's C entry calls; its layouts skewed by ``skew`` bytes, its
    return code ``rc``."""

    def __init__(self, skew=0, rc=0):
        self.skew, self.rc, self.calls = skew, rc, []

    def ogp_chol_trail_smem(self, tile):
        return cuda_chol.trail_smem_bytes(tile) + self.skew

    def ogp_blocked_cholesky(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """Routes blocked_cholesky_ex's CUDA branch to an _Entry on meta tensors
    of a card of SMS SMs: the plan, the scratch and the counter, no kernel."""
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "card_sms", lambda device: SMS)
    monkeypatch.setattr(_build, "check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(cuda_chol.blocked_cholesky, "launches", 0)

    def use(entry):
        monkeypatch.setattr(cuda_chol, "_chol_lib", lambda: entry)
        return entry

    return use


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("shape", [(4096, 4096), (2, 1936, 1936), (2, 2, 900, 900), (130, 130), (100, 100)])
def test_wrapper_hands_its_entry_the_plan(fake_card, monkeypatch, shape, lookahead):
    monkeypatch.setattr(cuda_chol, "LOOKAHEAD", lookahead)
    entry = fake_card(_Entry())
    q = torch.empty(shape, device="meta")
    L, info = cuda_chol.blocked_cholesky_ex(q)
    assert L.shape == q.shape and info.shape == q.shape[:-2]
    (args,) = entry.calls
    m, Bd = shape[-1], int(np.prod(shape[:-2], dtype=int))
    plan = cuda_chol.cholesky_plan(m, Bd, SMS)
    assert args[4:8] == (Bd, m, int(cuda_chol.PROGRAMMATIC_LAUNCH), int(plan.lookahead))
    npanels = args[10]
    assert npanels == len(plan.panels) == max(_cdiv(m, KB) - 1, 0)
    assert list(args[8])[:npanels] == [pp.tile for pp in plan.panels]
    assert list(args[9])[:npanels] == [pp.next_tile for pp in plan.panels]
    assert cuda_chol.blocked_cholesky.launches == 1


@pytest.mark.parametrize("m", [4096, 900])
@pytest.mark.parametrize("skew", [4, -4])
def test_wrapper_refuses_a_plan_that_is_not_the_kernel_layout(fake_card, skew, m):
    entry = fake_card(_Entry(skew=skew))
    with pytest.raises(RuntimeError, match="they must be changed together"):
        cuda_chol.blocked_cholesky_ex(torch.empty((m, m), device="meta"))
    assert entry.calls == [] and cuda_chol.blocked_cholesky.launches == 0


def test_wrapper_raises_where_the_entry_refuses_the_plan(fake_card):
    fake_card(_Entry(rc=cuda_chol.BAD_PLAN))
    with pytest.raises(RuntimeError, match="refused the plan"):
        cuda_chol.blocked_cholesky_ex(torch.empty((1936, 1936), device="meta"))
    assert cuda_chol.blocked_cholesky.launches == 0


@pytest.mark.parametrize("shape", [(46341, 46341), (2, 32768, 32768)])
def test_wrapper_takes_matrices_past_2_31_elements(fake_card, shape):
    """The kernels form 64-bit element offsets: (Bd, m, m) of 2^31 elements
    and more launches K6 on its plan (meta tensors: nothing is allocated)."""
    entry = fake_card(_Entry())
    L, info = cuda_chol.blocked_cholesky_ex(torch.empty(shape, device="meta"))
    (args,) = entry.calls
    m, Bd = shape[-1], int(np.prod(shape[:-2], dtype=int))
    assert Bd * m * m >= 2**31 and args[4:6] == (Bd, m) and args[10] == _cdiv(m, KB) - 1
    assert L.shape == shape and cuda_chol.blocked_cholesky.launches == 1


def test_wrapper_refuses_a_batch_past_the_launch_grid(fake_card):
    entry = fake_card(_Entry())
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        cuda_chol.blocked_cholesky_ex(torch.empty((65536, 4, 4), device="meta"))
    assert entry.calls == []


def test_plain_version_matches_numpy_at_a_ragged_multi_panel_shape():
    """m = 600 at block 128: four whole panels and one of 88 columns."""
    rng = np.random.default_rng(600)
    a = rng.standard_normal((600, 600)).astype(np.float32)
    q = a @ a.T / 600 + np.eye(600, dtype=np.float32)
    got = cuda_chol.blocked_cholesky_plain(torch.tensor(q), block=128).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(q.astype(np.float64)), atol=2e-5, rtol=1e-4)
    assert np.all(np.triu(got, 1) == 0.0)


# --------------------------------------------------------------------------
# (b) on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: K6's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _spd(m, Bd, dev, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((Bd, m, m), generator=g).to(dev)
    return (a @ a.mT / m + torch.eye(m, device=dev)).contiguous()


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("Bd", [1, 2])
@pytest.mark.parametrize("m", [1936, 2049, 4096, 4097])
def test_k6_wide_matches_plain_and_library(card, monkeypatch, m, Bd):
    q = _spd(m, Bd, card, m + Bd)
    got, info = cuda_chol.blocked_cholesky_ex(q)
    monkeypatch.setattr(cuda_chol, "LOOKAHEAD", not cuda_chol.LOOKAHEAD)
    other, _ = cuda_chol.blocked_cholesky_ex(q)
    torch.cuda.synchronize()
    assert torch.equal(got, other), "look-ahead on and off give other bits"
    assert not bool((info != 0).any())
    assert bool((torch.triu(got, 1) == 0).all())
    assert _rel(got, cuda_chol.blocked_cholesky_plain(q)) <= 5e-4
    assert _rel(got, torch.linalg.cholesky(q)) <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1936, 4097])
def test_k6_wide_flags_an_indefinite_matrix(card, m):
    q = _spd(m, 2, card, m)
    q[1, m - 3, m - 3] = -float(m)  # the last panel's pivot goes negative
    _, info = cuda_chol.blocked_cholesky_ex(q)
    _, want = torch.linalg.cholesky_ex(q)
    assert info.tolist() == [0, 1] and bool(want[1] != 0) and int(want[0]) == 0
