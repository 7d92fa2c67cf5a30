"""The port's batched CG, Lanczos, Lanczos root and SLQ log-det against the
JAX package, float64, with the same start vectors and probes: to 1e-10
relative to each output's largest entry. The JAX oracle is
tests/ops/test_cg_lanczos.py; the port's Lanczos takes leading batch dims
where JAX vmaps, and SLQ takes its probes as a tensor: the test draws JAX's
own (``split`` then ``rademacher``, as ``cg.py:149-159`` does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_gp_tpu.ops import cg as jcg
from online_gp_torch.ops import cg as tcg

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's small tensors: on a machine the
    test workers share, OpenMP threads over 64-element ops cost several
    times what they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(want, got, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.max(np.abs(want)), 1e-300))


def _psd(rng, m, cond=100.0):
    q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    return (q * np.logspace(0, np.log10(cond), m)) @ q.T


# A column frozen by a loose tolerance keeps a partial Krylov iterate, whose
# rounding CG amplifies (1.7e-10 of a largest entry of 1.3 here; the same
# JAX run with its matvec written as an einsum is bitwise its own): that
# case is held to 1e-9. Converged and never-started columns are held to 1e-10.
@pytest.mark.parametrize("tol,iters,rel", [(1e-10, 120, TOL), (1e-2, 40, 1e-9), (1e6, 10, TOL)])
def test_batched_cg_matches_jax(tol, iters, rel):
    """A batch of two systems with three right-hand sides each; a loose and
    a huge tolerance freeze columns early (the mask), as in JAX."""
    rng = np.random.default_rng(0)
    A = np.stack([_psd(rng, 40), _psd(rng, 40, cond=30.0)])
    rhs = rng.normal(size=(2, 40, 3))
    want = jcg.batched_cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(rhs), max_iters=iters, tol=tol)
    At = torch.tensor(A)
    got = tcg.batched_cg(lambda v: At @ v, torch.tensor(rhs), max_iters=iters, tol=tol)
    _close(want, got, rel)
    if tol == 1e-10:
        _close(rhs, At @ got, 1e-6)


def test_batched_cg_gradient_matches_jax():
    """Autograd through the iterations, as JAX differentiates through its
    scan, with the columns converging and freezing inside the run."""
    rng = np.random.default_rng(1)
    A0, rhs = _psd(rng, 20, cond=20.0), rng.normal(size=(20, 2))
    D = np.diag(rng.uniform(0.5, 1.5, 20))

    def jloss(s):
        A = jnp.asarray(A0) + s * jnp.asarray(D)
        return jnp.sum(jnp.asarray(rhs) * jcg.batched_cg(lambda v: A @ v, jnp.asarray(rhs), max_iters=40, tol=1e-12))

    s = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    A = torch.tensor(A0) + s * torch.tensor(D)
    loss = torch.sum(torch.tensor(rhs) * tcg.batched_cg(lambda v: A @ v, torch.tensor(rhs), max_iters=40, tol=1e-12))
    (g,) = torch.autograd.grad(loss, s)
    _close(jloss(0.3), loss.detach())
    _close(jax.grad(jloss)(0.3), g)


def test_lanczos_matches_jax_batched():
    """Three operators, each its own start vector, in one batch: Q, alpha
    and beta against JAX per operator."""
    rng = np.random.default_rng(2)
    m, k = 30, 12
    A = np.stack([_psd(rng, m, cond=50.0) for _ in range(3)])
    v0 = rng.normal(size=(3, m))
    At = torch.tensor(A)
    Q, a, b = tcg.lanczos(lambda v: (At @ v[..., None])[..., 0], torch.tensor(v0), k)
    assert Q.shape == (3, k, m) and a.shape == (3, k) and b.shape == (3, k - 1)
    for i in range(3):
        jQ, ja, jb = jcg.lanczos(lambda v: jnp.asarray(A[i]) @ v, jnp.asarray(v0[i]), k)
        _close(jQ, Q[i])
        _close(ja, a[i])
        _close(jb, b[i])


def test_lanczos_breakdown_guard_is_elementwise():
    """A batch of two: an operator whose Krylov space ends exactly after 6
    steps (a diagonal with 6 nonzeros, v0 on them) and a full-rank one. The
    guard zeroes the first's later vectors, alphas and betas and leaves the
    second alone, as JAX does for each alone."""
    rng = np.random.default_rng(3)
    m, k = 30, 12
    d = np.zeros(m)
    d[:6] = [5.0, 3.0, 2.0, 1.0, 0.5, 0.25]
    A = np.stack([np.diag(d), _psd(rng, m, cond=50.0)])
    v0 = np.stack([np.r_[np.ones(6), np.zeros(m - 6)], rng.normal(size=m)])
    At = torch.tensor(A)
    Q, a, b = tcg.lanczos(lambda v: (At @ v[..., None])[..., 0], torch.tensor(v0), k)
    for i in range(2):
        jQ, ja, jb = jcg.lanczos(lambda v: jnp.asarray(A[i]) @ v, jnp.asarray(v0[i]), k)
        _close(jQ, Q[i])
        _close(ja, a[i])
        _close(jb, b[i])
    assert bool((Q[0, 6:] == 0).all()) and bool((a[0, 6:] == 0).all()) and bool((b[0, 5:] == 0).all())
    assert bool((b[1] != 0).all())


def test_lanczos_root_past_operator_rank_matches_jax():
    """The case of test_cg_lanczos.py:63: a rank-12 operator asked for a
    rank-40 root. Past the breakdown the vectors are rounding noise until
    the guard cuts them, so the steps before it and R R^T are compared."""
    rng = np.random.default_rng(4)
    m, r, k = 60, 12, 40
    V = rng.normal(size=(m, r))
    A = V @ V.T
    v0 = rng.normal(size=(m,))
    At = torch.tensor(A)
    mv = lambda v: (At @ v[..., None])[..., 0]
    jmv = lambda v: jnp.asarray(A) @ v
    Q, a, b = tcg.lanczos(mv, torch.tensor(v0), k)
    jQ, ja, jb = jcg.lanczos(jmv, jnp.asarray(v0), k)
    _close(np.asarray(ja)[:r], a[:r])
    _close(np.asarray(jb)[: r - 1], b[: r - 1])
    _close(np.asarray(jQ)[:r], Q[:r])
    R = tcg.lanczos_root(mv, torch.tensor(v0), k)
    jR = jcg.lanczos_root(jmv, jnp.asarray(v0), k)
    assert bool(torch.isfinite(R).all())
    _close(jR @ jR.T, R @ R.T)
    np.testing.assert_allclose((R @ R.T).numpy(), A, rtol=1e-4, atol=1e-3)


def test_lanczos_root_matches_jax():
    """Rank-12 roots of two full-rank operators in one batch: R R^T against
    JAX's (the root's columns are fixed only up to sign)."""
    rng = np.random.default_rng(5)
    m, k = 40, 12
    A = np.stack([_psd(rng, m, cond=50.0), _psd(rng, m, cond=10.0)])
    v0 = rng.normal(size=(2, m))
    At = torch.tensor(A)
    R = tcg.lanczos_root(lambda v: (At @ v[..., None])[..., 0], torch.tensor(v0), k)
    assert R.shape == (2, m, k)
    for i in range(2):
        jR = jcg.lanczos_root(lambda v: jnp.asarray(A[i]) @ v, jnp.asarray(v0[i]), k)
        _close(jR @ jR.T, R[i] @ R[i].T)


def test_lanczos_root_lowrank():
    """The port's own: a rank-12 root captures an effectively rank-8
    operator (JAX's test_lanczos_root_lowrank)."""
    rng = np.random.default_rng(6)
    V = rng.normal(size=(40, 8))
    A = torch.tensor(V @ V.T + 1e-8 * np.eye(40))
    R = tcg.lanczos_root(lambda v: (A @ v[..., None])[..., 0], torch.tensor(rng.normal(size=40)), 12)
    assert float(torch.linalg.norm(R @ R.T - A) / torch.linalg.norm(A)) < 1e-4


def _jax_probes(key, m, num_probes, dtype=jnp.float64):
    """The probes slq_logdet draws from key: split, then one Rademacher
    vector per probe key."""
    keys = jax.random.split(key, num_probes)
    return np.stack([np.asarray(jax.random.rademacher(k, (m,), dtype=dtype)) for k in keys])


def test_slq_logdet_matches_jax():
    """JAX's own probes, passed to the port: the same estimate to 1e-10; two
    operators batched in one call."""
    rng = np.random.default_rng(5)
    m, P, iters = 60, 30, 40
    A = np.stack([_psd(rng, m, cond=30.0), _psd(rng, m, cond=5.0)])
    keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]
    want = [float(jcg.slq_logdet(lambda v: jnp.asarray(A[i]) @ v, m, keys[i], num_probes=P, num_iters=iters,
                                 dtype=jnp.float64)) for i in range(2)]
    probes = np.stack([_jax_probes(k, m, P) for k in keys])  # (2, P, m)
    At = torch.tensor(A)
    got = tcg.slq_logdet(lambda v: (At @ v.mT).mT, torch.tensor(probes), num_iters=iters)
    assert got.shape == (2,)
    _close(np.asarray(want), got)
    exact = np.linalg.slogdet(A)[1]
    assert np.all(np.abs(got.numpy() - exact) / np.abs(exact) < 0.05)


def test_rademacher_draws_signs_from_the_generator():
    z = tcg.rademacher((4, 1000), torch.Generator().manual_seed(0), torch.float64)
    assert set(np.unique(z.numpy())) == {-1.0, 1.0}
    again = tcg.rademacher((4, 1000), torch.Generator().manual_seed(0), torch.float64)
    assert torch.equal(z, again)
    assert abs(float(z.mean())) < 0.1
