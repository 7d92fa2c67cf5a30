"""The plain reference of a WISKI stream: exact GP algebra on a
cubic-interpolation (SKI) grid, in plain PyTorch.

It follows the published model (Stanton et al. 2021, WISKI) and works
everything out from the inputs the benchmark handed the program: the grid
from its bounds, the interpolation weights, for each of the state's B
outputs the Gram matrix A = W D^-1 W^T and W D^-1 y (D = I for the
regression wrapper, which conditions on unit noise and divides K_uu by the
learned second noise s2; D the Dirichlet noises of each point for the
classifier, :func:`dirichlet`), the jittered root of A, K_uu from the
hyperparameters, the posterior caches and the predictions.
It imports nothing of the program under test and nothing of the JAX
package. Every function takes its dtype from its inputs: float64 is the
reference, and float32 under :func:`precision` with TF32 on is the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls in TF32 (the control) or in true float32/float64."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Grid(NamedTuple):
    """A Cartesian grid: per-dimension first point and spacing, row-major
    flattening (dimension 0 slowest)."""

    sizes: tuple
    mins: tuple
    spacings: tuple

    @staticmethod
    def create(bounds, size: int, pad: int = 2) -> "Grid":
        """``size`` points a dimension over ``bounds`` widened by ``pad``
        spacings on each side, so that every query inside has its stencil."""
        mins, spacings = [], []
        for lo, hi in bounds:
            h = (hi - lo) / (size - 1 - 2 * pad)
            mins.append(lo - pad * h)
            spacings.append(h)
        return Grid((size,) * len(bounds), tuple(mins), tuple(spacings))

    @property
    def num_points(self) -> int:
        return math.prod(self.sizes)

    def points_1d(self, d: int, dtype, device) -> torch.Tensor:
        return self.mins[d] + self.spacings[d] * torch.arange(self.sizes[d], dtype=dtype, device=device)


def keys_cubic(u: torch.Tensor) -> torch.Tensor:
    """Keys' cubic-convolution kernel, a = -1/2."""
    a = torch.abs(u)
    near = 1.5 * a**3 - 2.5 * a**2 + 1.0
    far = -0.5 * a**3 + 2.5 * a**2 - 4.0 * a + 2.0
    return torch.where(a <= 1.0, near, torch.where(a <= 2.0, far, torch.zeros_like(a)))


def interp(grid: Grid, x: torch.Tensor):
    """Flat grid indices (n, 4^D) and weights (n, 4^D) of the cubic stencil
    of each row of x: the nodes i-1 .. i+2 around u = (x - min) / h with
    i = floor(u) kept inside [1, size - 3]."""
    n = x.shape[0]
    idx = torch.zeros((n, 1), dtype=torch.int64, device=x.device)
    w = torch.ones((n, 1), dtype=x.dtype, device=x.device)
    stride = 1
    strides = []
    for s in reversed(grid.sizes):
        strides.append(stride)
        stride *= s
    strides = strides[::-1]
    for d, size in enumerate(grid.sizes):
        u = (x[:, d] - grid.mins[d]) / grid.spacings[d]
        i = torch.floor(u).to(torch.int64).clamp(1, size - 3)
        nodes = i[:, None] + torch.arange(-1, 3, device=x.device)[None, :]
        wd = keys_cubic(u[:, None] - nodes.to(x.dtype))
        idx = (idx[:, :, None] + nodes[:, None, :] * strides[d]).reshape(n, -1)
        w = (w[:, :, None] * wd[:, None, :]).reshape(n, -1)
    return idx, w


def dense_w(idx: torch.Tensor, w: torch.Tensor, m: int) -> torch.Tensor:
    """W as dense (m, n) columns, repeated indices summed."""
    n, P = idx.shape
    cols = torch.zeros((m, n), dtype=w.dtype, device=w.device)
    rows = torch.arange(n, device=idx.device)[:, None].expand(n, P)
    return cols.index_put((idx.reshape(-1), rows.reshape(-1)), w.reshape(-1), accumulate=True)


def kuu(grid: Grid, lengthscale, outputscale: float, dtype, device) -> torch.Tensor:
    """The RBF K_uu on the grid: outputscale times the Kronecker product of
    the per-dimension exp(-r^2 / 2) matrices."""
    out = None
    for d in range(len(grid.sizes)):
        g = grid.points_1d(d, dtype, device)
        r = (g[:, None] - g[None, :]) / lengthscale[d]
        t = torch.exp(-0.5 * r * r)
        out = t if out is None else torch.kron(out, t)
    return outputscale * out


def dirichlet(labels: torch.Tensor, classes: int, alpha_eps: float, dtype=torch.float64):
    """Milios et al. 2018's Dirichlet transform of integer labels (n,):
    alpha = alpha_eps + onehot(label), noise = log(1 / alpha + 1),
    target = log(alpha) - noise / 2. Returns (targets, noises), each
    (n, classes)."""
    n = labels.shape[0]
    alpha = torch.full((n, classes), alpha_eps, dtype=dtype, device=labels.device)
    alpha[torch.arange(n, device=labels.device), labels] += 1.0
    noise = torch.log1p(1.0 / alpha)
    return torch.log(alpha) - 0.5 * noise, noise


class Data(NamedTuple):
    """What the stream has absorbed so far, in the reference's own terms,
    for each of the B outputs."""

    A: torch.Tensor  # (B, m, m) sum of w w^T / noise over the points
    wty: torch.Tensor  # (B, m) sum of w y / noise
    n: int


def empty(m: int, outputs: int, dtype, device) -> Data:
    return Data(torch.zeros((outputs, m, m), dtype=dtype, device=device),
                torch.zeros((outputs, m), dtype=dtype, device=device), 0)


def absorb(grid: Grid, data: Data, x: torch.Tensor, y: torch.Tensor, noise: torch.Tensor = None,
           block: int = 4096) -> Data:
    """Data after absorbing the points x with targets y (n, B) and noises
    (n, B), or unit noise where ``noise`` is None, in dense products of
    ``block`` points."""
    A, wty = data.A.clone(), data.wty.clone()
    m = grid.num_points
    for s in range(0, x.shape[0], block):
        idx, w = interp(grid, x[s:s + block])
        W = dense_w(idx, w, m)
        for b in range(A.shape[0]):
            Wd = W if noise is None else W / noise[s:s + block, b]
            A[b] += Wd @ W.T
            wty[b] += Wd @ y[s:s + block, b]
    return Data(A, wty, data.n + x.shape[0])


def jitter(A0: torch.Tensor, root_jitter: float) -> float:
    """The root's diagonal shift, fixed when the state is made from the seed
    points: root_jitter times max(mean |diag A0|, 1)."""
    return root_jitter * max(float(torch.mean(torch.abs(torch.diagonal(A0)))), 1.0)


def cholesky(M: torch.Tensor, tries: int = 16) -> torch.Tensor:
    """Lower Cholesky factor of a symmetric positive matrix; where rounding
    leaves it indefinite, with a diagonal shift of 1e-6, 1e-5, ... times
    max(mean |diag|, 1), the first that factors."""
    M = 0.5 * (M + M.T)
    L, info = torch.linalg.cholesky_ex(M)
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    scale = max(float(torch.mean(torch.abs(torch.diagonal(M)))), 1.0)
    for k in range(tries):
        if int(info) == 0:
            return L
        L, info = torch.linalg.cholesky_ex(M + 1e-6 * 10.0**k * scale * eye)
    raise torch.linalg.LinAlgError(f"no Cholesky factor within {tries} shifts")


def root(A: torch.Tensor, eps: float) -> torch.Tensor:
    """The lower root L of A + eps I."""
    return cholesky(A + eps * torch.eye(A.shape[0], dtype=A.dtype, device=A.device))


def root_pair(A: torch.Tensor, eps: float):
    """The root L of A + eps I and its inverse transpose B = L^-T."""
    L = root(A, eps)
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False).T


def root_update(L: torch.Tensor, B: torch.Tensor, V: torch.Tensor):
    """The roots after a block of points, the way a streaming state keeps
    them: L' L'^T = L L^T + V V^T and B' = L'^-T, for V (m, k) the block's
    stencil columns. With P = B^T V and P^T P = U diag(e) U^T,
    L' = L (I + P P^T)^(1/2) = L + V U diag(f) U^T P^T and
    B' = B (I + P P^T)^(-1/2) = B - (B P) U diag(g) U^T P^T, where
    f = 1 / (sqrt(1 + e) + 1) and g = f / sqrt(1 + e)."""
    P = B.T @ V
    e, U = torch.linalg.eigh(P.T @ P)
    r = torch.sqrt(1.0 + torch.clamp(e, min=0.0))
    f, g = 1.0 / (r + 1.0), 1.0 / (r * (r + 1.0))
    L = L + (V @ (U * f) @ U.T) @ P.T
    B = B - ((B @ P) @ (U * g) @ U.T) @ P.T
    return L, B


class Posterior(NamedTuple):
    """The grid-space posterior of one output (in units of s2 where there
    is a second noise): mean (m,), cov (m, m)."""

    mean: torch.Tensor
    cov: torch.Tensor


def posterior(K: torch.Tensor, L: torch.Tensor, wty: torch.Tensor) -> Posterior:
    """The exact caches of SKI regression through the root L of A (Woodbury):
    Q = I + L^T K L, mean = K wty - K L Q^-1 L^T K wty,
    cov = K - (K L) Q^-1 (K L)^T, with K = K_uu / s2 (K_uu without a
    second noise)."""
    KL = K @ L
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    Q = eye + L.T @ KL
    Lq = cholesky(Q)
    Kw = K @ wty
    proj = L.T @ Kw
    sol = torch.cholesky_solve(proj[:, None], Lq)[:, 0]
    mean = Kw - KL @ sol
    R = torch.linalg.solve_triangular(Lq, KL.T, upper=False)
    cov = K - R.T @ R
    return Posterior(mean, 0.5 * (cov + cov.T))


def predict(grid: Grid, post: Posterior, x: torch.Tensor, s2: float = None):
    """Predictive moments at x: mean w^T mu and, with a second noise s2,
    the y-variance s2 (w^T C w) + s2; without one, the latent variance
    w^T C w."""
    idx, w = interp(grid, x)
    mean = torch.sum(w * post.mean[idx], dim=1)
    sub = post.cov[idx[:, :, None], idx[:, None, :]]
    var = torch.einsum("np,npq,nq->n", w, sub, w)
    if s2 is None:
        return mean, torch.clamp(var, min=1e-12)
    return mean, torch.clamp(var * s2, min=1e-12) + s2
