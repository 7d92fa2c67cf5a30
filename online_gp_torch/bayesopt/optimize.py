"""Gradient-based acquisition optimization (port of
``online_gp_tpu/bayesopt/optimize.py``, botorch's ``optimize_acqf``).

Candidates are reparametrized into unconstrained space by a log-odds
transform and ascended from the best raw starts. JAX vmaps the restarts
over a ``lax.while_loop`` whose stopping rule leaves a finished restart's
carry as it is while the others go on. Here the restarts are one batch
with an active mask: each restart keeps its own optimizer state (Adam
moments and step count, or L-BFGS memory and linesearch), its own best
point and value, and stops for good when its rule fails; only the active
restarts are evaluated.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from online_gp_torch.utils.lbfgs import lbfgs_init, lbfgs_update, lbfgs_value_and_grad
from online_gp_torch.utils.optim import adam_init, adam_update


def sobol_raw_init(q: int, d: int, raw_samples: int, seed: int) -> torch.Tensor:
    """Host-side low-discrepancy raw starts for :func:`optimize_acqf`:
    (raw_samples, q, d) float32 on the CPU in (0.02, 0.98), scipy's
    scrambled Sobol (IID uniform without scipy); the JAX package's starts
    for the same seed."""
    try:
        from scipy.stats import qmc

        sob = qmc.Sobol(q * d, scramble=True, seed=seed)
        n_pow2 = 1 << max(int(np.ceil(np.log2(max(raw_samples, 1)))), 0)
        raw = np.asarray(sob.random_base2(int(np.log2(n_pow2)))[:raw_samples], np.float32)
    except ImportError:
        raw = np.random.default_rng(seed).uniform(size=(raw_samples, q * d)).astype(np.float32)
    return torch.from_numpy(0.02 + 0.96 * raw.reshape(raw_samples, q, d))


def optimize_acqf(
    acqf: Callable[[torch.Tensor], torch.Tensor],
    bounds: torch.Tensor,
    q: int,
    num_restarts: int = 10,
    raw_samples: int = 64,
    maxiter: int = 200,
    lr: float = 0.05,
    generator: Optional[torch.Generator] = None,
    method: str = "adam",
    raw_init: Optional[torch.Tensor] = None,
    raw_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize a q-batch acquisition over box bounds.

    Args:
      acqf: (R, q, d) -> (R,) acquisition values, one per row (botorch's
        ``b x q x d`` batch; the rows are independent).
      bounds: (d, 2); the candidates live on its device. The restarts run
        in ``raw_init``'s dtype, as in the JAX package.
      q: candidates per batch.
      method: ``"adam"`` (default) or ``"lbfgs"`` (optax's L-BFGS with its
        zoom linesearch, :mod:`online_gp_torch.utils.lbfgs`) per restart.
      generator: draws the Sobol seed when ``raw_init`` is not given (a
        CPU generator seeded 0 by default, as the JAX default key).
      raw_init: (raw_samples, q, d) starts in (0, 1), e.g. from
        :func:`sobol_raw_init`.
      raw_chunk: score the raw samples this many rows at a time (bounds the
        memory of acquisitions that condition a state per row); all at once
        by default.

    Returns:
      the best restart's candidates (q, d) and its acquisition value.
    """
    if method not in ("adam", "lbfgs"):
        raise ValueError(f"unknown method {method!r} (adam/lbfgs)")
    d = bounds.shape[0]
    lo, hi = bounds[:, 0], bounds[:, 1]
    if raw_init is None:
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        raw_init = sobol_raw_init(q, d, raw_samples, seed)
    raw = raw_init.to(device=bounds.device)  # its dtype is the restarts' (as in JAX)
    raw_x = lo + (hi - lo) * raw
    # the initialization heuristic scores every raw sample: jax.vmap(acqf)
    # in the JAX package, here one batched call (or one per chunk)
    with torch.no_grad():
        chunk = raw_x.shape[0] if raw_chunk is None else raw_chunk
        raw_vals = torch.cat([acqf(raw_x[i : i + chunk]) for i in range(0, raw_x.shape[0], chunk)])
    top = torch.argsort(-raw_vals, stable=True)[:num_restarts]
    xs, vals, _ = optimize_restarts(acqf, bounds, raw[top], maxiter, lr, method)
    best = torch.argmax(vals)
    return xs[best], vals[best]


def optimize_restarts(
    acqf: Callable[[torch.Tensor], torch.Tensor],
    bounds: torch.Tensor,
    starts: torch.Tensor,
    maxiter: int = 200,
    lr: float = 0.05,
    method: str = "adam",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ascend each restart from its start (R, q, d) in (0, 1) (the box's
    unit coordinates) until ``maxiter`` or until its value stops rising
    (after at least 5 iterations: value <= last + 1e-9), as one batch.

    Returns each restart's best candidates (R, q, d), best value (R,) and
    iteration count (R,)."""
    if method not in ("adam", "lbfgs"):
        raise ValueError(f"unknown method {method!r} (adam/lbfgs)")
    if maxiter < 1:
        raise ValueError(f"maxiter must be at least 1 (got {maxiter})")
    lo, hi = bounds[:, 0], bounds[:, 1]
    R, q, d = starts.shape

    def to_x(t):  # unconstrained -> box
        return lo + (hi - lo) * torch.sigmoid(t)

    t = torch.log(starts / (1.0 - starts))  # logit init

    def value_and_grad(tt):
        """(values (r,), d values / d t (r, q, d)) of the acquisition."""
        with torch.enable_grad():
            tt = tt.detach().requires_grad_(True)
            vals = acqf(to_x(tt))
            (g,) = torch.autograd.grad(vals.sum(), tt)
        return vals.detach(), g

    def loss_and_grad(flat):
        """L-BFGS minimizes -acqf, in the params' dtype, on flat rows."""
        vals, g = value_and_grad(flat.reshape(-1, q, d))
        return (-vals).to(flat.dtype), (-g).reshape(flat.shape).to(flat.dtype)

    it = 0
    iters = torch.zeros((R,), dtype=torch.int64, device=t.device)
    last = cur = best_val = None  # (R,) in the acquisition's dtype, from the first evaluation
    best_t = t.clone()
    opt_state = adam_init([t], batch_shape=(R,)) if method == "adam" else lbfgs_init(t.reshape(R, -1))
    active = torch.ones((R,), dtype=torch.bool, device=t.device)
    while bool(active.any()):
        if method == "lbfgs":
            flat = t.reshape(R, -1)
            loss, g = lbfgs_value_and_grad(loss_and_grad, flat, opt_state, active)
            val = -loss
        else:
            sel = torch.nonzero(active).flatten()
            v, g_up = value_and_grad(t[sel])
            val = v.new_zeros((R,))
            g = torch.zeros_like(t)
            val[sel], g[sel] = v, g_up
        if it == 0:
            last = cur = best_val = torch.full_like(val, -float("inf"))
        better = active & (val > best_val)
        best_t = torch.where(better[:, None, None], t, best_t)
        best_val = torch.where(better, val, best_val)
        if method == "lbfgs":
            up, opt_state = lbfgs_update(g, opt_state, flat, loss, loss_and_grad, active)
            t = t + up.reshape(t.shape)
        else:
            (up,), opt_state = adam_update([-g], opt_state, lr, active=active)
            t = t + up
        it += 1
        iters = iters + active
        last = torch.where(active, cur, last)
        cur = torch.where(active, val, cur)
        active = (it < maxiter) & ((it < 5) | (cur > last + 1e-9))
    return to_x(best_t).detach(), best_val, iters
