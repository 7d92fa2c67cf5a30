"""Monte-Carlo acquisition functions over WISKI posteriors (port of
``online_gp_tpu/bayesopt/acquisitions.py``).

The reference takes qEI, qNEI, qUCB, qKG and qMVES from botorch and qNIPV
from ``botorch.acquisition.active_learning``. Every acquisition is a
differentiable function of the candidates, built on

- joint posterior samples f = mean + R eps, with the grid-space covariance
  root R = W_x root(cov_cache) (:func:`wiski_predict_root`), and
- O(m^2) fantasy conditioning for the lookahead acquisitions, on the
  differentiable route (``detach_interp=False``: the plain updates autograd
  takes, never kernels K1, K2 or K3).

Batches: ``x`` is (q, d), which returns a scalar as the JAX functions do,
or (R, q, d) with R independent rows, which returns (R,) (what
:func:`~online_gp_torch.bayesopt.optimize.optimize_acqf` calls: the JAX
package vmaps the scalar form).

Draws: where JAX takes a PRNG key, these take the standard-normal base
samples themselves (``base_samples``, (S, k) for the joint samples, k the
root's rank), or a ``generator`` they are drawn from (on its own device,
then moved). The base samples stay fixed across an optimization, as a
fixed key does, so the acquisition is deterministic.

What does not depend on x is built once per optimization and handed in:
``context`` (:func:`acquisition_context`) holds the prediction caches and
the grid-space root; without it each call builds its own, the same values.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.models.wiski import (
    WiskiModel,
    WiskiState,
    wiski_condition_batched,
    wiski_expand,
    wiski_grid_root,
    wiski_predict,
    wiski_predict_root,
    wiski_prediction_caches,
)
from online_gp_torch.ops.interp import interp_coeffs

LOG_2PI = 1.8378770664093453


class AcquisitionContext(NamedTuple):
    """What an acquisition needs of the posterior that does not depend on
    the candidates: the prediction caches (mean_cache, cov_cache) and the
    grid-space root of cov_cache (None when not built)."""

    caches: Tuple[torch.Tensor, Optional[torch.Tensor]]
    grid_root: Optional[torch.Tensor]


def acquisition_context(model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig = DEFAULT_CONFIG,
                        root: bool = True) -> AcquisitionContext:
    """Build the caches (Q factored by K6 on the card: no grad here) and,
    with ``root``, the grid-space root (at m > cfg.max_root_decomposition_size
    a Lanczos run of that many steps), once."""
    with torch.no_grad():
        caches = wiski_prediction_caches(model, params, state, cfg)
        grid_root = wiski_grid_root(model, params, state, cfg, caches) if root else None
    return AcquisitionContext(caches, grid_root)


def _rows(x: torch.Tensor, state: WiskiState):
    """x (q, d) or (R, q, d) -> (x as (R, q, d) in the dtype it and the
    state's promote to, as the JAX package's products promote; whether to
    squeeze R)."""
    x = x.to(torch.promote_types(x.dtype, state.wty.dtype))
    return (x[None], True) if x.dim() == 2 else (x, False)


def _out(v: torch.Tensor, squeeze: bool) -> torch.Tensor:
    return v[0] if squeeze else v


def _samples(base_samples, generator, shape, like: torch.Tensor, what: str) -> torch.Tensor:
    if base_samples is None:
        if generator is None:
            raise ValueError(f"{what} is a MC estimator and needs base_samples or a generator")
        base_samples = torch.randn(shape, generator=generator, dtype=like.dtype, device=generator.device)
    return base_samples.to(dtype=like.dtype, device=like.device)


def _context(model, params, state, cfg, context, root=True) -> AcquisitionContext:
    if context is None:
        caches = wiski_prediction_caches(model, params, state, cfg)
        return AcquisitionContext(caches, wiski_grid_root(model, params, state, cfg, caches) if root else None)
    if root and context.grid_root is None:
        return AcquisitionContext(context.caches, wiski_grid_root(model, params, state, cfg, context.caches))
    return context


def _joint_samples(model, params, state, x3, eps, cfg, ctx) -> torch.Tensor:
    """(R, S, n) joint posterior samples (output 0) at the rows of x3
    (R, n, d), from base samples eps (S, k)."""
    R, n, d = x3.shape
    mean, root = wiski_predict_root(model, params, state, x3.reshape(R * n, d), cfg, ctx.caches, ctx.grid_root)
    mean, root = mean[0].reshape(R, n), root[0].reshape(R, n, -1)
    return mean[:, None, :] + torch.einsum("sk,rnk->rsn", eps.to(root.dtype), root)


def _marginal(model, params, state, x3, cfg, ctx):
    """Mean and variance (R, q) of output 0 at the rows of x3."""
    R, q, d = x3.shape
    mean, var = wiski_predict(model, params, state, x3.reshape(R * q, d), cfg, ctx.caches)
    return mean[0].reshape(R, q), var[0].reshape(R, q)


def _predict_rows(model: WiskiModel, params: Dict, caches, x: torch.Tensor, cfg: SolverConfig = DEFAULT_CONFIG):
    """Moments of output 0 of a batch of N states, each at its own points:
    caches with a leading N ((N, B, m, 1), (N, B, m, m) or None), x (N, K, d).
    Returns mean (N, K) and variance (N, K) or None, as :func:`wiski_predict`
    computes them (the variance rescaled by the second noise and clamped)."""
    mean_cache, cov_cache = caches
    N, K, d = x.shape
    idx, w = interp_coeffs(model.grid, x.reshape(N * K, d), detach=cfg.detach_interp_coeff)
    idx, w = idx.reshape(N, K, -1), w.reshape(N, K, -1)
    rows = torch.arange(N, device=x.device)[:, None, None]
    mean = torch.sum(w * mean_cache[:, 0, :, 0][rows, idx], dim=-1)
    if cov_cache is None:
        return mean, None
    sub = cov_cache[:, 0][rows[..., None], idx[..., :, None], idx[..., None, :]]  # (N, K, P, P)
    var = torch.einsum("nkp,nkpq,nkq->nk", w, sub, w)
    if model.learn_additional_noise:
        var = var * torch.exp(params["raw_second_noise"])[0]
    return mean, torch.clamp(var, min=1e-12)


def q_expected_improvement(
    model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, best_f, base_samples=None,
    num_samples: int = 256, cfg: SolverConfig = DEFAULT_CONFIG, generator: Optional[torch.Generator] = None,
    context: Optional[AcquisitionContext] = None,
) -> torch.Tensor:
    """qEI(X) = E[max_j relu(f(x_j) - best_f)].

    At q = 1 the analytic form sigma (z Phi(z) + phi(z)), the MC
    estimator's exact expectation: it needs only the marginal moments."""
    x3, squeeze = _rows(x, state)
    if x3.shape[1] == 1:
        ctx = _context(model, params, state, cfg, context, root=False)
        mean, var = _marginal(model, params, state, x3, cfg, ctx)
        sigma = torch.sqrt(torch.clamp(var[:, 0], min=1e-12))
        z = (mean[:, 0] - best_f) / sigma
        phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        Phi = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
        return _out(sigma * (z * Phi + phi), squeeze)
    ctx = _context(model, params, state, cfg, context)
    eps = _samples(base_samples, generator, (num_samples, ctx.grid_root.shape[-1]), ctx.grid_root, "qEI")
    f = _joint_samples(model, params, state, x3, eps, cfg, ctx)
    return _out(torch.mean(torch.amax(torch.relu(f - best_f), dim=-1), dim=-1), squeeze)


def q_upper_confidence_bound(
    model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, beta, base_samples=None,
    num_samples: int = 256, cfg: SolverConfig = DEFAULT_CONFIG, generator: Optional[torch.Generator] = None,
    context: Optional[AcquisitionContext] = None,
) -> torch.Tensor:
    """qUCB(X) = E[max_j (mu_j + sqrt(beta pi / 2) |f_j - mu_j|)], botorch's
    MC q-batch form over joint samples. At q = 1 the analytic form
    mu + sqrt(beta) sigma (the estimator's exact expectation); q > 1 needs
    base samples or a generator."""
    x3, squeeze = _rows(x, state)
    if x3.shape[1] == 1:
        ctx = _context(model, params, state, cfg, context, root=False)
        mean, var = _marginal(model, params, state, x3, cfg, ctx)
        return _out(torch.amax(mean + torch.sqrt(beta * torch.clamp(var, min=1e-12)), dim=-1), squeeze)
    ctx = _context(model, params, state, cfg, context)
    eps = _samples(base_samples, generator, (num_samples, ctx.grid_root.shape[-1]), ctx.grid_root, "qUCB at q > 1")
    R, q, d = x3.shape
    mean, root = wiski_predict_root(model, params, state, x3.reshape(R * q, d), cfg, ctx.caches, ctx.grid_root)
    mean, root = mean[0].reshape(R, q), root[0].reshape(R, q, -1)
    dev = torch.einsum("sk,rqk->rsq", eps.to(root.dtype), root)  # zero-mean joint deviations
    ucb = mean[:, None, :] + (beta * math.pi / 2.0) ** 0.5 * torch.abs(dev)
    return _out(torch.mean(torch.amax(ucb, dim=-1), dim=-1), squeeze)


def q_noisy_expected_improvement(
    model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, x_baseline: torch.Tensor,
    base_samples=None, num_samples: int = 256, cfg: SolverConfig = DEFAULT_CONFIG,
    generator: Optional[torch.Generator] = None, context: Optional[AcquisitionContext] = None,
) -> torch.Tensor:
    """qNEI(X) = E[max f(X) - max f(X_baseline)]_+ over joint samples."""
    x3, squeeze = _rows(x, state)
    R, q, d = x3.shape
    ctx = _context(model, params, state, cfg, context)
    eps = _samples(base_samples, generator, (num_samples, ctx.grid_root.shape[-1]), ctx.grid_root, "qNEI")
    joint = torch.cat([x3, x_baseline.to(x3.dtype).expand(R, *x_baseline.shape)], dim=1)
    f = _joint_samples(model, params, state, joint, eps, cfg, ctx)
    new_max = torch.amax(f[..., :q], dim=-1)
    base_max = torch.amax(f[..., q:], dim=-1)
    return _out(torch.mean(torch.relu(new_max - base_max), dim=-1), squeeze)


def q_knowledge_gradient(
    model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, x_discrete: torch.Tensor,
    current_best, base_samples=None, num_fantasies: int = 16, cfg: SolverConfig = DEFAULT_CONFIG,
    lookahead_steps: int = 20, lookahead_lr: float = 0.05, num_inner_restarts: int = 4,
    generator: Optional[torch.Generator] = None, context: Optional[AcquisitionContext] = None,
) -> torch.Tensor:
    """One-step lookahead KG: sample fantasy observations at X (base samples
    (num_fantasies, k)), condition the state on each (O(m^2) per fantasy,
    differentiably), and average the max posterior-mean gain.

    The inner maximization starts from the ``num_inner_restarts`` best
    points of ``x_discrete`` and takes ``lookahead_steps`` of projected
    gradient ascent on the fantasy mean (0: the discrete max alone). The
    ascent differentiates the mean with respect to the location only: the
    fantasy mean cache is detached (built once per fantasy, the JAX
    package's ``stop_gradient`` of the state), and so is the optimized
    location (envelope theorem), so the X-gradient flows through the
    fantasy-conditioned caches alone."""
    x3, squeeze = _rows(x, state)
    R, q, d = x3.shape
    ctx = _context(model, params, state, cfg, context)
    eps = _samples(base_samples, generator, (num_fantasies, ctx.grid_root.shape[-1]), ctx.grid_root, "qKG")
    fant_y = _joint_samples(model, params, state, x3, eps, cfg, ctx)  # (R, F, q)
    F = fant_y.shape[1]
    B = model.num_outputs
    cfg_mean = cfg.replace(skip_posterior_variances=True)
    xd = x_discrete.to(x3.dtype)
    lo = torch.amin(xd, dim=0)
    hi = torch.amax(xd, dim=0)

    xf = x3[:, None].expand(R, F, q, d).reshape(R * F, q, d)
    yf = fant_y.reshape(R * F, q, 1).expand(R * F, q, B)
    noise = torch.ones_like(yf)
    st = wiski_condition_batched(model, wiski_expand(state, R * F), xf, yf, noise)
    mean_cache, _ = wiski_prediction_caches(model, params, st, cfg_mean)  # (RF, B, m, 1)
    m_disc, _ = wiski_predict(model, params, st, xd, cfg_mean, (mean_cache, None))
    m_disc = m_disc[:, 0]  # (RF, N)
    best = torch.amax(m_disc, dim=-1)
    if lookahead_steps > 0:
        k = min(num_inner_restarts, xd.shape[0])
        xx = xd[torch.topk(m_disc.detach(), k, dim=-1).indices]  # (RF, k, d)
        cache_sg = (mean_cache.detach(), None)
        for _ in range(lookahead_steps):
            with torch.enable_grad():
                xg = xx.detach().requires_grad_(True)
                mm, _ = _predict_rows(model, params, cache_sg, xg, cfg_mean)
                (g,) = torch.autograd.grad(mm.sum(), xg)
            xx = torch.clamp(xx + lookahead_lr * g, lo, hi)
        vals, _ = _predict_rows(model, params, (mean_cache, None), xx.detach(), cfg_mean)  # (RF, k)
        # never below the best discrete seed's value
        best = torch.maximum(torch.amax(vals, dim=-1), best)
    return _out(torch.mean(best.reshape(R, F), dim=-1) - current_best, squeeze)


def mves_max_values(
    model: WiskiModel, params: Dict, state: WiskiState, candidate_set: torch.Tensor, max_samples: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG, max_value_method: str = "joint",
    context: Optional[AcquisitionContext] = None,
) -> torch.Tensor:
    """qMVES's max-value draws y* (S,), which do not depend on x.

    - ``"joint"`` (the reference's): the max over each joint posterior draw
      at the candidate set; ``max_samples`` are the normals (S, k).
    - ``"gumbel"``: Wang and Jegelka's Gumbel fit to the product of the
      marginal CDFs at the quartiles; ``max_samples`` are uniforms (S,) in
      (1e-4, 1 - 1e-4).
    """
    if max_value_method == "joint":
        ctx = _context(model, params, state, cfg, context)
        f_cand = _joint_samples(model, params, state, candidate_set[None], max_samples, cfg, ctx)[0]
        return torch.amax(f_cand, dim=-1)
    if max_value_method != "gumbel":
        raise ValueError(f"unknown max_value_method {max_value_method!r} (joint/gumbel)")
    ctx = _context(model, params, state, cfg, context, root=False)
    mean_c, var_c = wiski_predict(model, params, state, candidate_set, cfg, ctx.caches)
    mu, sd = mean_c[0], torch.sqrt(torch.clamp(var_c[0], min=1e-12))
    # the 0.25 / 0.5 / 0.75 quantiles of prod Phi((y - mu) / sd), 30 bisections each
    p = torch.tensor([0.25, 0.5, 0.75], dtype=mu.dtype, device=mu.device)
    a = torch.amin(mu - 5 * sd).expand(3)
    b = torch.amax(mu + 5 * sd).expand(3)
    for _ in range(30):
        mid = 0.5 * (a + b)
        below = torch.sum(torch.special.log_ndtr((mid[:, None] - mu[None]) / sd[None]), dim=-1) < torch.log(p)
        a, b = torch.where(below, mid, a), torch.where(below, b, mid)
    y25, y50, y75 = 0.5 * (a + b)
    scale = torch.clamp((y75 - y25) / (math.log(math.log(4.0)) - math.log(math.log(4.0 / 3.0))), min=1e-6)
    loc = y50 + scale * math.log(math.log(2.0))
    return loc - scale * torch.log(-torch.log(max_samples.to(mu.dtype)))


def _gain(mu, var, ys):
    """Truncated-normal information gain E_{y*}[gamma phi / (2 Phi) - log Phi],
    gamma = (y* - mu) / sigma: mu, var (...,), ys (..., S) -> (...,)."""
    sd = torch.sqrt(torch.clamp(var, min=1e-12))
    gamma = (ys - mu[..., None]) / sd[..., None]
    log_cdf = torch.special.log_ndtr(gamma)
    pdf = torch.exp((LOG_2PI + gamma**2) / -2.0)
    return torch.mean(gamma * pdf / (2.0 * torch.exp(log_cdf)) - log_cdf, dim=-1)


def q_max_value_entropy(
    model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, candidate_set: torch.Tensor,
    max_samples=None, num_max_samples: int = 16, cfg: SolverConfig = DEFAULT_CONFIG, num_fantasies: int = 8,
    noise_value: float = 1.0, max_value_method: str = "joint", fantasy_samples=None,
    generator: Optional[torch.Generator] = None, context: Optional[AcquisitionContext] = None,
    y_star: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """qMVES, max-value entropy search: a(x) = E_{y*}[gain(x)] with y* from
    :func:`mves_max_values` (``y_star`` when given: it does not depend on
    x, so an optimization draws it once; else from ``max_samples``, or from
    ``generator``).

    For q > 1 the batch is priced by botorch's sequential decomposition:
    sum_j E[gain(x_j | fantasy observations at x_<j)], with joint fantasy
    draws at X (``fantasy_samples`` (num_fantasies, k), the second split of
    the JAX package's key) and one differentiable rank-1 conditioning per
    fantasy and step, at observation noise ``noise_value``; the max is at
    least the fantasized values already seen (``run_max``).
    """
    x3, squeeze = _rows(x, state)
    R, q, d = x3.shape
    need_root = max_value_method == "joint" or q > 1
    ctx = _context(model, params, state, cfg, context, root=need_root)
    if y_star is None:
        if max_samples is None:
            if generator is None:
                raise ValueError("qMVES needs y_star, max_samples or a generator")
            if max_value_method == "joint":
                max_samples = _samples(None, generator, (num_max_samples, ctx.grid_root.shape[-1]), x3, "qMVES")
            else:
                u = torch.rand((num_max_samples,), generator=generator, dtype=x3.dtype, device=generator.device)
                max_samples = (1e-4 + (1 - 2e-4) * u).to(x3.device)
        y_star = mves_max_values(model, params, state, candidate_set, max_samples.to(x3.device), cfg,
                                 max_value_method, ctx)
    mean, var = _marginal(model, params, state, x3[:, :1], cfg, ctx)
    total = _gain(mean[:, 0], var[:, 0], y_star.expand(R, -1))
    if q == 1:
        return _out(total, squeeze)

    eps = _samples(fantasy_samples, generator, (num_fantasies, ctx.grid_root.shape[-1]), ctx.grid_root,
                   "qMVES at q > 1")
    fant_y = _joint_samples(model, params, state, x3, eps, cfg, ctx)  # (R, F, q)
    F, B = fant_y.shape[1], model.num_outputs
    sts = wiski_expand(state, R * F)
    run_max = torch.full((R, F), -float("inf"), dtype=fant_y.dtype, device=fant_y.device)
    for j in range(1, q):
        xj = x3[:, j - 1][:, None].expand(R, F, d).reshape(R * F, 1, d)
        yj = fant_y[:, :, j - 1]  # (R, F)
        noise = torch.full((R * F, 1, B), noise_value, dtype=fant_y.dtype, device=fant_y.device)
        sts = wiski_condition_batched(model, sts, xj, yj.reshape(R * F, 1, 1).expand(R * F, 1, B), noise)
        run_max = torch.maximum(run_max, yj)
        caches = wiski_prediction_caches(model, params, sts, cfg)
        x_next = x3[:, j][:, None].expand(R, F, d).reshape(R * F, 1, d)
        mu, v = _predict_rows(model, params, caches, x_next, cfg)
        ys = torch.maximum(y_star[None, None, :], run_max[..., None])  # (R, F, S)
        total = total + torch.mean(_gain(mu.reshape(R, F), v.reshape(R, F), ys), dim=-1)
    return _out(total, squeeze)


def q_negative_integrated_posterior_variance(
    model: WiskiModel, params: Dict, state: WiskiState, x: torch.Tensor, mc_points: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG, noise_value: float = 1.0,
) -> torch.Tensor:
    """qNIPV(X) = -mean_i Var[f(s_i) | D + X], the active-learning
    acquisition. The fantasy variance does not depend on y: one
    differentiable conditioning per row, at observation noise
    ``noise_value``."""
    x3, squeeze = _rows(x, state)
    R, q, d = x3.shape
    B = model.num_outputs
    dummy_y = torch.zeros((R, q, B), dtype=x3.dtype, device=x3.device)
    noise = torch.full((R, q, B), noise_value, dtype=x3.dtype, device=x3.device)
    st = wiski_condition_batched(model, wiski_expand(state, R), x3, dummy_y, noise)
    _, var = wiski_predict(model, params, st, mc_points.to(x3.dtype), cfg)  # (R, B, n)
    return _out(-torch.mean(var, dim=(-2, -1)), squeeze)
