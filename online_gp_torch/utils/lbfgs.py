"""optax's L-BFGS, over a batch of flat parameter vectors.

The algorithm of ``optax.lbfgs()`` (optax 0.2.6, ``_src/alias.py`` and
``_src/linesearch.py``), written out for tensors so that the port's BO
refit and acquisition restarts take the same iterates as the JAX package
(``torch.optim.LBFGS`` is a different method: another linesearch and
another first step):

- ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the
  two-loop product with the last 10 (param, gradient) differences; at the
  first step the identity is scaled by min(1, 1/|g|), a unit-ball cap;
- ``scale(-1)``, the descent direction d = -P g;
- ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` with its defaults (slope_rtol 1e-4,
  curv_rtol 0.9, approx_dec_rtol 1e-6, increase_factor 2,
  stepsize_precision 1e-5, tol 0, no max stepsize): an interval search
  from a unit step, then the zoom by cubic, quadratic or bisection
  interpolation, and the safe-step fallback when it fails;
- the value and gradient at the new params cached in the state, as
  ``optax.value_and_grad_from_state`` reads them back.

Every tensor carries a leading batch of R independent problems (the
restarts of ``optimize_acqf``; R = 1 for the refit), each with its own
count, memory and linesearch, as ``jax.vmap`` over the optax loop runs
them. The linesearch evaluates all unfinished rows in one call of
``value_and_grad_fn``: x (r, n) -> (values (r,), grads (r, n)).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5  # scale_by_zoom_linesearch's stepsize_precision
TOL = 0.0

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class LbfgsState(NamedTuple):
    count: torch.Tensor  # (R,) int64: updates taken
    params: torch.Tensor  # (R, n) params at the last update
    updates: torch.Tensor  # (R, n) gradient at the last update
    diff_params: torch.Tensor  # (R, M, n)
    diff_updates: torch.Tensor  # (R, M, n)
    weights: torch.Tensor  # (R, M)
    learning_rate: torch.Tensor  # (R,) the linesearch's last stepsize
    value: torch.Tensor  # (R,) value at the current params (inf: none cached)
    grad: torch.Tensor  # (R, n) gradient at the current params


def lbfgs_init(params: torch.Tensor) -> LbfgsState:
    """State for params (R, n)."""
    R, n = params.shape
    z = torch.zeros_like(params)
    return LbfgsState(
        count=torch.zeros((R,), dtype=torch.int64, device=params.device),
        params=z,
        updates=z,
        diff_params=params.new_zeros((R, MEMORY_SIZE, n)),
        diff_updates=params.new_zeros((R, MEMORY_SIZE, n)),
        weights=params.new_zeros((R, MEMORY_SIZE)),
        learning_rate=params.new_ones((R,)),
        value=torch.full((R,), float("inf"), dtype=params.dtype, device=params.device),
        grad=z,
    )


def _eval_rows(fn: ValueAndGrad, x: torch.Tensor, rows: torch.Tensor):
    """fn on the rows of x where ``rows`` is set, scattered back into (R,)
    and (R, n) tensors (zeros elsewhere, which callers mask out)."""
    if bool(rows.all()):
        return fn(x)
    values = x.new_zeros(x.shape[0])
    grads = torch.zeros_like(x)
    sel = torch.nonzero(rows).flatten()
    if sel.numel():
        v, g = fn(x[sel])
        values[sel] = v.to(x.dtype)
        grads[sel] = g.to(x.dtype)
    return values, grads


def lbfgs_value_and_grad(fn: ValueAndGrad, params: torch.Tensor, state: LbfgsState,
                         active: Optional[torch.Tensor] = None):
    """``optax.value_and_grad_from_state``: the cached value and gradient
    where the cached value is finite, fn's elsewhere (only rows in
    ``active`` are evaluated)."""
    cached = torch.isfinite(state.value)
    need = ~cached if active is None else (~cached & active)
    if not bool(need.any()):
        return state.value, state.grad
    v, g = _eval_rows(fn, params, need)
    return torch.where(need, v, state.value), torch.where(need[:, None], g, state.grad)


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def _precondition(updates, diff_params, diff_updates, weights, identity_scale, memory_idx):
    """Algorithm 7.4 of Nocedal and Wright, as optax's two ``lax.scan``s."""
    R, M, _ = diff_params.shape
    rows = torch.arange(R, device=updates.device)
    indices = (memory_idx[:, None] + torch.arange(M, device=updates.device)[None, :]) % M  # (R, M)
    vec = updates
    alphas = [None] * M
    for j in reversed(range(M)):
        idx = indices[:, j]
        dw, du = diff_params[rows, idx], diff_updates[rows, idx]
        alpha = weights[rows, idx] * _vdot(dw, vec)
        vec = vec + (-alpha)[:, None] * du
        alphas[j] = alpha
    vec = identity_scale[:, None] * vec
    for j in range(M):
        idx = indices[:, j]
        dw, du = diff_params[rows, idx], diff_updates[rows, idx]
        beta = weights[rows, idx] * _vdot(du, vec)
        vec = vec + (alphas[j] - beta)[:, None] * dw
    return vec


def _scale_by_lbfgs(grad, state: LbfgsState, params):
    """``scale_by_lbfgs``: the preconditioned gradient and the new memory."""
    M = state.weights.shape[1]
    R = params.shape[0]
    rows = torch.arange(R, device=params.device)
    memory_idx = state.count % M
    prev_idx = (state.count - 1) % M
    diff_params = params - state.params
    diff_updates = grad - state.updates
    vdot = _vdot(diff_updates, diff_params)
    weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    first = state.count == 0
    diff_params = torch.where(first[:, None], torch.zeros_like(diff_params), diff_params)
    diff_updates = torch.where(first[:, None], torch.zeros_like(diff_updates), diff_updates)
    weight = torch.where(first, torch.zeros_like(weight), weight)
    dp_mem, du_mem, w_mem = state.diff_params.clone(), state.diff_updates.clone(), state.weights.clone()
    dp_mem[rows, prev_idx] = diff_params
    du_mem[rows, prev_idx] = diff_updates
    w_mem[rows, prev_idx] = weight

    numerator = _vdot(diff_updates, diff_params)
    denominator = _vdot(diff_updates, diff_updates)
    identity_scale = torch.where(denominator > 0.0, numerator / denominator, torch.ones_like(numerator))
    update_norm = torch.sqrt(_vdot(grad, grad))
    capped_inv_norm = torch.minimum(torch.ones_like(update_norm), 1.0 / update_norm)
    identity_scale = torch.where(state.count > 0, identity_scale, capped_inv_norm)
    precond = _precondition(grad, dp_mem, du_mem, w_mem, identity_scale, memory_idx)
    return precond, (dp_mem, du_mem, w_mem)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc**2 * r0 + (-(db**2)) * r1) / denom
    B = ((-(dc**3)) * r0 + db**3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta_values)
    dec = torch.minimum(approx, dec)
    dec = torch.clamp(dec, min=0.0)
    return torch.where(torch.isnan(dec), torch.full_like(dec, float("inf")), dec)


def _curvature_error(slope_step, slope_init):
    curv = torch.clamp(torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init), min=0.0)
    return torch.where(torch.isnan(curv), torch.full_like(curv, float("inf")), curv)


_LS_FIELDS = ("count", "stepsize", "value", "grad", "slope", "decrease_error", "curvature_error", "interval_found",
              "done", "failed", "low", "value_low", "slope_low", "high", "value_high", "slope_high", "cubic_ref",
              "value_cubic_ref", "safe_stepsize", "safe_value", "safe_grad")


def _where(cond, new: dict, old: dict) -> dict:
    out = {}
    for k in old:
        a, b = new[k], old[k]
        c = cond if a.dim() == 1 else cond[:, None]
        out[k] = torch.where(c, a, b)
    return out


def zoom_linesearch(fn: ValueAndGrad, params, updates, value, grad, active: Optional[torch.Tensor] = None):
    """``scale_by_zoom_linesearch``'s while loop for each row: returns the
    stepsize, and the value and gradient at params + stepsize * updates.
    Rows outside ``active`` start done and return stepsize 0."""
    R = params.shape[0]
    dtype, dev = params.dtype, params.device
    zeros = torch.zeros((R,), dtype=dtype, device=dev)
    slope = _vdot(updates, grad)
    false = torch.zeros((R,), dtype=torch.bool, device=dev)
    s = dict(
        count=torch.zeros((R,), dtype=torch.int64, device=dev), stepsize=zeros, value=value, grad=grad, slope=slope,
        decrease_error=torch.full_like(zeros, float("inf")), curvature_error=torch.full_like(zeros, float("inf")),
        interval_found=false, done=false if active is None else ~active, failed=false, low=zeros,
        value_low=value, slope_low=slope, high=zeros, value_high=value, slope_high=slope, cubic_ref=zeros,
        value_cubic_ref=value, safe_stepsize=zeros, safe_value=value, safe_grad=grad,
    )
    value_init, slope_init = value, slope
    while True:
        running = ~(s["done"] | s["failed"])
        if not bool(running.any()):
            break
        found = s["interval_found"]
        low, high = s["low"], s["high"]
        vlow, slow, vhigh, shigh = s["value_low"], s["slope_low"], s["value_high"], s["slope_high"]

        # interval search (Algorithm 3.5): the stepsize to try
        new_stepsize = torch.where(s["count"] == 0, torch.ones_like(zeros), INCREASE_FACTOR * s["stepsize"])
        # zoom (Algorithm 3.6): the interpolated middle
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small_int = delta <= INTERVAL_THRESHOLD
        m_cubic = _cubicmin(low, vlow, slow, high, vhigh, s["cubic_ref"], s["value_cubic_ref"])
        use_cubic = (m_cubic > left + cubic_chk) & (m_cubic < right - cubic_chk)
        m_quad = _quadmin(low, vlow, slow, high, vhigh)
        use_quad = (~use_cubic) & (m_quad > left + quad_chk) & (m_quad < right - quad_chk)
        use_bisection = (~use_cubic) & (~use_quad)
        middle = torch.where(use_cubic, m_cubic, s["cubic_ref"])
        middle = torch.where(use_quad, m_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)

        step = torch.where(found, middle, new_stepsize)
        v, g = _eval_rows(fn, params + step[:, None] * updates, running)
        sl = _vdot(g, updates)
        dec = _decrease_error(step, v, sl, value_init, slope_init)
        curv = _curvature_error(sl, slope_init)
        err = torch.maximum(dec, curv)
        safe_decrease = dec <= TOL
        count = s["count"] + 1

        # the search branch's new state
        upd_safe = safe_decrease
        set_high_to_new = (dec > 0.0) | ((v >= s["value"]) & (s["count"] > 0))
        set_low_to_new = (sl >= 0.0) & (~set_high_to_new)
        sw = lambda a, b: torch.where(set_low_to_new, a, b)
        new_low, new_vlow, new_slow = sw(step, s["stepsize"]), sw(v, s["value"]), sw(sl, s["slope"])
        search = dict(
            count=count, stepsize=step, value=v, grad=g, slope=sl, decrease_error=dec, curvature_error=curv,
            interval_found=set_high_to_new | set_low_to_new | (err <= TOL), done=err <= TOL,
            failed=(count >= MAX_LINESEARCH_STEPS) & ~(err <= TOL),
            low=new_low, value_low=new_vlow, slope_low=new_slow,
            high=sw(s["stepsize"], step), value_high=sw(s["value"], v), slope_high=sw(s["slope"], sl),
            cubic_ref=new_low, value_cubic_ref=new_vlow,
            safe_stepsize=torch.where(upd_safe, step, s["safe_stepsize"]),
            safe_value=torch.where(upd_safe, v, s["safe_value"]),
            safe_grad=torch.where(upd_safe[:, None], g, s["safe_grad"]),
        )

        # the zoom branch's new state
        upd_safe = safe_decrease & (v < s["safe_value"])
        new_safe_stepsize = torch.where(upd_safe, step, s["safe_stepsize"])
        done = err <= TOL
        set_high_to_middle = (dec > 0.0) | (v >= vlow)
        set_high_to_low = (sl * (high - low) >= 0.0) & (~set_high_to_middle)
        set_low_to_middle = ~set_high_to_middle
        hm = lambda a, b: torch.where(set_high_to_middle, a, b)
        hl = lambda a, b: torch.where(set_high_to_low, a, b)
        lm = lambda a, b: torch.where(set_low_to_middle, a, b)
        moved_high = set_high_to_middle | set_high_to_low
        zoom = dict(
            count=count, stepsize=step, value=v, grad=g, slope=sl, decrease_error=dec, curvature_error=curv,
            interval_found=found, done=done,
            failed=((count >= MAX_LINESEARCH_STEPS) | (too_small_int & (new_safe_stepsize > 0.0))) & ~done,
            low=lm(step, low), value_low=lm(v, vlow), slope_low=lm(sl, slow),
            high=hl(low, hm(step, high)), value_high=hl(vlow, hm(v, vhigh)), slope_high=hl(slow, hm(sl, shigh)),
            cubic_ref=torch.where(moved_high, high, low), value_cubic_ref=torch.where(moved_high, vhigh, vlow),
            safe_stepsize=new_safe_stepsize, safe_value=torch.where(upd_safe, v, s["safe_value"]),
            safe_grad=torch.where(upd_safe[:, None], g, s["safe_grad"]),
        )
        new = _where(found, zoom, search)

        # a failed search falls back to the safe step where there is one
        failed = new["failed"]
        use_safe = failed & ((new["safe_stepsize"] > 0.0) | torch.isinf(new["decrease_error"]))
        new["stepsize"] = torch.where(use_safe, new["safe_stepsize"], new["stepsize"])
        new["value"] = torch.where(use_safe, new["safe_value"], new["value"])
        new["grad"] = torch.where(use_safe[:, None], new["safe_grad"], new["grad"])
        s = _where(running, new, s)
    return s["stepsize"], s["value"], s["grad"]


def lbfgs_update(grad: torch.Tensor, state: LbfgsState, params: torch.Tensor, value: torch.Tensor,
                 fn: ValueAndGrad, active: Optional[torch.Tensor] = None):
    """``optax.lbfgs().update(grad, state, params, value=value, grad=grad,
    value_fn=...)``: returns (updates, new state); params + updates is the
    next iterate. Rows outside ``active`` get a zero update and keep their
    state."""
    precond, (dp_mem, du_mem, w_mem) = _scale_by_lbfgs(grad, state, params)
    direction = -precond
    stepsize, new_value, new_grad = zoom_linesearch(fn, params, direction, value, grad, active)
    updates = stepsize[:, None] * direction
    new = LbfgsState(
        count=state.count + 1, params=params, updates=grad, diff_params=dp_mem, diff_updates=du_mem, weights=w_mem,
        learning_rate=stepsize, value=new_value, grad=new_grad,
    )
    if active is None:
        return updates, new
    updates = torch.where(active[:, None], updates, torch.zeros_like(updates))
    kept = []
    for a, b in zip(new, state):
        c = active.reshape(active.shape + (1,) * (a.dim() - 1))
        kept.append(torch.where(c, a, b))
    return updates, LbfgsState(*kept)
