"""Adam over parameter groups, in the form the baselines' optax chains
take (``optax.multi_transform`` of ``optax.adam``s, ``optax.zero_nans`` in
front, learning-rate schedules).

``torch.optim.Adam`` has optax's update formula (b1 0.9, b2 0.999, eps
1e-8, eps_root 0). What optax adds is kept here:

- a group's rate may be a function of the step count, as an optax schedule
  reads its count: the first step reads 0;
- a leaf whose gradient does not exist (the loss does not reach it) gets a
  zero gradient, never ``None``: ``torch.optim.Adam`` skips a parameter
  without a gradient, while optax moves it on its moments;
- ``zero_nans`` sets NaN entries of each gradient to 0 and lets +-Inf
  through, as ``optax.zero_nans``;
- a leaf frozen by ``optax.set_to_zero`` is simply left out of every
  group, so it builds no Adam state.

:func:`adam_init` / :func:`adam_update` are ``optax.adam`` as functions of
explicit state, batched over rows that each keep their own count (the
restarts of ``bayesopt.optimize.optimize_acqf``); :func:`adam_fit` runs
them on a loss of a nested dict of params (the BayesOpt and
active-learning refits).

:class:`GradientTransformation` is optax's contract on the params' leaves
(a list in :func:`tree_leaves` order): ``init(leaves) -> state`` and
``update(grads, state, leaves=None) -> (updates, state)``, the updates
added to the leaves. :func:`adam`, :func:`zero_nans` and :func:`chain` are
``optax.adam``, ``optax.zero_nans`` and ``optax.chain``; the mesh steps of
``parallel.mesh`` take one, as the JAX package's take an optax
transformation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Rate = Union[float, Callable[[int], float]]


class GroupAdam:
    def __init__(self, groups: Sequence[Tuple[Sequence[torch.Tensor], Rate]], zero_nans: bool = False):
        groups = [(list(leaves), rate) for leaves, rate in groups if len(leaves)]
        self.leaves = [p for leaves, _ in groups for p in leaves]
        self.rates = [rate for _, rate in groups]
        self.zero_nans = zero_nans
        self.count = 0
        self.opt = torch.optim.Adam([{"params": leaves, "lr": self._rate(rate)} for leaves, rate in groups]) \
            if groups else None

    def _rate(self, rate: Rate) -> float:
        return rate(self.count) if callable(rate) else rate

    def apply(self, grads: Sequence) -> None:
        """One step on these gradients, one per leaf (None: no gradient)."""
        for p, g in zip(self.leaves, grads):
            g = torch.zeros_like(p) if g is None else g
            p.grad = _nan_to_zero(g) if self.zero_nans else g
        for group, rate in zip(self.opt.param_groups, self.rates):
            group["lr"] = self._rate(rate)
        self.opt.step()
        self.count += 1


def adam_step(loss: torch.Tensor, *opts) -> None:
    """One step of each optimizer on the gradient of ``loss`` with respect to
    its leaves, taken in one backward pass (``None`` and leafless optimizers
    are skipped)."""
    opts = [o for o in opts if o is not None and o.opt is not None]
    leaves = [p for o in opts for p in o.leaves]
    if not leaves:
        return
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    start = 0
    for o in opts:
        o.apply(grads[start : start + len(o.leaves)])
        start += len(o.leaves)


class AdamState(NamedTuple):
    """Functional Adam state: the step count (``()`` or one per row of a
    batch of independent problems) and the two moments, one per leaf."""

    count: torch.Tensor
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


def adam_init(leaves: Sequence[torch.Tensor], batch_shape=()) -> AdamState:
    """Zero moments; ``batch_shape`` (leading dims of every leaf) gives each
    row its own count, as ``jax.vmap`` over ``optax.adam`` does."""
    dev = leaves[0].device
    return AdamState(
        count=torch.zeros(batch_shape, dtype=torch.int64, device=dev),
        mu=tuple(torch.zeros_like(p) for p in leaves),
        nu=tuple(torch.zeros_like(p) for p in leaves),
    )


def adam_update(grads: Sequence[torch.Tensor], state: AdamState, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, active: Optional[torch.Tensor] = None):
    """``optax.adam(lr).update`` with optax's order of operations: returns
    (updates, new state), updates = -lr * mu_hat / (sqrt(nu_hat) + eps).

    ``active`` (a bool tensor of the count's shape): rows where it is False
    get a zero update and keep their moments and count, as the carry of a
    vmapped ``lax.while_loop`` that has stopped.
    """
    count_inc = state.count + 1
    updates, mus, nus = [], [], []
    for g, mu, nu in zip(grads, state.mu, state.nu):
        mu_new = (1 - b1) * g + b1 * mu
        nu_new = (1 - b2) * g**2 + b2 * nu
        bshape = count_inc.shape + (1,) * (g.dim() - count_inc.dim())
        c = count_inc.to(torch.float64).reshape(bshape)
        mu_hat = mu_new / (1 - b1**c).to(g.dtype)
        nu_hat = nu_new / (1 - b2**c).to(g.dtype)
        up = -lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
        if active is not None:
            keep = active.reshape(bshape)
            up = torch.where(keep, up, torch.zeros_like(up))
            mu_new, nu_new = torch.where(keep, mu_new, mu), torch.where(keep, nu_new, nu)
        updates.append(up)
        mus.append(mu_new)
        nus.append(nu_new)
    if active is not None:
        count_inc = torch.where(active, count_inc, state.count)
    return updates, AdamState(count_inc, tuple(mus), tuple(nus))


def _nan_to_zero(g: torch.Tensor) -> torch.Tensor:
    """NaN entries set to 0, +-Inf kept (``optax.zero_nans``)."""
    return torch.where(torch.isnan(g), torch.zeros_like(g), g)


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair on a list of leaves:
    ``init(leaves) -> state``, ``update(grads, state, leaves=None) ->
    (updates, state)``."""

    init: Callable
    update: Callable


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam(lr)``: state an :class:`AdamState` of
    :func:`adam_init`, updates from :func:`adam_update`."""
    def update(grads, state, leaves=None):
        return adam_update(grads, state, lr, b1, b2, eps)

    return GradientTransformation(adam_init, update)


class ZeroNansState(NamedTuple):
    """Whether each leaf's last gradient held a NaN (optax's state, read by
    nobody inside)."""

    found_nan: Tuple[torch.Tensor, ...]


def zero_nans() -> GradientTransformation:
    """``optax.zero_nans()``: NaN entries of each gradient set to 0, +-Inf
    passed through."""

    def init(leaves):
        return ZeroNansState(tuple(torch.zeros((), dtype=torch.bool, device=p.device) for p in leaves))

    def update(grads, state, leaves=None):
        return [_nan_to_zero(g) for g in grads], ZeroNansState(tuple(torch.isnan(g).any() for g in grads))

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """``optax.chain``: each transformation's updates feed the next; the
    state is the tuple of theirs."""

    def init(leaves):
        return tuple(t.init(leaves) for t in transforms)

    def update(grads, state, leaves=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, leaves)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, keys sorted at each level (JAX's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def adam_fit(loss_fn: Callable, params, iters: int, lr: float, opt_state: Optional[AdamState] = None):
    """``iters`` steps of ``optax.adam(lr)`` on loss_fn(params), from
    ``opt_state`` (fresh moments by default), as the JAX package's
    ``lax.scan`` of them. Returns (params detached, the Adam state, the last
    step's loss, taken before its update)."""
    leaves = [p.detach() for p in tree_leaves(params)]
    opt_state = adam_init(leaves) if opt_state is None else opt_state
    last = None
    for _ in range(iters):
        with torch.enable_grad():
            ls = [p.detach().requires_grad_(True) for p in leaves]
            value = loss_fn(tree_rebuild(params, ls))
            grads = torch.autograd.grad(value, ls)
        ups, opt_state = adam_update(grads, opt_state, lr)
        leaves = [p + u for p, u in zip(leaves, ups)]
        last = value.detach()
    return tree_rebuild(params, leaves), opt_state, last
