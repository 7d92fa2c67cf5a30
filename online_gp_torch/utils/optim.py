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
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

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
            p.grad = torch.where(torch.isnan(g), torch.zeros_like(g), g) if self.zero_nans else g
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
