"""How ``correct`` is decided: the plain reference replays, in float64,
every point the run handed the program, and each number below compares
what the program produced with it. Each is computed for every output of
the state (a regression wrapper has one, the classifier one a class) and
the largest is reported.

  roots       max |L L^T - (A + eps I)| / max |A + eps I|: the state's root
              against the Gram matrix of every point absorbed
  wty         max |W D^-1 y - ref| / max |ref|
  state_mean  the state through what it predicts: the posterior mean at the
              check queries from the program's root and W D^-1 y (float64
              algebra), against the reference's, in units of the
              reference's predictive sd
  state_var   the same for the predictive variance, relative

Where the configuration's ``hyper_ranges`` draw a second noise s2 (the
regression wrapper's), K_uu is divided by it and the variance is that of
y, s2 added; without one (the classifier's), the latent variance.

An op whose steps return outputs (``gpbench/ops/<op>.py``) replays them in
the reference and adds its own numbers through its ``judge``, each the
largest over the checked requests.

A cell's limits file (``gpbench/limits/<cell>.json``) names the numbers it
compares and each one's limit. The control runs the same replay in float32
with TF32 on, puts its results in the program's place, and is judged alike.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from gpbench import reference as R
from gpbench import spec
from gpbench.traffic import Inputs, Record


class Produced(NamedTuple):
    """Outputs to judge, the program's or the control's."""

    root: Sequence[torch.Tensor]  # B roots (m, m): the program's (B, m, m), the reference's a list
    wty: torch.Tensor  # (B, m)
    requests: Dict[int, Dict[int, tuple]]  # request -> step -> outputs


def sample_requests(record: Record, warmup: int, count: int, seed: int) -> List[int]:
    """``count`` window requests with outputs drawn from the seed, and the
    last request."""
    window = [i for i in range(warmup, len(record.requests)) if record.outputs[i]]
    if not window:
        return []
    rng = np.random.default_rng([seed, 2])
    pick = set(rng.choice(window[:-1], size=min(count, len(window) - 1), replace=False).tolist()) if count else set()
    return sorted(pick | {window[-1]})


def program_produced(fin, record: Record, picked: List[int]) -> Produced:
    return Produced(fin.root, fin.wty, {i: record.outputs[i] for i in picked})


CONTROL_BLOCK = 256  # points a root update of the control


class Replay:
    """The reference's running state, which each op's ``replay`` drives:
    float64, for each output a root, the Cholesky factor of the Gram
    matrix of every point. With ``control``, the reference in the
    program's place one precision down: float32 with TF32 matmuls, each
    root kept as a streaming state keeps it (one update a block of
    CONTROL_BLOCK points)."""

    def __init__(self, config: Dict, hypers, inputs: Inputs, device, control: bool):
        self.dtype = torch.float32 if control else torch.float64
        self.device, self.control, self.hypers = device, control, hypers
        self.config = config
        self.grid = R.Grid.create(config["grid_bounds"], config["wrapper"]["grid_size"], config["grid_pad"])
        m = self.grid.num_points
        self.K = R.kuu(self.grid, hypers.lengthscale, hypers.outputscale, self.dtype, device)
        if hypers.noise is not None:
            self.K = self.K / hypers.noise
        self.data = R.absorb(self.grid, R.empty(m, config["num_outputs"], self.dtype, device),
                             self.t(inputs.seed_x), *self.observed(inputs.seed_y))
        # each output's jitter from its own seed Gram matrix, as the state's
        self.eps = [R.jitter(A, config["root_jitter"]) for A in self.data.A]
        self.roots = [R.root_pair(A, e) for A, e in zip(self.data.A, self.eps)] if control else None

    def t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    def observed(self, y: np.ndarray) -> tuple:
        """(targets (n, B), noises (n, B) or None for unit noise) of the
        stream's targets (n, 1), or of its integer labels (n, 1): their
        Dirichlet targets and noises."""
        if not np.issubdtype(y.dtype, np.integer):
            return self.t(y), None
        labels = torch.as_tensor(y[:, 0], device=self.device)
        return R.dirichlet(labels, self.config["num_outputs"], self.config["alpha_eps"], self.dtype)

    def absorb(self, x: np.ndarray, y: np.ndarray) -> None:
        """Absorb the points x with the stream's targets or labels y (n, 1)."""
        x = self.t(x)
        targets, noise = self.observed(y)
        self.data = R.absorb(self.grid, self.data, x, targets, noise)
        if self.control:
            for b in range(0, x.shape[0], CONTROL_BLOCK):
                idx, w = R.interp(self.grid, x[b:b + CONTROL_BLOCK])
                for o, (L, B) in enumerate(self.roots):
                    wo = w if noise is None else w / torch.sqrt(noise[b:b + CONTROL_BLOCK, o])[:, None]
                    self.roots[o] = R.root_update(L, B, R.dense_w(idx, wo, self.grid.num_points))

    def root(self) -> List[torch.Tensor]:
        """Each output's root, in the layout the factorization left it."""
        if self.control:
            return [L for L, _ in self.roots]
        return [R.root(A, e) for A, e in zip(self.data.A, self.eps)]


def replay(config: Dict, hypers, inputs: Inputs, record: Record, picked: List[int], device,
           control: bool = False) -> tuple:
    """What the reference produces for the requests the run issued.
    Returns (Produced, A + eps I for each output, K), the last two in the
    replay's dtype."""
    want = set(picked)
    with R.precision(control):
        ref = Replay(config, hypers, inputs, device, control)
        outs: Dict[int, Dict[int, tuple]] = {}
        for i, steps in enumerate(record.requests):
            for j, done in enumerate(steps):
                out = spec.op(done.op).replay(ref, done, inputs, i in want)
                if out is not None:
                    outs.setdefault(i, {})[j] = out
        eye = torch.eye(ref.grid.num_points, dtype=ref.dtype, device=device)
        A_eps = torch.stack([A + e * eye for A, e in zip(ref.data.A, ref.eps)])
    return Produced(ref.root(), ref.data.wty, outs), A_eps, ref.K


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.max(torch.abs(got.double() - ref)) / torch.max(torch.abs(ref)))


def moments(mean, var, ref_mean, ref_var) -> tuple:
    """max |mean - ref| in units of the reference's sd, and max relative
    error of the variance."""
    z = torch.max(torch.abs(mean.double() - ref_mean) / torch.sqrt(ref_var))
    v = torch.max(torch.abs(var.double() - ref_var) / ref_var)
    return float(z), float(v)


def _worst(out: Dict[str, float], name: str, value: float) -> None:
    """Keep the largest reading of a number; a NaN makes the number NaN."""
    out[name] = value if name not in out or math.isnan(value) else max(out[name], value)


def judge(got: Produced, truth: Produced, A_eps: torch.Tensor, K: torch.Tensor, config: Dict, hypers,
          queries: torch.Tensor, record: Record) -> Dict[str, float]:
    """Every number of the module's list, the largest over the outputs,
    and the ops' own, in float64."""
    grid = R.Grid.create(config["grid_bounds"], config["wrapper"]["grid_size"], config["grid_pad"])
    s2 = hypers.noise
    out: Dict[str, float] = {}
    for b in range(len(got.root)):
        L = got.root[b].double()
        _worst(out, "roots", _rel(L @ L.T, A_eps[b]))
        _worst(out, "wty", _rel(got.wty[b], truth.wty[b]))
        with R.precision(False):
            post = R.posterior(K, L, got.wty[b].double())
            ref_post = R.posterior(K, truth.root[b], truth.wty[b])
            mean, var = moments(*R.predict(grid, post, queries, s2), *R.predict(grid, ref_post, queries, s2))
        _worst(out, "state_mean", mean)
        _worst(out, "state_var", var)
    for i, steps in truth.requests.items():
        for j, want in steps.items():
            numbers = spec.op(record.requests[i][j].op).judge(got.requests[i][j], want)
            for name, value in numbers.items():
                _worst(out, name, value)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, Dict]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits file names; a number that is missing or not finite fails."""
    shown, ok = {}, True
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        shown[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and math.isfinite(value) and value <= lim["limit"]
    return ok, shown
