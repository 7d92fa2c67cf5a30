"""Bayesian-optimization loop: WISKI and MC acquisitions on test functions
(port of ``online_gp_tpu/bayesopt/loop.py``).

Per step, as the reference's ``experiments/bayesopt/bayesopt.py``: refit
the hypers on the Woodbury MLL of the carried state, optimize the
acquisition with multi-restart Adam, evaluate the noisy, standardized
test function, and absorb the observation with an O(m^2) conditioning;
hypers and state persist across steps.

On the card the refit's every forward factors Q with kernel K6 (inside
``wiski_mll``), the acquisition's caches are built once per step with Q
on K6, and a single queried point is absorbed by kernel K2, in place.

Draws come from one CPU ``torch.Generator`` seeded from ``seed`` and are
moved to the device, so a run on the card and its CPU twin draw the same
numbers (they cannot be the JAX package's, which come from its keys).
The Sobol raw starts are the JAX package's: the same seeds.

    python -m online_gp_torch.bayesopt.loop function=Ackley dim=3 acqf=ucb num_steps=30
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from online_gp_torch.bayesopt import acquisitions as acq
from online_gp_torch.bayesopt.optimize import optimize_acqf, sobol_raw_init
from online_gp_torch.bayesopt.test_functions import make_test_function
from online_gp_torch.config import SolverConfig
from online_gp_torch.kernels.base import make_kernel
from online_gp_torch.kernels.priors import GammaPrior
from online_gp_torch.models.wiski import WiskiModel, wiski_condition, wiski_init, wiski_mll
from online_gp_torch.ops.grid import Grid
from online_gp_torch.utils.lbfgs import lbfgs_init, lbfgs_update, lbfgs_value_and_grad
from online_gp_torch.utils.optim import adam_fit, adam_init, tree_leaves, tree_rebuild

ACQ_RESTARTS, ACQ_RAW, ACQ_MAXITER = 8, 32, 100
NEI_BASELINE_SIZE = 64


def make_fit_fn(model: WiskiModel, cfg: SolverConfig, fit_method: str, fit_iters: int, fit_lr: float):
    """The per-step hyper refit: ``(init, fit)`` with
    ``fit(params, state, init(params)) -> (params, opt_state, last_loss)``
    running ``fit_iters`` optimizer steps on -sum(wiski_mll) (the loss of
    the last step is that before its update, as the JAX scan's; the JAX
    package's ``opt.init`` is ``init`` here).

    ``"adam"`` is ``optax.adam(fit_lr)``; ``"lbfgs"`` is optax's L-BFGS with
    its zoom linesearch (:mod:`online_gp_torch.utils.lbfgs`) over the flat
    params, the optimizer class of the reference's per-step L-BFGS-B refit.
    The params come back detached."""

    def loss(params, state):
        return -torch.sum(wiski_mll(model, params, state, cfg))

    if fit_method == "adam":
        def fit(params, state, opt_state):
            return adam_fit(lambda p: loss(p, state), params, fit_iters, fit_lr, opt_state)

        return (lambda params: adam_init(tree_leaves(params))), fit
    if fit_method != "lbfgs":
        raise ValueError(f"unknown fit_method {fit_method!r} (adam/lbfgs)")

    def flatten(params):
        return torch.cat([p.detach().reshape(-1) for p in tree_leaves(params)])[None]

    def fit(params, state, opt_state):
        shapes = [p.shape for p in tree_leaves(params)]
        sizes = [p.numel() for p in tree_leaves(params)]
        unflatten = lambda x: tree_rebuild(params, [c.reshape(s) for c, s in zip(x.split(sizes), shapes)])
        flat = flatten(params)

        def value_and_grad(x):
            with torch.enable_grad():
                xg = x[0].detach().requires_grad_(True)
                value = loss(unflatten(xg), state)
                (g,) = torch.autograd.grad(value, xg)
            # the linesearch caches the value in the params' dtype
            return value.detach().to(x.dtype)[None], g[None]

        last = None
        for _ in range(fit_iters):
            value, g = lbfgs_value_and_grad(value_and_grad, flat, opt_state)
            up, opt_state = lbfgs_update(g, opt_state, flat, value, value_and_grad)
            flat = flat + up
            last = value[0]
        return unflatten(flat[0]), opt_state, last

    return (lambda params: lbfgs_init(flatten(params))), fit


def _normalize(x, bounds):
    """Raw function domain -> unit cube [0, 1]^d (the reference trains its
    surrogate on the unit cube)."""
    return (x - bounds[:, 0]) / (bounds[:, 1] - bounds[:, 0])


def _denormalize(u, bounds):
    return bounds[:, 0] + u * (bounds[:, 1] - bounds[:, 0])


def _make_surrogate(surrogate: str, dim: int, grid_size: int, noise_std: float, device="cuda"):
    """Surrogate spec -> (model, fixed noise value per observation).

    ``"reference"`` is the reference's BO model: ScaleKernel(Matern-5/2 with
    GammaPrior(3, 6) on the lengthscale, Interval(1e-4, 12)) with
    GammaPrior(2, 0.15) / Interval(1e-4, 12) on the outputscale, a learnable
    second noise and fixed per-point noise ``noise_std**2`` (the Matern in
    its per-dimension product form, the grid-structured family SKI needs).
    ``"plain"``: unconstrained RBF, no priors, unit fixed noise.
    """
    if surrogate == "reference":
        kernel = make_kernel("matern52").constrain(lengthscale_bounds=(1e-4, 12.0), outputscale_bounds=(1e-4, 12.0))
        priors = (("raw_lengthscale", GammaPrior(3.0, 6.0)), ("raw_outputscale", GammaPrior(2.0, 0.15)))
        noise_value = noise_std**2
    elif surrogate == "plain":
        kernel = make_kernel("rbf")
        priors = None
        noise_value = 1.0
    else:
        raise ValueError(f"unknown surrogate {surrogate!r} (reference/plain)")
    grid = Grid.create([(-0.05, 1.05)] * dim, grid_size, device=device)
    model = WiskiModel(kernel, grid, num_outputs=1, learn_additional_noise=True, priors=priors)
    return model, noise_value


def sync_device(device):
    """Wait for the card (a no-op on the CPU): the loops' step times are of
    finished work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_acquisition(acqf: str, model: WiskiModel, params: Dict, state, cfg: SolverConfig, batch_size: int,
                     gen: torch.Generator, step_i: int, best_f, train_u: torch.Tensor, noise_std: float):
    """One BO step's acquisition, (R, q, d) -> (R,), with everything that
    does not depend on the candidates built here once: the prediction caches
    and grid-space root (:func:`acquisition_context`), the base samples, the
    discrete sets of qKG and qMVES, qMVES's y* draws. Draws come from
    ``gen`` (on its device), then move to the state's."""
    dim = train_u.shape[-1]
    dev, dtype = state.wty.device, state.wty.dtype
    mc = acqf in ("nei", "kg", "mves") or batch_size > 1
    ctx = acq.acquisition_context(model, params, state, cfg, root=mc)
    k = min(model.grid.num_points, cfg.max_root_decomposition_size)  # the root's rank: base samples' width
    normals = lambda n: torch.randn((n, k), generator=gen, dtype=dtype, device=gen.device).to(dev)
    uniforms = lambda n: torch.rand((n, dim), generator=gen, dtype=train_u.dtype, device=gen.device).to(dev)
    if acqf == "ucb":
        beta, eps = 0.9**step_i, normals(128) if batch_size > 1 else None
        return lambda X: acq.q_upper_confidence_bound(model, params, state, X, beta, eps, 128, cfg, context=ctx)
    if acqf == "ei":
        eps = normals(128) if batch_size > 1 else None
        return lambda X: acq.q_expected_improvement(model, params, state, X, best_f, eps, 128, cfg, context=ctx)
    if acqf == "nei":
        # a fixed-size recent-observation baseline, wrap-padded below 64 points
        base = train_u[-NEI_BASELINE_SIZE:]
        reps = -(-NEI_BASELINE_SIZE // len(base))
        baseline = torch.cat([base] * reps)[:NEI_BASELINE_SIZE]
        eps = normals(128)
        return lambda X: acq.q_noisy_expected_improvement(model, params, state, X, baseline, eps, 128, cfg,
                                                          context=ctx)
    if acqf == "kg":
        eps, disc = normals(8), uniforms(256)
        return lambda X: acq.q_knowledge_gradient(model, params, state, X, disc, best_f, eps, 8, cfg, context=ctx)
    if acqf == "mves":
        max_eps, fant_eps, cand = normals(16), normals(8), uniforms(512)
        y_star = acq.mves_max_values(model, params, state, cand, max_eps, cfg, "joint", ctx)
        return lambda X: acq.q_max_value_entropy(model, params, state, X, cand, cfg=cfg, noise_value=noise_std**2,
                                                 fantasy_samples=fant_eps, context=ctx, y_star=y_star)
    raise ValueError(f"unknown acquisition {acqf!r} (ucb/ei/nei/kg/mves)")


def run_bayesopt(
    function: str = "Ackley",
    dim: int = 3,
    acqf: str = "ucb",
    num_steps: int = 30,
    num_init: int = 10,
    batch_size: int = 1,
    grid_size: int = 10,
    noise_std: float = 0.1,
    fit_iters: int = 50,
    fit_lr: float = 0.05,
    fit_method: str = "adam",
    surrogate: str = "reference",
    seed: int = 0,
    cfg: SolverConfig = SolverConfig(use_toeplitz=True),
    logger=None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Returns a dict with the best value per step, the per-step records
    (fit, acquisition and condition times, synchronized with the device)
    and the optimum.

    ``fit_method``: ``"adam"`` or ``"lbfgs"`` (:func:`make_fit_fn`).
    ``checkpoint_path`` saves the final surrogate (hypers, state, queried
    data, standardization) with :func:`online_gp_torch.utils.checkpoint.save_pytree`;
    ``resume_from`` continues the campaign from such a checkpoint, the
    port's or the JAX package's (``function``, ``dim``, ``grid_size``,
    ``noise_std`` and ``surrogate`` must match the saving run)."""
    device = torch.device(device)
    fn = make_test_function(function, dim, device=device)
    model, noise_value = _make_surrogate(surrogate, dim, grid_size, noise_std, device)

    if resume_from is not None:
        from online_gp_torch.utils.checkpoint import load_pytree

        blob = load_pytree(resume_from, device=device)
        params, state = blob["params"], blob["state"]
        train_u, train_y = blob["train_u"], blob["train_y"]
        y_mean, y_std = blob["y_mean"], blob["y_std"]
        latent = blob["latent"]
        if train_u.shape[-1] != dim:
            raise ValueError(f"checkpoint dim {train_u.shape[-1]} != requested dim {dim}")
        ckpt_surrogate = blob.get("surrogate", "plain")
        if str(ckpt_surrogate) != surrogate:
            raise ValueError(f"checkpoint surrogate {ckpt_surrogate!r} != requested {surrogate!r}")
        gen = torch.Generator().manual_seed(seed * 1_000_003 + train_u.shape[0])
        best_per_step = [float(v) for v in blob["best_per_step"].cpu()]
    else:
        gen = torch.Generator().manual_seed(seed)
        params = model.init_params(dim)
        train_u = torch.rand((num_init, dim), generator=gen).to(device)  # unit cube
        train_x = _denormalize(train_u, fn.bounds)
        y, latent = fn.noisy(train_x, noise_std, gen)
        y_mean, y_std = torch.mean(y), torch.std(y, correction=0) + 1e-6
        train_y = ((y - y_mean) / y_std)[:, None]
        state = wiski_init(model, train_u, train_y, noise_value * torch.ones_like(train_y))
        best_per_step = [float(torch.max(latent))]

    init, fit = make_fit_fn(model, cfg, fit_method, fit_iters, fit_lr)
    unit_bounds = torch.tensor([[0.0, 1.0]] * dim, dtype=torch.float32, device=device)
    # KG and q > 1 MVES condition a state per row and fantasy: score the raw
    # samples a restart batch at a time
    raw_chunk = ACQ_RESTARTS if acqf in ("kg", "mves") else None

    records = []
    best_f = torch.max(train_y)
    for step_i in range(num_steps):
        t0 = time.perf_counter()
        params, _, loss = fit(params, state, init(params))
        sync_device(device)
        t_fit = time.perf_counter() - t0

        raw = sobol_raw_init(batch_size, dim, ACQ_RAW, seed * 100003 + step_i)
        t0 = time.perf_counter()
        acq_fn = make_acquisition(acqf, model, params, state, cfg, batch_size, gen, step_i, best_f, train_u,
                                  noise_std)
        cand_u, acq_val = optimize_acqf(acq_fn, unit_bounds, q=batch_size, num_restarts=ACQ_RESTARTS,
                                        raw_samples=ACQ_RAW, maxiter=ACQ_MAXITER, raw_init=raw, raw_chunk=raw_chunk)
        sync_device(device)
        t_acq = time.perf_counter() - t0

        cand_u = cand_u.to(train_u.dtype)
        cand_x = _denormalize(cand_u, fn.bounds)
        y_new, latent_new = fn.noisy(cand_x, noise_std, gen)
        y_std_new = ((y_new - y_mean) / y_std)[:, None]

        t0 = time.perf_counter()
        state = wiski_condition(model, state, cand_u, y_std_new, noise_value * torch.ones_like(y_std_new))
        sync_device(device)
        t_cond = time.perf_counter() - t0

        train_u = torch.cat([train_u, cand_u])
        train_y = torch.cat([train_y, y_std_new])
        best_f = torch.max(train_y)
        latent = torch.cat([latent, latent_new])
        best_per_step.append(float(torch.max(latent)))
        rec = dict(step=step_i + 1, best_value=best_per_step[-1], acq_value=float(acq_val), mll=-float(loss),
                   fit_time=t_fit, acq_time=t_acq, cond_time=t_cond)
        records.append(rec)
        if logger is not None:
            logger.log(rec, step=step_i + 1, table_name="bayesopt_metrics")
        if verbose and (step_i % 5 == 4 or step_i == 0):
            print(f"step {step_i + 1}: best {best_per_step[-1]:.4f} acq {float(acq_val):.4f} "
                  f"(fit {t_fit:.2f}s acq {t_acq:.2f}s cond {t_cond * 1e3:.1f}ms)")

    if checkpoint_path is not None:
        from online_gp_torch.utils.checkpoint import save_pytree

        save_pytree(checkpoint_path, dict(
            params=params, state=state, train_u=train_u, train_y=train_y, y_mean=y_mean, y_std=y_std,
            latent=latent, best_per_step=torch.tensor(best_per_step, dtype=torch.float64), surrogate=surrogate,
        ))

    return dict(best_per_step=best_per_step, records=records, optimal=fn.optimal_value, checkpoint=checkpoint_path,
                params=params, state=state, train_u=train_u)


def main():
    import sys

    from online_gp_torch.experiments.config import parse_cli_kwargs

    out = run_bayesopt(**parse_cli_kwargs(sys.argv[1:]))
    print("best value trajectory:", [round(v, 3) for v in out["best_per_step"]])


if __name__ == "__main__":
    main()
