"""Active learning with qNIPV on the malaria dataset, WISKI against the
exact GP (port of ``online_gp_tpu/bayesopt/active_learning.py``).

Pool-based, as the reference's ``qnIPV_experiment.py``: fit a WISKI GP
(30x30 grid, Matern-1/2 ARD, Gamma priors on the hypers) or an exact GP on
a small seed set, then per step refit with a decayed learning rate,
maximize qNIPV over the unit square, snap to the nearest pool point not
yet queried, condition, and log the test RMSE and the mean variance.

On the card the WISKI refit factors Q with kernel K6 in every forward,
and each queried point is absorbed by kernel K2, in place. The Monte-Carlo
points of qNIPV come from the same numpy ``rng`` as in the JAX package, so
they are the same points.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from online_gp_torch.bayesopt.acquisitions import q_negative_integrated_posterior_variance
from online_gp_torch.bayesopt.loop import sync_device
from online_gp_torch.bayesopt.optimize import optimize_acqf
from online_gp_torch.config import SolverConfig
from online_gp_torch.data.malaria import malaria_dataset
from online_gp_torch.kernels.base import make_kernel
from online_gp_torch.kernels.priors import GammaPrior
from online_gp_torch.models.exact_online import (
    ExactGPModel,
    exact_data_append,
    exact_data_init,
    exact_gp_mll,
    exact_gp_posterior,
)
from online_gp_torch.models.wiski import WiskiModel, wiski_condition, wiski_init, wiski_mll, wiski_predict
from online_gp_torch.ops.grid import Grid
from online_gp_torch.utils.optim import adam_fit


def run_active_learning(
    model_type: str = "wiski",  # or "exact"
    num_steps: int = 25,
    num_init: int = 50,
    num_test: int = 500,
    grid_size: int = 30,
    mc_points: int = 256,
    fit_iters: int = 100,
    fit_lr: float = 0.1,
    lr_decay: float = 0.97,
    seed: int = 0,
    data_path=None,
    logger=None,
    verbose: bool = True,
    checkpoint_path=None,
    device="cuda",
) -> Dict:
    device = torch.device(device)
    data = malaria_dataset(data_path, seed=seed)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data.x))
    test_idx, pool_idx = perm[:num_test], perm[num_test:]
    seed_idx, pool_idx = pool_idx[:num_init], pool_idx[num_init:]

    x_all = torch.from_numpy(data.x).to(device)
    y_all = torch.from_numpy(data.y)[:, None].to(device)
    nv_all = torch.from_numpy(data.y_var)[:, None].to(device)
    test_x, test_y = x_all[test_idx], y_all[test_idx]
    cfg = SolverConfig()

    priors = (("raw_lengthscale", GammaPrior(3.0, 6.0)), ("raw_outputscale", GammaPrior(2.0, 0.15)))
    queried = list(seed_idx)
    train_x, train_y, train_nv = x_all[seed_idx], y_all[seed_idx], nv_all[seed_idx]

    if model_type == "wiski":
        grid = Grid.create([(-0.05, 1.05)] * 2, grid_size, device=device)
        model = WiskiModel(make_kernel("matern12"), grid, num_outputs=1, priors=priors)
        params = model.init_params(2)
        state = wiski_init(model, train_x, train_y, train_nv)

        def fit(params, state, lr):
            params, _, loss = adam_fit(lambda p: -torch.sum(wiski_mll(model, p, state, cfg)), params, fit_iters, lr)
            return params, loss

        def posterior(params, state, xt):
            return wiski_predict(model, params, state, xt, cfg)

        def condition(state, xi, yi, ni):
            return wiski_condition(model, state, xi, yi, ni)

        def nipv(params, state):
            mc = x_all[rng.choice(test_idx, size=mc_points)]
            return lambda C: q_negative_integrated_posterior_variance(model, params, state, C, mc, cfg)

    elif model_type == "exact":
        # the reference's exact arm is botorch's FixedNoiseGP with a RADIAL
        # ARD Matern-1/2 and the same Gamma priors; the product Matern above
        # is the grid-structured family only the SKI arm needs
        model = ExactGPModel(make_kernel("radial_matern12"), num_outputs=1, learn_noise=False, priors=priors)
        params = model.init_params(2, device=device)
        state = exact_data_init(train_x, train_y, train_nv)

        def fit(params, state, lr):
            params, _, loss = adam_fit(lambda p: -torch.sum(exact_gp_mll(model, p, state)), params, fit_iters, lr)
            return params, loss

        def posterior(params, state, xt):
            return exact_gp_posterior(model, params, state, xt)

        def condition(state, xi, yi, ni):
            return exact_data_append(state, xi, yi, ni)

        def nipv(params, state):
            mc = x_all[rng.choice(test_idx, size=mc_points)]

            def one(C):
                # the exact-GP fantasy variance through a masked-buffer append
                st = exact_data_append(state, C, torch.zeros((C.shape[0], 1), dtype=C.dtype, device=C.device),
                                       torch.full((C.shape[0], 1), 0.1, dtype=C.dtype, device=C.device))
                _, var = exact_gp_posterior(model, params, st, mc)
                return -torch.mean(var)

            # the buffer's append is per candidate batch: the rows in turn
            return lambda C: torch.stack([one(c) for c in C])
    else:
        raise ValueError(model_type)

    records = []
    lr = fit_lr
    bounds = torch.tensor([[0.0, 1.0], [0.0, 1.0]], dtype=torch.float32, device=device)
    for step_i in range(num_steps):
        t0 = time.perf_counter()
        params, loss = fit(params, state, lr)
        lr *= lr_decay
        sync_device(device)
        t_fit = time.perf_counter() - t0

        acqf = nipv(params, state)
        t0 = time.perf_counter()
        cand, acq_val = optimize_acqf(acqf, bounds, q=1, num_restarts=6, raw_samples=24, maxiter=60)
        sync_device(device)
        t_acq = time.perf_counter() - t0

        # snap to the nearest un-queried pool point
        pool = x_all[pool_idx]
        j = int(torch.argmin(torch.sum((pool - cand[0]) ** 2, dim=-1)))
        pick = pool_idx[j]
        pool_idx = np.delete(pool_idx, j)
        queried.append(pick)

        t0 = time.perf_counter()
        state = condition(state, x_all[pick][None], y_all[pick][None], nv_all[pick][None])
        sync_device(device)
        t_cond = time.perf_counter() - t0

        mean, var = posterior(params, state, test_x)
        rmse = float(torch.sqrt(torch.mean((mean[0] - test_y[:, 0]) ** 2)))
        avg_var = float(torch.mean(var))
        rec = dict(step=step_i + 1, test_rmse=rmse, avg_variance=avg_var, mll=-float(loss), fit_time=t_fit,
                   acq_time=t_acq, cond_time=t_cond)
        records.append(rec)
        if logger is not None:
            logger.log(rec, step=step_i + 1, table_name="active_learning_metrics")
        if verbose and (step_i % 5 == 4 or step_i == 0):
            print(f"step {step_i + 1}: test RMSE {rmse:.4f}, avg var {avg_var:.4f}")

    if checkpoint_path is not None:
        # the final surrogate and the query trace, as the reference's
        # end-of-run torch.save of the model's state
        from online_gp_torch.utils.checkpoint import save_pytree

        save_pytree(checkpoint_path, dict(params=params, state=state,
                                          queried=torch.tensor(np.asarray(queried, dtype=np.int64))))

    return dict(records=records, num_queried=len(queried), synthetic_data=data.synthetic,
                checkpoint=checkpoint_path, params=params, state=state)


def main():
    import sys

    from online_gp_torch.experiments.config import parse_cli_kwargs

    out = run_active_learning(**parse_cli_kwargs(sys.argv[1:]))
    print("final:", out["records"][-1])


if __name__ == "__main__":
    main()
