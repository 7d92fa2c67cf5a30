"""Max-posterior-variance active learning with an online SVGP (port of
``online_gp_tpu/bayesopt/mpv_osvgp.py``).

As the reference's ``experiments/active_learning/mpv_osvgp.py``: fit an
SVGP on seed data, then per step pick the candidate of largest posterior
variance (Adam on logit candidates, ``generate_candidates``), snap it to
the nearest pool point not yet queried, absorb it with the Bui closed-form
variational update and re-fit the hypers briefly on the streaming ELBO.
The SVGP core runs no kernel of the port (``torch.linalg`` factorizations).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from online_gp_torch.bayesopt.loop import sync_device
from online_gp_torch.bayesopt.optimize import optimize_acqf
from online_gp_torch.data.malaria import malaria_dataset
from online_gp_torch.kernels.base import make_kernel
from online_gp_torch.models.svgp import (
    SVGPModel,
    svgp_closed_form_update,
    svgp_elbo,
    svgp_init_variational_to_prior,
    svgp_predict,
    svgp_snapshot,
    svgp_streaming_correction,
)
from online_gp_torch.utils.optim import adam_fit


def run_mpv_osvgp(
    num_steps: int = 25,
    num_init: int = 50,
    num_test: int = 500,
    num_inducing: int = 64,
    fit_iters: int = 200,
    refit_iters: int = 20,
    fit_lr: float = 0.05,
    seed: int = 0,
    data_path=None,
    logger=None,
    verbose: bool = True,
    device="cuda",
) -> Dict:
    """The inducing points are uniform on the unit square from a CPU
    generator seeded ``seed`` (the JAX package draws them from its key);
    each step's acquisition starts from a generator seeded with the step."""
    device = torch.device(device)
    data = malaria_dataset(data_path, seed=seed)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data.x))
    test_idx, pool_idx = perm[:num_test], perm[num_test:]
    seed_idx, pool_idx = pool_idx[:num_init], pool_idx[num_init:]

    x_all = torch.from_numpy(data.x).to(device)
    y_all = torch.from_numpy(data.y).to(device)
    test_x, test_y = x_all[test_idx], y_all[test_idx]

    model = SVGPModel(make_kernel("rbf"))
    z = torch.rand((num_inducing, 2), generator=torch.Generator().manual_seed(seed)).to(device)
    params = svgp_init_variational_to_prior(model, model.init_params(z, 2, device=device, lengthscale=0.3))
    train_x, train_y = x_all[seed_idx], y_all[seed_idx]

    def fit(params, x, y, iters, old=None):
        def loss(q):
            value = -svgp_elbo(model, q, x, y, x.shape[0], 1.0)
            if old is not None:
                value = value + svgp_streaming_correction(model, q, old, x.shape[0], 1e-3)
            return value

        params, _, last = adam_fit(loss, params, iters, fit_lr)
        return params, last

    params, loss = fit(params, train_x, train_y, fit_iters)

    records = []
    queried = list(seed_idx)
    bounds = torch.tensor([[0.0, 1.0], [0.0, 1.0]], dtype=torch.float32, device=device)
    for step_i in range(num_steps):
        def mpv_acqf(C):  # the candidate of largest posterior variance
            R, q, d = C.shape
            _, var = svgp_predict(model, params, C.reshape(R * q, d))
            return torch.sum(var.reshape(R, q), dim=-1)

        t0 = time.perf_counter()
        cand, acq_val = optimize_acqf(mpv_acqf, bounds, q=1, num_restarts=6, raw_samples=24, maxiter=100,
                                      generator=torch.Generator().manual_seed(step_i))
        sync_device(device)
        t_acq = time.perf_counter() - t0

        pool = x_all[pool_idx]
        j = int(torch.argmin(torch.sum((pool - cand[0]) ** 2, dim=-1)))
        pick = pool_idx[j]
        pool_idx = np.delete(pool_idx, j)
        queried.append(pick)
        train_x = torch.cat([train_x, x_all[pick][None]])
        train_y = torch.cat([train_y, y_all[pick][None]])

        # the closed-form O-SVGP absorb, then a short streaming re-fit
        old = svgp_snapshot(model, params)
        params = svgp_closed_form_update(model, params, x_all[pick][None], y_all[pick][None])
        if refit_iters:
            params, loss = fit(params, train_x[-256:], train_y[-256:], refit_iters, old)

        mean, var = svgp_predict(model, params, test_x)
        rmse = float(torch.sqrt(torch.mean((mean - test_y) ** 2)))
        rec = dict(step=step_i + 1, test_rmse=rmse, avg_variance=float(var.mean()), acq_value=float(acq_val),
                   acq_time=t_acq)
        records.append(rec)
        if logger is not None:
            logger.log(rec, step=step_i + 1, table_name="mpv_metrics")
        if verbose and (step_i % 5 == 4 or step_i == 0):
            print(f"step {step_i + 1}: test RMSE {rmse:.4f}, avg var {rec['avg_variance']:.4f}")

    return dict(records=records, num_queried=len(queried), synthetic_data=data.synthetic)


def main():
    import sys

    from online_gp_torch.experiments.config import parse_cli_kwargs

    out = run_mpv_osvgp(**parse_cli_kwargs(sys.argv[1:]))
    print("final:", out["records"][-1])


if __name__ == "__main__":
    main()
