"""Fixed-noise streaming-regression timing benchmark (malaria); the port of
``online_gp_tpu/experiments/fixed_noise_regression.py``.

The two arms of the reference's fixed-noise benchmark:

- ``arm=wiski`` — ``experiments/fixed_noise_regression/wiski_regression.py``
  (lines 120-178): stream the malaria spatial data point-by-point into a
  fixed-noise WISKI GP, doing a per-step Woodbury-MLL hyper fit
  (``mll_iters_per_step`` optax-style Adam steps on ``-wiski_mll``; Q on
  kernel K6 on the card) + conditioning (``wiski_condition`` per chunk;
  kernel K2 at ``chunk_size=1``), timing both phases, and logging test
  RMSE every ``eval_every`` steps; ``chunk_size > 1`` conditions on a
  chunk at a time.
- ``arm=exact`` — the exact-GP timing baseline
  (``experiments/fixed_noise_regression/botorch_regression.py:120-190``):
  the same stream through an exact fixed-noise GP (Matern-1/2, zero mean),
  per step one MLL gradient step (timed) + condition-on-observation
  (timed; here append + posterior-cache Cholesky refresh — the O(n^3)
  cost the reference's ``condition_on_observations`` pays), RMSE every
  ``eval_every`` steps with the reference's 0.9x lr decay.
- ``arm=both`` — run both on the identical stream and write the
  side-by-side per-step timing + RMSE comparison CSV.

Each timed phase ends in a device sync (``torch.cuda.synchronize`` on the
card), so it times execution, not dispatch. Everything runs on ``device``
("cuda" unless the caller asks for the CPU).

Usage: python -m online_gp_torch.experiments.fixed_noise_regression \
           num_steps=500 chunk_size=8 arm=both
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from online_gp_torch.config import SolverConfig
from online_gp_torch.data.malaria import malaria_dataset
from online_gp_torch.kernels.base import make_kernel
from online_gp_torch.logging import CSVLogger, block_until_ready
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


def run(
    num_steps: int = 500,
    num_init: int = 100,
    num_test: int = 500,
    grid_size: int = 30,
    chunk_size: int = 1,
    mll_iters_per_step: int = 1,
    lr: float = 0.01,
    eval_every: int = 25,
    seed: int = 0,
    data_path=None,
    log_dir: str = "logs",
    verbose: bool = True,
    arm: str = "wiski",
    device="cuda",
) -> Dict:
    data = malaria_dataset(data_path, seed=seed)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data.x))
    x_all = torch.as_tensor(data.x[perm], device=device)
    y_all = torch.as_tensor(data.y[perm], device=device)[:, None]
    nv_all = torch.as_tensor(data.y_var[perm], device=device)[:, None]
    test_x, test_y = x_all[:num_test], y_all[:num_test]
    pool = slice(num_test, None)
    x_pool, y_pool, nv_pool = x_all[pool], y_all[pool], nv_all[pool]
    stream = dict(
        x_pool=x_pool, y_pool=y_pool, nv_pool=nv_pool,
        test_x=test_x, test_y=test_y,
    )
    if arm == "exact":
        return _run_exact(stream, num_steps, num_init, lr, eval_every,
                          log_dir, verbose)
    if arm == "both":
        w = _run_wiski(stream, num_steps, num_init, grid_size, chunk_size,
                       mll_iters_per_step, lr, eval_every, log_dir, verbose)
        e = _run_exact(stream, num_steps, num_init, lr, eval_every,
                       log_dir, verbose)
        cmp_path = _write_comparison(w, e, log_dir)
        return dict(wiski=w, exact=e, comparison_csv=cmp_path,
                    cond_speedup=e["median_cond_ms"] / max(w["median_cond_ms"], 1e-9),
                    mll_speedup=e["median_mll_ms"] / max(w["median_mll_ms"], 1e-9))
    if arm != "wiski":
        raise ValueError(f"unknown arm {arm!r} (wiski/exact/both)")
    return _run_wiski(stream, num_steps, num_init, grid_size, chunk_size,
                      mll_iters_per_step, lr, eval_every, log_dir, verbose)


def _run_wiski(
    stream: Dict, num_steps: int, num_init: int, grid_size: int,
    chunk_size: int, mll_iters_per_step: int, lr: float, eval_every: int,
    log_dir: str, verbose: bool,
) -> Dict:
    x_pool, y_pool, nv_pool = stream["x_pool"], stream["y_pool"], stream["nv_pool"]
    test_x, test_y = stream["test_x"], stream["test_y"]

    cfg = SolverConfig()
    grid = Grid.create([(-0.05, 1.05)] * 2, grid_size, device=x_pool.device)
    model = WiskiModel(make_kernel("matern12"), grid, num_outputs=1)
    params = model.init_params(2)
    state = wiski_init(model, x_pool[:num_init], y_pool[:num_init], nv_pool[:num_init])
    opt_state = None

    logger = CSVLogger(log_dir, f"wiski_fixed_noise_chunk{chunk_size}")
    logger.add_table("timing_metrics")
    mll_times, cond_times, eval_rows = [], [], []
    t_start = time.time()
    pos = num_init
    steps_done = 0
    while steps_done < num_steps and pos + chunk_size <= x_pool.shape[0]:
        t0 = time.perf_counter()
        params, opt_state, loss = adam_fit(
            lambda p: -torch.sum(wiski_mll(model, p, state, cfg)), params, mll_iters_per_step, lr, opt_state
        )
        block_until_ready(loss)
        mll_times.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        with torch.no_grad():
            state = wiski_condition(
                model, state, x_pool[pos : pos + chunk_size], y_pool[pos : pos + chunk_size],
                nv_pool[pos : pos + chunk_size],
            )
        block_until_ready(state.roots.root)
        cond_times.append(time.perf_counter() - t0)
        pos += chunk_size
        steps_done += 1

        if steps_done % eval_every == 0:
            with torch.no_grad():
                mean, var = wiski_predict(model, params, state, test_x, cfg)
            rmse = float(torch.sqrt(torch.mean((mean[0] - test_y[:, 0]) ** 2)))
            rec = dict(
                num_data=int(state.num_data),
                test_rmse=rmse,
                mll_time_ms=1e3 * float(np.median(mll_times[-eval_every:])),
                cond_time_ms=1e3 * float(np.median(cond_times[-eval_every:])),
                mll=-float(loss),
            )
            logger.log(rec, step=steps_done, table_name="timing_metrics")
            eval_rows.append(dict(step=steps_done, **rec))
            if verbose:
                print(f"step {steps_done}: rmse {rmse:.4f} "
                      f"mll {rec['mll_time_ms']:.2f}ms cond {rec['cond_time_ms']:.2f}ms")

    logger.write_csv()
    total = time.time() - t_start
    return dict(
        arm="wiski",
        steps=steps_done,
        points_absorbed=steps_done * chunk_size,
        total_time=total,
        median_mll_ms=1e3 * float(np.median(mll_times)),
        median_cond_ms=1e3 * float(np.median(cond_times)),
        points_per_sec=steps_done * chunk_size / max(sum(cond_times), 1e-9),
        log_dir=logger.log_dir,
        eval_rows=eval_rows,
    )


def _run_exact(
    stream: Dict, num_steps: int, num_init: int, lr: float, eval_every: int,
    log_dir: str, verbose: bool,
) -> Dict:
    """Exact fixed-noise GP baseline arm
    (``experiments/fixed_noise_regression/botorch_regression.py:120-190``):
    per stream point, one Adam step on the exact MLL (timed) then
    condition on the observation (timed). Conditioning is append +
    posterior-cache refresh; the refresh recomputes the Cholesky of the
    (masked fixed-capacity) train covariance — the O(n^3) cost that
    ``condition_on_observations`` pays in the reference and the quantity
    WISKI's O(m^2) updates are benchmarked against. RMSE on the held-out
    set every ``eval_every`` steps with the reference's 0.9x lr decay."""
    x_pool, y_pool, nv_pool = stream["x_pool"], stream["y_pool"], stream["nv_pool"]
    test_x, test_y = stream["test_x"], stream["test_y"]

    model = ExactGPModel(make_kernel("matern12"), num_outputs=1, learn_noise=False)
    params = model.init_params(2, device=x_pool.device)
    # default power-of-2 capacity doubling: the per-step Cholesky cost is a
    # staircase bracketing the reference's true O(n^3) growth (cap < 2n)
    data = exact_data_init(x_pool[:num_init], y_pool[:num_init], nv_pool[:num_init])
    opt_state = None

    def test_eval(params, data):
        with torch.no_grad():
            mean, _ = exact_gp_posterior(model, params, data, test_x)
        return torch.sqrt(torch.mean((mean[0] - test_y[:, 0]) ** 2))

    logger = CSVLogger(log_dir, "exact_fixed_noise")
    logger.add_table("timing_metrics")
    mll_times, cond_times, eval_rows = [], [], []
    t_start = time.time()
    pos = num_init
    steps_done = 0
    while steps_done < num_steps and pos + 1 <= x_pool.shape[0]:
        t0 = time.perf_counter()
        params, opt_state, loss = adam_fit(
            lambda p: -torch.sum(exact_gp_mll(model, p, data)), params, 1, lr, opt_state
        )
        block_until_ready(loss)
        mll_times.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        data = exact_data_append(
            data, x_pool[pos : pos + 1], y_pool[pos : pos + 1], nv_pool[pos : pos + 1]
        )
        # the posterior at the new point through a fresh Cholesky of the
        # masked train covariance: the per-step conditioning cost
        with torch.no_grad():
            mean, _ = exact_gp_posterior(model, params, data, x_pool[pos : pos + 1])
        block_until_ready(mean)
        cond_times.append(time.perf_counter() - t0)
        pos += 1
        steps_done += 1

        if steps_done % eval_every == 0:
            rmse = float(test_eval(params, data))
            rec = dict(
                num_data=int(data.count),
                test_rmse=rmse,
                mll_time_ms=1e3 * float(np.median(mll_times[-eval_every:])),
                cond_time_ms=1e3 * float(np.median(cond_times[-eval_every:])),
                mll=-float(loss),
            )
            logger.log(rec, step=steps_done, table_name="timing_metrics")
            eval_rows.append(dict(step=steps_done, **rec))
            if verbose:
                print(f"[exact] step {steps_done}: rmse {rmse:.4f} "
                      f"mll {rec['mll_time_ms']:.2f}ms cond {rec['cond_time_ms']:.2f}ms")
            # reference decays the exact arm's lr 0.9x every eval block
            lr = lr * 0.9

    logger.write_csv()
    return dict(
        arm="exact",
        steps=steps_done,
        points_absorbed=steps_done,
        total_time=time.time() - t_start,
        median_mll_ms=1e3 * float(np.median(mll_times)),
        median_cond_ms=1e3 * float(np.median(cond_times)),
        points_per_sec=steps_done / max(sum(cond_times), 1e-9),
        log_dir=logger.log_dir,
        eval_rows=eval_rows,
    )


def _write_comparison(w: Dict, e: Dict, log_dir: str) -> str:
    """Side-by-side per-eval-block table (the reference publishes the two
    arms as separate ``.pt`` dumps; one CSV is friendlier)."""
    logger = CSVLogger(log_dir, "fixed_noise_comparison")
    logger.add_table("comparison")
    e_by_step = {r["step"]: r for r in e["eval_rows"]}
    for r in w["eval_rows"]:
        er = e_by_step.get(r["step"], {})
        logger.log(
            dict(
                wiski_rmse=r["test_rmse"],
                wiski_mll_ms=r["mll_time_ms"],
                wiski_cond_ms=r["cond_time_ms"],
                exact_rmse=er.get("test_rmse", float("nan")),
                exact_mll_ms=er.get("mll_time_ms", float("nan")),
                exact_cond_ms=er.get("cond_time_ms", float("nan")),
                cond_speedup=er.get("cond_time_ms", float("nan"))
                / max(r["cond_time_ms"], 1e-9),
            ),
            step=r["step"],
            table_name="comparison",
        )
    logger.write_csv()
    return os.path.join(logger.log_dir, "comparison.csv")


def main():
    from online_gp_torch.experiments.config import parse_cli_kwargs

    out = run(**parse_cli_kwargs(sys.argv[1:]))
    print({k: (round(v, 3) if isinstance(v, float) else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
