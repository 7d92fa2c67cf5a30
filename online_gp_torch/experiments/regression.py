"""Streaming-regression experiment driver (the port of
``online_gp_tpu/experiments/regression.py``).

Batch model fit -> online model init on ``init_ratio`` of the stream ->
optional pretrain -> prequential evaluate/update loop with
regret-vs-batch bookkeeping and the ``online_metrics`` CSV schema
(stem_loss, gp_loss, batch/online rmse+nll, regret, test_rmse, test_nll,
noise, step_time), column for column as the JAX package writes it.

Usage (Hydra-style overrides; the models run on "cuda" unless
``device=cpu``):
    python -m online_gp_torch.experiments.regression \\
        model=wiski_gp_regression dataset=skillcraft stem=eye batch_size=1
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from online_gp_torch.experiments.common import build_model, load_dataset, pretrain_stem
from online_gp_torch.experiments.config import parse_config
from online_gp_torch.likelihoods.gaussian import gaussian_nll
from online_gp_torch.logging import block_until_ready, make_logger
from online_gp_torch.utils.checkpoint import save_wrapper


def _mean_noise(model) -> float:
    return float(torch.as_tensor(model.noise).detach().mean())


def online_regression(batch_model, online_model, train_x, train_y, test_x, test_y,
                      update_stem, batch_size, logger, logging_freq, max_stream=None):
    online_rmse = online_nll = 0.0
    batch_rmse = batch_nll = 0.0
    logger.add_table("online_metrics")
    n = len(train_x)
    if max_stream:
        n = min(n, max_stream)

    for t, start in enumerate(range(0, n - batch_size + 1, batch_size)):
        x = train_x[start : start + batch_size]
        y = train_y[start : start + batch_size]
        t0 = time.time()
        o_rmse, o_nll = online_model.evaluate(x, y)
        stem_loss, gp_loss = online_model.update(x, y, update_stem=update_stem)
        step_time = time.time() - t0

        b_rmse, b_nll = batch_model.evaluate(x, y)
        online_rmse += o_rmse
        online_nll += o_nll
        batch_rmse += b_rmse
        batch_nll += b_nll
        regret = online_rmse - batch_rmse

        if t % logging_freq == (logging_freq - 1):
            rmse, nll = online_model.evaluate(test_x, test_y)
            print(f"T: {t + 1}, test RMSE: {rmse:0.4f}, test NLL: {nll:0.4f}")
            logger.log(
                dict(
                    stem_loss=stem_loss,
                    gp_loss=gp_loss,
                    batch_rmse=batch_rmse,
                    batch_nll=batch_nll,
                    online_rmse=online_rmse,
                    online_nll=online_nll,
                    regret=regret,
                    test_rmse=rmse,
                    test_nll=nll,
                    noise=_mean_noise(online_model),
                    step_time=step_time,
                ),
                step=(t + 1) * batch_size,
                table_name="online_metrics",
            )
            logger.write_csv()


def _chunk_metrics(mean, var, y, batch_size):
    """Per-chunk RMSE/NLL of (n, T) moments: the math of evaluate() per chunk."""
    nc = mean.shape[0] // batch_size
    m = mean.detach().cpu()[: nc * batch_size].reshape(nc, batch_size, -1)
    v = var.detach().cpu()[: nc * batch_size].reshape(nc, batch_size, -1)
    t = torch.as_tensor(np.asarray(y))[: nc * batch_size].reshape(nc, batch_size, -1)
    rmse = torch.sqrt(torch.mean((m - t) ** 2, dim=(1, 2)))
    nll = torch.mean(gaussian_nll(m, v, t), dim=(1, 2))
    return rmse.numpy(), nll.numpy()


def online_regression_fused(batch_model, online_model, train_x, train_y, test_x, test_y,
                            update_stem, batch_size, logger, logging_freq, max_stream=None):
    """Fused prequential streaming: one blocked evaluate-then-condition pass
    per logging segment instead of 2-3 calls per chunk.

    Runs :meth:`OnlineSKIRegression.prequential` (``wiski_prequential_stream``,
    kernel K3 on the card) over each ``logging_freq * batch_size``-point
    segment, then a stem + GP hyper step at the segment boundary
    (``hyper_step``). Semantics match the per-point loop except that
    hyper/stem steps land once per segment instead of once per chunk
    (conditioning itself stays per-point exact). Emits the same
    ``online_metrics`` schema, with per-chunk prequential RMSE/NLL computed
    from the stream's per-point moments, plus ``points_per_sec``.
    """
    if not hasattr(online_model, "prequential"):
        raise ValueError(
            f"stream_mode=fused needs a prequential-capable model "
            f"(WISKI dense core); got {type(online_model).__name__}"
        )
    online_rmse = online_nll = 0.0
    batch_rmse = batch_nll = 0.0
    stem_loss = gp_loss = 0.0
    logger.add_table("online_metrics")
    n = len(train_x)
    if max_stream:
        n = min(n, max_stream)
    seg = logging_freq * batch_size
    n = (n // batch_size) * batch_size  # whole chunks only, like the per-step loop
    steps_done = 0

    for start in range(0, n, seg):
        seg_x = train_x[start : min(start + seg, n)]
        seg_y = train_y[start : min(start + seg, n)]
        if len(seg_x) < batch_size:
            break
        t0 = time.time()
        mean, var = online_model.prequential(seg_x, seg_y)
        block_until_ready(mean)
        t_seg = time.time() - t0
        stem_loss, gp_loss = online_model.hyper_step(
            seg_x[-batch_size:], seg_y[-batch_size:], update_stem=update_stem
        )

        o_rmse, o_nll = _chunk_metrics(mean, var, seg_y, batch_size)
        online_rmse += float(o_rmse.sum())
        online_nll += float(o_nll.sum())
        # regret bookkeeping vs the batch model (vectorized over the segment)
        b_mean, b_var = batch_model.predict(seg_x)
        b_rmse, b_nll = _chunk_metrics(b_mean, b_var, seg_y, batch_size)
        batch_rmse += float(b_rmse.sum())
        batch_nll += float(b_nll.sum())
        regret = online_rmse - batch_rmse
        num_chunks = len(o_rmse)
        steps_done += num_chunks

        rmse, nll = online_model.evaluate(test_x, test_y)
        pps = len(seg_x) / t_seg
        print(f"T: {steps_done}, test RMSE: {rmse:0.4f}, test NLL: {nll:0.4f}, "
              f"stream {pps:,.0f} points/s")
        logger.log(
            dict(
                stem_loss=stem_loss,
                gp_loss=gp_loss,
                batch_rmse=batch_rmse,
                batch_nll=batch_nll,
                online_rmse=online_rmse,
                online_nll=online_nll,
                regret=regret,
                test_rmse=rmse,
                test_nll=nll,
                noise=_mean_noise(online_model),
                step_time=t_seg / num_chunks,
                points_per_sec=pps,
            ),
            step=steps_done * batch_size,
            table_name="online_metrics",
        )
        logger.write_csv()


def prepare_trial(cfg):
    """A trial up to its stream: the logger, the dataset, the batch model
    fit on the whole training split, the online model built on the first
    ``init_ratio`` of it (and fit there with ``pretrain``), both at their
    streaming rates. Returns (logger, batch model, online model, (stream x,
    stream y, test x, test y))."""
    logger = make_logger(cfg, f"{cfg['model']['name']}-{cfg['dataset']['name']}-trial{cfg['trial_id']}")
    logger.write_config(cfg)
    train_x, train_y, test_x, test_y = load_dataset(cfg)
    print(f"dataset {cfg['dataset']['name']}: train {train_x.shape}, test {test_x.shape}")

    batch_model = build_model(cfg, train_x, train_y)
    if cfg["pretrain_stem"]["enabled"] and batch_model.stem.has_params:
        recs = pretrain_stem(batch_model.stem, train_x, train_y, **cfg["pretrain_stem"])
        logger.tables["batch_pretrain_stem_metrics"] = recs

    print("==== training GP in batch setting ====")
    base_lr = cfg["dataset"]["base_lr"]
    batch_model.set_lr(gp_lr=base_lr, stem_lr=base_lr / 10)
    batch_metrics = batch_model.fit(train_x, train_y, cfg["num_batch_epochs"], (test_x, test_y))
    logger.tables["batch_metrics"] = batch_metrics
    logger.write_csv()

    num_init = int(cfg["model"]["init_ratio"] * len(train_x))
    init_x, stream_x = train_x[:num_init], train_x[num_init:]
    init_y, stream_y = train_y[:num_init], train_y[num_init:]
    print(f"==== training model in online setting, N: {len(stream_x)} ====")
    online_model = build_model(cfg, init_x, init_y)

    if cfg["pretrain"]:
        online_model.set_lr(gp_lr=base_lr, stem_lr=base_lr / 10)
        pretrain_metrics = online_model.fit(init_x, init_y, cfg["num_batch_epochs"], (test_x, test_y))
        logger.tables["pretrain_metrics"] = pretrain_metrics
        logger.write_csv()

    online_model.set_lr(gp_lr=base_lr / 10, stem_lr=base_lr / 100)
    return logger, batch_model, online_model, (stream_x, stream_y, test_x, test_y)


def regression_trial(cfg) -> dict:
    logger, batch_model, online_model, (stream_x, stream_y, test_x, test_y) = prepare_trial(cfg)
    stream_fn = (
        online_regression_fused
        if cfg.get("stream_mode", "step") == "fused"
        else online_regression
    )
    stream_fn(
        batch_model, online_model, stream_x, stream_y, test_x, test_y,
        cfg["update_stem"], cfg["batch_size"], logger, cfg["logging_freq"],
        cfg.get("max_stream"),
    )
    logger.write_csv()
    final_rmse, final_nll = online_model.evaluate(test_x, test_y)
    print(f"final online test RMSE {final_rmse:.4f} NLL {final_nll:.4f} "
          f"(dataset baseline: {cfg['dataset'].get('baseline_rmse')})")
    # persist the final online model; a fresh wrapper restored through
    # load_wrapper continues the stream
    ckpt = os.path.join(logger.log_dir, "final_state")
    save_wrapper(ckpt, online_model)
    return dict(test_rmse=final_rmse, test_nll=final_nll, log_dir=logger.log_dir,
                checkpoint=ckpt)


def main():
    cfg = parse_config(sys.argv[1:])
    np.random.seed(cfg["seed"])
    return regression_trial(cfg)


if __name__ == "__main__":
    main()
