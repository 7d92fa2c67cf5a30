"""Streaming-classification experiment driver (the port of
``online_gp_tpu/experiments/classification.py``).

Re-build of the reference's ``experiments/classification.py``: batch
fit, then point-by-point prequential streaming with cumulative accuracy
and regret vs the batch model.

Usage (the models run on "cuda" unless ``device=cpu``):
    python -m online_gp_torch.experiments.classification \
        model=wiski_gpd dataset=banana stem=eye
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from online_gp_torch.experiments.common import build_model, load_dataset
from online_gp_torch.experiments.config import parse_config
from online_gp_torch.logging import make_logger
from online_gp_torch.utils.checkpoint import save_wrapper


def _predict_labels(model, x):
    pred = model.predict(x)
    if isinstance(pred, tuple):
        pred = pred[0]
    return torch.as_tensor(pred).detach().cpu().numpy().reshape(-1)


def online_classification(batch_model, online_model, train_x, train_y, test_x, test_y,
                          update_stem, logger, logging_freq, max_stream=None):
    logger.add_table("online_metrics")
    online_correct = batch_correct = 0
    n = len(train_x)
    if max_stream:
        n = min(n, max_stream)

    for t in range(n):
        x, y = train_x[t : t + 1], train_y[t : t + 1]
        t0 = time.time()
        online_correct += int(_predict_labels(online_model, x)[0] == train_y[t])
        stem_loss, gp_loss = online_model.update(x, y, update_stem)
        step_time = time.time() - t0
        batch_correct += int(_predict_labels(batch_model, x)[0] == train_y[t])

        if t % logging_freq == (logging_freq - 1):
            test_acc = online_model.evaluate(test_x, test_y)
            cum_acc = online_correct / (t + 1)
            regret = (batch_correct - online_correct) / (t + 1)
            print(f"T: {t + 1}, cum acc: {cum_acc:0.4f}, test acc: {test_acc:0.4f}")
            logger.log(
                dict(
                    stem_loss=stem_loss,
                    gp_loss=gp_loss,
                    online_acc=cum_acc,
                    batch_acc=batch_correct / (t + 1),
                    regret=regret,
                    test_acc=test_acc,
                    step_time=step_time,
                ),
                step=t + 1,
                table_name="online_metrics",
            )
            logger.write_csv()


def classification_trial(cfg) -> dict:
    logger = make_logger(cfg, f"{cfg['model']['name']}-{cfg['dataset']['name']}-trial{cfg['trial_id']}")
    logger.write_config(cfg)
    train_x, train_y, test_x, test_y = load_dataset(cfg)
    print(f"dataset {cfg['dataset']['name']}: train {train_x.shape}, test {test_x.shape}")

    batch_model = build_model(cfg, train_x, train_y)
    print("==== training GP in batch setting ====")
    base_lr = cfg["dataset"]["base_lr"]
    batch_model.set_lr(gp_lr=base_lr, stem_lr=base_lr / 10)
    batch_metrics = batch_model.fit(train_x, train_y, cfg["num_batch_epochs"], (test_x, test_y))
    logger.tables["batch_metrics"] = batch_metrics
    logger.write_csv()

    num_init = int(cfg["model"]["init_ratio"] * len(train_x))
    init_x, stream_x = train_x[:num_init], train_x[num_init:]
    init_y, stream_y = train_y[:num_init], train_y[num_init:]
    online_model = build_model(cfg, init_x, init_y)

    if cfg["pretrain"]:
        online_model.set_lr(gp_lr=base_lr, stem_lr=base_lr / 10)
        pretrain_metrics = online_model.fit(init_x, init_y, cfg["num_batch_epochs"], (test_x, test_y))
        logger.tables["pretrain_metrics"] = pretrain_metrics
        logger.write_csv()

    online_model.set_lr(gp_lr=base_lr / 10, stem_lr=base_lr / 100)
    online_classification(
        batch_model, online_model, stream_x, stream_y, test_x, test_y,
        cfg["update_stem"], logger, cfg["logging_freq"], cfg.get("max_stream"),
    )
    logger.write_csv()
    final_acc = online_model.evaluate(test_x, test_y)
    print(f"final online test acc {final_acc:.4f}")
    ckpt = os.path.join(logger.log_dir, "final_state")
    save_wrapper(ckpt, online_model)
    return dict(test_acc=final_acc, log_dir=logger.log_dir, checkpoint=ckpt)


def main():
    cfg = parse_config(sys.argv[1:])
    np.random.seed(cfg["seed"])
    return classification_trial(cfg)


if __name__ == "__main__":
    main()
