"""Shared experiment plumbing: model/stem/dataset factories + stem
pretraining (the port of ``online_gp_tpu/experiments/common.py``).

Models are built on ``cfg["device"]``, "cuda" unless the config says
otherwise (``device=cpu`` on the command line).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from online_gp_torch.api import (
    OnlineExactClassifier,
    OnlineExactRegression,
    OnlineLocalGPRegression,
    OnlineSGPRegression,
    OnlineSKIClassifier,
    OnlineSKIRegression,
    OnlineSVGPClassifier,
    OnlineSVGPRegression,
    make_stem,
)
from online_gp_torch.config import SolverConfig
from online_gp_torch.data import (
    banana_dataset,
    criteo_dataset,
    load_uci,
    streaming_friedman,
    svmguide1_dataset,
)
from online_gp_torch.utils.optim import adam_init, adam_update

_REGRESSION_MODELS = {
    "wiski_gp_regression": OnlineSKIRegression,
    "exact_gp_regression": OnlineExactRegression,
    "svgp_regression": OnlineSVGPRegression,
    "sgpr_regression": OnlineSGPRegression,
    "localgp_regression": OnlineLocalGPRegression,
}
_CLASSIFICATION_MODELS = {
    "wiski_gpd": OnlineSKIClassifier,
    "exact_gpd": OnlineExactClassifier,
    "svgp_classification": OnlineSVGPClassifier,
}


def solver_config(cfg: Dict) -> SolverConfig:
    s = cfg.get("solver", {})
    return SolverConfig(
        max_root_decomposition_size=int(s.get("max_root_decomposition_size", 512)),
        max_cholesky_size=int(s.get("max_cholesky_size", 2048)),
        cg_tolerance=float(s.get("cg_tolerance", 1e-2)),
    )


def build_stem(cfg: Dict):
    stem_cfg = dict(cfg["stem"])
    name = stem_cfg.pop("name")
    input_dim = stem_cfg.pop("input_dim")
    feature_dim = stem_cfg.pop("feature_dim", None)
    return make_stem(name, input_dim, feature_dim, **stem_cfg)


def build_model(cfg: Dict, init_x, init_y):
    model_cfg = dict(cfg["model"])
    name = model_cfg.pop("name")
    model_cfg.pop("type", None)
    model_cfg.pop("init_ratio", None)
    stem = build_stem(cfg)
    registry = {**_REGRESSION_MODELS, **_CLASSIFICATION_MODELS}
    cls = registry[name]
    if name in _CLASSIFICATION_MODELS:
        model_cfg.setdefault("num_classes", cfg["dataset"].get("num_classes", 2))
    device = cfg.get("device") or "cuda"
    return cls(stem, init_x, init_y, cfg=solver_config(cfg), seed=cfg["seed"], device=device, **model_cfg)


def load_dataset(cfg: Dict):
    d = cfg["dataset"]
    if d["type"] == "classification":
        if d["name"] == "banana":
            return banana_dataset(seed=cfg["seed"])
        if d["name"] == "svmguide1":
            tr_x, tr_y, te_x, te_y, synth = svmguide1_dataset(cfg.get("data_dir"), cfg["seed"])
            if synth:
                print("[data] no local svmguide1 files; using the flagged synthetic surrogate")
            return tr_x, tr_y, te_x, te_y
        if d["name"] == "criteo":
            tr_x, tr_y, te_x, te_y, synth = criteo_dataset(cfg.get("data_dir"), cfg["seed"])
            if synth:
                print("[data] no local criteo files; using the flagged synthetic surrogate")
            return tr_x, tr_y, te_x, te_y
        raise ValueError(f"unknown classification dataset {d['name']}")
    if d["name"] == "friedman":
        return streaming_friedman(n=int(d.get("n", 4000)), seed=cfg["seed"], num_dims=d["input_dim"])
    bundle = load_uci(
        d["name"],
        data_dir=cfg.get("data_dir"),
        subsample_ratio=cfg.get("subsample_ratio", 1.0),
        seed=cfg["seed"],
    )
    if bundle.synthetic:
        print(f"[data] no local files for {d['name']!r}; using the flagged synthetic surrogate")
    return bundle.train_x, bundle.train_y, bundle.test_x, bundle.test_y


def pretrain_stem(stem, x, y, lr=0.1, num_epochs=200, batch_size=256, seed=0, **_):
    """Supervised stem pretraining (reference ``utils/dkl.py:35-58``):
    regress targets from features through a throwaway zero-initialized
    linear head, one optax-style Adam step an epoch on a batch drawn with
    ``np.random.default_rng(seed).integers``, the stem in training mode
    (its BatchNorm statistics move). Updates ``stem`` in place, on its
    device; returns one record per epoch."""
    device = next(stem.parameters()).device
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device).reshape(x.shape[0], -1)
    head_w = torch.zeros((stem.output_dim, y.shape[-1]), device=device, requires_grad=True)
    head_b = torch.zeros((y.shape[-1],), device=device, requires_grad=True)
    leaves = list(stem.parameters()) + [head_w, head_b]
    opt_state = adam_init([p.detach() for p in leaves])
    rng = np.random.default_rng(seed)
    records = []
    n = x.shape[0]
    bs = min(batch_size, n)
    stem.train()
    try:
        for epoch in range(num_epochs):
            idx = torch.as_tensor(rng.integers(0, n, bs), device=device)
            pred = stem(x[idx]) @ head_w + head_b
            loss = torch.mean((pred - y[idx]) ** 2)
            grads = torch.autograd.grad(loss, leaves)
            updates, opt_state = adam_update(grads, opt_state, lr)
            with torch.no_grad():
                for p, u in zip(leaves, updates):
                    p.add_(u)
            records.append({"epoch": epoch + 1, "loss": float(loss)})
    finally:
        stem.eval()
    return records
