"""Mini config system with the reference's Hydra override grammar (the
port's own copy of ``online_gp_tpu/experiments/config.py``: the same
grammar and presets, so one argv gives one config in both packages).

The reference drives experiments with Hydra config groups and CLI
overrides (``python experiments/regression.py model=wiski_gp_regression
dataset=skillcraft stem=eye model.lr=1e-3``; reference
``config/**/*.yaml``, ``README.md:47-67``). Equivalent here without the
Hydra dependency: nested default dicts per group, group presets selected
with ``group=name``, leaves overridden with dotted paths
(``model.lr=0.001``). Interpolation-like defaults (e.g. SVGP's
``num_update_steps: ${batch_size}``) are resolved in ``finalize``.

The port's drivers read one more leaf, ``device`` (``device=cpu``), set
like any other override; it has no default here, and a config without it
runs on "cuda".
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

# -- group presets (mirroring reference config/model/*.yaml etc.) ----------

MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    # regression (reference config/model/*.yaml)
    "wiski_gp_regression": dict(name="wiski_gp_regression", type="regression", init_ratio=0.05,
                                lr=1e-2, grid_size=16, grid_bound=1.0),
    "exact_gp_regression": dict(name="exact_gp_regression", type="regression", init_ratio=0.05, lr=1e-2),
    "svgp_regression": dict(name="svgp_regression", type="regression", init_ratio=0.05, streaming=True,
                            num_inducing=256, lr=1e-2, prior_beta=1e-3, online_beta=1e-3,
                            num_update_steps=None,
                            # "grad": reference O-SVGP (ELBO gradient steps on all
                            # params); "closed_form": variational-EM — Bui et al.
                            # exact (m, S) update per batch, gradients only on
                            # hypers (models/svgp.py::svgp_closed_form_update).
                            # closed_form is the default since the round-5 A/B
                            # (docs/svgp_ab_r5_cpu.json): ~2x lower streaming
                            # test RMSE than grad on both baseline streams
                            # (0.44 vs 0.84 powerplant, 0.35 vs 0.89 elevators,
                            # 3 seeds), and the reference's own online arm also
                            # updates q(u) in closed form
                            # (online_gp/models/variational_gp_model.py:149-202)
                            variational_mode="closed_form"),
    "sgpr_regression": dict(name="sgpr_regression", type="regression", init_ratio=0.05,
                            num_inducing=256, lr=1e-2, num_update_steps=1, jitter=1e-4),
    "localgp_regression": dict(name="localgp_regression", type="regression", init_ratio=0.05,
                               lr=1e-2, max_data_per_model=256, max_experts=64),
    # classification (reference config/model/{wiski_gpd,exact_gpd,svgp_classification}.yaml)
    "wiski_gpd": dict(name="wiski_gpd", type="classification", init_ratio=0.05, alpha_eps=0.01,
                      lr=1e-2, grid_size=16, grid_bound=1.0),
    "exact_gpd": dict(name="exact_gpd", type="classification", init_ratio=0.05, alpha_eps=0.01, lr=1e-2),
    "svgp_classification": dict(name="svgp_classification", type="classification", init_ratio=0.05,
                                num_inducing=256, lr=1e-2, prior_beta=1e-3, online_beta=1e-3,
                                num_update_steps=None),
}

DATASET_PRESETS: Dict[str, Dict[str, Any]] = {
    # regression UCI (reference config/dataset/*.yaml incl. baseline_rmse anchors)
    "skillcraft": dict(name="skillcraft", type="regression", input_dim=19, baseline_rmse=1.8619, base_lr=5e-2),
    "powerplant": dict(name="powerplant", type="regression", input_dim=4, baseline_rmse=0.2169, base_lr=5e-2),
    "elevators": dict(name="elevators", type="regression", input_dim=18, baseline_rmse=0.475, base_lr=5e-2),
    "protein": dict(name="protein", type="regression", input_dim=9, baseline_rmse=2.1227, base_lr=5e-2),
    "3droad": dict(name="3droad", type="regression", input_dim=2, baseline_rmse=0.3711, base_lr=5e-2),
    "hopper": dict(name="hopper", type="regression", input_dim=11, baseline_rmse=None, base_lr=5e-2),
    "walker2d": dict(name="walker2d", type="regression", input_dim=17, baseline_rmse=None, base_lr=5e-2),
    "friedman": dict(name="friedman", type="regression", input_dim=5, baseline_rmse=None, base_lr=5e-2),
    # classification
    "banana": dict(name="banana", type="classification", input_dim=2, base_lr=5e-2, num_classes=2),
    "svmguide1": dict(name="svmguide1", type="classification", input_dim=4, base_lr=5e-2, num_classes=2),
    "criteo": dict(name="criteo", type="classification", input_dim=13, base_lr=5e-2, num_classes=2),
}

STEM_PRESETS: Dict[str, Dict[str, Any]] = {
    "eye": dict(name="eye", feature_dim=None),
    "linear": dict(name="linear", feature_dim=2),
    "mlp": dict(name="mlp", feature_dim=2, depth=2, hidden_dims="64,64"),
}

DEFAULTS: Dict[str, Any] = dict(
    model="wiski_gp_regression",
    dataset="skillcraft",
    stem="linear",  # reference default (config/regression.yaml); SKI needs low-dim features
    update_stem=True,
    pretrain=True,
    pretrain_stem=dict(enabled=False, lr=1e-1, num_epochs=200, batch_size=256),
    num_batch_epochs=200,
    batch_size=1,
    logging_freq=100,
    seed=0,
    trial_id=0,
    dtype="float32",
    data_dir="data",
    log_dir="logs",
    subsample_ratio=1.0,
    max_stream=None,  # optional cap on streamed points
    # "step": reference-faithful per-chunk evaluate->update loop;
    # "fused": blocked prequential engine per logging segment with
    # hyper/stem steps at segment boundaries (WISKI dense core only)
    stream_mode="step",
    # reference config/logger/{local,s3}.yaml: local DataFrame logger or
    # the S3 sink (bucket + key prefix); override with logger.name=s3
    logger=dict(name="local", bucket_name="online-gp-tpu", prefix="",
                bucket_root=None),
    solver=dict(
        max_root_decomposition_size=512,
        max_cholesky_size=2048,
        cg_tolerance=1e-2,
    ),
)


def _set_dotted(cfg: Dict, dotted: str, value: str):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = _parse_value(value)


def parse_cli_kwargs(argv: List[str]) -> Dict[str, Any]:
    """``key=value`` CLI args -> kwargs with int/float/bool/None coercion
    (shared by the standalone drivers' ``main()``s: bayesopt loop, active
    learning, fixed-noise benchmark)."""
    kwargs: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"argument {arg!r} must be key=value")
        k, v = arg.split("=", 1)
        kwargs[k] = _parse_value(v)
    return kwargs


def _parse_value(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("null", "none"):
        return None
    return v


def parse_config(argv: List[str], presets_model=MODEL_PRESETS, presets_dataset=DATASET_PRESETS) -> Dict:
    """Build a config from ``key=value`` CLI overrides (Hydra grammar)."""
    cfg = copy.deepcopy(DEFAULTS)
    group_args, leaf_args = {}, []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"override {arg!r} must be key=value")
        k, v = arg.split("=", 1)
        if k in ("model", "dataset", "stem"):
            group_args[k] = v
        else:
            leaf_args.append((k, v))

    model_name = group_args.get("model", cfg["model"])
    dataset_name = group_args.get("dataset", cfg["dataset"])
    stem_name = group_args.get("stem", cfg["stem"])
    if model_name not in presets_model:
        raise ValueError(f"unknown model {model_name!r}; known: {sorted(presets_model)}")
    if dataset_name not in presets_dataset:
        raise ValueError(f"unknown dataset {dataset_name!r}; known: {sorted(presets_dataset)}")
    if stem_name not in STEM_PRESETS:
        raise ValueError(f"unknown stem {stem_name!r}; known: {sorted(STEM_PRESETS)}")

    cfg["model"] = copy.deepcopy(presets_model[model_name])
    cfg["dataset"] = copy.deepcopy(presets_dataset[dataset_name])
    cfg["stem"] = copy.deepcopy(STEM_PRESETS[stem_name])

    for k, v in leaf_args:
        _set_dotted(cfg, k, v)
    return finalize(cfg)


def finalize(cfg: Dict) -> Dict:
    """Resolve cross-field defaults (the reference's interpolations)."""
    # ${batch_size} interpolation on variational update steps
    if cfg["model"].get("num_update_steps", "missing") is None:
        cfg["model"]["num_update_steps"] = cfg["batch_size"]
    # stem input dim patched from the dataset (reference regression.py:90)
    cfg["stem"]["input_dim"] = cfg["dataset"]["input_dim"]
    if cfg["stem"].get("feature_dim") is None:
        cfg["stem"]["feature_dim"] = cfg["dataset"]["input_dim"]
    return cfg
