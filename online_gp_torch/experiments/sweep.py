"""Multi-trial sweep runner (the port of ``online_gp_tpu/experiments/sweep.py``).

The reference farms independent trials as separate processes
(``scripts/launch_jobs.sh``, Hydra submitit launchers, one GPU per
trial). ``mode=seq`` runs the trials one after another in one process,
trial ``t`` with ``trial_id=t`` and ``seed=t`` (the bash-loop equivalent).
``mode=mesh`` runs them batched: the trials are split over the ranks of the
``dp`` mesh (:func:`online_gp_torch.parallel.make_mesh`: a world of one in a
plain process, every rank under ``torchrun``), and each rank runs its
trials as one batch, the trial dim folded into the WISKI output batch
(:mod:`online_gp_torch.parallel.trials`): one K2 launch conditions every
trial of a step and one K6 launch factors every trial's Q.

Usage:
    python -m online_gp_torch.experiments.sweep num_trials=4 mode=seq \\
        model=wiski_gp_regression dataset=friedman stem=linear ...
    torchrun --nproc-per-node=2 -m online_gp_torch.experiments.sweep \\
        num_trials=8 mode=mesh model=wiski_gp_regression dataset=skillcraft ...
"""

from __future__ import annotations

import copy
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

# the mesh sweeps' per-step and held-out metrics, by classification
_STEP_METRICS = {False: ("stem_loss", "gp_loss", "online_rmse", "online_nll", "noise"),
                 True: ("stem_loss", "gp_loss", "online_acc")}
_TEST_METRICS = {False: ("test_rmse", "test_nll"), True: ("test_acc",)}


def run_sweep(num_trials: int, mode: str, overrides: List[str]) -> List[Dict]:
    from online_gp_torch.experiments.config import parse_config

    if mode == "mesh":
        name = parse_config(overrides)["model"]["name"]
        if name == "wiski_gp_regression":
            return mesh_regression_sweep(num_trials, overrides)
        if name == "wiski_gpd":
            return mesh_classification_sweep(num_trials, overrides)
        if name == "svgp_regression":
            return mesh_svgp_sweep(num_trials, overrides)
        if name == "svgp_classification":
            return mesh_svgp_classification_sweep(num_trials, overrides)
        if name == "sgpr_regression":
            return mesh_sgpr_sweep(num_trials, overrides)
        raise ValueError(
            f"mode=mesh supports wiski_gp_regression / wiski_gpd / "
            f"svgp_regression / svgp_classification / sgpr_regression "
            f"(functional vmappable cores); got {name!r} — use mode=seq "
            "for other models"
        )
    if mode != "seq":
        raise ValueError(f"unknown sweep mode {mode!r} (seq/mesh)")
    from online_gp_torch.experiments.classification import classification_trial
    from online_gp_torch.experiments.regression import regression_trial

    results = []
    for trial in range(num_trials):
        cfg = parse_config(overrides + [f"trial_id={trial}", f"seed={trial}"])
        np.random.seed(trial)
        if cfg["model"]["type"] == "classification":
            results.append(classification_trial(cfg))
        else:
            results.append(regression_trial(cfg))
    return results


def _stack_trial_data(cfg, num_trials: int, y_mode: str):
    """Load ``num_trials`` per-seed datasets and stack along a leading T
    dim (host side), truncating to the shortest trial. ``y_mode`` picks
    the target layout: ``"multi"`` (n, B) f32, ``"single"`` (n, 1) f32,
    ``"labels_i"`` flat int32, ``"labels_f"`` flat f32."""
    from online_gp_torch.experiments.common import load_dataset

    per_trial = []
    for t in range(num_trials):
        ct = copy.deepcopy(cfg)
        ct["seed"] = t
        per_trial.append(load_dataset(ct))
    n_tr = min(d[0].shape[0] for d in per_trial)
    n_te = min(d[2].shape[0] for d in per_trial)

    def ys(col, n):
        if y_mode == "multi":
            return [np.asarray(d[col][:n]).reshape(n, -1) for d in per_trial], np.float32
        if y_mode == "single":
            return [np.asarray(d[col][:n]).reshape(n, -1)[:, :1] for d in per_trial], np.float32
        if y_mode == "labels_i":
            return [np.asarray(d[col][:n]).reshape(-1) for d in per_trial], np.int32
        if y_mode == "labels_f":
            return [np.asarray(d[col][:n]).reshape(-1) for d in per_trial], np.float32
        raise ValueError(y_mode)

    train_x = np.stack([np.asarray(d[0][:n_tr]) for d in per_trial]).astype(np.float32)
    rows, dt = ys(1, n_tr)
    train_y = np.stack(rows).astype(dt)
    test_x = np.stack([np.asarray(d[2][:n_te]) for d in per_trial]).astype(np.float32)
    rows, dt = ys(3, n_te)
    test_y = np.stack(rows).astype(dt)
    return train_x, train_y, test_x, test_y


def trial_stems(cfg, trials, device):
    """One stem per trial, its weights drawn from a ``torch.Generator``
    seeded from (cfg seed, trial) (where the JAX sweep splits one key)."""
    from online_gp_torch.experiments.common import build_stem

    stems = []
    for t in trials:
        stem = build_stem(cfg).to(device)
        seed = int(np.random.SeedSequence([int(cfg["seed"]), int(t)]).generate_state(1)[0])
        stem.reset_parameters(torch.Generator().manual_seed(seed))
        stem.eval()
        stems.append(stem)
    return stems


def trial_inducing_points(cfg, trials, num_inducing: int, dim: int, device) -> torch.Tensor:
    """Each trial's initial inducing points, U(-1, 1) of shape
    (num_inducing, dim), drawn from a ``torch.Generator`` seeded from (cfg
    seed, trial) as :func:`trial_stems` seeds the stems (where the JAX
    sweeps split one key). Returns (len(trials), num_inducing, dim)."""
    zs = []
    for t in trials:
        seed = int(np.random.SeedSequence([int(cfg["seed"]), int(t), 1]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        zs.append(torch.rand((num_inducing, dim), generator=gen) * 2.0 - 1.0)
    return torch.stack(zs).to(device)


def _features(stems, x):
    """Each trial's stem on its own points: x (T, n, D) -> (T, n, F)."""
    return torch.stack([stem(x[i]) for i, stem in enumerate(stems)])


def _adam_apply(leaves, grads, opt_state, lr):
    from online_gp_torch.utils.optim import adam_update

    updates, opt_state = adam_update(grads, opt_state, lr)
    with torch.no_grad():
        for p, u in zip(leaves, updates):
            p.add_(u)
    return opt_state


def _stream_shape(cfg, n_tr: int):
    """(initial points, streamed chunks) of a trial of n_tr training points;
    raises ValueError when the stream has no chunk."""
    num_init = max(int(cfg["model"]["init_ratio"] * n_tr), 2)
    n_stream = n_tr - num_init
    if cfg.get("max_stream"):
        n_stream = min(n_stream, int(cfg["max_stream"]))
    num_chunks = n_stream // cfg["batch_size"]
    if num_chunks == 0:
        raise ValueError(
            f"stream of {n_stream} points is shorter than batch_size={cfg['batch_size']} (after init split / "
            "max_stream cap): nothing to sweep — lower batch_size or raise max_stream"
        )
    return num_init, num_chunks


def _run_trials(cfg, tx, ty, ex, ey, stems, device, classification: bool):
    """The local trials of a mesh sweep as one batch, the trial dim folded
    into the output batch: pretrain epochs (full-cache refits, gradients to
    the stems through the interpolation weights; BatchNorm statistics frozen
    after them), then the stream (prequential evaluate, stem step on the
    partial MLL, GP step with ``skip_logdet_forward``, condition), then the
    held-out evaluation. Returns ({metric: (T, chunks)}, {test metric: (T,)})."""
    from online_gp_torch.api.regression import cosine_lr
    from online_gp_torch.experiments.common import solver_config
    from online_gp_torch.kernels.base import make_kernel
    from online_gp_torch.likelihoods.dirichlet import dirichlet_transform
    from online_gp_torch.likelihoods.gaussian import gaussian_nll
    from online_gp_torch.models.wiski import WiskiModel
    from online_gp_torch.ops.grid import Grid
    from online_gp_torch.parallel.trials import (
        trials_condition,
        trials_init,
        trials_mll,
        trials_params,
        trials_partial_mll,
        trials_predict,
        trials_prediction_caches,
    )
    from online_gp_torch.utils.optim import adam_init, tree_leaves, tree_rebuild

    T, n_tr = tx.shape[:2]
    feat_dim = stems[0].output_dim
    C = int(cfg["dataset"].get("num_classes", 2))
    alpha_eps = float(cfg["model"].get("alpha_eps", 0.01))
    outputs = C if classification else ty.shape[-1]
    grid_bound = cfg["model"].get("grid_bound", 1.0) + 1e-1
    grid = Grid.create([(-grid_bound, grid_bound)] * feat_dim, cfg["model"]["grid_size"], device=device)
    model = WiskiModel(make_kernel("rbf"), grid, num_outputs=outputs, learn_additional_noise=not classification)
    scfg = solver_config(cfg)
    scfg_skip = scfg.replace(skip_logdet_forward=True)
    base_lr = cfg["dataset"]["base_lr"]
    batch_size = cfg["batch_size"]
    num_init, num_chunks = _stream_shape(cfg, n_tr)
    num_epochs = cfg["num_batch_epochs"] if cfg["pretrain"] else 0
    has_params = stems[0].has_params
    update_stem = bool(cfg["update_stem"]) and has_params

    def targets(labels_or_y):
        """(targets, noise), each (T, n, outputs)."""
        if not classification:
            return labels_or_y, torch.ones_like(labels_or_y)
        tg, _, s2 = dirichlet_transform(labels_or_y.reshape(-1), C, alpha_eps)
        return tg.reshape(T, -1, C), s2.reshape(T, -1, C)

    t_init, s_init = targets(ty[:, :num_init])
    init_x = tx[:, :num_init]
    params = trials_params(model, feat_dim, T, device=device)
    gp_leaves = tree_leaves(params)  # updated in place by each Adam step
    stem_leaves = [p for stem in stems for p in stem.parameters()]

    # pretrain epochs: full-cache refits, the stems in training mode
    gp_opt, stem_opt = adam_init(gp_leaves), adam_init(stem_leaves) if has_params else None
    fixed_state = None if has_params else trials_init(model, _features(stems, init_x), t_init, s_init)
    for epoch in range(num_epochs):
        lr = cosine_lr(base_lr, max(num_epochs, 1), epoch)
        leaves = [p.detach().requires_grad_(True) for p in gp_leaves]
        with torch.enable_grad():
            if has_params:
                for stem in stems:
                    stem.train()
                state = trials_init(model, _features(stems, init_x), t_init, s_init)
                for stem in stems:
                    stem.eval()
            else:
                state = fixed_state
            loss = -torch.sum(trials_mll(model, tree_rebuild(params, leaves), state, scfg))
            grads = torch.autograd.grad(loss, leaves + stem_leaves)
        gp_opt = _adam_apply(gp_leaves, grads[: len(leaves)], gp_opt, lr)
        if has_params:
            stem_opt = _adam_apply(stem_leaves, grads[len(leaves):], stem_opt, lr)

    with torch.no_grad():
        state = fixed_state if fixed_state is not None else trials_init(model, _features(stems, init_x), t_init, s_init)

    # the stream: prequential evaluate -> stem step -> GP step -> condition
    span = slice(num_init, num_init + num_chunks * batch_size)
    xs = tx[:, span].reshape(T, num_chunks, batch_size, -1)
    ys = ty[:, span].reshape(T, num_chunks, batch_size, *ty.shape[2:])
    gp_opt = adam_init(gp_leaves)
    stem_opt = adam_init(stem_leaves) if has_params else None
    steps = []
    for c in range(num_chunks):
        x, y = xs[:, c], ys[:, c]
        tg, noise = targets(y)
        with torch.no_grad():
            feats = _features(stems, x)
            caches = trials_prediction_caches(model, params, state, scfg)
            mean, var = trials_predict(model, params, state, feats, scfg, caches)  # (T, outputs, q)
        if classification:
            evals = (torch.mean((torch.argmax(mean, dim=1) == y).to(torch.float32), dim=-1),)
        else:
            var = var + torch.exp(params["raw_second_noise"])[..., None]
            evals = (torch.sqrt(torch.mean((mean.mT - y) ** 2, dim=(1, 2))),
                     torch.mean(gaussian_nll(mean.mT, var.mT, y), dim=(1, 2)))
        if update_stem:
            with torch.enable_grad():
                stem_y = tg / noise if classification else y
                s_loss = -torch.sum(trials_partial_mll(model, params, state, _features(stems, x), stem_y, caches), -1)
                grads = torch.autograd.grad(torch.sum(s_loss), stem_leaves)
            stem_opt = _adam_apply(stem_leaves, grads, stem_opt, base_lr / 100)
            s_loss = s_loss.detach()
        else:
            s_loss = torch.zeros(T, device=device)
        leaves = [p.detach().requires_grad_(True) for p in gp_leaves]
        with torch.enable_grad():
            g_loss = -torch.sum(trials_mll(model, tree_rebuild(params, leaves), state, scfg_skip), dim=-1)
            grads = torch.autograd.grad(torch.sum(g_loss), leaves)
        gp_opt = _adam_apply(gp_leaves, grads, gp_opt, base_lr / 10)
        with torch.no_grad():
            state = trials_condition(model, state, feats, tg, noise)
        extra = () if classification else (torch.mean(torch.exp(params["raw_second_noise"]), dim=-1),)
        steps.append(torch.stack([s_loss, g_loss.detach(), *evals, *extra]))

    # the held-out evaluation
    with torch.no_grad():
        mean, var = trials_predict(model, params, state, _features(stems, ex), scfg)
        if classification:
            test = {"test_acc": torch.mean((torch.argmax(mean, dim=1) == ey).to(torch.float32), dim=-1)}
        else:
            var = var + torch.exp(params["raw_second_noise"])[..., None]
            test = {"test_rmse": torch.sqrt(torch.mean((mean.mT - ey) ** 2, dim=(1, 2))),
                    "test_nll": torch.mean(gaussian_nll(mean.mT, var.mT, ey), dim=(1, 2))}
    by_step = torch.stack(steps, dim=-1)  # (metrics, T, chunks)
    return {k: by_step[i] for i, k in enumerate(_STEP_METRICS[classification])}, test


def _mesh_sweep(num_trials: int, overrides: List[str], name: str, classification: bool, y_mode: str,
                run_local) -> List[Dict]:
    """``mode=mesh``: the trials split over the ``dp`` ranks (contiguous
    blocks, as ``Shard(0)`` cuts them), each rank running its trials
    through ``run_local(cfg, trials, tx, ty, ex, ey, device)``, which
    returns ({step metric: (T, chunks)}, {test metric: (T,)}); rank 0
    gathers the metrics (one all_reduce of a zero-filled buffer) and writes
    one ``online_metrics`` CSV per trial in the JAX package's schema.
    ``step_time`` is the wall time of a rank's trials over its chunks times
    its trials, as the JAX sweep divides its program's time."""
    import torch.distributed as dist

    from online_gp_torch.experiments.config import parse_config
    from online_gp_torch.logging import CSVLogger
    from online_gp_torch.parallel.mesh import _chunk_bounds, local_device, make_mesh

    cfg = parse_config(overrides)
    kind = "classification" if classification else "regression"
    if cfg["model"]["name"] != name or cfg["dataset"]["type"] != kind:
        raise ValueError(
            f"mode=mesh runs the {name} {kind} core; got model={cfg['model']['name']!r} "
            f"dataset type={cfg['dataset']['type']!r} — use mode=seq for other models"
        )
    train_x, train_y, test_x, test_y = _stack_trial_data(cfg, num_trials, y_mode)
    if y_mode == "labels_f":
        test_y = test_y.astype(np.int32)
    num_chunks = _stream_shape(cfg, train_x.shape[1])[1]
    device_type = torch.device(cfg.get("device") or "cuda").type
    owns_group = not dist.is_initialized()
    mesh = make_mesh(axis_name="dp", device_type=device_type)
    try:
        device = local_device(device_type)
        lo, hi = _chunk_bounds(num_trials, mesh.size(0), mesh.get_local_rank("dp"))
        names, tests = _STEP_METRICS[classification], _TEST_METRICS[classification]
        width = num_chunks * len(names) + len(tests) + 1
        gathered = torch.zeros((num_trials, width), dtype=torch.float64, device=device)
        if hi > lo:
            to = lambda a: torch.as_tensor(a[lo:hi], device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            steps, test = run_local(cfg, range(lo, hi), to(train_x), to(train_y), to(test_x), to(test_y), device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_time = (time.perf_counter() - t0) / max(num_chunks * (hi - lo), 1)
            row = torch.cat([*(steps[k] for k in names), *(test[k][:, None] for k in tests),
                             torch.full((hi - lo, 1), step_time, device=device)], dim=1)
            gathered[lo:hi] = row.to(torch.float64)
        if mesh.size(0) > 1:
            dist.all_reduce(gathered, group=mesh.get_group("dp"))
        table = gathered.cpu().numpy()
        rank0 = mesh.get_local_rank("dp") == 0
    finally:
        if owns_group:
            dist.destroy_process_group()

    metrics = {k: table[:, i * num_chunks : (i + 1) * num_chunks] for i, k in enumerate(names)}
    test = {k: table[:, num_chunks * len(names) + i] for i, k in enumerate(tests)}
    step_times = table[:, -1]
    if classification:
        metrics["online_acc"] = np.cumsum(metrics["online_acc"], axis=1) / np.arange(1, num_chunks + 1)
    else:
        metrics["online_rmse"] = np.cumsum(metrics["online_rmse"], axis=1)
        metrics["online_nll"] = np.cumsum(metrics["online_nll"], axis=1)
    batch_size, freq = cfg["batch_size"], max(int(cfg["logging_freq"]), 1)
    run_tag = f"mesh-{cfg['model']['name']}-{cfg['dataset']['name']}"
    log_rows = sorted(set(range(freq - 1, num_chunks, freq)) | {num_chunks - 1})
    nan = float("nan")
    results = []
    for t in range(num_trials):
        logger = CSVLogger(cfg["log_dir"], f"{run_tag}-trial{t}")
        for c in log_rows:
            last = c == num_chunks - 1
            step = dict(stem_loss=float(metrics["stem_loss"][t, c]), gp_loss=float(metrics["gp_loss"][t, c]))
            if classification:
                step.update(online_acc=float(metrics["online_acc"][t, c]), batch_acc=nan, regret=nan,
                            test_acc=float(test["test_acc"][t]) if last else nan)
            else:
                step.update(batch_rmse=nan, batch_nll=nan, online_rmse=float(metrics["online_rmse"][t, c]),
                            online_nll=float(metrics["online_nll"][t, c]), regret=nan,
                            test_rmse=float(test["test_rmse"][t]) if last else nan,
                            test_nll=float(test["test_nll"][t]) if last else nan,
                            noise=float(metrics["noise"][t, c]))
            step["step_time"] = float(step_times[t])
            logger.log(step, step=(c + 1) * batch_size, table_name="online_metrics")
        if rank0:
            logger.write_config(cfg)
            logger.write_csv()
        results.append(dict(trial=t, **{k: float(test[k][t]) for k in tests}, log_dir=logger.log_dir))
    return results


def _wiski_runner(classification: bool):
    def run(cfg, trials, tx, ty, ex, ey, device):
        stems = trial_stems(cfg, trials, device)
        return _run_trials(cfg, tx, ty, ex, ey, stems, device, classification)

    return run


def mesh_regression_sweep(num_trials: int, overrides: List[str]) -> List[Dict]:
    """``num_trials`` independent streaming-regression trials of the WISKI
    flagship, batched (the replacement for the reference's Slurm trial
    array, ``scripts/launch_jobs.sh:1-21``). Arbitrary model/dataset/stem
    overrides go through the ``mode=seq`` config grammar; per-trial data
    shuffles and stem inits differ by seed. Each trial writes its own
    ``online_metrics`` CSV (reference schema). As in the JAX sweep: no
    batch-model regret arm (batch_rmse, batch_nll, regret NaN), and the
    BatchNorm statistics freeze after the pretrain epochs."""
    return _mesh_sweep(num_trials, overrides, "wiski_gp_regression", False, "multi", _wiski_runner(False))


def mesh_classification_sweep(num_trials: int, overrides: List[str]) -> List[Dict]:
    """``mode=mesh`` for the Dirichlet WISKI classifier (``wiski_gpd``):
    Dirichlet-transformed targets with per-class heteroscedastic noise
    (C outputs a trial, T * C in the folded batch), prequential predict ->
    stem step on the partial MLL -> hyper step -> condition; the same
    deltas from the sequential driver as :func:`mesh_regression_sweep`."""
    return _mesh_sweep(num_trials, overrides, "wiski_gpd", True, "labels_i", _wiski_runner(True))


def _baseline_shape(cfg, n_tr: int):
    """(initial points, chunks, pretrain epochs) of a baseline trial."""
    num_init, num_chunks = _stream_shape(cfg, n_tr)
    num_epochs = cfg["num_batch_epochs"] if cfg["pretrain"] else 0
    return num_init, num_chunks, num_epochs


def _pretrain(stem, init_x, epochs: int, loss_of_feats, opt, stem_opt) -> None:
    """Full-init-batch epochs, the stem in training mode (its BatchNorm
    statistics move with each epoch, then stay frozen)."""
    from online_gp_torch.utils.optim import adam_step

    for _ in range(epochs):
        stem.train()
        feats = stem(init_x)
        stem.eval()
        adam_step(loss_of_feats(feats), opt, stem_opt)


def _regression_evals(mean, var, noise, y):
    """(rmse, mean nll) of the predictive moments with noise added."""
    from online_gp_torch.likelihoods.gaussian import gaussian_nll

    var = var + noise
    return (torch.sqrt(torch.mean((mean[:, None] - y) ** 2)),
            torch.mean(gaussian_nll(mean[:, None], var[:, None], y)))


def _svgp_trial(cfg, stem, z, tx, ty, ex, ey, classification: bool):
    """One streaming O-SVGP trial (the per-trial body of the JAX package's
    ``mesh_svgp_sweep`` / ``mesh_svgp_classification_sweep``): full-batch
    ELBO epochs with beta = 1, then per chunk prequential evaluate ->
    snapshot -> ``num_update_steps`` ELBO steps at ``prior_beta`` with
    Bui's streaming correction at ``online_beta``; then the test set. The
    GP's optimizer is ``optax.zero_nans`` before Adam at lr on the hypers
    and lr / 10 on the variational params, the stem's Adam at lr / 10
    (the JAX sweep's ``_make_optimizer(lr)``), one for the whole trial."""
    from online_gp_torch.api.regression import _leaves, _stem_leaves
    from online_gp_torch.api.svgp import _split
    from online_gp_torch.experiments.common import solver_config
    from online_gp_torch.kernels.base import make_kernel
    from online_gp_torch.likelihoods.bernoulli import bernoulli_probit_predictive
    from online_gp_torch.models.svgp import (
        SVGPModel,
        svgp_elbo,
        svgp_init_variational_to_prior,
        svgp_predict,
        svgp_snapshot,
        svgp_streaming_correction,
    )
    from online_gp_torch.utils.optim import GroupAdam, adam_step

    model = SVGPModel(make_kernel("rbf"), likelihood="bernoulli" if classification else "gaussian")
    scfg = solver_config(cfg)
    base_lr, batch_size = cfg["dataset"]["base_lr"], cfg["batch_size"]
    prior_beta, online_beta = float(cfg["model"]["prior_beta"]), float(cfg["model"]["online_beta"])
    num_update_steps = int(cfg["model"]["num_update_steps"] or batch_size)
    streaming = bool(cfg["model"].get("streaming", True))
    num_init, num_chunks, num_epochs = _baseline_shape(cfg, tx.shape[0])
    init_x, init_y = tx[:num_init], ty[:num_init]
    span = slice(num_init, num_init + num_chunks * batch_size)
    xs = tx[span].reshape(num_chunks, batch_size, -1)
    ys = ty[span].reshape(num_chunks, batch_size, *ty.shape[1:])

    with torch.no_grad():
        params = svgp_init_variational_to_prior(
            model, model.init_params(z, stem.output_dim, dtype=tx.dtype, device=tx.device))
    for t in _leaves(params):
        t.requires_grad_(True)
    hyper, variational = _split(params)
    opt = GroupAdam([(hyper, base_lr), (variational, base_lr / 10.0)], zero_nans=True)
    stem_opt = GroupAdam([(_stem_leaves(stem), base_lr / 10.0)])
    _pretrain(stem, init_x, num_epochs, lambda f: -svgp_elbo(model, params, f, init_y, num_init, 1.0, scfg),
              opt, stem_opt)

    steps = []
    for c in range(num_chunks):
        x, y = xs[c], ys[c]
        with torch.no_grad():
            mean, var = svgp_predict(model, params, stem(x), scfg)
            if classification:
                prob = bernoulli_probit_predictive(mean, var)
                evals = (torch.mean(((prob >= 0.5).to(y.dtype) == y).to(torch.float32)),)
            else:
                evals = _regression_evals(mean, var, torch.exp(params["raw_noise"]), y)
        old = svgp_snapshot(model, params)
        for _ in range(num_update_steps):
            loss = -svgp_elbo(model, params, stem(x), y, batch_size, prior_beta, scfg)
            if streaming:
                loss = loss + svgp_streaming_correction(model, params, old, batch_size, online_beta, scfg)
            adam_step(loss, opt, stem_opt)
        with torch.no_grad():
            extra = () if classification else (torch.exp(params["raw_noise"]),)
            steps.append(torch.stack([torch.full_like(loss, float("nan")), loss, *evals, *extra]))

    with torch.no_grad():
        mean, var = svgp_predict(model, params, stem(ex), scfg)
        if classification:
            pred = (bernoulli_probit_predictive(mean, var) >= 0.5).to(ey.dtype)
            test = {"test_acc": torch.mean((pred == ey).to(torch.float32))}
        else:
            rmse, nll = _regression_evals(mean, var, torch.exp(params["raw_noise"]), ey)
            test = {"test_rmse": rmse, "test_nll": nll}
    return torch.stack(steps, dim=-1), test


def _sgpr_trial(cfg, stem, z, tx, ty, ex, ey):
    """One streaming O-SGPR trial (the per-trial body of the JAX package's
    ``mesh_sgpr_sweep``): collapsed-bound epochs on the init batch, an
    initial absorb, then per chunk prequential evaluate -> (every
    ``rebase_every``-th chunk) ``num_update_steps`` bound steps and a
    rebasing absorb, else an exact accumulating absorb; then the test set.
    JAX's ``lax.cond`` depends on the chunk index alone, so it is a Python
    branch here. The wrapper's rates: the fit at (1e-1, 1e-2) for (hypers,
    z) and the stem at 1e-2, the stream at (lr, lr / 10), fresh Adams."""
    from online_gp_torch.api.regression import _leaves, _stem_leaves
    from online_gp_torch.api.sgpr_regression import _hyper_leaves
    from online_gp_torch.kernels.base import make_kernel
    from online_gp_torch.models.sgpr import SGPRModel, sgpr_absorb, sgpr_bound, sgpr_predict
    from online_gp_torch.utils.optim import GroupAdam, adam_step

    model = SGPRModel(make_kernel("rbf"), jitter=float(cfg["model"].get("jitter", 1e-4)))
    base_lr, batch_size = cfg["dataset"]["base_lr"], cfg["batch_size"]
    num_update_steps = int(cfg["model"].get("num_update_steps") or 1)
    rebase_every = max(1, int(cfg["model"].get("rebase_every", 25)))
    num_init, num_chunks, num_epochs = _baseline_shape(cfg, tx.shape[0])
    init_x, init_y = tx[:num_init], ty[:num_init, 0]
    span = slice(num_init, num_init + num_chunks * batch_size)
    xs = tx[span].reshape(num_chunks, batch_size, -1)
    ys = ty[span].reshape(num_chunks, batch_size)

    params = model.init_params(z, stem.output_dim, dtype=tx.dtype, device=tx.device)
    for t in _leaves(params):
        t.requires_grad_(True)
    adams = lambda gp_lr, z_lr, stem_lr: (GroupAdam([(_hyper_leaves(params), gp_lr), ([params["z"]], z_lr)]),
                                          GroupAdam([(_stem_leaves(stem), stem_lr)]))
    _pretrain(stem, init_x, num_epochs, lambda f: -sgpr_bound(model, params, None, f, init_y, combine_terms=True),
              *adams(1e-1, 1e-2, 1e-2))
    with torch.no_grad():
        _, old, moments = sgpr_absorb(model, params, None, None, stem(init_x), init_y)
    opt, stem_opt = adams(base_lr, base_lr / 10.0, base_lr / 10.0)

    steps = []
    for c in range(num_chunks):
        x, y = xs[c], ys[c]
        with torch.no_grad():
            mean, var = sgpr_predict(model, params, moments, stem(x))
            evals = _regression_evals(mean, var, torch.exp(params["raw_noise"]), y[:, None])
        do_hyper = (c + 1) % rebase_every == 0 and num_update_steps > 0
        loss = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
        for _ in range(num_update_steps if do_hyper else 0):
            logp, trace, _, _ = sgpr_bound(model, params, old, stem(x), y, combine_terms=False)
            loss = -(logp + trace)
            adam_step(loss, opt, stem_opt)
        with torch.no_grad():
            _, old, moments = sgpr_absorb(model, params, old, None, stem(x), y, rebase=do_hyper)
            steps.append(torch.stack([torch.full_like(loss, float("nan")), loss, *evals,
                                      torch.exp(params["raw_noise"])]))

    with torch.no_grad():
        mean, var = sgpr_predict(model, params, moments, stem(ex))
        rmse, nll = _regression_evals(mean, var, torch.exp(params["raw_noise"]), ey)
    return torch.stack(steps, dim=-1), {"test_rmse": rmse, "test_nll": nll}


def _baseline_runner(trial_fn, classification: bool):
    """A ``run_local`` of :func:`_mesh_sweep` running ``trial_fn`` on each
    of the rank's trials in turn, each with its stem and inducing points."""

    def run(cfg, trials, tx, ty, ex, ey, device):
        stems = trial_stems(cfg, trials, device)
        zs = trial_inducing_points(cfg, trials, int(cfg["model"]["num_inducing"]), stems[0].output_dim, device)
        per = [trial_fn(cfg, stem, zs[i].to(tx.dtype), tx[i], ty[i], ex[i], ey[i])
               for i, stem in enumerate(stems)]
        by_step = torch.stack([p[0] for p in per], dim=1)  # (metrics, T, chunks)
        steps = {k: by_step[i] for i, k in enumerate(_STEP_METRICS[classification])}
        return steps, {k: torch.stack([p[1][k] for p in per]) for k in _TEST_METRICS[classification]}

    return run


def mesh_svgp_sweep(num_trials: int, overrides: List[str]) -> List[Dict]:
    """``mode=mesh`` for streaming O-SVGP regression: the per-trial
    semantics of ``OnlineSVGPRegression`` (per-trial inducing points from
    :func:`trial_inducing_points`, full-init-batch ELBO epochs with beta =
    1, then per chunk prequential evaluate -> snapshot ->
    ``num_update_steps`` ELBO steps at ``prior_beta`` with the Bui
    streaming correction at ``online_beta``), with the JAX sweep's
    single-program deltas: BatchNorm statistics frozen after the pretrain,
    no 1,024-point replay padding (the stream is chunked). The GP's
    optimizer is ``optax.zero_nans`` before Adam at lr on the hypers and
    lr / 10 on the variational params, the stem's Adam at lr / 10."""
    return _mesh_sweep(num_trials, overrides, "svgp_regression", False, "single",
                       _baseline_runner(lambda *a: _svgp_trial(*a, classification=False), False))


def mesh_svgp_classification_sweep(num_trials: int, overrides: List[str]) -> List[Dict]:
    """``mode=mesh`` for the streaming probit O-SVGP classifier
    (``OnlineSVGPClassifier``): the Bernoulli-probit ELBO, per-chunk
    snapshot and streaming-corrected update steps, p >= 0.5 decisions;
    labels enter the ELBO in {0, 1}. The deltas of :func:`mesh_svgp_sweep`."""
    return _mesh_sweep(num_trials, overrides, "svgp_classification", True, "labels_f",
                       _baseline_runner(lambda *a: _svgp_trial(*a, classification=True), True))


def mesh_sgpr_sweep(num_trials: int, overrides: List[str]) -> List[Dict]:
    """``mode=mesh`` for streaming O-SGPR regression
    (``OnlineSGPRegression``): collapsed-bound pretrain epochs on the init
    batch, an initial absorb, then per chunk prequential evaluate -> (every
    ``rebase_every``-th chunk) ``num_update_steps`` bound steps then a
    rebasing absorb, other chunks an exact accumulating absorb with the
    hypers frozen (``gp_loss`` NaN there). Deltas: BatchNorm statistics
    frozen after the pretrain, no replay padding, no z resampling."""
    return _mesh_sweep(num_trials, overrides, "sgpr_regression", False, "single", _baseline_runner(_sgpr_trial, False))


def main():
    args = sys.argv[1:]
    num_trials, mode, overrides = 2, "seq", []
    for a in args:
        k, v = a.split("=", 1)
        if k == "num_trials":
            num_trials = int(v)
        elif k == "mode":
            mode = v
        else:
            overrides.append(a)
    results = run_sweep(num_trials, mode, overrides)
    if int(os.environ.get("RANK", 0)) == 0:  # torchrun's other ranks hold the same results
        for r in results:
            print(r)


if __name__ == "__main__":
    main()
