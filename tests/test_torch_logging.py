"""The port's logging and host utilities against the JAX package's:
``CSVLogger`` writes the same bytes for the same calls, ``make_logger``
dispatches alike, ``S3Logger`` over ``LocalBucketTransport`` mirrors the
run directory as JAX's does; ``profile_trace`` (a ``torch.profiler``
window on the CPU here); ``shuffle_tensors`` (one shared
permutation from a ``torch.Generator``, where JAX takes a key, so the
permutation itself differs); ``plotting`` (read_table, aggregate_trials)
equal to JAX's on the same CSVs."""

import csv
import os

import numpy as np
import pytest
import torch

from online_gp_tpu import logging as j_logging
from online_gp_tpu.utils import plotting as j_plotting
from online_gp_torch import logging as t_logging
from online_gp_torch.logging import CSVLogger, LocalBucketTransport, S3Logger, make_logger, profile_trace
from online_gp_torch.utils import plotting
from online_gp_torch.utils.random import shuffle_tensors


def _drive(logger):
    logger.add_table("online_metrics")
    logger.log(dict(test_rmse=np.float32(0.5), noise=0.1, step_time=1.25), step=1, table_name="online_metrics")
    logger.log(dict(test_rmse=0.4, noise=np.float64(0.09), extra=3), step=2, table_name="online_metrics")
    logger.log(dict(loss=1.0, tag="a"), step=1, table_name="batch_metrics")
    logger.add_table("empty")
    logger.write_csv()
    logger.write_config({"model": {"name": "wiski", "lr": 0.01}, "max_stream": None})


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_csv_logger_writes_jax_bytes(tmp_path):
    _drive(j_logging.CSVLogger(str(tmp_path / "jax"), "run"))
    _drive(CSVLogger(str(tmp_path / "torch"), "run"))
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert sorted(got) == sorted(want) == ["run/batch_metrics.csv", "run/config.json", "run/online_metrics.csv"]
    assert got == want


def test_s3_logger_mirrors_jax(tmp_path):
    for pkg, name in ((j_logging, "jax"), (t_logging, "torch")):
        transport = pkg.LocalBucketTransport(str(tmp_path / name / "buckets"))
        logger = pkg.S3Logger(str(tmp_path / name / "logs"), "runA", bucket_name="bkt", prefix="projects/online_gp",
                              transport=transport)
        _drive(logger)
        if pkg is t_logging:
            assert isinstance(logger, CSVLogger)
            remote = tmp_path / name / "buckets" / "bkt" / "projects/online_gp" / "runA"
            assert logger.synced == [str(remote / f) for f in ("batch_metrics.csv", "config.json",
                                                                "online_metrics.csv")]
            with open(remote / "online_metrics.csv") as f:
                rows = list(csv.DictReader(f))
            assert len(rows) == 2 and float(rows[-1]["test_rmse"]) == 0.4
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_make_logger_dispatch(tmp_path):
    cfg = dict(log_dir=str(tmp_path), logger=dict(name="local"))
    assert type(make_logger(cfg, "r")) is CSVLogger
    assert type(make_logger(dict(log_dir=str(tmp_path)), "r")) is CSVLogger
    cfg_s3 = dict(log_dir=str(tmp_path), logger=dict(name="s3", bucket_name="b", prefix="p",
                                                     bucket_root=str(tmp_path / "root")))
    lg = make_logger(cfg_s3, "r")
    assert isinstance(lg, S3Logger) and isinstance(lg.transport, LocalBucketTransport)
    assert (lg.bucket_name, lg.prefix, lg.transport.root, lg.log_dir) == ("b", "p", str(tmp_path / "root"),
                                                                          os.path.join(str(tmp_path), "r"))
    jl = j_logging.make_logger(cfg_s3, "r")
    assert (jl.bucket_name, jl.prefix, jl.transport.root, jl.log_dir) == (lg.bucket_name, lg.prefix,
                                                                          lg.transport.root, lg.log_dir)
    # no boto3 here: the default transport is the filesystem one, under the temporary directory
    lg = make_logger(dict(log_dir=str(tmp_path), logger=dict(name="s3")), "r")
    assert isinstance(lg.transport, LocalBucketTransport) and lg.bucket_name == "online-gp-tpu"
    for fn in (make_logger, j_logging.make_logger):
        with pytest.raises(ValueError, match="unknown logger"):
            fn(dict(log_dir=".", logger=dict(name="wandb")), "r")


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_shuffle_tensors_one_shared_permutation():
    x = torch.arange(10.0)[:, None] * torch.ones(1, 3)
    y = torch.arange(10)
    sx, sy = shuffle_tensors(x, y, seed=3)
    np.testing.assert_array_equal(sx[:, 0].long().numpy(), sy.numpy())
    assert sorted(sy.tolist()) == list(range(10)) and sy.tolist() != list(range(10))
    again = shuffle_tensors(y, seed=3)
    assert torch.equal(again, sy)  # one tensor in, one tensor out; the seed fixes the draw
    g = torch.Generator().manual_seed(3)
    assert torch.equal(shuffle_tensors(y, generator=g), sy)
    assert not torch.equal(shuffle_tensors(y, generator=g), sy)  # the generator moved on
    with pytest.raises(ValueError, match="one length"):
        shuffle_tensors(x, y[:5])


def _trial_dirs(root):
    rng = np.random.default_rng(0)
    for t in range(3):
        lg = CSVLogger(str(root), f"trial{t}")
        for s in range(4 + t):
            lg.log(dict(test_rmse=float(rng.uniform()), note="x"), step=s + 1, table_name="online_metrics")
        lg.write_csv()
    os.makedirs(root / "trial_empty")


def test_plotting_matches_jax(tmp_path):
    _trial_dirs(tmp_path)
    table = str(tmp_path / "trial0" / "online_metrics.csv")
    got, want = plotting.read_table(table), j_plotting.read_table(table)
    assert set(got) == set(want) == {"step", "test_rmse", "note"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    pattern = str(tmp_path / "trial*")
    got, want = plotting.aggregate_trials(pattern, lo=0.1, hi=0.9), j_plotting.aggregate_trials(pattern, lo=0.1, hi=0.9)
    assert set(got) == set(want) and int(got["num_trials"]) == 3 and len(got["median"]) == 4
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert plotting.aggregate_trials(str(tmp_path / "none*")) == {}
