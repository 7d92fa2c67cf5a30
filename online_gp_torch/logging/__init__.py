"""Metric sinks for the experiment drivers (the port of
``online_gp_tpu/logging``): the CSV logger and the S3-compatible sink; and
the program's spans on ``torch.profiler``'s clock."""

from online_gp_torch.logging.csv_logger import CSVLogger
from online_gp_torch.logging.remote import Boto3Transport, LocalBucketTransport, S3Logger
from online_gp_torch.logging.timing import block_until_ready, profile_trace, span, spanned


def make_logger(cfg: dict, run_name: str):
    """Logger factory for the experiment drivers (reference selects the
    sink via the Hydra ``logger`` group, ``config/logger/{local,s3}.yaml``).

    ``cfg['logger']['name']``: ``"local"`` -> :class:`CSVLogger`;
    ``"s3"`` -> :class:`S3Logger` (boto3 when importable, filesystem
    bucket emulation under ``logger.bucket_root`` otherwise).
    """
    lcfg = cfg.get("logger") or {}
    name = lcfg.get("name", "local")
    if name == "local":
        return CSVLogger(cfg["log_dir"], run_name)
    if name == "s3":
        transport = None
        if lcfg.get("bucket_root"):
            transport = LocalBucketTransport(lcfg["bucket_root"])
        return S3Logger(cfg["log_dir"], run_name,
                        bucket_name=lcfg.get("bucket_name", "online-gp-tpu"),
                        prefix=lcfg.get("prefix", ""), transport=transport)
    raise ValueError(f"unknown logger {name!r} (local/s3)")


__all__ = ["CSVLogger", "S3Logger", "LocalBucketTransport", "Boto3Transport",
           "block_until_ready", "profile_trace", "span", "spanned", "make_logger"]
