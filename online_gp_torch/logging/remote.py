"""Remote (S3-compatible) metrics sink (the port's own copy of
``online_gp_tpu/logging/remote.py``).

Re-build of the reference's ``upcycle.logging.S3Logger``
(the reference's ``config/logger/s3.yaml``: same table API as the local
DataFrame logger, with the CSV artifacts synced to
``s3://<bucket>/<log_dir>``). Same shape here: :class:`S3Logger` IS a
:class:`CSVLogger` — every ``write_csv()`` stages the tables locally and
then pushes every file under the run directory through a transport.

Transports:

- :class:`Boto3Transport` — real S3, used automatically when ``boto3``
  is importable (the import is lazy and optional).
- :class:`LocalBucketTransport` — filesystem emulation
  (``<root>/<bucket>/<key>``; ``root`` defaults to ``online_gp_buckets``
  under the temporary directory), the offline default; exercises the
  full sync path in tests and air-gapped runs, and doubles as an
  NFS/Fuse sink (point ``root`` at a mounted bucket).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

from online_gp_torch.logging.csv_logger import CSVLogger


class LocalBucketTransport:
    """Filesystem ``put``: ``<root>/<bucket>/<key>``."""

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.join(tempfile.gettempdir(), "online_gp_buckets") if root is None else root

    def put(self, local_path: str, bucket: str, key: str) -> str:
        dest = os.path.join(self.root, bucket, key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy2(local_path, dest)
        return dest


class Boto3Transport:
    """Real S3 ``put`` via boto3 (optional dependency)."""

    def __init__(self, **client_kwargs):
        import boto3  # optional dependency; the caller opts in

        self._client = boto3.client("s3", **client_kwargs)

    def put(self, local_path: str, bucket: str, key: str) -> str:
        self._client.upload_file(local_path, bucket, key)
        return f"s3://{bucket}/{key}"


def default_transport():
    """boto3 when importable, filesystem emulation otherwise."""
    try:
        return Boto3Transport()
    except Exception:  # no boto3, or no credentials or region: the offline sink
        return LocalBucketTransport()


class S3Logger(CSVLogger):
    """CSVLogger that mirrors the run directory into a bucket.

    Args:
      bucket_name: target bucket (reference ``s3.yaml:bucket_name``).
      prefix: key prefix inside the bucket (reference composes
        ``projects/${project_name}/${log_dir}``).
      transport: object with ``put(local_path, bucket, key)``;
        ``default_transport()`` when omitted.
    """

    def __init__(self, log_dir: str = "./logs", run_name: str = "run",
                 bucket_name: str = "online-gp-tpu", prefix: str = "",
                 transport: Optional[object] = None):
        super().__init__(log_dir, run_name)
        self.bucket_name = bucket_name
        self.prefix = prefix
        self.transport = transport if transport is not None else default_transport()
        self.synced = []  # destination URIs/paths from the last sync

    def _sync(self) -> None:
        self.synced = []
        if not os.path.isdir(self.log_dir):
            return
        run_name = os.path.basename(self.log_dir.rstrip(os.sep))
        for fname in sorted(os.listdir(self.log_dir)):
            local = os.path.join(self.log_dir, fname)
            if not os.path.isfile(local):
                continue
            key = "/".join(p for p in (self.prefix, run_name, fname) if p)
            self.synced.append(self.transport.put(local, self.bucket_name, key))

    def write_csv(self):
        super().write_csv()
        self._sync()

    def write_config(self, config: dict):
        super().write_config(config)
        self._sync()
