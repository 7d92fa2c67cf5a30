"""True-f32 matmuls on every path that feeds a Cholesky.

The JAX package pins ``jax.default_matmul_precision("float32")`` around
every accumulation that feeds a factorization (``ops/precision.py`` and
the blocks in ``models/wiski.py`` and ``ops/root_update.py`` there):
reduced-precision passes push a borderline-PSD Gram indefinite. On an
NVIDIA card the reduced-precision mode is TF32 (about three decimal
digits), which PyTorch enables for cuDNN convolutions by default and for
matmuls when asked. ``f32_matmul_precision`` turns it off for the body of
a ``with`` block and checks that it is off; the previous settings come
back on exit, as with the JAX context manager.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["assert_true_f32", "f32_matmul_precision"]


def _settings():
    return (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )


def _apply(settings):
    matmul_tf32, cudnn_tf32, precision = settings
    torch.set_float32_matmul_precision(precision)
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


def assert_true_f32() -> None:
    """Raise unless TF32 is off for matmuls and convolutions."""
    matmul_tf32, cudnn_tf32, precision = _settings()
    if matmul_tf32 or cudnn_tf32 or precision != "highest":
        raise RuntimeError(
            "TF32 is on (matmul allow_tf32="
            f"{matmul_tf32}, cudnn allow_tf32={cudnn_tf32}, "
            f"float32 matmul precision={precision!r}); the Cholesky paths "
            "need true float32"
        )


@contextlib.contextmanager
def f32_matmul_precision():
    """Run the body with TF32 off everywhere, then restore the settings."""
    saved = _settings()
    _apply((False, False, "highest"))
    try:
        assert_true_f32()
        yield
    finally:
        _apply(saved)
