"""FP32 matrix-product precision, scoped.

No value-carrying GEMM of the port runs below FP32 unless the caller asks:
TF32 keeps about three decimal digits, and the reference's residual ladder
(DESIGN.md section 8) shows a reduced-precision GEMM tier leaves a raw
residual that Newton-Schulz cannot bring back. ``precision="highest"`` (the
default everywhere) turns TF32 off; ``"high"`` and ``"default"`` allow it,
the nearest Hopper tier to the TPU's bf16 passes. The switch is PyTorch's
process-global ``torch.backends.cuda.matmul.allow_tf32``, so it is set only
inside :func:`matmul_precision`, which restores it on exit.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("default", "high", "highest")


@contextlib.contextmanager
def matmul_precision(precision: str = "highest"):
    """Run the enclosed CUDA FP32 matmuls at ``precision``; restore after."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = precision != "highest"
    try:
        if precision == "highest" and matmul.allow_tf32:
            raise RuntimeError("TF32 is still enabled for FP32 matmuls")
        yield
    finally:
        matmul.allow_tf32 = prev
