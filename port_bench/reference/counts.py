"""Operations and bytes of the work, and the card's peaks.

The counts are of the work an inverse needs, not of what a route issues:
2 n^3 operations a matrix (Gauss-Jordan on [A | I], the count the
reference's bench uses), its input read once and its inverse written once.
A route that stops doing redundant work reads closer to its roofline.

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W, dense: each
dtype's rate outside the tensor cores, and HBM3 bandwidth. The port keeps
TF32 off, so its value-carrying products run at the FP32 rate; a route
that moves them onto the tensor cores needs a new peak here first.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_HBM_BYTES = 3.35e12


def inverse_flops(n: int, batch: int = 1) -> float:
    """Operations of ``batch`` n x n inverses: 2 n^3 each."""
    return 2.0 * batch * n ** 3


def inverse_bytes(n: int, batch: int = 1, itemsize: int = 4) -> float:
    """Bytes of ``batch`` n x n inverses: A read once, X written once."""
    return 2.0 * batch * n * n * itemsize


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least seconds the card could take: the larger of the operations
    over ``dtype``'s peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_HBM_BYTES)
