"""Input-contract validation.

Mirrors the reference's guards: order <= 0 or a non-square flat vector yields
the empty-vector failure return (``matrix_inversion_FP32.cpp:229-237``,
``mat_inv_32.cpp:206-215``, README.md:53-54).

A copy of ``gpu_matrix_inversion_tpu/utils/validation.py`` (numpy-only;
importing the JAX package's module would run its ``__init__``, which
imports JAX).
"""

from __future__ import annotations

import numpy as np


def validate_flat_matrix(flat, order: int) -> np.ndarray | None:
    """Validate a flat row-major matrix; return an (order, order) float array
    or ``None`` when the input violates the reference contract."""
    if not isinstance(order, (int, np.integer)):
        return None
    if order <= 0:
        return None
    arr = np.asarray(flat)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    if arr.size != order * order:
        return None
    return arr.reshape(order, order)
