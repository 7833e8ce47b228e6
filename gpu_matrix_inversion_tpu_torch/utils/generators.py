"""Test/benchmark matrix generators.

The reference's experiment protocol builds "hollow" random matrices: uniform
(0, 100) entries with a zeroed diagonal (``main_file.cpp:41-52``,
``matrix_inv_numpy.py:12-14``). The zero diagonal forces the pivoted paths to
actually pivot on the first column of every leading submatrix.

A copy of ``gpu_matrix_inversion_tpu/utils/generators.py`` (numpy-only;
importing the JAX package's module would run its ``__init__``, which
imports JAX).
"""

from __future__ import annotations

import numpy as np


def random_matrix(n: int, *, seed: int = 0, dtype=np.float32,
                  low: float = 0.0, high: float = 100.0) -> np.ndarray:
    """Uniform(low, high) n x n matrix (reference matrix_inv_pyopencl.py:17)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, (n, n)).astype(dtype)


def hollow_random_matrix(n: int, *, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Uniform(0,100) matrix with zero diagonal (reference main_file.cpp:41-52)."""
    a = random_matrix(n, seed=seed, dtype=dtype)
    np.fill_diagonal(a, 0)
    return a


def well_conditioned_matrix(n: int, *, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Diagonally-dominant random matrix: safe for the no-pivot path
    (reference matrix_inversion_no_pivots.cpp assumes nonzero pivots)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = a + n * np.eye(n)
    return a.astype(dtype)


def ill_conditioned_matrix(n: int, *, cond: float = 1e6, seed: int = 0,
                           dtype=np.float32) -> np.ndarray:
    """Random matrix with prescribed 2-norm condition number, for the
    LU + iterative-refinement test set (BASELINE.md configs[3])."""
    rng = np.random.default_rng(seed)
    # Orthogonal factors from QR of Gaussian matrices.
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), n)
    return ((q1 * s) @ q2).astype(dtype)
