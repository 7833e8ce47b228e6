"""Parity of the port's Newton-Schulz refinement in a residual dtype and of
``lu_inverse_refined`` with the JAX package, on the CPU, at the sizes of
``tests/test_lu.py``'s refinement tests.

Tolerances, each with its reason:
- Residuals: the JAX tests' own gates (refined < 1e-10, and below the raw
  FP32 residual / 10).
- Port against JAX: the two FP32 LU inverses sum in other orders, and
  refinement in float64 takes both to the inverse's FP64 neighbourhood,
  so they agree to about cond(A) * 1e-12: within 1e-8 relative at
  cond = 1e4, and 1e-10 for the well-conditioned n = 64 input.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gpu_matrix_inversion_tpu.ops import lu as jlu  # noqa: E402
from gpu_matrix_inversion_tpu.ops import refine as jrefine  # noqa: E402
from gpu_matrix_inversion_tpu_torch import ops as tops  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import lu as tlu  # noqa: E402
from gpu_matrix_inversion_tpu_torch.ops import refine as trefine  # noqa: E402,E501
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix, ill_conditioned_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    relative_residual)


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def test_refined_inverse_reaches_fp64_residual():
    """tests/test_lu.py's configs[3] test: an FP32 LU inverse of a cond 1e4
    matrix, refined in float64, reaches an FP64-level residual, in both
    packages, and the two agree."""
    n = 128
    a = ill_conditioned_matrix(n, cond=1e4, seed=55, dtype=np.float64)
    x32, ok = tlu.lu_inverse(torch.from_numpy(a.astype(np.float32)))
    assert bool(ok)
    raw = relative_residual(a, x32.double().numpy())
    x, ok = tops.lu_inverse_refined(torch.from_numpy(a), iters=4,
                                    residual_dtype=torch.float64)
    assert bool(ok) and x.dtype == torch.float64
    refined = relative_residual(a, x.numpy())
    assert refined < 1e-10
    assert refined < raw / 10
    xj, okj = jrefine.lu_inverse_refined(a, iters=4,
                                         residual_dtype=np.float64)
    assert bool(okj) and relative_residual(a, np.asarray(xj)) < 1e-10
    assert _rel(x.numpy(), xj) <= 1e-8


def test_newton_schulz_improves():
    """tests/test_lu.py's Newton-Schulz test: two steps in float64 from the
    FP32 LU inverse of a hollow n = 64 matrix, in both packages."""
    n = 64
    a = hollow_random_matrix(n, seed=56)
    x0, _ = tlu.lu_inverse(torch.from_numpy(a))
    x1 = trefine.newton_schulz_refine(torch.from_numpy(a).double(),
                                      x0.double(), iters=2,
                                      residual_dtype=torch.float64)
    assert x1.dtype == torch.float64
    assert relative_residual(a, x1.numpy()) < 1e-10
    x0j, _ = jlu.lu_inverse(a)
    x1j = jrefine.newton_schulz_refine(
        a.astype(np.float64), np.asarray(x0j, dtype=np.float64), iters=2,
        residual_dtype=np.float64)
    assert relative_residual(a, np.asarray(x1j)) < 1e-10
    assert _rel(x1.numpy(), x1j) <= 1e-10


@pytest.mark.parametrize("residual_dtype", [None, torch.float64])
def test_newton_schulz_returns_the_residual_dtype(residual_dtype):
    """An FP32 inverse refined in float64 comes back in float64 and closer
    than FP32 can hold; without residual_dtype it stays FP32, as before."""
    a = hollow_random_matrix(48, seed=57)
    x0, _ = tlu.lu_inverse(torch.from_numpy(a))
    x = trefine.newton_schulz_refine(torch.from_numpy(a), x0, iters=3,
                                     residual_dtype=residual_dtype)
    assert x.dtype == (residual_dtype or torch.float32)
    r = relative_residual(a, x.double().numpy())
    assert r < (1e-12 if residual_dtype else 1e-5)
