"""Compute: the plain-torch spec, the kernels' wrappers (K1 fused, K2-K4
blocked, K5 LU, K6 lockstep, K7 matmul), the Cholesky route, and
Newton-Schulz refinement. The same exports as the JAX package's ``ops``."""

from gpu_matrix_inversion_tpu_torch.ops.gauss_jordan import (
    gauss_jordan_inverse,
    gauss_jordan_inverse_no_pivot,
)
from gpu_matrix_inversion_tpu_torch.ops.lu import (
    lu_factor,
    lu_factor_blocked,
    lu_solve,
    lu_solve_fast,
    lu_inverse,
    lu_inverse_fast,
    invert_triangular,
    det,
    slogdet,
    cond_estimate,
)
from gpu_matrix_inversion_tpu_torch.ops.cholesky import (
    cholesky_factor,
    cholesky_solve,
    cholesky_inverse,
)
from gpu_matrix_inversion_tpu_torch.ops.refine import (
    newton_schulz_refine,
    lu_inverse_refined,
)

__all__ = [
    "gauss_jordan_inverse",
    "gauss_jordan_inverse_no_pivot",
    "lu_factor",
    "lu_factor_blocked",
    "lu_solve",
    "lu_solve_fast",
    "lu_inverse",
    "lu_inverse_fast",
    "invert_triangular",
    "det",
    "slogdet",
    "cholesky_factor",
    "cholesky_solve",
    "cholesky_inverse",
    "cond_estimate",
    "newton_schulz_refine",
    "lu_inverse_refined",
]
