"""Precision refinement: Newton-Schulz polish of an approximate inverse,
and iterative refinement of an LU solve.

Port of ``newton_schulz_refine``, ``refine_solve`` and
``lu_inverse_refined`` from ``gpu_matrix_inversion_tpu/ops/refine.py``.
Each Newton-Schulz step ``X <- X + X @ (I - A @ X)`` squares the residual
(quadratic convergence) for the cost of two GEMMs, in the residual dtype
(``residual_dtype``, default the approximate inverse's): so an FP32 inverse
refined with ``residual_dtype=torch.float64`` reaches FP64-level residuals
(``lu_inverse_refined``, the BASELINE.md configs[3] path). Both GEMMs run
in true FP32 or FP64, TF32 off. The reference runs the FP32 correction
GEMM one tier down (bf16x3 on the TPU); Hopper's nearest tier is TF32,
which is coarser, so the port keeps FP32 there until a measurement says
otherwise. The reference's ``optimization_barrier`` guards an XLA:TPU
rewrite and has no counterpart.
"""

from __future__ import annotations

import torch

from gpu_matrix_inversion_tpu_torch.utils.graphs import compiled
from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision
from gpu_matrix_inversion_tpu_torch.utils.profiling import span


@compiled
def newton_schulz_refine(a: torch.Tensor, x: torch.Tensor, *,
                         iters: int = 2, residual_dtype=None) -> torch.Tensor:
    """Refine an approximate inverse ``x`` of ``a`` by ``iters`` Newton-
    Schulz steps on ``x``'s device, computed and returned in
    ``residual_dtype`` (a torch dtype; default ``x``'s dtype)."""
    rd = residual_dtype or x.dtype
    eye = torch.eye(a.shape[-1], dtype=rd, device=x.device)
    a_h = a.to(device=x.device, dtype=rd)
    x_h = x.to(rd)
    with matmul_precision("highest"):
        for _ in range(iters):
            r = eye - a_h @ x_h
            x_h = x_h + x_h @ r
    return x_h


@compiled
def refine_solve(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 lu: torch.Tensor, perm: torch.Tensor, *, iters: int = 3,
                 residual_dtype=None) -> torch.Tensor:
    """Iterative refinement of a solve ``A x = b`` from its LU factors
    (the LAPACK dsgesv pattern): the residual in ``residual_dtype``
    (default ``x``'s), each correction from the spec's ``lu_solve`` in
    ``x``'s dtype. Returns the refined ``x`` in ``residual_dtype``."""
    from gpu_matrix_inversion_tpu_torch.ops.lu import lu_solve

    rd = residual_dtype or x.dtype
    b_h, a_h, x_h = b.to(rd), a.to(rd), x.to(rd)
    with matmul_precision("highest"):
        for _ in range(iters):
            r = b_h - a_h @ x_h
            d, _ = lu_solve(lu, perm, r.to(x.dtype))
            x_h = x_h + d.to(rd)
    return x_h


def lu_inverse_refined(a: torch.Tensor, *, iters: int = 2,
                       residual_dtype=None):
    """FP32 LU inverse (the spec getri) plus ``iters`` Newton-Schulz steps
    in ``residual_dtype``; returns ``(inverse, ok)`` (refine.py:86-96, the
    BASELINE.md configs[3] path: FP32 factor, FP64-level residual).

    Profiler spans (``utils/profiling.span``): ``refine.inverse`` over the
    whole call, inside it ``refine.factor`` (the FP32 cast and the getri)
    then ``refine.polish`` (the Newton-Schulz steps)."""
    from gpu_matrix_inversion_tpu_torch.ops.lu import lu_inverse

    with span("refine.inverse"):
        with span("refine.factor"):
            x0, ok = lu_inverse(a.to(torch.float32))
        with span("refine.polish"):
            x = newton_schulz_refine(a, x0, iters=iters,
                                     residual_dtype=residual_dtype)
        return x, ok & torch.isfinite(x).all(dim=(-2, -1))
