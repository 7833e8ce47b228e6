"""Precision refinement: Newton-Schulz polish of an approximate inverse,
and iterative refinement of an LU solve.

Port of ``newton_schulz_refine`` and ``refine_solve`` from
``gpu_matrix_inversion_tpu/ops/refine.py``. Each Newton-Schulz step
``X <- X + X @ (I - A @ X)`` squares the residual (quadratic convergence)
for the cost of two GEMMs. Both GEMMs run in true FP32. The reference
runs the correction GEMM one tier down (bf16x3 on the TPU); Hopper's
nearest tier is TF32, which is coarser, so the port keeps FP32 there
until a measurement says otherwise. The reference's
``optimization_barrier`` guards an XLA:TPU rewrite and has no counterpart.
``lu_inverse_refined`` is not ported yet.
"""

from __future__ import annotations

import torch

from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision


def newton_schulz_refine(a: torch.Tensor, x: torch.Tensor, *,
                         iters: int = 2) -> torch.Tensor:
    """Refine an approximate inverse ``x`` of ``a`` by ``iters`` Newton-
    Schulz steps, in ``x``'s dtype on ``x``'s device."""
    eye = torch.eye(a.shape[-1], dtype=x.dtype, device=x.device)
    a = a.to(x.dtype)
    with matmul_precision("highest"):
        for _ in range(iters):
            r = eye - a @ x
            x = x + x @ r
    return x


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
