"""Precision refinement: Newton-Schulz polish of an approximate inverse.

Port of ``newton_schulz_refine`` from ``gpu_matrix_inversion_tpu/ops/
refine.py``. Each step ``X <- X + X @ (I - A @ X)`` squares the residual
(quadratic convergence) for the cost of two GEMMs. Both GEMMs run in true
FP32. The reference runs the correction GEMM one tier down (bf16x3 on the
TPU); Hopper's nearest tier is TF32, which is coarser, so the port keeps
FP32 there until a measurement says otherwise. The reference's
``optimization_barrier`` guards an XLA:TPU rewrite and has no counterpart.
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
