"""The plain reference of the FP32-factor, FP64-refined LU inverse.

Plain PyTorch, written for this benchmark, and independent of the program:
it imports nothing of ``gpu_matrix_inversion_tpu_torch`` nor of JAX. The
algorithm of LAPACK's ``dsgesv`` applied to the inverse, as the program's
``ops.lu_inverse_refined`` runs it:

1. the input rounded to float32 and factored ``P A = L U`` with partial
   pivoting, one row step at a time: the row of largest magnitude in the
   column (the first such) swapped up, the multipliers below the pivot,
   then the rank-1 update of the trailing rows (getrf, unblocked);
2. the inverse of the factor (getri): ``P I`` by forward substitution
   through ``L`` and back substitution through ``U``, one row at a time;
3. ``iters`` Newton-Schulz steps ``X <- X + X (I - A X)`` in
   ``residual_dtype`` on the input as given.

TF32 is off for every product (both ``allow_tf32`` flags False, restored
after). Where it departs from the program:

- the substitutions sum each row's dot product in one ``matmul``, in the
  library's order; the program's L5 runs column-oriented updates, each
  element's chain in step order, so the FP32 inverse differs in its last
  bits (the refinement takes both to the same FP64 neighbourhood);
- the trailing update rounds ``f * v`` and the difference apart, which the
  program's L4 may contract into one fused multiply-add;
- it runs eagerly, one operation at a time: no kernel, no CUDA graph.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _exact_matmul():
    """TF32 off for the enclosed CUDA matmuls; restored after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = prev


def lu_factor(a: torch.Tensor):
    """``(lu, perm, ok)`` of ``a`` (``(B, n, n)``): ``L`` below the
    diagonal (unit diagonal implied) and ``U`` on and above it, ``perm``
    the rows of ``a`` in the order of ``P A``; ``ok`` False where a pivot
    is zero."""
    bsz, n, _ = a.shape
    idx = torch.arange(bsz, device=a.device)
    lu = a.clone()
    perm = torch.arange(n, device=a.device).repeat(bsz, 1)
    ok = torch.ones(bsz, dtype=torch.bool, device=a.device)
    for k in range(n):
        p = k + lu[:, k:, k].abs().argmax(dim=1)
        for t in (lu, perm):
            row_k, row_p = t[idx, k].clone(), t[idx, p].clone()
            t[idx, k], t[idx, p] = row_p, row_k
        pivot = lu[:, k, k]
        ok &= pivot != 0
        f = lu[:, k + 1:, k] / torch.where(pivot == 0, 1, pivot)[:, None]
        lu[:, k + 1:, k + 1:] -= f[:, :, None] * lu[:, k, None, k + 1:]
        lu[:, k + 1:, k] = f
    return lu, perm, ok


def lu_inverse(lu: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``A^-1`` from :func:`lu_factor`'s ``(lu, perm)``, in ``lu``'s
    dtype: row ``i`` of ``P`` is ``e_perm[i]``, so ``P I`` has a 1 at
    ``(i, perm[i])``."""
    bsz, n, _ = lu.shape
    y = torch.zeros_like(lu)
    y.scatter_(2, perm[:, :, None], 1.0)
    with _exact_matmul():
        for i in range(1, n):                 # L y = P I, L unit lower
            y[:, i] -= (lu[:, i, None, :i] @ y[:, :i])[:, 0]
        x = torch.empty_like(y)
        for i in range(n - 1, -1, -1):        # U x = y
            rest = (lu[:, i, None, i + 1:] @ x[:, i + 1:])[:, 0]
            x[:, i] = (y[:, i] - rest) / lu[:, i, i, None]
    return x


def lu_inverse_refined(a: torch.Tensor, *, iters: int = 2,
                       residual_dtype=torch.float64):
    """``(X, ok)`` for ``a`` (``(..., n, n)``): the FP32 LU inverse refined
    by ``iters`` Newton-Schulz steps in ``residual_dtype``, returned in it.
    ``ok`` is False where a pivot is zero or ``X`` is not finite."""
    shape = a.shape
    n = shape[-1]
    a = a.reshape(-1, n, n)
    lu, perm, ok = lu_factor(a.to(torch.float32))
    x = lu_inverse(lu, perm).to(residual_dtype)
    a_r = a.to(residual_dtype)
    eye = torch.eye(n, dtype=residual_dtype, device=a.device)
    with _exact_matmul():
        for _ in range(iters):
            x = x + x @ (eye - a_r @ x)
    ok &= torch.isfinite(x).all(dim=(-2, -1))
    return x.reshape(shape), ok.reshape(shape[:-2])
