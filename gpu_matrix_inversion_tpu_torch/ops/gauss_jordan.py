"""Plain-torch Gauss-Jordan inversion: the executable spec of the reference.

Port of ``gpu_matrix_inversion_tpu/ops/gauss_jordan.py``. Per iteration
``r = 0..N-1`` over the augmented ``[A|I]`` system the reference launches
five OpenCL kernels from the host (``matrix_inversion_FP32.cpp:622-705``):

- ``maxPivotKernel`` + ``finalMaxPivotKernel``: partial-pivot argmax of
  ``abs(col r)`` restricted to rows >= r  (FP32.cpp:68-142)
- ``pivotElementsKernel``: swap row r with the argmax row   (FP32.cpp:171-192)
- ``fixRowKernel``: normalize row r by the pivot            (FP32.cpp:150-164)
- ``fixColumnKernel``: rank-1 eliminate all other rows      (FP32.cpp:17-63)

Here each iteration is a handful of tensor operations on the whole batch,
updating the (B, n, 2n) augmented buffer in place (one buffer for the loop
instead of a fresh copy per step). It runs on the input's device in the
input's dtype, and serves ``method="spec"`` and the FP64 ``auto`` route for
n < 512. The pivot is the full-precision first max (``torch.argmax`` returns
the first maximal index, as ``jnp.argmax`` does).

The no-pivot variant mirrors ``matrix_inversion_no_pivots.cpp`` (assumes a
nonzero diagonal; reference kernels ``findCrr`` / ``copyCirColumn``,
no_pivots.cpp:39-54).

Singularity contract: ``(inverse, ok)`` where ``ok`` is False iff a pivot
was exactly zero or the result is non-finite; the flat-vector API maps
``ok == False`` to the reference's empty-vector return (FP32.cpp:814-835).
"""

from __future__ import annotations

import torch


def _augment(a: torch.Tensor) -> torch.Tensor:
    """Build the augmented system ``[A|I]`` (reference makeAugmentedMatrix,
    matrix_inversion_FP32.cpp:198-215)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    return torch.cat([a, eye], dim=-1)


def _gj_step(aug: torch.Tensor, r: int, ok: torch.Tensor, *,
             pivot: bool) -> None:
    """One Gauss-Jordan iteration on the (B, n, 2n) system, in place."""
    bsz, n, _ = aug.shape
    items = torch.arange(bsz, device=aug.device)
    rows = torch.arange(n, device=aug.device)
    col = aug[:, :, r].clone()                                  # (B, n)
    if pivot:
        # Partial pivot: argmax of |col| over rows >= r
        # (reference maxPivot/finalMaxPivot, FP32.cpp:68-142).
        cand = torch.where(rows >= r, col.abs(), torch.full_like(col, -1))
        p = cand.argmax(dim=1)
    else:
        # No-pivot variant uses the diagonal directly
        # (reference findCrr, no_pivots.cpp:39-44).
        p = torch.full((bsz,), r, dtype=torch.long, device=aug.device)
    piv = col[items, p]
    ok &= piv != 0
    piv_safe = torch.where(piv == 0, torch.ones_like(piv), piv)

    row_p = aug[items, p, :]                                    # copy
    if pivot:
        # Swap rows r and p (reference pivotElementsKernel,
        # FP32.cpp:171-192); only entries r and p of the column move.
        aug[items, p, :] = aug[:, r, :].clone()
        aug[:, r, :] = row_p
        col[items, p] = col[:, r].clone()
        col[:, r] = piv
    # Normalize the pivot row (reference fixRowKernel, FP32.cpp:150-164).
    norm_row = row_p / piv_safe[:, None]                        # (B, 2n)
    # Rank-1 eliminate every other row (reference fixColumnKernel,
    # FP32.cpp:17-63), then deposit the normalized row in row r.
    col[:, r] = 0
    aug -= col[:, :, None] * norm_row[:, None, :]
    aug[:, r, :] = norm_row


def _gauss_jordan_aug(a: torch.Tensor, *, pivot: bool):
    """(B, n, n) -> (inverse (B, n, n), ok (B,))."""
    n = a.shape[-1]
    aug = _augment(a)
    ok = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    for r in range(n):
        _gj_step(aug, r, ok, pivot=pivot)
    inv = aug[:, :, n:]
    ok &= torch.isfinite(inv).all(dim=(-2, -1))
    return inv, ok


def gauss_jordan_inverse(a: torch.Tensor, *, pivot: bool = True):
    """Invert ``a`` by Gauss-Jordan elimination on the augmented ``[A|I]``.

    Args:
      a: ``(..., n, n)`` tensor (float32 or float64). Leading axes are
        batched.
      pivot: partial pivoting on/off (reference FP32/FP64 vs no_pivots).

    Returns:
      ``(inverse, ok)`` where ``inverse`` has the shape/dtype of ``a`` and
      ``ok`` is a boolean tensor with the batch shape -- False where a zero
      pivot was hit or the result is non-finite.
    """
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got "
                         f"{tuple(a.shape)}")
    n = a.shape[-1]
    inv, ok = _gauss_jordan_aug(a.reshape(-1, n, n), pivot=pivot)
    return inv.reshape(a.shape), ok.reshape(a.shape[:-2])


def gauss_jordan_inverse_no_pivot(a: torch.Tensor):
    """No-pivot Gauss-Jordan (reference matrix_inversion_no_pivots.cpp:10).

    Assumes a nonzero diagonal throughout elimination; returns ``(inv, ok)``.
    """
    return gauss_jordan_inverse(a, pivot=False)
