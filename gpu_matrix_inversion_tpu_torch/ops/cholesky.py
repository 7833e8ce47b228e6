"""Cholesky factorization (potrf), SPD solves (potrs) and inversion (potri).

Port of ``gpu_matrix_inversion_tpu/ops/cholesky.py``. For symmetric
positive-definite systems the LAPACK route is potrf/potri at half of
getrf/getri's operations, with no pivot search: the whole factorization is
(b, b) diagonal Cholesky blocks, panel triangular solves and rank-b trailing
updates.

The reference reaches no Pallas kernel here; it calls XLA's primitives
(``lax.linalg.cholesky``, ``lax.linalg.triangular_solve``, ``jnp.matmul``),
and so does the port, through their PyTorch counterparts
(``torch.linalg.cholesky_ex``, ``torch.linalg.solve_triangular``,
``torch.matmul``), batched over leading axes. Every FP32 product runs in
true FP32 (TF32 off) whatever the caller's global flag.

Failure semantics follow the reference: a diagonal block that is not
positive definite factors to NaN (XLA's cholesky returns NaN there;
``cholesky_ex`` reports it in ``info``, and the block is set to NaN with no
host sync), and ``ok`` comes out of the same probe, finite and diagonal
> 0.
"""

from __future__ import annotations

import os

import torch

from gpu_matrix_inversion_tpu_torch.ops.lu import (_check_square, _eye,
                                                   _fp32_gemms,
                                                   _getri_product,
                                                   _getri_product_flops,
                                                   _trtri_effective_flops,
                                                   invert_triangular)
from gpu_matrix_inversion_tpu_torch.utils.graphs import compiled

# potri's product schedule (cholesky.py:27-40): the column schedule by
# default, the 2-D double-triangular tiling with MATINV_POTRI_PRODUCT=2d.
# The reference chose the default by a TPU utilization gate; it is kept so
# that both packages schedule alike. Read at import, as the reference does.
_POTRI_PRODUCT_2D = os.environ.get("MATINV_POTRI_PRODUCT", "cols") == "2d"

# From this many trailing rows the update is a chunked syrk (cholesky.py:
# 79-104); below it one dense GEMM.
_SYRK_CHUNK_ROWS = 1024


def _chol_factor_blocked_2d(a: torch.Tensor, *, b: int):
    """Right-looking blocked potrf of ``(B, m, m)`` matrices, lower
    triangle (cholesky.py:43-114); returns ``(L, ok)``.

    Only the lower triangle of ``a`` is read. Each (b, b) diagonal block is
    mirrored from its own lower half just before it is factored; the upper
    triangle of the working copy goes stale on purpose, and every later
    read is a diagonal block, a strictly lower panel, or a syrk strip that
    stops at its own diagonal block.
    """
    m = a.shape[-1]
    w = torch.tril(a)
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    for k0 in range(0, m, b):
        k1 = k0 + b
        dblk = w[:, k0:k1, k0:k1]
        dblk = torch.tril(dblk) + torch.tril(dblk, -1).mT
        lkk, info = torch.linalg.cholesky_ex(dblk, check_errors=False)
        lkk = torch.where((info != 0)[:, None, None], nan, lkk)
        w[:, k0:k1, k0:k1] = lkk
        rows = m - k1
        if not rows:
            continue
        # Panel: X L_kk^T = A_below, so X = A_below L_kk^-T.
        pan = torch.linalg.solve_triangular(lkk.mT, w[:, k1:, k0:k1],
                                            upper=True, left=False)
        w[:, k1:, k0:k1] = pan
        if rows >= _SYRK_CHUNK_ROWS:
            # The trailing update is symmetric: strip [i0, ie) needs only
            # columns < ie. cw stays a multiple of b, so no diagonal block
            # straddles two strips (its top rows would read the stale
            # wedge).
            cw = -(-rows // 4)
            cw = -(-cw // b) * b
            for i0 in range(0, rows, cw):
                ie = min(i0 + cw, rows)
                w[:, k1 + i0:k1 + ie, k1:k1 + ie] -= (
                    pan[:, i0:ie] @ pan[:, :ie].mT)
        else:
            w[:, k1:, k1:] -= pan @ pan.mT
    low = torch.tril(w)
    diag = torch.diagonal(low, dim1=-2, dim2=-1)
    ok = torch.isfinite(low).all(dim=(-2, -1)) & (diag > 0).all(dim=-1)
    return low, ok


def _block_size(n: int, block_size: int) -> int:
    return min(block_size, max(-(-n // 8) * 8, 8))


@compiled
@_fp32_gemms
def cholesky_factor(a: torch.Tensor, *, block_size: int = 256):
    """potrf: lower-Cholesky factor of SPD ``a`` (shape ``(..., n, n)``).

    Returns ``(L, ok)`` with ``A = L @ L.T``; ``ok`` is False per matrix
    when the input is not positive definite (the analog of the reference's
    empty-on-failure contract, ``mat_inv_32.cpp:206-215``). Only the lower
    triangle of ``a`` is read (LAPACK ``uplo='L'``). n is padded with the
    identity to a multiple of b (cholesky.py:117-134), which keeps the
    matrix SPD; the factor is cropped back.
    """
    _check_square(a)
    n = a.shape[-1]
    b = _block_size(n, block_size)
    m = max(-(-n // b) * b, b)
    x = a.reshape(-1, n, n)
    if m != n:
        pad = _eye(m, a).repeat(x.shape[0], 1, 1)
        pad[:, :n, :n] = x
        x = pad
    low, ok = _chol_factor_blocked_2d(x, b=b)
    return (low[:, :n, :n].reshape(a.shape), ok.reshape(a.shape[:-2]))


@compiled
@_fp32_gemms
def cholesky_solve(low: torch.Tensor, b: torch.Tensor):
    """potrs: solve ``A @ x = b`` given ``A = L @ L.T`` from
    :func:`cholesky_factor` (cholesky.py:153-171). ``b`` may be
    ``(..., n, k)`` or ``(..., n)``. Returns ``(x, ok)``."""
    vec = b.ndim == low.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(low, b, upper=False)
    x = torch.linalg.solve_triangular(low.mT, y, upper=True)
    ok = ((torch.diagonal(low, dim1=-2, dim2=-1) > 0).all(dim=-1)
          & torch.isfinite(x).all(dim=(-2, -1)))
    if vec:
        x = x[..., 0]
    return x, ok


def potri_effective_flops(n: int, *, block_size: int = 256) -> int:
    """Flops (2 * MACs) one :func:`cholesky_inverse` call schedules --
    blocked potrf (chunked-syrk trailing), one trtri(L), and the chunked
    ``L^-T @ L^-1`` product -- tracking the chunk geometry the code
    selects (cholesky.py:196-219)."""
    b = _block_size(n, block_size)
    m = max(-(-n // b) * b, b)
    fl = 0
    for k0 in range(0, m, b):
        rows = m - k0 - b
        if rows:
            fl += rows * b * b  # panel solve vs L_kk^T (~rows*b^2/2 MACs)
            if rows >= _SYRK_CHUNK_ROWS:
                cw = -(-(-(-rows // 4)) // b) * b
                for i0 in range(0, rows, cw):
                    ie = min(i0 + cw, rows)
                    fl += 2 * (ie - i0) * b * ie
            else:
                fl += 2 * rows * rows * b  # dense trailing GEMM
    return (fl + _trtri_effective_flops(n)
            + _getri_product_flops(n, left_triangular=_POTRI_PRODUCT_2D))


@compiled
@_fp32_gemms
def cholesky_inverse(a: torch.Tensor):
    """potri: explicit inverse of SPD ``a`` via ``A^-1 = L^-T L^-1``
    (cholesky.py:174-193, 222-233).

    trtri of L, then the chunked product that skips L^-1's zero upper
    triangle (``ops/lu._getri_product``, contracting on L^-1's rows, so the
    transpose is never formed). Returns ``(inverse, ok)``; ``ok`` is False
    (and the flat-vector API returns empty) for input that is not SPD.
    """
    _check_square(a)
    low, ok_f = cholesky_factor(a)
    linv, ok_t = invert_triangular(low, lower=True, unit_diagonal=False)
    inv = _getri_product(linv, linv, left_transposed=True,
                         left_triangular=_POTRI_PRODUCT_2D)
    ok = ok_f & ok_t & torch.isfinite(inv).all(dim=(-2, -1))
    return inv, ok
