"""The plain reference: blocked Gauss-Jordan with partial pivoting.

Plain PyTorch, written for this benchmark, and independent of the program:
it imports nothing of ``gpu_matrix_inversion_tpu_torch`` nor of JAX.
``[A | I]`` is reduced panel by panel. A pass over a panel's strip picks
the pivot rows (partial pivoting over the rows not yet used, as an
unblocked elimination would); the rows are swapped into place; then one
GEMM applies the panel to the whole augmented system. The right half ends
as ``A^-1``.

``gemm`` sets how the GEMMs are computed: ``"exact"`` in the input's dtype
with TF32 off (the reference runs in float64), ``"tf32"`` with both
operands rounded to TF32's 10 mantissa bits first and the products summed
in float32, as the tensor cores' TF32 mode does. The second is the
control: the reference one precision below what the configurations state
(FP32 with TF32 off). It is emulated, so it gives the same answer on any
device.
"""

from __future__ import annotations

import contextlib

import torch

BLOCK = 32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at TF32's 10 mantissa bits;
    finite inputs only."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


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


def _mm(x: torch.Tensor, y: torch.Tensor, gemm: str) -> torch.Tensor:
    if gemm == "tf32":
        if x.dtype != torch.float32:
            raise TypeError("the tf32 GEMM takes float32 operands")
        return round_tf32(x) @ round_tf32(y)
    return x @ y


def inverse(a: torch.Tensor, *, gemm: str = "exact", block: int = BLOCK):
    """``(inverse, ok)`` of ``a`` (``(..., n, n)``), in ``a``'s dtype and on
    its device. ``ok`` is False where a pivot is zero or the result is not
    finite."""
    if gemm not in ("exact", "tf32"):
        raise ValueError(f"gemm is 'exact' or 'tf32', not {gemm!r}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n), got {tuple(a.shape)}")
    shape = a.shape
    n = shape[-1]
    a = a.reshape(-1, n, n)
    bsz = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(bsz, n, n)
    w = torch.cat([a, eye], dim=2)
    idx = torch.arange(bsz, device=a.device)
    ok = torch.ones(bsz, dtype=torch.bool, device=a.device)
    with _exact_matmul():
        for k0 in range(0, n, block):
            k1 = min(k0 + block, n)
            perm = _panel_pivots(w[:, :, k0:k1].clone(), k0, idx, ok)
            w = torch.gather(w, 1, perm[:, :, None].expand_as(w))
            d = w[:, k0:k1, k0:k1]
            dinv, info = torch.linalg.inv_ex(d)
            ok &= info == 0
            piv = _mm(dinv, w[:, k0:k1, :], gemm)
            w = w - _mm(w[:, :, k0:k1], piv, gemm)
            w[:, k0:k1, :] = piv
    x = w[:, :, n:]
    ok &= torch.isfinite(x).all(dim=(1, 2))
    return x.reshape(shape), ok.reshape(shape[:-2])


def _panel_pivots(strip: torch.Tensor, k0: int, idx: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """The row order after the panel ``strip`` (``(B, n, b)``, its first
    column at row ``k0``) has chosen its pivots: column j takes the row of
    largest magnitude among rows ``k0 + j`` on, after the columns before it
    were eliminated from every row. Clears ``ok`` where a pivot is 0."""
    bsz, n, b = strip.shape
    perm = torch.arange(n, device=strip.device).repeat(bsz, 1)
    for j in range(b):
        k = k0 + j
        p = k + strip[:, k:, j].abs().argmax(dim=1)
        for t in (strip, perm):
            row_k, row_p = t[idx, k].clone(), t[idx, p].clone()
            t[idx, k], t[idx, p] = row_p, row_k
        pivot = strip[idx, k, j]
        ok &= pivot != 0
        row = strip[idx, k] / torch.where(pivot == 0, 1, pivot)[:, None]
        f = strip[:, :, j].clone()
        f[idx, k] = 0
        strip -= f[:, :, None] * row[:, None, :]
        strip[idx, k] = row
    return perm
