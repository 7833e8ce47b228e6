"""Tiled matmul: the verification GEMM as a hand-written kernel.

Port of ``gpu_matrix_inversion_tpu/ops/matmul.py``. The reference's C8
(``matrix_multiply.cpp:17-36``) is a naive OpenCL GEMM, one work-item per
output element, used only to verify inverses; the JAX package keeps it as
a tiled Pallas kernel for parity and to cross-check the library GEMM in
tests. Here it is kernel K7 (``csrc/tiled_matmul.cu``). As in the
reference, no inversion path calls it: the production GEMMs are library
calls.

K7 has two branches: bf16 operands go to the tensor cores (``wgmma`` fed
by TMA), fp32 ones through a pipelined FMA tile loop (true FP32). The TPU
kernel's tile argument (``block``) does not carry over: K7's tiles are
fixed for the GPU, and it masks the ragged edges itself. It does read each
operand row in 16-byte units, so an operand whose row stride or base
address is not a multiple of 16 bytes, or whose rows another tensor's
elements follow inside their last unit, is first copied into a zero-tailed
buffer with a padded row stride (:func:`stride_padded`, counted in
``tiled_matmul.padded``), the counterpart of ``pallas_matmul``'s own
padding to its tile.
"""

from __future__ import annotations

import math

import torch

from gpu_matrix_inversion_tpu_torch.utils import cuda_build
from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision

_DTYPES = (torch.float32, torch.bfloat16)
_ROW_BYTES = 16  # K7 reads rows in 16-byte units (TMA; float4, cp.async)


def error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise worst-case bound on the difference of two
    fp32-accumulated products of ``a`` and ``b`` that sum in different
    orders (K7 and its twin): each is within k * 2^-24 * (|a| @ |b|) of the
    exact sum; bf16 outputs may then round to neighbouring bf16 values, one
    bf16 spacing (at most 2^-7 of the value) apart. It is the check for
    bf16 operands. For fp32 ones it is too wide to tell fp32 from TF32:
    hold an fp32 result to :func:`fp32_error_bound` instead."""
    k = a.shape[1]
    with matmul_precision("highest"):
        scale = a.abs().float() @ b.abs().float()
    tol = 2 * k * 2.0 ** -24 * scale
    if a.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * (a.float() @ b.float()).abs()
    return tol


def fp32_error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on ``|c - a @ b|``, the exact product taken in
    float64, for ``c`` summed in fp32 from fp32 operands whose products
    have random signs (as seeded normal operands have).

    Each of the k fp32 additions rounds its partial sum s_j by at most
    2^-24 of it. Those errors add up with a standard deviation of at most
    2^-24 * sqrt(sum_j s_j^2 / 3), and for random signs sum_j s_j^2 is
    about k * sum_j (a_j b_j)^2 / 2. The bound allows about 20 standard
    deviations, 8 * sqrt(k) * 2^-24 * sqrt(sum_j (a_j b_j)^2), plus the
    output's own rounding. Operands rounded to TF32 (10-bit mantissas)
    give an error of about 2^-11 * sqrt(2/3) * sqrt(sum_j (a_j b_j)^2),
    13x this bound at k = 4096 and 60x at k = 200; bf16 operands give
    8x more. Both fail it, so it checks the fp32 contract."""
    k = a.shape[1]
    a64, b64 = a.double(), b.double()
    spread = ((a64 * a64) @ (b64 * b64)).sqrt()
    return 2.0 ** -24 * (8 * math.sqrt(k) * spread + (a64 @ b64).abs())


def tiled_matmul_twin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of K7: the product accumulated in fp32 (TF32 off),
    rounded once to ``a``'s dtype."""
    with matmul_precision("highest"):
        return (a.float() @ b.float()).to(a.dtype)


def needs_stride_pad(x: torch.Tensor) -> bool:
    """Whether K7 cannot read the caller's row-major 2-D operand ``x`` in
    place. K7 reads each row in whole 16-byte units from an aligned start
    (TMA's rule, and the float4 and ``cp.async`` loads'), so the row stride
    and the base address must be multiples of 16 bytes; and the fp32
    branch takes a row's last unit as it finds it, so what follows a row
    inside that unit must be zeros. Only a copy makes sure of that when the
    row stride exceeds a row length that is not a multiple of 16 bytes (a
    one-row view of a wider tensor counts as contiguous whatever its row
    stride). The wrapper asks this of the caller's operands only:
    :func:`stride_padded`'s copy, zero-tailed, is read in place. An operand
    with no elements is never read."""
    if x.numel() == 0:
        return False
    per = _ROW_BYTES // x.element_size()
    return bool(x.stride(0) % per or x.data_ptr() % _ROW_BYTES
                or (x.stride(0) != x.shape[1] and x.shape[1] % per))


def stride_padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, cols) copied into a zeroed buffer whose row stride is
    cols rounded up to 16 bytes; returns the (rows, cols) view of that
    buffer: the same shape and values, each row followed by a zero tail."""
    rows, cols = x.shape
    per = _ROW_BYTES // x.element_size()
    buf = torch.zeros((rows, -(-cols // per) * per), dtype=x.dtype,
                      device=x.device)
    buf[:, :cols] = x
    return buf[:, :cols]


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D fp32 or bf16 operands of one dtype (the
    counterpart of ``pallas_matmul``), with an fp32 accumulator and the
    output in ``a``'s dtype. A CUDA tensor launches K7 (an operand that
    :func:`needs_stride_pad` is copied by :func:`stride_padded` first); a
    CPU tensor takes :func:`tiled_matmul_twin`."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES:
        raise NotImplementedError(f"tiled_matmul serves fp32/bf16, got "
                                  f"{a.dtype}")
    if b.dtype != a.dtype or b.device != a.device:
        raise TypeError(f"operands must share dtype and device, got "
                        f"{a.dtype} on {a.device} and {b.dtype} on "
                        f"{b.device}")
    if a.device.type == "cpu":
        return tiled_matmul_twin(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"K7 runs on cuda (or its twin on cpu), not "
                         f"{a.device}")
    a, b = a.contiguous(), b.contiguous()
    if needs_stride_pad(a):
        a = stride_padded(a)
        tiled_matmul.padded += 1
    if needs_stride_pad(b):
        b = stride_padded(b)
        tiled_matmul.padded += 1
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = cuda_build.load()
    err = lib.matinv_tiled_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0),
        b.stride(0), int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check(err, "K7 tiled_matmul")
    if not cuda_build.capturing():   # a graph's record is no launch
        tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
tiled_matmul.padded = 0
