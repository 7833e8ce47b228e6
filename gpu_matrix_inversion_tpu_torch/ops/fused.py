"""Fused whole-matrix Gauss-Jordan: kernel K1 and its plain twin.

Port of ``gpu_matrix_inversion_tpu/ops/fused.py``. The reference's OpenCL
host loop enqueues 5 kernels and pays 3 host syncs per iteration, N
iterations per inversion (``FP32_bench.cpp:342-405``; SURVEY.md section 3.1
names it as the reason it lost to LAPACK). Here the whole r-loop of each
matrix runs inside ONE kernel launch: ``csrc/fused_gj.cu``, one thread block
per matrix of the batch. At m = 128 the block keeps the matrix in
registers, in the in-place layout (m live columns of ``[A | I]``), with two
block barriers a step and two blocks on each SM; for 256 <= m <= 640 the
augmented ``[A | I]`` system lives in a global workspace (0.5 to 3.2 MB per
matrix: L2 holds a few, but a batch that fills the card streams the
workspace from HBM).

Pivoting is swap-free, as on the TPU: a used-row mask replaces row
exchanges (selecting the max-|value| row among unused rows is the same
pivot sequence as partial pivoting with exchanges), the pivot is ONE
packed-key max over unused rows, and the caller restores row order with a
single gather by the emitted position vector.

:func:`gj_kernel` is the wrapper: a CUDA tensor launches the kernel (or the
call raises), a CPU tensor runs :func:`gj_twin`, the plain PyTorch version
of the same math that the CPU tests hold against the JAX package. The TPU
kernel's ``pack`` (several systems per program, so that their step chains
hide each other's latency) becomes two blocks resident on each SM at
m = 128: only blocks on the same SM hide that SM's chain.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_matrix_inversion_tpu_torch.utils import cuda_build

# Largest n the fused route takes. Kept equal to the JAX package's
# FUSED_MAX_N (a TPU VMEM bound) so both packages route every input alike.
FUSED_MAX_N = 640
# A block's shared memory on an H100 (227 KB), the limit the panel kernels'
# strips are sized against (ops/blocked.py, ops/lockstep.py).
SHARED_BYTES = 227 * 1024
# K1 keeps the matrix in registers at this m; larger m take a workspace.
REGISTER_M = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _kmask(m: int) -> int:
    """next_pow2(m) - 1: the row-index field of the packed pivot key."""
    k = 1
    while k < m:
        k *= 2
    return k - 1


def _packed_argmax(col: torch.Tensor, used: torch.Tensor, kmask: int):
    """Packed-key pivot over the last axis of ``col`` (fused.py:182-194,
    blocked.py:149-157): int32 bits of |v| with the low bits replaced by
    (kmask - row), -1 for used rows; returns the winning row index
    (int64, shape ``col.shape[:-1]``)."""
    rows = torch.arange(col.shape[-1], device=col.device, dtype=torch.int32)
    bits = col.abs().to(torch.float32).view(torch.int32)
    key = torch.where(used, torch.full_like(bits, -1),
                      (bits & ~kmask) | (kmask - rows))
    return (kmask - (key.amax(dim=-1) & kmask)).long()


def _fms(x: torch.Tensor, f: torch.Tensor, v: torch.Tensor):
    """``x - f * v`` in fp32 with one rounding, as an FMA computes it (the
    kernels' fmaf; XLA's CPU code for the JAX reference fuses the same
    way). The product is exact in float64; the difference then rounds to
    float64 and to float32, which differs from one rounding only when the
    float64 result lies exactly halfway between two float32 values."""
    return (x.double() - f.double() * v.double()).float()


def gj_twin(a: torch.Tensor, *, pivot: bool):
    """Plain PyTorch twin of K1 on padded ``(B, m, m)`` input.

    Returns ``(inv, pos, ok)``: the inverse in pivot-row order in the input
    dtype, ``pos`` (B, m) int32 (inverse row g lives at row pos[g]) and
    ``ok`` (B,) bool. Computes in fp32 on the input's device and rounds
    as the kernel does.
    """
    bsz, m, _ = a.shape
    dev = a.device
    kmask = _kmask(m)
    items = torch.arange(bsz, device=dev)
    # One (B, m, 2m) buffer updated in place for all m steps.
    aug = torch.cat([a.to(torch.float32),
                     torch.eye(m, device=dev).expand(bsz, m, m)], dim=-1)
    used = torch.zeros((bsz, m), dtype=torch.bool, device=dev)
    pos = torch.empty((bsz, m), dtype=torch.int32, device=dev)
    ok = torch.ones(bsz, dtype=torch.bool, device=dev)
    for r in range(m):
        col = aug[:, :, r].clone()                      # (B, m) factors
        if pivot:
            p = _packed_argmax(col, used, kmask)
        else:
            p = torch.full((bsz,), r, dtype=torch.long, device=dev)
        used[items, p] = True
        pos[:, r] = p.to(torch.int32)
        piv = col[items, p]
        ok &= piv != 0
        norm_row = aug[items, p, :] / torch.where(
            piv == 0, torch.ones_like(piv), piv)[:, None]
        aug.copy_(_fms(aug, col[:, :, None], norm_row[:, None, :]))
        aug[items, p, :] = norm_row                     # the deposit
    inv = aug[:, :, m:]
    ok &= torch.isfinite(inv).all(dim=(-2, -1))
    return inv.to(a.dtype), pos, ok


def gj_kernel(a: torch.Tensor, *, pivot: bool):
    """K1 (``csrc/fused_gj.cu``) on padded ``(B, m, m)`` fp32/bf16 input,
    m a multiple of 128 up to 640. Same outputs as :func:`gj_twin`.

    A CUDA tensor launches the kernel; a CPU tensor takes the twin."""
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"expected (B, m, m), got {tuple(a.shape)}")
    bsz, m, _ = a.shape
    if m % 128 or not 0 < m <= _round_up(FUSED_MAX_N, 128):
        raise ValueError(f"m={m} must be a multiple of 128 up to "
                         f"{_round_up(FUSED_MAX_N, 128)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes float32 or bfloat16, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("K1 needs a contiguous input")
    if a.device.type == "cpu":
        return gj_twin(a, pivot=pivot)
    if a.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda (or its twin on cpu), not "
                         f"{a.device}")
    lib = cuda_build.load()
    inv = torch.empty_like(a)
    pos = torch.empty((bsz, m), dtype=torch.int32, device=a.device)
    ok = torch.empty(bsz, dtype=torch.int32, device=a.device)
    work = (None if m == REGISTER_M else
            torch.empty((bsz, m, 2 * m), dtype=torch.float32,
                        device=a.device))
    err = lib.matinv_fused_gj(
        a.data_ptr(), inv.data_ptr(), pos.data_ptr(), ok.data_ptr(),
        None if work is None else work.data_ptr(), bsz, m, int(pivot),
        int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check(err, "K1 fused_gj")
    gj_kernel.launches += 1
    return inv, pos, ok != 0


gj_kernel.launches = 0


def blocks_per_sm() -> int:
    """K1 blocks at m = 128 that one SM holds at once, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports it (needs the
    card)."""
    blocks = ctypes.c_int(0)
    cuda_build.check(cuda_build.load().matinv_fused_gj_occupancy(
        ctypes.byref(blocks)), "K1 occupancy query")
    return blocks.value


def _fused_batched(a: torch.Tensor, *, pivot: bool):
    """Pad ``(B, n, n)`` to m = round_up(n, 128), run K1, restore row order
    and un-pad (fused.py:262-309)."""
    bsz, n, _ = a.shape
    m = max(_round_up(n, 128), 128)
    if m != n:
        # Pad to blockdiag(A, I): the inverse is blockdiag(inv(A), I), and
        # padded rows/cols never win a pivot against a nonsingular A.
        pad = torch.eye(m, dtype=a.dtype, device=a.device).repeat(bsz, 1, 1)
        pad[:, :n, :n] = a
        a = pad
    inv, pos, ok = gj_kernel(a.contiguous(), pivot=pivot)
    # Undo the logical permutation: inverse row g is at physical row pos[g].
    inv = torch.gather(inv, 1, pos.long()[:, :, None].expand(bsz, m, m))
    return inv[:, :n, :n], ok


def fused_inverse(a: torch.Tensor, *, pivot: bool = True):
    """Invert ``(..., n, n)`` fp32/bf16 matrices with the fused kernel.

    Mirrors the reference's FP32 pivoted Gauss-Jordan entry point
    (``matrix_inversion_FP32.cpp:12``) with the whole ``[A | I]`` system in
    one launch; ``pivot=False`` is the ``matrix_inversion_no_pivots.cpp:10``
    variant. bf16 is an I/O format: the kernel computes in fp32 and returns
    bf16. Returns ``(inverse, ok)``; raises ``NotImplementedError`` for
    dtypes or sizes the fused route does not serve.
    """
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the fused kernel serves fp32/bf16; got {a.dtype} "
            "(FP64 routes to the spec)")
    n = a.shape[-1]
    if n > FUSED_MAX_N:
        raise NotImplementedError(
            f"n={n} exceeds the fused route ({FUSED_MAX_N}); "
            "use the blocked path")
    batch_shape = a.shape[:-2]
    inv, ok = _fused_batched(a.reshape(-1, n, n), pivot=pivot)
    return inv.reshape(a.shape), ok.reshape(batch_shape)
