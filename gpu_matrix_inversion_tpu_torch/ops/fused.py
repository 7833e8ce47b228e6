"""Fused whole-matrix Gauss-Jordan: kernel K1 and its plain twin.

Port of ``gpu_matrix_inversion_tpu/ops/fused.py``. The reference's OpenCL
host loop enqueues 5 kernels and pays 3 host syncs per iteration, N
iterations per inversion (``FP32_bench.cpp:342-405``; SURVEY.md section 3.1
names it as the reason it lost to LAPACK). Here the whole r-loop of each
matrix runs inside ONE kernel launch: ``csrc/fused_gj.cu``. At m = 128 one
thread block inverts each matrix of the batch, the matrix in registers in
the in-place layout (m live columns of ``[A | I]``), with two block
barriers a step and two blocks on each SM. For 256 <= m <= 640 the
in-place matrix (256 KiB to 1.6 MiB) fits no single SM, so each matrix
runs on one thread-block cluster of C CTAs (:func:`cluster_geometry`),
each CTA holding m / C of its rows in shared memory, with one exchange
between the CTAs a step; nothing of it lives in global memory.

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
import dataclasses

import torch

from gpu_matrix_inversion_tpu_torch.utils import cuda_build
from gpu_matrix_inversion_tpu_torch.utils.profiling import span

# Largest n the fused route takes. Kept equal to the JAX package's
# FUSED_MAX_N (a TPU VMEM bound) so both packages route every input alike.
FUSED_MAX_N = 640
# A block's shared memory on an H100 (227 KB), the limit the cluster
# kernels' slices are sized against (K1's cluster_geometry below, K2's in
# ops/blocked.py).
SHARED_BYTES = 227 * 1024
# K1 keeps the matrix in registers at this m; larger m take a cluster.
REGISTER_M = 128

# The cluster geometry of K1's m = 256 .. 640 branch
# (``fused_gj_cluster_kernel`` in ``csrc/fused_gj.cu``, which checks what it
# is given).
MAX_CLUSTER = 16              # CTAs; past 8 the runtime's non-portable size
_PORTABLE_CLUSTER = 8
_CLUSTER_THREADS = 512
_MAX_ROWS = 128               # 16 warps of at most 8 row slots
_MIN_ROWS = 32                # a small batch's C stops growing here
GROW_CLUSTER = 8              # ... and here
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class GJCluster:
    """How K1 runs one (m, m) matrix at m = 256 .. 640: ``cluster`` CTAs,
    CTA r owning rows [r*rows, (r+1)*rows), ``threads`` threads each, and
    ``smem`` bytes of shared memory a CTA."""
    cluster: int
    rows: int
    threads: int
    smem: int


def cluster_smem_bytes(m: int, c: int) -> int:
    """Per-CTA shared memory of K1's cluster branch (``cluster_smem_bytes``
    in the source): its rows of the matrix (m / c rows of m floats), two
    step parities of c slots (a row of m floats and a 16-byte key) and of
    the normalized pivot row (m floats), two mbarriers, the pivot order (m
    ints), the reduction scratch (2 x 16 ints) and a flag (4 ints)."""
    return ((m // c) * m * 4 + 2 * c * (4 * m + 16) + 2 * 4 * m + 2 * 8
            + 4 * m + (2 * 16 + 4) * 4)


def cluster_geometry(m: int, batch: int = 1, max_cluster: int = MAX_CLUSTER,
                     sms: int = H100_SMS) -> GJCluster:
    """The cluster of K1's branch for a batch of ``batch`` (m, m) matrices,
    m in 256 .. 640 (a multiple of 128), at most ``max_cluster`` CTAs.

    C is the smallest of 2, 4, 8, 16 whose per-CTA count
    (:func:`cluster_smem_bytes`) fits one CTA's 232,448 bytes with at most
    128 rows a CTA: 2 at m = 256, 4 at 384, 8 at 512, 16 at 640 (the
    fewest SMs a matrix, the most matrices at once for a batch that fills
    the card). A batch whose clusters leave the card's ``sms`` SMs idle
    takes more CTAs a matrix: C doubles, up to ``GROW_CLUSTER`` (8), while
    the batch on 2C CTAs a matrix still fits one wave (batch * 2C <= sms)
    and each CTA keeps at least 32 rows, so a single matrix takes 8 at
    m = 256 to 512. Past 8 a step's exchange (every CTA's candidate row
    into every CTA) costs more than the smaller slices save (``PERF.md``
    section 6). C changes no bit of the output. Raises ``ValueError`` for
    another m, or where no C up to ``max_cluster`` fits (m = 640 needs the
    non-portable 16).
    """
    if m % 128 or not 2 * REGISTER_M <= m <= _round_up(FUSED_MAX_N, 128):
        raise ValueError(f"K1's cluster branch takes m = 256 .. 640 in "
                         f"steps of 128, not m={m}")
    c = 2
    while (c <= max_cluster and (m // c > _MAX_ROWS
                                 or cluster_smem_bytes(m, c) > SHARED_BYTES)):
        c *= 2
    if c > max_cluster:
        raise ValueError(f"K1 at m={m} fits no cluster of at most "
                         f"{max_cluster} CTAs ({SHARED_BYTES} bytes of shared "
                         f"memory a CTA)")
    while (2 * c <= min(max_cluster, GROW_CLUSTER)
           and batch * 2 * c <= sms and m // (2 * c) >= _MIN_ROWS):
        c *= 2
    return GJCluster(c, m // c, _CLUSTER_THREADS, cluster_smem_bytes(m, c))


_plans: dict = {}


def cluster_plan(m: int, batch: int):
    """``(geometry, clusters)``: the :class:`GJCluster` K1 launches with
    for this batch on the current card, and how many such clusters it holds
    at once (``cudaOccupancyMaxActiveClusters``). The geometry is
    :func:`cluster_geometry` at ``MAX_CLUSTER``, else at the portable 8
    where the runtime refuses the first; raises ``RuntimeError`` where
    neither is admitted (no launch then falls back to anything else)."""
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tried = []
    for cmax in dict.fromkeys((MAX_CLUSTER,
                               min(MAX_CLUSTER, _PORTABLE_CLUSTER))):
        try:
            geo = cluster_geometry(m, batch, cmax, sms)
        except ValueError as exc:
            tried.append((cmax, str(exc)))
            continue
        key = (m, geo.cluster, dev)
        if key not in _plans:
            count = ctypes.c_int(0)
            err = cuda_build.load().matinv_fused_clusters(
                m, geo.cluster, geo.smem, ctypes.addressof(count))
            _plans[key] = (err, count.value)
        err, count = _plans[key]
        tried.append((geo.cluster, err, count))
        if err == 0 and count >= 1:
            return geo, count
    raise RuntimeError(f"the card admits no cluster for K1 at m={m} "
                       f"((CTAs, CUDA error, clusters) tried: {tried})")


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


# A float64 whose low 29 bits are 1 followed by 28 zeros lies exactly
# halfway between two (normal) float32 values.
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28


def _fms(x: torch.Tensor, f: torch.Tensor, v: torch.Tensor):
    """``x - f * v`` in fp32 with one rounding, as an FMA computes it (the
    kernels' fmaf; XLA's CPU code for the JAX reference fuses the same
    way). The product is exact in float64, and so is the difference
    whenever the float64 sum s is not exactly halfway between two float32
    values: rounding s to float32 is then the single rounding. Where s is
    halfway and inexact, the rounding to float64 may have moved the
    difference onto the tie, so s moves one float64 ulp toward the exact
    difference (its error, by TwoSum) before the rounding to float32
    (round-to-odd). Exact for results in float32's normal range."""
    xd, pd = torch.broadcast_tensors(x.double(), f.double() * v.double())
    s = xd - pd
    tie = (s.view(torch.int64) & _LOW29) == _HALF29
    if bool(tie.any()):
        xs, ps, st = xd[tie], pd[tie], s[tie]
        bb = st - xs
        err = (xs - (st - bb)) - (ps + bb)
        away = torch.where(err > 0, torch.full_like(st, float("inf")),
                           torch.full_like(st, -float("inf")))
        s[tie] = torch.where(err != 0, torch.nextafter(st, away), st)
    return s.float()


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

    A CUDA tensor launches the kernel (a thread block per matrix at
    m = 128, else a thread-block cluster per matrix, :func:`cluster_plan`);
    a CPU tensor takes the twin."""
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
    return _launch(a, pivot)


def _launch(a: torch.Tensor, pivot: bool):
    """K1's launch on a checked (B, m, m) tensor: its outputs are all it
    allocates."""
    bsz, m, _ = a.shape
    geo = None if m == REGISTER_M else cluster_plan(m, bsz)[0]
    lib = cuda_build.load()
    inv = torch.empty_like(a)
    pos = torch.empty((bsz, m), dtype=torch.int32, device=a.device)
    ok = torch.empty(bsz, dtype=torch.int32, device=a.device)
    err = lib.matinv_fused_gj(
        a.data_ptr(), inv.data_ptr(), pos.data_ptr(), ok.data_ptr(), bsz, m,
        int(pivot), int(a.dtype == torch.bfloat16),
        0 if geo is None else geo.cluster, 0 if geo is None else geo.smem,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check(err, "K1 fused_gj")
    if not cuda_build.capturing():   # a graph's record is no launch
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
    and un-pad (fused.py:262-309); the profiler spans ``fused.k1`` and
    ``fused.gather`` (``utils/profiling.span``)."""
    bsz, n, _ = a.shape
    m = max(_round_up(n, 128), 128)
    with span("fused.k1"):
        if m != n:
            # Pad to blockdiag(A, I): the inverse is blockdiag(inv(A), I),
            # and padded rows/cols never win a pivot against a nonsingular
            # A.
            pad = torch.eye(m, dtype=a.dtype,
                            device=a.device).repeat(bsz, 1, 1)
            pad[:, :n, :n] = a
            a = pad
        inv, pos, ok = gj_kernel(a.contiguous(), pivot=pivot)
    with span("fused.gather"):
        # Undo the logical permutation: inverse row g is at physical row
        # pos[g].
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
