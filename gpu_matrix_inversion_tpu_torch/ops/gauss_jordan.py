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

The JAX package runs the loop as one on-device ``lax.fori_loop``
(gauss_jordan.py:98-105). Here :func:`_gauss_jordan_aug` is the wrapper of
kernel L1 (``csrc/gauss_jordan.cu``), its counterpart: on a CUDA tensor it
launches L1, on a CPU tensor it runs :func:`gauss_jordan_twin`, the loop
above written as tensor operations, whose bits L1 reproduces.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from gpu_matrix_inversion_tpu_torch.ops.fused import H100_SMS, SHARED_BYTES
from gpu_matrix_inversion_tpu_torch.utils import cuda_build
from gpu_matrix_inversion_tpu_torch.utils.graphs import compiled

# L1's geometry (``csrc/gauss_jordan.cu`` checks what it is given). The
# cluster branch keeps a matrix on one thread-block cluster's shared memory
# up to n = ONCHIP_MAX_N (fp64 511: 2.09 MB on 16 CTAs); past it a
# persistent grid runs one matrix at a time.
ONCHIP_MAX_N = 511
CLUSTER_CAP = 16        # CTAs; past 8 the runtime's non-portable size
CLUSTER_GROW = 8        # a small batch's C grows to here ...
CLUSTER_MIN_ROWS = 8    # ... while each CTA keeps this many rows
GRID_MIN_ROWS = 32      # a grid CTA's rows before the grid grows for room
_THREADS = 256
_WARPS = _THREADS // 32
_CAND = 16              # bytes of a pivot candidate (key, order, row)


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def loop_smem(rows: int, w: int, ints: int, itemsize: int, *,
              rows_shared: bool, props_shared: bool) -> int:
    """Shared memory of a CTA of L1 or L2 (``smem_bytes`` in
    ``csrc/gj_loop.cuh``): its ``rows`` rows of ``w`` values where they
    live there, the normalized pivot row, its two proposals (a 16-byte
    header and a row each) on a cluster, ``ints`` ints (L1's three position
    maps, L2's row states), the reduction scratch and a flag."""
    return ((_a16(rows * w * itemsize) if rows_shared else 0)
            + _a16(w * itemsize)
            + (2 * _a16(_CAND + w * itemsize) if props_shared else 0)
            + _a16(4 * ints) + _WARPS * _CAND + 16)


def grid_props_bytes(g: int, w: int, itemsize: int) -> int:
    """The device workspace of a grid's proposals (``GridComm`` in
    ``csrc/gj_loop.cuh``): two parities of g proposals, each a 16-byte
    header and a row of w values."""
    return 2 * g * _a16(_CAND + w * itemsize)


@dataclasses.dataclass(frozen=True)
class LoopGeometry:
    """How L1 or L2 runs: ``branch`` "cluster" (``ctas`` CTAs a matrix) or
    "grid" (a persistent grid of ``ctas`` CTAs), CTA k owning rows
    [k*rows, (k+1)*rows), in its shared memory where ``rows_shared``,
    ``smem`` bytes of shared memory a CTA."""
    branch: str
    ctas: int
    rows: int
    rows_shared: bool
    smem: int


def grid_geometry(rows: int, w: int, itemsize: int, *, ints: int | None,
                  sms: int = H100_SMS) -> LoopGeometry:
    """The persistent grid of L1's grid branch and of L2 over a
    (rows, w) working matrix: a CTA per GRID_MIN_ROWS rows, at most one
    per SM, grown until the rows fit in shared memory or the grid fills the
    card; no CTA left without rows. ``ints`` ints of shared memory a CTA
    besides (None: one per row it owns)."""
    def smem(g: int, shared: bool) -> int:
        rp = _cdiv(rows, g)
        return loop_smem(rp, w, rp if ints is None else ints, itemsize,
                         rows_shared=shared, props_shared=False)

    g = min(sms, max(1, _cdiv(rows, GRID_MIN_ROWS)))
    while g < sms and smem(g, True) > SHARED_BYTES:
        g += 1
    g = _cdiv(rows, _cdiv(rows, g))
    shared = smem(g, True) <= SHARED_BYTES
    if smem(g, shared) > SHARED_BYTES:
        raise ValueError(f"a ({rows}, {w}) job needs {smem(g, shared)} "
                         f"bytes of shared memory a CTA")
    return LoopGeometry("grid", g, _cdiv(rows, g), shared, smem(g, shared))


def loop_geometry(n: int, batch: int, itemsize: int,
                  sms: int = H100_SMS) -> LoopGeometry:
    """L1's geometry for a (batch, n, n) call in a dtype of ``itemsize``
    bytes. n <= ONCHIP_MAX_N: the cluster branch, C the smallest power of
    two whose CTAs hold their rows, doubled up to CLUSTER_GROW while the
    batch's clusters leave SMs idle and each CTA keeps CLUSTER_MIN_ROWS
    rows (fp64 b = 256: C = 4 for a (64, 256^2) batch, 8 for one block;
    n = 511: C = 16). Past it: :func:`grid_geometry`."""
    if n > ONCHIP_MAX_N:
        return grid_geometry(n, n, itemsize, ints=3 * n, sms=sms)

    def smem(c: int) -> int:
        return loop_smem(_cdiv(n, c), n, 3 * n, itemsize, rows_shared=True,
                         props_shared=True)

    c = 1
    while smem(c) > SHARED_BYTES:
        c *= 2
    while (c < CLUSTER_GROW and batch * 2 * c <= sms
           and _cdiv(n, 2 * c) >= CLUSTER_MIN_ROWS):
        c *= 2
    if c > CLUSTER_CAP:
        raise ValueError(f"n={n} does not fit a cluster of {CLUSTER_CAP}")
    return LoopGeometry("cluster", c, _cdiv(n, c), True, smem(c))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_plans: dict = {}


def loop_plan(n: int, batch: int, dtype: torch.dtype, device):
    """``(geometry, clusters)``: the :class:`LoopGeometry` L1 launches with
    on ``device`` and, on the cluster branch, how many such clusters the
    card holds at once (``cudaOccupancyMaxActiveClusters``; None on the
    grid branch, whose cooperative launch the runtime admits or refuses).
    Raises ``RuntimeError`` where the card admits no cluster."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    itemsize = dtype.itemsize
    geo = loop_geometry(n, batch, itemsize, sm_count(index))
    if geo.branch != "cluster":
        return geo, None
    key = (n, itemsize, geo.ctas, index)
    if key not in _plans:
        count = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = cuda_build.load().matinv_gauss_jordan_clusters(
                n, int(itemsize == 8), geo.ctas, geo.smem,
                ctypes.addressof(count))
        _plans[key] = (err, count.value)
    err, count = _plans[key]
    if err != 0 or count < 1:
        raise RuntimeError(f"L1 at n={n}: the card admits no cluster of "
                           f"{geo.ctas} CTAs with {geo.smem} bytes each "
                           f"(error {err}, {count} clusters)")
    return geo, count


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


def gauss_jordan_twin(a: torch.Tensor, *, pivot: bool):
    """(B, n, n) -> (inverse (B, n, n), ok (B,)): the plain loop, L1's twin.
    ``calls`` counts its calls."""
    gauss_jordan_twin.calls += 1
    n = a.shape[-1]
    aug = _augment(a)
    ok = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    for r in range(n):
        _gj_step(aug, r, ok, pivot=pivot)
    inv = aug[:, :, n:]
    ok &= torch.isfinite(inv).all(dim=(-2, -1))
    return inv, ok


gauss_jordan_twin.calls = 0


def _gauss_jordan_aug(a: torch.Tensor, *, pivot: bool):
    """L1 (``csrc/gauss_jordan.cu``): (B, n, n) -> (inverse (B, n, n),
    ok (B,)), the result of :func:`gauss_jordan_twin` bit for bit up to the
    sign of a zero (on a non-finite input only ``ok`` agrees).

    A CPU tensor runs the twin. A CUDA tensor launches L1 in fp64 or fp32
    (:func:`loop_plan`: a cluster per matrix to n = 511, a persistent grid
    past it); bf16 and fp16 are I/O formats there, computed in fp32 and
    returned in the input's dtype, as the fused route does."""
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"L1 takes (B, n, n), got {tuple(a.shape)}")
    if a.device.type == "cpu":
        return gauss_jordan_twin(a, pivot=pivot)
    if a.device.type != "cuda":
        raise ValueError(f"L1 runs on cuda (or its twin on cpu), not "
                         f"{a.device}")
    if a.dtype in (torch.bfloat16, torch.float16):
        inv, ok = _gauss_jordan_aug(a.float(), pivot=pivot)
        return inv.to(a.dtype), ok
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"L1 takes float32 or float64, got {a.dtype}")
    a = a.contiguous()
    bsz, n, _ = a.shape
    geo, _ = loop_plan(n, bsz, a.dtype, a.device)
    lib = cuda_build.load()
    dev = a.device
    inv = torch.empty_like(a)
    ok = torch.empty(bsz, dtype=torch.int32, device=dev)
    work = props = bar = flags = None
    if geo.branch == "grid":
        if not geo.rows_shared:
            work = torch.empty((n, n), dtype=a.dtype, device=dev)
        props = torch.empty(grid_props_bytes(geo.ctas, n, a.element_size()),
                            dtype=torch.uint8, device=dev)
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        flags = torch.empty(geo.ctas, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.matinv_gauss_jordan(
        a.data_ptr(), inv.data_ptr(), ok.data_ptr(), ptr(work), ptr(props),
        ptr(bar), ptr(flags), bsz, n, int(a.dtype == torch.float64),
        int(pivot), int(geo.branch == "grid"), geo.ctas, int(geo.rows_shared),
        geo.smem, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "L1 gauss_jordan")
    if not cuda_build.capturing():   # a graph's record is no launch
        _gauss_jordan_aug.launches += 1
    return inv, ok != 0


_gauss_jordan_aug.launches = 0


@compiled
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
