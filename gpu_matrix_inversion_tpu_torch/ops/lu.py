"""LU factorization, getri-style inversion and solves: kernel K5 and the
blocked getrf around it.

Port of ``gpu_matrix_inversion_tpu/ops/lu.py``, the LAPACK-shaped path the
reference's README concedes to (``README.md:62``): partial-pivoted LU
(getrf), triangular solves (getrs), explicit inversion (getri through trtri)
and the determinant. Storage follows LAPACK: unit-lower L and U packed in
one matrix plus a row permutation ``perm`` (PA = LU, output row i is input
row perm[i]).

- The spec (:func:`lu_factor`, :func:`lu_solve`, :func:`lu_inverse`): the
  JAX package runs its loops as on-device ``lax.fori_loop`` loops. Here the
  getrf loop is kernel L4 (``csrc/gauss_jordan.cu``, wrapper
  :func:`_lu_factor_batched`) and the getrs loops kernel L5
  (``csrc/lu_solve.cu``, :func:`_lu_solve_batched`); a CPU tensor runs
  their plain twins (:func:`lu_factor_twin`, :func:`lu_solve_twin`), one
  step at a time, whose bits the kernels reproduce.
- The blocked getrf (:func:`lu_factor_blocked`) rides the blocked
  Gauss-Jordan path's machinery. For fp32 the panel pivots come from kernel
  K3 (``ops/blocked.pivot_search``; partial-pivoted GJ and LU choose the
  same pivots, since the search reads only not-yet-pivoted rows and those
  receive the same updates under both), the pivot block factors in kernel
  K5 (``csrc/small_lu.cu``, no pivoting: K3 fixed the order), and the rest
  of the panel is assembled with triangular solves and GEMMs. Other dtypes
  run the panel loop as the reference does, here kernel L3
  (``csrc/lu_panel.cu``, wrapper :func:`_lu_panel`, twin
  :func:`lu_panel_twin`).
- Triangular solves are ``torch.linalg.solve_triangular`` (the reference's
  ``lax.linalg.triangular_solve``; ``left_side=False`` is ``left=False``)
  and the GEMMs are library calls, in true FP32 (TF32 off) whatever the
  caller's global flag: the public functions run under
  ``matmul_precision("highest")``.

The reference's ``optimization_barrier`` guards and x64 scopes steer
XLA:TPU and Mosaic and have no counterpart; its ``vmap``/``lax.map`` over a
batch is a loop here.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch

from gpu_matrix_inversion_tpu_torch.ops.blocked import (_default_group_size,
                                                        _select_block_params,
                                                        logical_geometry,
                                                        pivot_search)
from gpu_matrix_inversion_tpu_torch.ops.fused import (H100_SMS, SHARED_BYTES,
                                                      _fms)
from gpu_matrix_inversion_tpu_torch.ops.gauss_jordan import (
    grid_props_bytes, launch_matrix_loop, sm_count)
from gpu_matrix_inversion_tpu_torch.utils import cuda_build
from gpu_matrix_inversion_tpu_torch.utils.graphs import compiled
from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision


def _fp32_gemms(fn):
    """Run ``fn`` with its FP32 GEMMs in true FP32 (TF32 off)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapper


def _check_square(a: torch.Tensor) -> None:
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got "
                         f"{tuple(a.shape)}")


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _tri_solve(t, rhs, *, lower: bool, left: bool = True,
               unit_diagonal: bool = False):
    return torch.linalg.solve_triangular(t, rhs, upper=not lower, left=left,
                                         unitriangular=unit_diagonal)


# --------------------------------------------------------------------------
# The spec: getrf / getrs / getri (lu.py:29-157), kernels L4 and L5
# --------------------------------------------------------------------------


def lu_factor_twin(a: torch.Tensor, *, pivot: bool):
    """Partial-pivoted LU of (B, n, n) with real row swaps (the first max
    of |column r| over rows >= r), L4's plain twin; returns ``(lu, perm,
    ok)``. ``calls`` counts its calls."""
    lu_factor_twin.calls += 1
    bsz, n, _ = a.shape
    dev = a.device
    items = torch.arange(bsz, device=dev)
    rows = torch.arange(n, device=dev)
    lu = a.clone()
    perm = torch.arange(n, device=dev).repeat(bsz, 1)
    ok = torch.ones(bsz, dtype=torch.bool, device=dev)
    for r in range(n):
        col = lu[:, :, r].clone()
        if pivot:
            p = r + col[:, r:].abs().argmax(dim=1)
        else:
            p = torch.full((bsz,), r, dtype=torch.long, device=dev)
        piv = col[items, p]
        ok &= piv != 0
        piv_safe = torch.where(piv == 0, torch.ones_like(piv), piv)
        if pivot:
            row_p = lu[items, p]
            lu[items, p] = lu[:, r].clone()
            lu[:, r] = row_p
            perm_p = perm[items, p]
            perm[items, p] = perm[:, r].clone()
            perm[:, r] = perm_p
            col[items, p] = col[:, r].clone()
            col[:, r] = piv
        # Multipliers of the rows below r; eliminate the trailing columns
        # and store the multipliers in column r (LAPACK packed layout).
        f = torch.where(rows > r, col / piv_safe[:, None],
                        torch.zeros_like(col))
        lu[:, :, r + 1:] -= f[:, :, None] * lu[:, r:r + 1, r + 1:]
        lu[:, r + 1:, r] = f[:, r + 1:]
    ok &= torch.isfinite(lu).all(dim=(-2, -1))
    return lu, perm, ok


lu_factor_twin.calls = 0


def _device_index(t: torch.Tensor) -> int:
    index = t.device.index
    return torch.cuda.current_device() if index is None else index


def _lu_factor_batched(a: torch.Tensor, *, pivot: bool):
    """L4 (``csrc/gauss_jordan.cu``, L1's kernels in their LU mode):
    partial-pivoted LU of (B, n, n) with row swaps; ``(lu, perm, ok)`` of
    :func:`lu_factor_twin` bit for bit, perm int64.

    A CPU tensor runs the twin. A CUDA tensor launches L4 in fp64 or fp32
    through L1's launcher (``gauss_jordan.launch_matrix_loop``: a cluster
    per matrix to n = 511, a persistent grid past it); bf16 and fp16 are
    computed in fp32 and the factor returned in the input's dtype, as L1
    does."""
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"L4 takes (B, n, n), got {tuple(a.shape)}")
    if a.device.type == "cpu":
        return lu_factor_twin(a, pivot=pivot)
    if a.device.type != "cuda":
        raise ValueError(f"L4 runs on cuda (or its twin on cpu), not "
                         f"{a.device}")
    if a.dtype in (torch.bfloat16, torch.float16):
        lu, perm, ok = _lu_factor_batched(a.float(), pivot=pivot)
        return lu.to(a.dtype), perm, ok
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"L4 takes float32 or float64, got {a.dtype}")
    lu, perm, ok = launch_matrix_loop(a.contiguous(), lu=True, pivot=pivot)
    if not cuda_build.capturing():   # a graph's record is no launch
        _lu_factor_batched.launches += 1
    return lu, perm, ok != 0


_lu_factor_batched.launches = 0


@compiled
def lu_factor(a: torch.Tensor, *, pivot: bool = True):
    """getrf (the spec): ``(lu, perm, ok)`` with PA = LU, batched over
    leading axes. ``perm`` maps output row i to input row perm[i]."""
    _check_square(a)
    n = a.shape[-1]
    lu, perm, ok = _lu_factor_batched(a.reshape(-1, n, n), pivot=pivot)
    return (lu.reshape(a.shape), perm.reshape(a.shape[:-1]),
            ok.reshape(a.shape[:-2]))


def lu_solve_twin(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor):
    """getrs (the spec) on (B, n, n), (B, n), (B, n, k), L5's plain twin:
    ``(x, ok)``. ``calls`` counts its calls."""
    lu_solve_twin.calls += 1
    n = lu.shape[-1]
    y = torch.take_along_dim(b, perm.long()[:, :, None], dim=1)
    for j in range(n):                   # forward: L is unit lower
        y[:, j + 1:] -= lu[:, j + 1:, j, None] * y[:, j:j + 1]
    ok = torch.ones(lu.shape[0], dtype=torch.bool, device=lu.device)
    for j in range(n - 1, -1, -1):       # back substitution: U x = y
        ujj = lu[:, j, j]
        ok &= ujj != 0
        xj = y[:, j:j + 1] / torch.where(ujj == 0, torch.ones_like(ujj),
                                         ujj)[:, None, None]
        y[:, :j] -= lu[:, :j, j, None] * xj
        y[:, j:j + 1] = xj
    ok &= torch.isfinite(y).all(dim=(-2, -1))
    return y, ok


lu_solve_twin.calls = 0

# L5's per-column path gives a CTA at most this many right-hand-side
# columns.
LU_SOLVE_MAX_COLS = 16


def lu_solve_geometry(batch: int, k: int, sms: int = H100_SMS) -> int:
    """The right-hand-side columns a CTA of L5's per-column path takes:
    LU_SOLVE_MAX_COLS, halved (to 1) while the (matrix, column tile) CTAs
    leave SMs idle. (1, k = 16): 1, so 16 CTAs; (1, k = 4096): 16, so 256;
    (64, k = 128): 16, so 512."""
    kc = LU_SOLVE_MAX_COLS
    while kc > 1 and batch * -(-k // kc) < sms:
        kc //= 2
    return kc


# L5's cluster path: a tile of 256 bytes of each row's right-hand sides
# (64 fp32 or 32 fp64 columns) on one cluster of at most 16 CTAs.
LU_SOLVE_TILE_BYTES = 256
LU_SOLVE_MAX_CLUSTER = 16
# Below this order the cluster path takes only batches whose per-column
# CTAs would fill the card twice over.
LU_SOLVE_CLUSTER_MIN_N = 512


@dataclasses.dataclass(frozen=True)
class LuSolvePlan:
    """How L5 runs a solve: ``cluster`` CTAs a cluster, one cluster a
    (matrix, tile of ``kc`` columns), ``smem`` bytes of shared memory a
    CTA (the cluster path); or ``cluster`` 0, one CTA a (matrix, tile of
    ``kc`` columns) (the per-column path). ``ctas`` CTAs in all, each
    writing one flag."""
    cluster: int
    kc: int
    smem: int
    ctas: int


def lu_solve_smem(n: int, cluster: int, itemsize: int) -> int:
    """Shared memory of a CTA of L5's cluster path at order n
    (``cluster_smem_bytes`` in ``csrc/lu_solve.cu``): four barriers, two
    buffers of a block's 32 finished rows of the tile, the owner's two
    32 x 32 blocks of the factor, and the CTA's blocks of 32 rows of y,
    each row of these three padded by 16 bytes."""
    blocks = -(-(-(-n // 32)) // cluster)
    return (32 + 2 * 32 * LU_SOLVE_TILE_BYTES + 2 * 32 * (32 * itemsize + 16)
            + blocks * 32 * (LU_SOLVE_TILE_BYTES + 16))


def lu_solve_plan(batch: int, n: int, k: int, itemsize: int,
                  sms: int = H100_SMS) -> LuSolvePlan:
    """L5's path for a (batch, n, n) solve of k right-hand sides in a dtype
    of ``itemsize`` bytes, by shape alone.

    The cluster path where a CTA's rows fit its shared memory and either n
    is at least LU_SOLVE_CLUSTER_MIN_N or the per-column path's CTAs would
    fill the card twice over; C the largest power of two up to
    LU_SOLVE_MAX_CLUSTER and the count of 32-row blocks, halved while the
    clusters' CTAs outnumber two an SM and two CTAs of half as many still
    share an SM (fewer finished blocks to send, more tiles in flight):
    (1, 4096^2) C = 16, 95,264 bytes a CTA, 64 clusters at k = 4096 fp32;
    (64, 128^2, k = 128) C = 2. Else the per-column path,
    :func:`lu_solve_geometry`: below n = 512 with few CTAs (a chain of 2 n
    short steps beats 2 n / 32 exchanges; H100, ``PERF.md``) and past
    n = 11,776 (fp32: y outgrows a cluster of 16)."""
    kc_col = lu_solve_geometry(batch, k, sms)
    col_ctas = batch * -(-k // kc_col)
    blocks = -(-n // 32)
    c = min(LU_SOLVE_MAX_CLUSTER, 1 << (blocks.bit_length() - 1))
    if (lu_solve_smem(n, c, itemsize) > SHARED_BYTES
            or (n < LU_SOLVE_CLUSTER_MIN_N and col_ctas < 2 * sms)):
        return LuSolvePlan(0, kc_col, 0, col_ctas)
    kc = LU_SOLVE_TILE_BYTES // itemsize
    tiles = batch * -(-k // kc)
    while (c > 1 and tiles * c > 2 * sms
           and 2 * lu_solve_smem(n, c // 2, itemsize) <= SHARED_BYTES):
        c //= 2
    return LuSolvePlan(c, kc, lu_solve_smem(n, c, itemsize), tiles * c)


def _lu_solve_batched(lu: torch.Tensor, perm: torch.Tensor,
                      b: torch.Tensor):
    """L5 (``csrc/lu_solve.cu``): getrs on (B, n, n), (B, n), (B, n, k);
    ``(x, ok)`` of :func:`lu_solve_twin` bit for bit.

    A CPU tensor runs the twin. A CUDA tensor launches L5 in fp64 or fp32
    on the path :func:`lu_solve_plan` chooses by shape: one cluster a
    (matrix, tile of 256 bytes of columns), or one CTA a (matrix, tile of
    :func:`lu_solve_geometry` columns); bf16 and
    fp16 are computed in fp32 and x returned in the input's dtype. Where
    b's dtype differs from the factor's, the solve runs in the wider of the
    two and x is returned in b's dtype, as the twin returns it: the twin's
    bits where b is the wider, else rounded once where the twin rounds y
    into b's dtype at every step."""
    if (lu.ndim != 3 or lu.shape[-1] != lu.shape[-2] or b.ndim != 3
            or perm.shape != lu.shape[:2] or b.shape[:2] != lu.shape[:2]):
        raise ValueError(f"L5 takes (B, n, n), (B, n) and (B, n, k), got "
                         f"{tuple(lu.shape)}, {tuple(perm.shape)} and "
                         f"{tuple(b.shape)}")
    if lu.device.type == "cpu":
        return lu_solve_twin(lu, perm, b)
    if lu.device.type != "cuda":
        raise ValueError(f"L5 runs on cuda (or its twin on cpu), not "
                         f"{lu.device}")
    if not b.is_floating_point():
        raise TypeError(f"L5 takes a floating b, got {b.dtype}")
    if b.dtype != lu.dtype:
        wide = torch.promote_types(lu.dtype, b.dtype)
        x, ok = _lu_solve_batched(lu.to(wide), perm, b.to(wide))
        return x.to(b.dtype), ok
    if lu.dtype in (torch.bfloat16, torch.float16):
        x, ok = _lu_solve_batched(lu.float(), perm, b.float())
        return x.to(lu.dtype), ok
    if lu.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"L5 takes float32 or float64, got {lu.dtype}")
    lu, b = lu.contiguous(), b.contiguous()
    perm = perm.long().contiguous()
    bsz, n, _ = lu.shape
    k = b.shape[-1]
    dev = lu.device
    plan = lu_solve_plan(bsz, n, k, lu.element_size(),
                         sm_count(_device_index(lu)))
    lib = cuda_build.load()
    x = torch.empty_like(b)
    flags = torch.empty((bsz, plan.ctas // bsz), dtype=torch.int32,
                        device=dev)
    # The cluster path's two slots a cluster of a block's finished rows.
    work = (torch.empty((plan.ctas // plan.cluster, 2, 32, plan.kc),
                        dtype=lu.dtype, device=dev) if plan.cluster else None)
    err = lib.matinv_lu_solve(
        lu.data_ptr(), perm.data_ptr(), b.data_ptr(), x.data_ptr(),
        flags.data_ptr(), None if work is None else work.data_ptr(), bsz, n,
        k, plan.kc, plan.cluster, int(lu.dtype == torch.float64),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "L5 lu_solve")
    if not cuda_build.capturing():   # a graph's record is no launch
        _lu_solve_batched.launches += 1
        if plan.cluster:
            _lu_solve_batched.cluster_launches += 1
        else:
            _lu_solve_batched.column_launches += 1
    return x, (flags != 0).all(dim=1)


# launches: every launch; cluster_launches and column_launches: those of
# each path.
_lu_solve_batched.launches = 0
_lu_solve_batched.cluster_launches = 0
_lu_solve_batched.column_launches = 0


@compiled
def lu_solve(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor):
    """Solve with a prior :func:`lu_factor`; ``b`` is (..., n, k).
    Returns ``(x, ok)``."""
    n, k = lu.shape[-1], b.shape[-1]
    x, ok = _lu_solve_batched(lu.reshape(-1, n, n), perm.reshape(-1, n),
                              b.reshape(-1, n, k))
    return x.reshape(b.shape), ok.reshape(lu.shape[:-2])


@compiled
def lu_inverse(a: torch.Tensor):
    """getri (the spec): the inverse by LU and n simultaneous solves;
    returns ``(inverse, ok)``."""
    lu, perm, ok_f = lu_factor(a)
    eye = _eye(a.shape[-1], a).expand(a.shape)
    inv, ok_s = lu_solve(lu, perm, eye)
    return inv, ok_f & ok_s


@compiled
def lu_solve_matrix(a: torch.Tensor, b: torch.Tensor, *, pivot: bool = True):
    """One-shot solve A x = b (the spec); returns ``(x, ok)``."""
    lu, perm, ok_f = lu_factor(a, pivot=pivot)
    x, ok_s = lu_solve(lu, perm, b)
    return x, ok_f & ok_s


# --------------------------------------------------------------------------
# K5: the getrf base case
# --------------------------------------------------------------------------


def small_lu_twin(d: torch.Tensor):
    """Plain twin of K5 on (B, b, b) fp32: no-pivot LAPACK-packed LU, the
    trailing update rounded once (as XLA's CPU code contracts the TPU
    kernel's ``full - f * row``) and IEEE division. Returns
    ``(packed, ok)``."""
    b = d.shape[-1]
    lu = d.clone()
    ok = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    for r in range(b):
        piv = lu[:, r, r].clone()
        ok &= piv != 0
        f = lu[:, r + 1:, r] / torch.where(piv == 0, torch.ones_like(piv),
                                           piv)[:, None]
        lu[:, r + 1:, r + 1:] = _fms(lu[:, r + 1:, r + 1:], f[:, :, None],
                                     lu[:, r:r + 1, r + 1:])
        lu[:, r + 1:, r] = f
    ok &= torch.isfinite(lu).all(dim=(-2, -1))
    return lu, ok


# K5 holds a block in registers: 16 warps of 8 rows, 32 lanes of 4 columns.
K5_MAX_B = 128


def check_small_lu_block(b: int) -> None:
    """Raise unless K5 serves (b, b) blocks: 1 <= b <= 128, the registers
    of its 16 warps x 32 lanes holding 8 x 4 values each. 128 is the
    largest block the getrf geometry (``_select_block_params``) hands it."""
    if not 1 <= b <= K5_MAX_B:
        raise ValueError(f"K5 small_lu serves blocks of 1 to {K5_MAX_B} "
                         f"rows (its registers hold at most "
                         f"{K5_MAX_B} x {K5_MAX_B}), got b = {b}")


def small_lu(d: torch.Tensor):
    """K5 (``csrc/small_lu.cu``): no-pivot packed LU of (b, b) fp32 blocks,
    batched over a leading axis; returns ``(packed, ok)`` in the input's
    batch shape, ok = every pivot nonzero and every value finite. A CUDA
    tensor launches the kernel (the block in registers, b <= 128, see
    :func:`check_small_lu_block`); a CPU tensor takes
    :func:`small_lu_twin`."""
    if d.ndim not in (2, 3) or d.shape[-1] != d.shape[-2]:
        raise ValueError(f"K5 takes (b, b) or (B, b, b), got "
                         f"{tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise TypeError(f"K5 takes float32, got {d.dtype}")
    d3 = d.reshape(-1, d.shape[-1], d.shape[-1]).contiguous()
    bsz, b, _ = d3.shape
    if d.device.type == "cpu":
        packed, ok = small_lu_twin(d3)
    elif d.device.type == "cuda":
        check_small_lu_block(b)
        lib = cuda_build.load()
        packed = torch.empty_like(d3)
        ok = torch.empty(bsz, dtype=torch.int32, device=d.device)
        err = lib.matinv_small_lu(
            d3.data_ptr(), packed.data_ptr(), ok.data_ptr(), bsz, b,
            torch.cuda.current_stream(d.device).cuda_stream)
        cuda_build.check(err, "K5 small_lu")
        if not cuda_build.capturing():   # a graph's record is no launch
            small_lu.launches += 1
        ok = ok != 0
    else:
        raise ValueError(f"K5 runs on cuda (or its twin on cpu), not "
                         f"{d.device}")
    return packed.reshape(d.shape), ok.reshape(d.shape[:-2])


small_lu.launches = 0


# --------------------------------------------------------------------------
# Blocked getrf (lu.py:227-578)
# --------------------------------------------------------------------------


def lu_panel_twin(strip: torch.Tensor, used: torch.Tensor, kb: int, *,
                  b: int, pivot: bool):
    """Factor an (m, b) panel with no-swap partial pivoting (the full-
    precision first max over unused rows), multipliers stored in place
    below the logical diagonal: L3's plain twin. ``used`` (m,) int32 is
    read only. Returns ``(w, pivrows, used, ok)`` with the updated mask.
    ``calls`` counts its calls."""
    lu_panel_twin.calls += 1
    dev = strip.device
    m = strip.shape[0]
    rows = torch.arange(m, device=dev)
    w = strip.clone()
    used = used.clone()
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for r in range(b):
        col = w[:, r].clone()
        # The pivot row as a one-element index: a 0-dim tensor would index
        # as a Python int, read back from the card each step.
        if pivot:
            p = torch.where(used != 0, torch.full_like(col, -1),
                            col.abs()).argmax().view(1)
        else:
            p = torch.full((1,), kb + r, dtype=torch.long, device=dev)
        piv = col[p][0]
        ok &= piv != 0
        eliminable = (used == 0) & (rows != p)
        f = torch.where(eliminable,
                        col / torch.where(piv == 0, torch.ones_like(piv), piv),
                        torch.zeros_like(col))
        used.index_fill_(0, p, 1)
        pivrows[r] = p[0]
        w[:, r + 1:] -= f[:, None] * w[p, r + 1:]
        w[:, r] = torch.where(eliminable, f, w[:, r])
    return w, pivrows, used, ok


lu_panel_twin.calls = 0


def _lu_panel(strip: torch.Tensor, used: torch.Tensor, kb: int, *, b: int,
              pivot: bool):
    """L3 (``csrc/lu_panel.cu``): the blocked getrf's panel for every dtype
    but fp32's kernel route; ``(w, pivrows, used, ok)`` of
    :func:`lu_panel_twin` bit for bit.

    A CPU tensor runs the twin. A CUDA tensor (fp64 or fp32, unit column
    stride) launches L3, one persistent grid on L2's geometry
    (``blocked.logical_geometry``); bf16 and fp16 are computed in fp32 and
    w returned in the input's dtype."""
    m = strip.shape[0]
    if strip.ndim != 2 or strip.shape[1] != b or used.shape != (m,):
        raise ValueError(f"L3 takes an (m, {b}) strip and an (m,) mask, got "
                         f"{tuple(strip.shape)} and {tuple(used.shape)}")
    if strip.device.type == "cpu":
        return lu_panel_twin(strip, used, kb, b=b, pivot=pivot)
    if strip.device.type != "cuda":
        raise ValueError(f"L3 runs on cuda (or its twin on cpu), not "
                         f"{strip.device}")
    if strip.dtype in (torch.bfloat16, torch.float16):
        w, pivrows, used_out, ok = _lu_panel(strip.float(), used, kb, b=b,
                                             pivot=pivot)
        return w.to(strip.dtype), pivrows, used_out, ok
    if strip.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"L3 takes float32 or float64, got {strip.dtype}")
    if strip.stride(1) != 1:
        strip = strip.contiguous()
    dev = strip.device
    geo = logical_geometry(m, b, strip.element_size(),
                           sm_count(_device_index(strip)))
    lib = cuda_build.load()
    used32 = used.to(torch.int32).contiguous()
    w = torch.empty((m, b), dtype=strip.dtype, device=dev)
    used_out = torch.empty(m, dtype=torch.int32, device=dev)
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(1, dtype=torch.int32, device=dev)
    work = (None if geo.rows_shared else
            torch.empty((m, b), dtype=strip.dtype, device=dev))
    props = torch.empty(grid_props_bytes(geo.ctas, b, strip.element_size()),
                        dtype=torch.uint8, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lib.matinv_lu_panel(
        strip.data_ptr(), strip.stride(0), used32.data_ptr(), w.data_ptr(),
        used_out.data_ptr(), pivrows.data_ptr(), ok.data_ptr(),
        None if work is None else work.data_ptr(),
        props.data_ptr(), bar.data_ptr(), m, b, int(kb),
        int(strip.dtype == torch.float64), int(pivot), geo.ctas,
        int(geo.rows_shared), geo.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "L3 lu_panel")
    if not cuda_build.capturing():   # a graph's record is no launch
        _lu_panel.launches += 1
    return w, pivrows, used_out.to(used.dtype), ok[0] != 0


_lu_panel.launches = 0


def _panel_from_kernels(pstrip, used, kb, *, b, pivot, search_bf16):
    """One fp32 panel through K3 and K5 (lu.py:292-331, 438-463): the pivot
    rows, the pivot block's packed LU, the multipliers of every row as
    A_panel @ U11^-1, and the packed panel write-back. Returns
    ``(w, pivrows, l_trunc, l11, ok)``."""
    dev, dtype = pstrip.device, pstrip.dtype
    if pivot:
        search = pstrip.to(torch.bfloat16) if search_bf16 else pstrip
        pivrows = pivot_search(search.t().contiguous(), used)
    else:
        pivrows = torch.arange(kb, kb + b, dtype=torch.int32, device=dev)
    rows = pivrows.long()
    packed, ok = small_lu(pstrip[rows])
    tri_b = torch.ones(b, b, dtype=torch.bool, device=dev).tril(-1)
    l11 = torch.where(tri_b, packed, 0.0) + _eye(b, packed)
    u11 = torch.where(tri_b, 0.0, packed)
    lall = _tri_solve(u11, pstrip, lower=False, left=False)
    l_trunc = _truncate(lall, rows, used)
    # Frozen prior-U rows keep their strip values; this panel's pivot rows
    # get [L11 strictly lower | U11]; unpivoted rows their multipliers.
    w = pstrip * used.to(dtype)[:, None] + l_trunc
    w[rows] += u11
    return w, pivrows, l_trunc, l11, ok


def _truncate(lall: torch.Tensor, rows: torch.Tensor, used: torch.Tensor):
    """The truncated multiplier matrix: L[i, r] is live iff row i was still
    unpivoted at step r and not used before the panel (masks multiplied,
    as the reference does, so non-finite values spread alike)."""
    m, b = lall.shape
    dev, dtype = lall.device, lall.dtype
    order = torch.full((m,), b, dtype=torch.long, device=dev)
    order[rows] = torch.arange(b, device=dev)
    lmask = (order[:, None] > torch.arange(b, device=dev)[None, :])
    return lall * lmask.to(dtype) * (1 - used.to(dtype))[:, None]


def _pad_identity(a: torch.Tensor, m: int) -> torch.Tensor:
    n = a.shape[-1]
    out = _eye(m, a)
    out[:n, :n] = a
    return out


def _lu_factor_blocked_2d(a: torch.Tensor, *, b: int, pivot: bool,
                          use_kernels: bool = False,
                          search_bf16: bool = False):
    """The flat panel loop (lu.py:269-374): one rank-b full-width trailing
    GEMM per panel."""
    n = a.shape[-1]
    m = max(-(-n // b) * b, b)
    dev, dtype = a.device, a.dtype
    lu = _pad_identity(a, m)
    lane_m = torch.arange(m, device=dev)
    tri_b = torch.ones(b, b, dtype=torch.bool, device=dev).tril(-1)
    used = torch.zeros(m, dtype=torch.int32, device=dev)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for kb in range(0, m, b):
        used_before = used.clone()
        strip = lu[:, kb:kb + b].clone()
        if use_kernels:
            w, pivrows, l_trunc, l11, okp = _panel_from_kernels(
                strip, used, kb, b=b, pivot=pivot, search_bf16=search_bf16)
            used.index_fill_(0, pivrows.long(), 1)
        else:
            w, pivrows, used, okp = _lu_panel(strip, used, kb, b=b,
                                              pivot=pivot)
            l_trunc = _truncate(w, pivrows.long(), used_before)
            l11 = torch.where(tri_b, w[pivrows.long()], 0.0) + _eye(b, w)
        ok &= okp
        lu[:, kb:kb + b] = w
        pos[kb:kb + b] = pivrows
        # U rows for the trailing columns: a unit-lower solve against the
        # panel's multiplier block, then one rank-b GEMM.
        u_all = _tri_solve(l11, lu[pivrows.long()], lower=True,
                           unit_diagonal=True)
        u_rest = torch.where(lane_m >= kb + b, u_all, 0.0)
        lu -= l_trunc @ u_rest
    lu = lu[pos.long()][:n, :n]
    ok &= torch.isfinite(lu).all()
    return lu, pos[:n], ok


def _lu_group_sizes(num_panels: int, group: int):
    """Static (first_panel, gsize) schedule: full groups plus one tail."""
    out, k = [], 0
    while k < num_panels:
        g = min(group, num_panels - k)
        out.append((k, g))
        k += g
    return out


def _lu_factor_grouped_2d(a: torch.Tensor, *, b: int, group: int,
                          pivot: bool, search_bf16: bool):
    """Two-level blocked getrf (lu.py:390-515), the fp32 kernel path:
    ``group`` panels factor against the (m, gw) group strip (rank-b updates
    confined to it), then the remaining window gets one rank-gw update. The
    group's U rows come from one unit-lower (gw, gw) solve in pivot order,
    and the order-truncated L writes the pivot rows' own U values in the
    same GEMM."""
    n = a.shape[-1]
    m = max(-(-n // b) * b, b)
    dev, dtype = a.device, a.dtype
    lu = _pad_identity(a, m)
    used = torch.zeros(m, dtype=torch.int32, device=dev)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for k0, gsize in _lu_group_sizes(m // b, group):
        kb0 = k0 * b
        gw = gsize * b
        lane_gw = torch.arange(gw, device=dev)
        used_g0 = used.clone()
        strip = lu[:, kb0:kb0 + gw].clone()
        pivloc = torch.empty(gw, dtype=torch.int32, device=dev)
        for ib in range(0, gw, b):
            w, pivrows, l_trunc, l11, okp = _panel_from_kernels(
                strip[:, ib:ib + b], used, kb0 + ib, b=b, pivot=pivot,
                search_bf16=search_bf16)
            ok &= okp
            strip[:, ib:ib + b] = w
            rows = pivrows.long()
            used.index_fill_(0, rows, 1)
            pivloc[ib:ib + b] = pivrows
            # Internal trailing update, confined to the strip.
            u_all = _tri_solve(l11, strip[rows], lower=True,
                               unit_diagonal=True)
            strip -= l_trunc @ torch.where(lane_gw >= ib + b, u_all, 0.0)
        lu[:, kb0:kb0 + gw] = strip
        pos[kb0:kb0 + gw] = pivloc
        if m - kb0 - gw:
            win = lu[:, kb0 + gw:]
            rows = pivloc.long()
            tri_gw = torch.ones(gw, gw, dtype=torch.bool,
                                device=dev).tril(-1)
            lgg = torch.where(tri_gw, strip[rows], 0.0) + _eye(gw, strip)
            u_rest = _tri_solve(lgg, win[rows], lower=True,
                                unit_diagonal=True)
            win -= _truncate(strip, rows, used_g0) @ u_rest
    lu = lu[pos.long()][:n, :n]
    ok &= torch.isfinite(lu).all()
    return lu, pos[:n], ok


@compiled
@_fp32_gemms
def lu_factor_blocked(a: torch.Tensor, *, pivot: bool = True,
                      block_size: int = 128):
    """Blocked getrf; ``(lu, perm, ok)`` as :func:`lu_factor`.

    fp32 panels take K3 and K5, two-level grouped (``MATINV_LU_GROUP``,
    read per call, overrides the panels per group; 1 is the flat per-panel
    loop); other dtypes run the panel loop of kernel L3 (:func:`_lu_panel`).
    A batch loops one matrix at a time."""
    _check_square(a)
    n = a.shape[-1]
    b, use_kernels, search_bf16 = _select_block_params(
        n, min(block_size, max(n, 8)), a.dtype, False)
    use_kernels = use_kernels and a.dtype == torch.float32
    if use_kernels:
        group = (int(os.environ.get("MATINV_LU_GROUP", 0))
                 or _default_group_size(b))
        if group > 1:
            fn = functools.partial(_lu_factor_grouped_2d, b=b, group=group,
                                   pivot=pivot, search_bf16=search_bf16)
        else:
            fn = functools.partial(_lu_factor_blocked_2d, b=b, pivot=pivot,
                                   use_kernels=True, search_bf16=search_bf16)
    else:
        fn = functools.partial(_lu_factor_blocked_2d, b=b, pivot=pivot)
    outs = [fn(one) for one in a.reshape(-1, n, n)]
    lu, perm, ok = (torch.stack(t) for t in zip(*outs))
    return (lu.reshape(a.shape), perm.reshape(a.shape[:-1]),
            ok.reshape(a.shape[:-2]))


def _lu_mats(lu: torch.Tensor):
    """(unit-lower L, U) unpacked from a packed factor."""
    n = lu.shape[-1]
    tri = torch.ones(n, n, dtype=torch.bool, device=lu.device).tril(-1)
    return (torch.where(tri, lu, 0.0) + _eye(n, lu),
            torch.where(tri, 0.0, lu))


@compiled
@_fp32_gemms
def lu_solve_fast(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor):
    """Blocked getrs through the library's triangular solves (the fast
    path; :func:`lu_solve` is the spec). Returns ``(x, ok)``."""
    lmat, umat = _lu_mats(lu)
    y = torch.take_along_dim(b, perm.long()[..., None], dim=-2)
    y = _tri_solve(lmat, y, lower=True, unit_diagonal=True)
    x = _tri_solve(umat, y, lower=False)
    diag = torch.diagonal(umat, dim1=-2, dim2=-1)
    ok = (diag != 0).all(dim=-1) & torch.isfinite(x).all(dim=(-2, -1))
    return x, ok


# --------------------------------------------------------------------------
# Blocked triangular inversion (trtri) and getri (lu.py:612-959)
# --------------------------------------------------------------------------


def _trtri_default_b(n: int) -> int:
    """Base block of the bisection (lu.py:612-617): 1024 from n = 2048."""
    return 1024 if n >= 2048 else 256


def _tri_mm_chunks(s: int) -> int:
    """Cross-GEMM chunking factor (lu.py:620-626): 4 strips from s = 512,
    which cuts a dense (s, s) product against a triangular factor to
    0.625 of its MACs."""
    return 4 if s >= 512 else 1


def _trtri_blocked_2d(t: torch.Tensor, *, lower: bool, unit_diagonal: bool,
                      b: int | None = None, canvas: bool = True):
    """Inverse of an (n, n) triangular matrix by block bisection
    (lu.py:629-757): X = [[X11, 0], [-X22 T21 X11, X22]] (lower; mirrored
    for upper), level by level from base blocks of the adaptive size
    ``base`` (n padded to base * 2^levels with identity). ``canvas`` writes
    each level's cross blocks in place on an (m, m) canvas; the batched
    form rebuilds the blocks by concatenation."""
    n = t.shape[-1]
    if b is None:
        b = _trtri_default_b(n)
    if n <= b:
        return _tri_solve(t, _eye(n, t), lower=lower,
                          unit_diagonal=unit_diagonal)
    levels = max((-(-n // b) - 1).bit_length(), 0)
    base = -(-n // (1 << levels))
    base = -(-base // 8) * 8
    m = base * (1 << levels)
    b = base
    if m != n:
        t = _pad_identity(t, m)
    nb = m // b
    diag = torch.stack([t[i * b:(i + 1) * b, i * b:(i + 1) * b]
                        for i in range(nb)])
    x = _tri_solve(diag, _eye(b, t).expand(nb, b, b), lower=lower,
                   unit_diagonal=unit_diagonal)

    def tri_mm_right(y, xt):
        # y @ xt with xt triangular: column strip J of the result only
        # touches xt's nonzero rows for those columns.
        s = xt.shape[-1]
        ch = _tri_mm_chunks(s)
        if ch == 1:
            return y @ xt
        cw = s // ch
        cols = []
        for j0 in range(0, s, cw):
            if lower:   # xt lower: rows >= j0 in columns [j0, j0+cw)
                cols.append(y[..., :, j0:] @ xt[..., j0:, j0:j0 + cw])
            else:       # xt upper: rows < j0+cw
                cols.append(y[..., :, :j0 + cw] @ xt[..., :j0 + cw,
                                                     j0:j0 + cw])
        return torch.cat(cols, dim=-1)

    def tri_mm_left(xt, y):
        # xt @ y with xt triangular: row strip I of the result only
        # touches xt's nonzero columns in those rows.
        s = xt.shape[-2]
        ch = _tri_mm_chunks(s)
        if ch == 1:
            return xt @ y
        cw = s // ch
        rows = []
        for i0 in range(0, s, cw):
            if lower:   # xt lower: columns < i0+cw in rows [i0, i0+cw)
                rows.append(xt[..., i0:i0 + cw, :i0 + cw]
                            @ y[..., :i0 + cw, :])
            else:       # xt upper: columns >= i0
                rows.append(xt[..., i0:i0 + cw, i0:] @ y[..., i0:, :])
        return torch.cat(rows, dim=-2)

    if canvas:
        xc = torch.zeros((m, m), dtype=t.dtype, device=t.device)
        for i in range(nb):
            xc[i * b:(i + 1) * b, i * b:(i + 1) * b] = x[i]
        for level in range(levels):
            s = b << level
            for r0 in range(0, m, 2 * s):
                x11 = xc[r0:r0 + s, r0:r0 + s]
                x22 = xc[r0 + s:r0 + 2 * s, r0 + s:r0 + 2 * s]
                if lower:
                    off = t[r0 + s:r0 + 2 * s, r0:r0 + s]
                    xc[r0 + s:r0 + 2 * s, r0:r0 + s] = -tri_mm_left(
                        x22, tri_mm_right(off, x11))
                else:
                    off = t[r0:r0 + s, r0 + s:r0 + 2 * s]
                    xc[r0:r0 + s, r0 + s:r0 + 2 * s] = -tri_mm_left(
                        x11, tri_mm_right(off, x22))
        return xc[:n, :n]

    for level in range(levels):
        s = b << level
        npairs = m // (2 * s)
        tb = t.reshape(npairs, 2 * s, npairs, 2 * s)
        if lower:
            off = torch.stack([tb[p, s:, p, :s] for p in range(npairs)])
        else:
            off = torch.stack([tb[p, :s, p, s:] for p in range(npairs)])
        x11, x22 = x[0::2], x[1::2]
        if lower:
            cross = -tri_mm_left(x22, tri_mm_right(off, x11))
            top = torch.cat([x11, torch.zeros_like(cross)], dim=-1)
            bot = torch.cat([cross, x22], dim=-1)
        else:
            cross = -tri_mm_left(x11, tri_mm_right(off, x22))
            top = torch.cat([x11, cross], dim=-1)
            bot = torch.cat([torch.zeros_like(cross), x22], dim=-1)
        x = torch.cat([top, bot], dim=-2)
    return x[0][:n, :n]


@compiled
@_fp32_gemms
def invert_triangular(t: torch.Tensor, *, lower: bool = True,
                      unit_diagonal: bool = False, b: int | None = None,
                      canvas: bool = True):
    """trtri: explicit inverse of a triangular matrix, batched over leading
    axes; returns ``(inverse, ok)``, ok False on a zero diagonal or any
    non-finite output. The off-triangle of ``t`` is ignored; ``b``
    overrides the default base block (``_trtri_default_b``)."""
    _check_square(t)
    n = t.shape[-1]
    keep = torch.ones(n, n, dtype=torch.bool, device=t.device)
    keep = keep.tril(-1) if lower else keep.triu(1)
    diag = torch.diagonal(t, dim1=-2, dim2=-1)
    dvals = torch.ones_like(diag) if unit_diagonal else diag
    tc = torch.where(keep, t, 0.0) + _eye(n, t) * dvals[..., None, :]
    out = torch.stack([
        _trtri_blocked_2d(one, lower=lower, unit_diagonal=unit_diagonal,
                          b=b, canvas=canvas)
        for one in tc.reshape(-1, n, n)]).reshape(t.shape)
    ok = (dvals != 0).all(dim=-1) & torch.isfinite(out).all(dim=(-2, -1))
    return out, ok


def _getri_product(left: torch.Tensor, linv: torch.Tensor, *,
                   chunk: int = 512, left_transposed: bool = False,
                   left_triangular: bool = False, rchunk: int = 512):
    """``left @ linv`` exploiting ``linv``'s lower triangularity
    (lu.py:792-857): column chunk J multiplies only the rows of ``linv`` at
    or below its start. ``left_transposed`` computes ``left.T @ linv``;
    ``left_triangular`` also uses that ``left`` (after the optional
    transpose) is upper triangular, tiling (I, J) with contraction from
    max(i0, j0) (~n^3/3 MACs). Batched over leading axes."""
    n = linv.shape[-1]

    def lhs(rows, ks):
        if left_transposed:
            return left[..., ks, rows].transpose(-1, -2)
        return left[..., rows, ks]

    if left_triangular:
        out = []
        for i0 in range(0, n, rchunk):
            rows = slice(i0, i0 + rchunk)
            out.append(torch.cat([
                lhs(rows, slice(max(i0, j0), None))
                @ linv[..., max(i0, j0):, j0:j0 + chunk]
                for j0 in range(0, n, chunk)], dim=-1))
        return torch.cat(out, dim=-2)
    return torch.cat([lhs(slice(None), slice(j0, None))
                      @ linv[..., j0:, j0:j0 + chunk]
                      for j0 in range(0, n, chunk)], dim=-1)


def _lu_inverse_trtri(a: torch.Tensor):
    """getri via trtri (lu.py:860-884): A^-1 = U^-1 L^-1 P, the
    permutation applied as one final column gather."""
    n = a.shape[-1]
    lu, perm, ok_f = lu_factor_blocked(a)
    linv, ok_l = invert_triangular(lu, lower=True, unit_diagonal=True)
    uinv, ok_u = invert_triangular(lu, lower=False, unit_diagonal=False)
    prod = _getri_product(uinv, linv, left_triangular=True)
    # (P x)[i] = x[perm[i]], so column j of the inverse is column
    # invperm[j] of the product.
    invperm = torch.empty_like(perm)
    invperm[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    inv = prod[:, invperm]
    return inv, ok_f & ok_l & ok_u & torch.isfinite(inv).all()


# From this order the solve route of getri solves the identity in column
# chunks (lu.py:887-894). The reference set it by a TPU's HBM; it is kept
# so that both packages take the same route.
GETRI_CHUNK_MIN_N = 8192 + 1


def _lu_inverse_chunked(lu: torch.Tensor, perm: torch.Tensor, *,
                        chunk: int):
    """getri solve with the identity right-hand side ``chunk`` columns at a
    time (lu.py:897-927); the permuted identity chunk is built as the
    one-hot ``perm[i] == j0 + jj``."""
    n = lu.shape[-1]
    lmat, umat = _lu_mats(lu)
    lane = torch.arange(chunk, device=lu.device)
    out = torch.empty((n, n), dtype=lu.dtype, device=lu.device)
    for j0 in range(0, n, chunk):
        y = (perm[:, None] == j0 + lane[None, :]).to(lu.dtype)
        y = _tri_solve(lmat, y, lower=True, unit_diagonal=True)
        x = _tri_solve(umat, y, lower=False)
        out[:, j0:j0 + chunk] = x[:, :min(chunk, n - j0)]
    ok = (torch.diagonal(umat) != 0).all() & torch.isfinite(out).all()
    return out, ok


@compiled
@_fp32_gemms
def lu_inverse_fast(a: torch.Tensor, *, chunk: int = 2048):
    """Blocked getri; returns ``(inverse, ok)`` (lu.py:930-959).

    Single matrices take the trtri composition A^-1 = U^-1 L^-1 P; batches
    take the solve route. ``MATINV_GETRI_ROUTE=solve`` (read per call)
    forces the solve route for single matrices, with the identity chunked
    from :data:`GETRI_CHUNK_MIN_N`."""
    _check_square(a)
    n = a.shape[-1]
    route = os.environ.get("MATINV_GETRI_ROUTE", "trtri")
    if a.ndim == 2 and route != "solve":
        return _lu_inverse_trtri(a)
    lu, perm, ok_f = lu_factor_blocked(a)
    if a.ndim == 2 and n >= GETRI_CHUNK_MIN_N:
        inv, ok_s = _lu_inverse_chunked(lu, perm, chunk=min(chunk, n))
    else:
        inv, ok_s = lu_solve_fast(lu, perm, _eye(n, a).expand(a.shape))
    return inv, ok_f & ok_s


# --------------------------------------------------------------------------
# Scheduled-flop models (lu.py:973-1039): the MACs the functions above
# issue, 2 flops each; triangular solves at ~k^2/2 MACs per column.
# --------------------------------------------------------------------------


def _trtri_effective_flops(n: int, b: int | None = None) -> int:
    """Flops one :func:`_trtri_blocked_2d` call schedules (one triangle)."""
    if b is None:
        b = _trtri_default_b(n)
    if n <= b:
        return n**3  # triangular solve vs I: ~n^3/2 MACs
    levels = max((-(-n // b) - 1).bit_length(), 0)
    base = -(-n // (1 << levels))
    base = -(-base // 8) * 8
    m = base * (1 << levels)
    fl = (m // base) * base**3  # batched diagonal-block solves vs I
    for level in range(levels):
        s = base << level
        npairs = m // (2 * s)
        mult = (1 + 1 / _tri_mm_chunks(s)) / 2  # 0.625 chunked, 1.0 dense
        # two chunked (s, s) cross products per pair (right then left)
        fl += npairs * 2 * int(2 * mult * s**3)
    return fl


def _getri_product_flops(n: int, chunk: int = 512,
                         left_triangular: bool = False,
                         rchunk: int = 512) -> int:
    """Flops of :func:`_getri_product`'s chunks (mirrors its tiling)."""
    fl = 0
    if left_triangular:
        for i0 in range(0, n, rchunk):
            r = min(rchunk, n - i0)
            for j0 in range(0, n, chunk):
                c = min(chunk, n - j0)
                fl += 2 * r * c * (n - max(i0, j0))
        return fl
    for j0 in range(0, n, chunk):
        fl += 2 * n * (n - j0) * min(chunk, n - j0)
    return fl


def getrf_effective_flops(n: int, *, block_size: int = 128) -> int:
    """Flops :func:`lu_factor_blocked`'s grouped fp32 path schedules."""
    b, _, _ = _select_block_params(n, min(block_size, max(n, 8)),
                                   torch.float32, False)
    group = (int(os.environ.get("MATINV_LU_GROUP", 0))
             or _default_group_size(b))
    m = max(-(-n // b) * b, b)
    fl = 0
    for k0, gsize in _lu_group_sizes(m // b, group):
        gw = gsize * b
        rest = m - k0 * b - gw
        # Per panel: lall solve (m, b) + psel @ u11 + u_all (b, gw) solve
        # + rank-b strip GEMM + the search kernel's deferred dots (~m*b^2).
        fl += gsize * (m * b * b + 2 * m * b * b + b * b * gw
                       + 2 * m * b * gw + 2 * m * b * b)
        if rest:
            fl += gw * gw * rest       # u_rest unit-lower solve
            fl += 2 * m * gw * rest    # rank-gw window update
    return fl


def getri_effective_flops(n: int) -> int:
    """Flops the default trtri-route getri (:func:`lu_inverse_fast`)
    schedules: grouped getrf + the L/U trtri pair + the product."""
    return (getrf_effective_flops(n) + 2 * _trtri_effective_flops(n)
            + _getri_product_flops(n, left_triangular=True))


# --------------------------------------------------------------------------
# Diagnostics (lu.py:1042-1110)
# --------------------------------------------------------------------------


@_fp32_gemms
def cond_estimate(a: torch.Tensor, inv: torch.Tensor, *, iters: int = 8,
                  seed: int = 0):
    """Estimate the 2-norm condition number from a matrix and its inverse:
    power iteration on A^T A and inv^T inv estimates ||A||_2 and
    ||A^-1||_2. The start vector is drawn from a ``torch.Generator``
    seeded with ``seed`` (other numbers than the reference's
    ``jax.random`` key; the estimate converges to the same value)."""
    n = a.shape[-1]

    def spectral_norm(mat):
        gen = torch.Generator(device=mat.device).manual_seed(seed)
        v = torch.randn(mat.shape[:-2] + (n, 1), generator=gen,
                        dtype=mat.dtype, device=mat.device)
        for _ in range(iters):
            v = mat.transpose(-1, -2) @ (mat @ v)
            norm = torch.sqrt((v * v).sum(dim=(-2, -1), keepdim=True))
            v = v / torch.where(norm == 0, torch.ones_like(norm), norm)
        av = mat @ v
        return torch.sqrt((av * av).sum(dim=(-2, -1)))

    return spectral_norm(a) * spectral_norm(inv)


@compiled
def slogdet(a: torch.Tensor):
    """Sign and log-absolute-determinant from the LU factorization
    (``numpy.linalg.slogdet``'s contract); returns ``(sign, logabsdet,
    ok)``, batched over leading axes. det(A) = sign(P) prod(diag(U)); the
    permutation's sign is the parity of its inversion count. Exactly
    singular input gives sign 0, logabsdet -inf and ok False."""
    _check_square(a)
    n = a.shape[-1]
    if n >= 256:
        lu, perm, ok = lu_factor_blocked(a)
    else:
        lu, perm, ok = lu_factor(a)
    diag = torch.diagonal(lu, dim1=-2, dim2=-1)
    lt = torch.ones(n, n, dtype=torch.bool, device=a.device).triu(1)
    inversions = (lt & (perm[..., :, None] > perm[..., None, :])).sum(
        dim=(-2, -1))
    sign_perm = 1.0 - 2.0 * (inversions % 2).to(a.dtype)
    sign = sign_perm * torch.sign(diag).prod(dim=-1)
    logabs = torch.log(diag.abs()).sum(dim=-1)
    return sign, logabs, ok


def det(a: torch.Tensor):
    """Determinant via :func:`slogdet` (overflows to +-inf where
    ``numpy.linalg.det`` does); returns ``(det, ok)``."""
    sign, logabs, ok = slogdet(a)
    return sign * torch.exp(logabs), ok
