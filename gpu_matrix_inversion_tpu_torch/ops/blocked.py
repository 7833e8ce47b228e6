"""Blocked right-looking Gauss-Jordan: panel kernels plus GEMM updates.

Port of ``gpu_matrix_inversion_tpu/ops/blocked.py``, the large-N route. The
reference's ``fixColumnKernel`` performs the O(N^2) rank-1 trailing update
once per iteration, N times (``matrix_inversion_FP32.cpp:17-63``). Here the
same elimination is regrouped panel by panel:

1. *Panel factorization*: the pivot rows of the (m, b) strip and the
   panel's composite transform C^T, such that X + C @ X[pivrows] eliminates
   the panel from any columns X and deposits its scaled pivot rows. Four
   routes, chosen as the reference chooses them (``_factor_panel``):

   - fp32 within ``_emit_fused``: kernel K2 (``csrc/panel_factor.cu``)
     emits both in one launch;
   - fp32 past it (n > 16384, or ``search_bf16=True``), the split path:
     kernel K3 (K2's steps, on an fp32 or bf16 strip) gives the pivot
     rows, kernel K4 (``csrc/small_inv.cu``) inverts the (b, b) pivot
     block, and one GEMM assembles C from it;
   - fp64 where the f32 search reaches (b*m <= 128*8192), the f32-search
     tier: K3 on the strip cast to fp32, the pivot block inverted in fp64
     by kernel L1 (``csrc/gauss_jordan.cu``, the spec's loop);
   - everything else (fp64 past that, fp64 without pivoting, fp32 past
     m = 65536): the logical panel, which the reference runs as a
     device-side loop without a Pallas kernel: kernel L2
     (``csrc/logical_panel.cu``) finds the pivot rows, L1 inverts the
     pivot block.
2. *Group composites*: ``group`` consecutive panels are factored against an
   [O | G] working set (O = the group's columns, G = identity-probe columns
   injected panel by panel); afterwards G - E^T is the group's composite
   transform, applied to the live window in ONE rank-(group*b) GEMM.
3. *Logical permutation*: rows never move. The windowed pivot-order slot
   layout keeps the live columns one contiguous window of width m - gw, so
   the trailing GEMMs touch half the columns of the classic [A | I] layout,
   and two gathers at the very end put the inverse in order.

The GEMMs (the outer rank-gw update, the internal rank-b panel updates and
the split path's C assembly) are products the JAX package leaves to XLA
outside any Pallas kernel; here they are library GEMMs (see :func:`_mm` for
their precision). What the reference runs only to steer XLA:TPU and Mosaic
(optimization barriers, x64 scopes, the v1/v2 kernel split, group-loop
unrolling, the (8, m) used tile, interpret mode) has no counterpart.
A batch loops one matrix at a time, unless the opt-in lockstep route
(``MATINV_LOCKSTEP=1``, ``ops/lockstep.py``, kernel K6) takes it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gpu_matrix_inversion_tpu_torch.ops.fused import (H100_SMS,
                                                      SHARED_BYTES, _fms,
                                                      _packed_argmax,
                                                      _round_up)
from gpu_matrix_inversion_tpu_torch.ops.gauss_jordan import (
    LoopGeometry, _gauss_jordan_aug, grid_geometry, grid_props_bytes,
    sm_count)
from gpu_matrix_inversion_tpu_torch.ops.refine import newton_schulz_refine
from gpu_matrix_inversion_tpu_torch.utils import cuda_build
from gpu_matrix_inversion_tpu_torch.utils.graphs import compiled
from gpu_matrix_inversion_tpu_torch.utils.precision import (PRECISIONS,
                                                            matmul_precision)
from gpu_matrix_inversion_tpu_torch.utils.profiling import phase

DEFAULT_BLOCK_SIZE = 256
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# --------------------------------------------------------------------------
# Geometry: copies of the JAX package's functions, so both packages pick the
# same b, group, sub and kmask for the same n (tests pin the equality).
# --------------------------------------------------------------------------


def _factor_geometry(m: int, b: int):
    """(sub, kmask) for the panel kernel: sub = 16 walked down to a divisor
    of b (a non-divisor would skip the last b % sub pivots), kmask =
    next_pow2(m) - 1. The reference's ``MATINV_FACTOR_SUB`` experiment knob
    is not carried over."""
    sub = min(16, b)
    while b % sub:
        sub -= 1
    kmask = 1
    while kmask < m:
        kmask = 2 * kmask
    return sub, kmask - 1


def _emit_fused(m: int, b: int, use_kernels: bool, search_bf16: bool) -> bool:
    """Where the fused panel-factor kernel serves (blocked.py:447-458):
    b*m <= 128*8192, fp32 search. Past it the split search + small-inverse
    path (K3 + K4) takes over: a bf16 C^T would put ~1e-3 into every
    value-carrying GEMM, not just the pivot choice."""
    return use_kernels and not search_bf16 and b * m <= 128 * 8192


def _default_group_size(b: int, num_panels: int | None = None) -> int:
    """Panels per composite group (blocked.py:461-496): composite width
    gw ~ 1536 without a panel count, gw = 1024 with one, preferring a
    group that divides the panel count at m <= 8192."""
    bb = min(b, 128)
    if num_panels is None:
        return max(4, 1536 // bb)
    m = num_panels * b
    target_gw = 1024
    target = max(4, target_gw // bb)
    if num_panels <= target or m > 8192:
        return target
    divisors = [g for g in range(max(4, target // 2),
                                 min(num_panels, 2 * target) + 1)
                if num_panels % g == 0]
    return min(divisors, key=lambda g: abs(g - target), default=target)


def _select_block_params(n: int, block_size: int, dtype,
                         search_bf16: bool):
    """Size gating (blocked.py:842-878); returns (b, use_kernels,
    search_bf16). fp32 keeps b = 128 to m = 8192 and b = 64 to m = 16384;
    past that the search runs on bf16 strips, b = 32 from m = 32768, and
    past m = 65536 the plain logical panel takes over (the reference warns
    there; this port does not)."""
    b = min(block_size, max(_round_up(n, 8), 8))
    use_kernels = dtype in _KERNEL_DTYPES
    if not use_kernels:
        return b, False, False
    b = min(b, 128)
    m = max(_round_up(n, b), b)
    if m > 8192:
        b = min(b, 128 if search_bf16 else 64)
        m = max(_round_up(n, b), b)
    if m > 16384:
        search_bf16 = True
        b = min(b, 64)
        m = max(_round_up(n, b), b)
    if m > 32768:
        b = min(b, 32)
        m = max(_round_up(n, b), b)
    if m > 65536:
        use_kernels = False
    return b, use_kernels, search_bf16


def _gemm_flops(n: int, block_size: int, search_bf16: bool,
                group_size: int | None, dtype, first_dot: bool) -> int:
    b, _, search_bf16 = _select_block_params(n, block_size, dtype,
                                             search_bf16)
    m = max(_round_up(n, b), b)
    num_panels = m // b
    if group_size is None:
        group_size = _default_group_size(b, num_panels)
    group = max(1, min(group_size, num_panels))
    num_groups = num_panels // group
    tail = num_panels - num_groups * group
    sub, _ = _factor_geometry(m, b)
    emit = _emit_fused(m, b, True, search_bf16)
    dots = 2 if first_dot else 1
    fl = 0
    for gsize in [group] * num_groups + ([tail] if tail else []):
        gw = gsize * b
        fl += 2 * m * gw * (m - gw)        # outer composite rank-gw GEMM
        fl += gsize * 2 * m * b * (gw + b)  # internal rank-b panel updates
        fl += gsize * (b // sub) * dots * (2 * b * sub * m)  # deferred dots
        if not emit:
            fl += gsize * 2 * m * b * b     # split-path cmat assembly
    return fl


def effective_gemm_flops(n: int, *, block_size: int = DEFAULT_BLOCK_SIZE,
                         search_bf16: bool = False,
                         group_size: int | None = None,
                         dtype=torch.float32) -> int:
    """Flops the windowed blocked algorithm schedules for one inversion as
    the JAX package counts them (blocked.py:1072-1116), equal to its
    function: the outer composite GEMMs, the internal rank-b panel updates
    and the panel kernels' two deferred dots a sub-panel. The panel kernels
    here compute the first dot as a gather: :func:`scheduled_gemm_flops`
    counts what the card runs."""
    return _gemm_flops(n, block_size, search_bf16, group_size, dtype, True)


def scheduled_gemm_flops(n: int, *, block_size: int = DEFAULT_BLOCK_SIZE,
                         search_bf16: bool = False,
                         group_size: int | None = None,
                         dtype=torch.float32) -> int:
    """Flops this port's blocked inversion schedules on the card: those of
    :func:`effective_gemm_flops` but the first deferred dot (rows @ psel^T,
    a contraction against one-hot rows, which K2 and K3 compute as a
    gather of each row's values at the sub-panel's pivot lanes), 2 b m^2
    fewer. A ``benchmark`` cell that reports an achieved rate
    (``*_gflops_effective``, ``*_mfu``) uses this count; the effective
    count is only for comparison with the JAX package's records."""
    return _gemm_flops(n, block_size, search_bf16, group_size, dtype, False)


# --------------------------------------------------------------------------
# K2 and K3: the panel kernels
# --------------------------------------------------------------------------


def _panel_twin(stripT: torch.Tensor, kb: int, used: torch.Tensor, *,
                pivot: bool, emit_ct: bool):
    """Plain PyTorch twin of K2 (``emit_ct``) and K3: same steps, same
    pivot rule, on the input's device.

    An fp32 strip rounds as the kernels' fmaf does; a bf16 strip computes
    in fp32 and rounds every operation to bf16, as the TPU kernel's bf16
    code does under XLA's CPU backend (values are held in fp32 tensors
    that carry bf16 values). The deferred second dot is a ``torch.matmul``,
    so its summation order (and only that) differs from the kernels' FMA
    loop. Returns ``(pivrows, ct, ok)`` with ``emit_ct``, else ``pivrows``.
    """
    b, m = stripT.shape
    dev = stripT.device
    sub, kmask = _factor_geometry(m, b)
    if stripT.dtype == torch.float32:
        def rnd(x):
            return x

        def elim(x, n, f):
            return _fms(x, n, f)
    else:
        def rnd(x):
            return x.to(stripT.dtype).float()

        def elim(x, n, f):
            return rnd(x - rnd(n * f))
    # The output doubles as the working buffer.
    ct = stripT.to(torch.float32, copy=True)
    used = used != 0             # a local copy: the caller owns the mask
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    zeros = torch.zeros((sub, m), dtype=torch.float32, device=dev)
    for r0 in range(0, b, sub):
        # Merged working set: the sub-panel's strip rows, then its probe.
        wp = torch.cat([ct[r0:r0 + sub], zeros])
        col = ct[r0].clone()
        for r2 in range(sub):
            if pivot:
                p = _packed_argmax(col, used, kmask)
            else:
                p = torch.tensor(kb + r0 + r2, device=dev)
            used[p] = True
            pivrows[r0 + r2] = p
            pivcol = wp[:, p].clone()
            # The probe's identity one-hot.
            pivcol[sub + r2] = rnd(pivcol[sub + r2] + 1.0)
            pv = pivcol[r2]
            ok &= pv != 0
            norm = rnd(pivcol / torch.where(pv == 0, torch.ones_like(pv), pv))
            factors = col.clone()
            factors[p] = 0.0
            wp = elim(wp, norm[:, None], factors[None, :])
            wp[:, p] = norm
            col = wp[r2 + 1].clone()
        lanes = pivrows[r0:r0 + sub].long()
        ctl = wp[sub:].clone()
        diag = torch.arange(sub, device=dev)
        ctl[diag, lanes] = rnd(ctl[diag, lanes] - 1.0)      # probe - psel
        rest = torch.arange(r0 + sub, b, device=dev)
        if emit_ct:
            rest = torch.cat([torch.arange(0, r0, device=dev), rest])
        if rest.numel():
            # Deferred rank-sub update: rows @ psel^T picks the rows'
            # values at the pivot lanes; then rows += g @ C_l^T in FP32.
            x = ct[rest]
            with matmul_precision("highest"):
                ct[rest] = rnd(x + rnd(x[:, lanes] @ ctl))
        if emit_ct:
            ct[r0:r0 + sub] = ctl
    if not emit_ct:
        return pivrows
    ok &= torch.isfinite(ct).all()
    return pivrows, ct, ok


def panel_factor_twin(stripT: torch.Tensor, kb: int, used: torch.Tensor, *,
                      pivot: bool):
    """Plain twin of K2: ``(pivrows (b,) int32, ct (b, m) fp32, ok)``."""
    return _panel_twin(stripT, kb, used, pivot=pivot, emit_ct=True)


def pivot_search_twin(stripT: torch.Tensor, used: torch.Tensor):
    """Plain twin of K3: the (b,) int32 pivot rows."""
    return _panel_twin(stripT, 0, used, pivot=True, emit_ct=False)


def _check_panel_inputs(name: str, stripT: torch.Tensor, used: torch.Tensor,
                        dtypes) -> None:
    if stripT.ndim != 2 or stripT.dtype not in dtypes:
        raise TypeError(f"{name} takes a (b, m) {'/'.join(map(str, dtypes))}"
                        f" strip, got {tuple(stripT.shape)} {stripT.dtype}")
    m = stripT.shape[1]
    if used.shape != (m,) or used.dtype != torch.int32:
        raise TypeError(f"{name} takes an ({m},) int32 used mask, got "
                        f"{tuple(used.shape)} {used.dtype}")
    if used.device != stripT.device:
        raise ValueError("strip and used mask must share a device")
    if not (stripT.is_contiguous() and used.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    if stripT.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda (or its twin on cpu), not "
                         f"{stripT.device}")


# The cluster geometry of K2 and K3 (``cluster_body`` in
# ``csrc/panel_factor.cu``, which checks what it is given).
MAX_CLUSTER = 16          # CTAs; past 8 the runtime's non-portable size
_PORTABLE_CLUSTER = 8
_SLOTS = 16               # kMaxCluster: a CTA holds a slot for each CTA
_MIN_LANES = 128          # a smaller m takes fewer CTAs
_CLUSTER_THREADS = 512
_ONE_CTA_PER_SM = 120 * 1024   # two such CTAs exceed one SM's 228 KiB
_SLOT_BYTES = 4 * (2 * 16 + 4)  # one CTA's published column and key


@dataclasses.dataclass(frozen=True)
class PanelCluster:
    """How K2 or K3 runs one (m, b) panel: ``cluster`` CTAs, CTA r owning
    lanes [r*lanes, (r+1)*lanes) of m, ``threads`` threads each, and
    ``smem`` bytes of shared memory a CTA, which holds its slice of the
    working set wp (2*sub, lanes) if ``wp_shared`` and of the strip rows
    (b, lanes) if ``rows_shared`` (else each stays in global memory)."""
    cluster: int
    lanes: int
    threads: int
    wp_shared: bool
    rows_shared: bool
    smem: int


def cluster_geometry(m: int, b: int, sub: int, elt: int,
                     max_cluster: int = MAX_CLUSTER) -> PanelCluster:
    """The per-CTA geometry of K2 and K3 for an (m, b) panel of ``elt``-byte
    values, at most ``max_cluster`` CTAs.

    C = max_cluster, cut so that every CTA keeps at least 128 lanes
    (C = max(1, min(max_cluster, m // 128))); L = ceil(m / C), so no CTA is
    empty. Threads: L rounded up to a warp, at most 512. A CTA's shared
    memory (``cluster_smem_bytes`` in the source) always holds the gathered
    pivot-lane values ((b - sub) rows of sub floats padded to a float4), a
    slot for each of 16 CTAs and two step parities, two mbarriers, each
    warp's normalized column, lanes, scratch and the used flags (L bytes);
    then wp where it fits, then the strip rows where they fit beside it.
    Each CTA asks at least 120 KiB, so no two share an SM. Raises ``ValueError`` where even the fixed part does
    not fit one CTA's 232,448 bytes (m past ~3.6 million at C = 16).
    """
    c = max(1, min(max_cluster, m // _MIN_LANES))
    lanes = -(-m // c)
    threads = min(_CLUSTER_THREADS, _round_up(lanes, 32))
    # g, slots, mbarriers, the warps' normalized columns, lanes + scratch +
    # flag, used flags.
    base = (_round_up((b - sub) * _round_up(sub, 4) * 4, 16)
            + 2 * _SLOTS * _SLOT_BYTES + 2 * 8
            + (_CLUSTER_THREADS // 32) * 32 * 4 + (16 + 32 + 4) * 4 + lanes)
    wp = _round_up(2 * sub * lanes * elt, 16)
    rows = _round_up(b * lanes * elt, 16)
    wp_shared = base + wp <= SHARED_BYTES
    rows_shared = wp_shared and base + wp + rows <= SHARED_BYTES
    need = base + wp * wp_shared + rows * rows_shared
    if need > SHARED_BYTES:
        raise ValueError(f"the panel kernels at m={m}, b={b} need {need} "
                         f"bytes of shared memory a CTA, more than "
                         f"{SHARED_BYTES}")
    return PanelCluster(c, lanes, threads, wp_shared, rows_shared,
                        max(need, _ONE_CTA_PER_SM))


_plans: dict = {}


def cluster_plan(kind: int, m: int, b: int, sub: int):
    """``(geometry, clusters)``: the :class:`PanelCluster` K2 (``kind`` 0)
    or K3 (1 on fp32, 2 on bf16) launches with on the current card, and how
    many such clusters it holds at once (``cudaOccupancyMaxActiveClusters``).
    C is ``MAX_CLUSTER`` where the runtime admits one cluster of it, else
    the portable 8; raises ``RuntimeError`` where neither is admitted (no
    launch then falls back to anything else)."""
    key = (kind, m, b, sub, MAX_CLUSTER, torch.cuda.current_device())
    if key not in _plans:
        lib = cuda_build.load()
        tried = []
        for cmax in dict.fromkeys((MAX_CLUSTER,
                                   min(MAX_CLUSTER, _PORTABLE_CLUSTER))):
            geo = cluster_geometry(m, b, sub, 2 if kind == 2 else 4, cmax)
            count = ctypes.c_int(0)
            err = lib.matinv_panel_clusters(
                kind, m, b, sub, geo.cluster, geo.threads,
                int(geo.wp_shared), int(geo.rows_shared), geo.smem,
                ctypes.addressof(count))
            tried.append((geo.cluster, err, count.value))
            if err == 0 and count.value >= 1:
                _plans[key] = (geo, count.value)
                break
        else:
            raise RuntimeError(f"the card admits no cluster for the panel "
                               f"kernel {kind} at m={m}, b={b} ((CTAs, "
                               f"CUDA error, clusters) tried: {tried})")
    return _plans[key]


def panel_factor(stripT: torch.Tensor, kb: int, used: torch.Tensor, *,
                 pivot: bool):
    """K2 (``csrc/panel_factor.cu``): factor one panel.

    ``stripT`` is the panel's (b, m) fp32 strip, transposed; ``kb`` the
    panel's first column; ``used`` the (m,) int32 cross-panel mask, read
    only (the caller marks the returned pivot rows). Same outputs as
    :func:`panel_factor_twin`. A CUDA tensor launches the kernel, one
    thread-block cluster (:func:`cluster_plan`); a CPU tensor takes the
    twin.
    """
    _check_panel_inputs("K2", stripT, used, (torch.float32,))
    b, m = stripT.shape
    if not 0 <= kb <= m - b:
        raise ValueError(f"kb={kb} outside [0, {m - b}]")
    if stripT.device.type == "cpu":
        return panel_factor_twin(stripT, kb, used, pivot=pivot)
    sub, kmask = _factor_geometry(m, b)
    geo, _ = cluster_plan(0, m, b, sub)
    lib = cuda_build.load()
    dev = stripT.device
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    ct = torch.empty((b, m), dtype=torch.float32, device=dev)
    ok = torch.empty(1, dtype=torch.int32, device=dev)
    wp = (None if geo.wp_shared else
          torch.empty((2 * sub, m), dtype=torch.float32, device=dev))
    err = lib.matinv_panel_factor(
        stripT.data_ptr(), used.data_ptr(), pivrows.data_ptr(),
        ct.data_ptr(), ok.data_ptr(), None if wp is None else wp.data_ptr(),
        m, b, sub, kmask, kb, int(pivot), geo.cluster, geo.threads,
        int(geo.wp_shared), int(geo.rows_shared), geo.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "K2 panel_factor")
    if not cuda_build.capturing():   # a graph's record is no launch
        panel_factor.launches += 1
    return pivrows, ct, ok[0] != 0


panel_factor.launches = 0


def pivot_search(stripT: torch.Tensor, used: torch.Tensor):
    """K3 (``csrc/panel_factor.cu``, pivot search): the (b,) int32 pivot
    rows of one panel.

    ``stripT`` is the (b, m) strip, transposed, in fp32 or bf16; ``used``
    the (m,) int32 cross-panel mask, read only. A CUDA tensor launches the
    kernel, one thread-block cluster (:func:`cluster_plan`); a CPU tensor
    takes :func:`pivot_search_twin`. Each CTA keeps m/C lanes: their used
    flags in shared memory always, their working set and strip rows where
    they fit (:func:`cluster_geometry`), which serves m up to about 3.6
    million at C = 16 (the gates ask at most 65536 of bf16 and 16384 of
    fp32); past that it raises ``ValueError``.
    """
    _check_panel_inputs("K3", stripT, used, _KERNEL_DTYPES)
    b, m = stripT.shape
    if stripT.device.type == "cpu":
        return pivot_search_twin(stripT, used)
    sub, kmask = _factor_geometry(m, b)
    bf16 = stripT.dtype == torch.bfloat16
    geo, _ = cluster_plan(2 if bf16 else 1, m, b, sub)
    lib = cuda_build.load()
    dev = stripT.device
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    w = None if geo.rows_shared else torch.empty_like(stripT)
    wp = (None if geo.wp_shared else
          torch.empty((2 * sub, m), dtype=stripT.dtype, device=dev))
    err = lib.matinv_pivot_search(
        stripT.data_ptr(), used.data_ptr(), pivrows.data_ptr(),
        None if w is None else w.data_ptr(),
        None if wp is None else wp.data_ptr(), m, b, sub, kmask, int(bf16),
        geo.cluster, geo.threads, int(geo.wp_shared), int(geo.rows_shared),
        geo.smem, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "K3 pivot_search")
    if not cuda_build.capturing():   # a graph's record is no launch
        pivot_search.launches += 1
    return pivrows


pivot_search.launches = 0


# --------------------------------------------------------------------------
# K4: the split path's pivot-block inverse
# --------------------------------------------------------------------------


def invert_small_twin(d: torch.Tensor, *, pivot: bool):
    """Plain twin of K4 on (B, b, b) fp32: ``gj_eliminate``'s rule
    (fused.py:74-137) -- the first max of |column r| over rows >= r, a real
    row swap, normalize, eliminate with one FMA rounding, deposit. Returns
    ``(inv (B, b, b), ok (B,))``."""
    bsz, b, _ = d.shape
    dev = d.device
    items = torch.arange(bsz, device=dev)
    eye = torch.eye(b, dtype=torch.float32, device=dev).expand(bsz, b, b)
    aug = torch.cat([d, eye], dim=-1)
    ok = torch.ones(bsz, dtype=torch.bool, device=dev)
    for r in range(b):
        col = aug[:, :, r].clone()
        if pivot:
            p = r + col[:, r:].abs().argmax(dim=1)
        else:
            p = torch.full((bsz,), r, dtype=torch.long, device=dev)
        piv = col[items, p]
        ok &= piv != 0
        row_p = aug[items, p]
        aug[items, p] = aug[:, r].clone()                  # the swap
        col[items, p] = col[:, r].clone()
        col[:, r] = 0.0
        norm = row_p / torch.where(piv == 0, torch.ones_like(piv),
                                   piv)[:, None]
        aug = _fms(aug, col[:, :, None], norm[:, None, :])
        aug[:, r] = norm
    inv = aug[:, :, b:]
    ok &= torch.isfinite(inv).all(dim=(-2, -1))
    return inv, ok


def invert_small(d: torch.Tensor, *, pivot: bool):
    """K4 (``csrc/small_inv.cu``): invert (b, b) fp32 blocks, batched over
    a leading axis; returns ``(inv, ok)`` in the input's batch shape. A
    CUDA tensor launches the kernel (b <= 128, the block in registers); a
    CPU tensor takes :func:`invert_small_twin`."""
    if d.ndim not in (2, 3) or d.shape[-1] != d.shape[-2]:
        raise ValueError(f"K4 takes (b, b) or (B, b, b), got "
                         f"{tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise TypeError(f"K4 takes float32, got {d.dtype}")
    d3 = d.reshape(-1, d.shape[-1], d.shape[-1]).contiguous()
    bsz, b, _ = d3.shape
    if d.device.type == "cpu":
        inv, ok = invert_small_twin(d3, pivot=pivot)
    elif d.device.type == "cuda":
        if b > 128:
            raise ValueError(f"K4 takes b <= 128, got b={b}")
        lib = cuda_build.load()
        inv = torch.empty_like(d3)
        ok = torch.empty(bsz, dtype=torch.int32, device=d.device)
        err = lib.matinv_small_inv(
            d3.data_ptr(), inv.data_ptr(), ok.data_ptr(), bsz, b, int(pivot),
            torch.cuda.current_stream(d.device).cuda_stream)
        cuda_build.check(err, "K4 small_inv")
        if not cuda_build.capturing():   # a graph's record is no launch
            invert_small.launches += 1
        ok = ok != 0
    else:
        raise ValueError(f"K4 runs on cuda (or its twin on cpu), not "
                         f"{d.device}")
    return inv.reshape(d.shape), ok.reshape(d.shape[:-2])


invert_small.launches = 0


# --------------------------------------------------------------------------
# Panel routes and the blocked driver
# --------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` for the driver's value-carrying GEMMs, in ``a``'s dtype.

    ``"highest"`` accumulates fp32 products in float64 and rounds the sum
    once. Each update eliminates, so the buffer and ``a @ b`` nearly
    cancel, and an FP32 GEMM's summation error survives that cancellation.
    The residual gates on the hollow protocol input were set on a TPU;
    plain FP32 GEMMs miss them elsewhere, in both packages: at n = 1950
    (seed 1950) the JAX package on the CPU refines to 3.0e-7, and this
    driver with FP32 GEMMs to 2.2e-7 on the CPU and 9.8e-7 on an H100 80GB
    HBM3 (700 W), against a gate of 1e-7; float64 accumulation gives
    1.7e-8 and 1.8e-8. On that card it adds at most ~6% to a raw call from
    n = 1950 to 16384 (``probes/gemm_precision.py``): Hopper runs float64
    GEMMs on its tensor cores at the FP32 SIMT peak. ``"high"`` and
    ``"default"`` run one GEMM at the precision the caller's
    :func:`matmul_precision` scope sets (TF32 on the card, plain FP32 on
    the CPU). fp64 operands run one fp64 GEMM.
    """
    if precision == "highest" and a.dtype != torch.float64:
        return (a.double() @ b.double()).to(a.dtype)
    return a @ b


def _update(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            precision: str) -> None:
    """``out += a @ b`` in place, at :func:`_mm`'s precision."""
    if precision == "highest" and out.dtype != torch.float64:
        out.copy_(torch.addmm(out.double(), a.double(), b.double()))
    else:
        out.addmm_(a, b)


def logical_panel_twin(strip: torch.Tensor, used: torch.Tensor, kb: int,
                       *, b: int, pivot: bool):
    """Plain swap-free panel pivot search in any dtype (blocked.py:675-712),
    L2's twin: b Gauss-Jordan steps on the (m, b) strip under the used-row
    mask, the full-precision first max over unused rows. ``used`` is read
    only; returns ``(pivrows (b,) int32, ok)``. ``calls`` counts its
    calls."""
    logical_panel_twin.calls += 1
    dev = strip.device
    w = strip.clone()
    used = used != 0
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for r in range(b):
        col = w[:, r].clone()
        # The pivot row as a one-element index: a 0-dim tensor would index
        # as a Python int, read back from the card each step.
        if pivot:
            p = torch.where(used, torch.full_like(col, -1),
                            col.abs()).argmax().view(1)
        else:
            p = torch.full((1,), kb + r, dtype=torch.long, device=dev)
        piv = col[p][0]
        ok &= piv != 0
        used.index_fill_(0, p, True)
        pivrows[r] = p[0]
        norm = w[p][0] / torch.where(piv == 0, torch.ones_like(piv), piv)
        col.index_fill_(0, p, 0.0)
        w -= col[:, None] * norm[None, :]
        w[p] = norm[None]
    return pivrows, ok


logical_panel_twin.calls = 0


def logical_geometry(m: int, b: int, itemsize: int,
                     sms: int = H100_SMS) -> LoopGeometry:
    """L2's persistent grid over an (m, b) strip: a CTA per 32 rows, at most
    one per SM, each CTA's rows in its shared memory where they fit
    (:func:`~gpu_matrix_inversion_tpu_torch.ops.gauss_jordan.
    grid_geometry`): (8192, 256) fp64 on 131 CTAs of 63 rows in shared
    memory, (16384, 256) in a device workspace, (65600, 32) fp32 in shared
    memory."""
    return grid_geometry(m, b, itemsize, ints=None, sms=sms)


def _panel_pivots_logical(strip: torch.Tensor, used: torch.Tensor, kb: int,
                          *, b: int, pivot: bool):
    """L2 (``csrc/logical_panel.cu``): the pivot rows and ok of the (m, b)
    ``strip`` under the ``used`` mask, those of :func:`logical_panel_twin`.
    The reference runs this loop without a Pallas kernel (fp64 past the
    f32-search tier, fp64 without pivoting, fp32 past m = 65536).

    A CPU tensor runs the twin; a CUDA tensor (fp64 or fp32, unit column
    stride) launches L2, one persistent grid (:func:`logical_geometry`).
    Returns ``(pivrows (b,) int32, ok)``."""
    m = strip.shape[0]
    if strip.ndim != 2 or strip.shape[1] != b or used.shape != (m,):
        raise ValueError(f"L2 takes an (m, {b}) strip and an (m,) mask, got "
                         f"{tuple(strip.shape)} and {tuple(used.shape)}")
    if strip.device.type == "cpu":
        return logical_panel_twin(strip, used, kb, b=b, pivot=pivot)
    if strip.device.type != "cuda":
        raise ValueError(f"L2 runs on cuda (or its twin on cpu), not "
                         f"{strip.device}")
    if strip.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"L2 takes float32 or float64, got {strip.dtype}")
    if strip.stride(1) != 1:
        strip = strip.contiguous()
    dev = strip.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    geo = logical_geometry(m, b, strip.element_size(), sm_count(index))
    lib = cuda_build.load()
    used32 = used.to(torch.int32).contiguous()
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(1, dtype=torch.int32, device=dev)
    work = (None if geo.rows_shared else
            torch.empty((m, b), dtype=strip.dtype, device=dev))
    props = torch.empty(grid_props_bytes(geo.ctas, b, strip.element_size()),
                        dtype=torch.uint8, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lib.matinv_logical_panel(
        strip.data_ptr(), strip.stride(0), used32.data_ptr(),
        pivrows.data_ptr(), ok.data_ptr(),
        None if work is None else work.data_ptr(), props.data_ptr(),
        bar.data_ptr(), m, b, int(kb), int(strip.dtype == torch.float64),
        int(pivot), geo.ctas, int(geo.rows_shared), geo.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "L2 logical_panel")
    if not cuda_build.capturing():   # a graph's record is no launch
        _panel_pivots_logical.launches += 1
    return pivrows, ok[0] != 0


_panel_pivots_logical.launches = 0


def _factor_panel(strip: torch.Tensor, kb: int, used: torch.Tensor, *,
                  b: int, pivot: bool, use_kernels: bool, search_bf16: bool,
                  emit: bool, search_f32: bool, precision: str):
    """Pivot rows and composite transform C^T (b, m) of the (m, b) panel
    ``strip`` (blocked.py:721-780); returns ``(pivrows, ct, ok)``.

    On the fused route C^T comes from K2. Otherwise it is assembled from
    the (b, b) pivot-block inverse: C = (E - L_masked) @ D^-1 - E, one
    (m, b) @ (b, b) GEMM at :func:`_mm`'s precision. The phase ranges
    (``utils/profiling.phase``) mark the pivot search (K2, K3, L2) as
    ``pivot`` and the pivot-block inverse (K4, L1) as ``row``.
    """
    m = strip.shape[0]
    dev = strip.device
    if emit:
        with phase("pivot"):
            return panel_factor(strip.t().contiguous(), kb, used,
                                pivot=pivot)
    if use_kernels:
        # The split path: K3 finds the pivots (no-pivot rows are simply
        # kb..kb+b-1, blocked.py:738-743), K4 inverts the pivot block.
        with phase("pivot"):
            if pivot:
                search = strip.to(torch.bfloat16) if search_bf16 else strip
                pivrows = pivot_search(search.t().contiguous(), used)
            else:
                pivrows = torch.arange(kb, kb + b, dtype=torch.int32,
                                       device=dev)
        with phase("row"):
            dinv, ok = invert_small(strip[pivrows.long()], pivot=pivot)
    elif search_f32 and pivot:
        # The FP64 f32-search tier (blocked.py:750-767): pivots from K3 on
        # the strip cast to fp32, the pivot block inverted in fp64.
        with phase("pivot"):
            pivrows = pivot_search(strip.float().t().contiguous(), used)
        with phase("row"):
            dinv, ok = _gauss_jordan_aug(strip[pivrows.long()][None],
                                         pivot=pivot)
            dinv, ok = dinv[0], ok[0]
    else:
        with phase("pivot"):
            pivrows, ok_p = _panel_pivots_logical(strip, used, kb, b=b,
                                                  pivot=pivot)
        with phase("row"):
            dinv, ok_d = _gauss_jordan_aug(strip[pivrows.long()][None],
                                           pivot=pivot)
            dinv, ok = dinv[0], ok_p & ok_d[0]
    rows = pivrows.long()
    lhs = -strip
    lhs[rows] = torch.eye(b, dtype=strip.dtype, device=dev)
    cmat = _mm(lhs, dinv, precision)
    cmat[rows, torch.arange(b, device=dev)] -= 1.0
    return pivrows, cmat.t(), ok


def _group_factor(og: torch.Tensor, kb0: int, used: torch.Tensor, *,
                  gsize: int, gw: int, b: int, precision: str, **route):
    """Factor ``gsize`` consecutive panels on the [O | G] working set
    ``og`` (m, 2*gw), in place (blocked.py:783-835). ``route`` is
    :func:`_factor_panel`'s choice of panel route. Marks the pivot rows in
    ``used``; returns ``(pivtot (gw,) int32, ok)``."""
    dev = og.device
    pivtot = torch.empty(gw, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(gsize):
        ib = i * b
        pivrows, ct, ok_f = _factor_panel(og[:, ib:ib + b], kb0 + ib, used,
                                          b=b, precision=precision, **route)
        ok &= ok_f
        pivtot[ib:ib + b] = pivrows
        _apply_panel(og, used, pivrows, ct, ib=ib, gw=gw, precision=precision)
    return pivtot, ok


def _apply_panel(og: torch.Tensor, used: torch.Tensor, pivrows: torch.Tensor,
                 ct: torch.Tensor, *, ib: int, gw: int,
                 precision: str) -> None:
    """Apply one factored panel (pivot rows, C^T) to the [O | G] working
    set ``og`` in place, and mark its pivot rows in ``used``."""
    b = pivrows.shape[0]
    rows = pivrows.long()
    used.index_fill_(0, rows, 1)
    # Inject this panel's identity probe columns BEFORE its own update
    # (prior transforms act as identity on them; the columns were 0).
    og[rows, torch.arange(gw + ib, gw + ib + b, device=og.device)] = (
        og.new_ones(()))
    # Windowed internal update: O columns before this panel are frozen and
    # G probes beyond it still zero, so the live columns are
    # og[:, ib : gw+ib+b]. One rank-b GEMM eliminates AND deposits. The
    # pivot rows are gathered into their own buffer first (index_select
    # copies) because the update overwrites them.
    win = og[:, ib:gw + ib + b]
    block_rows = win.index_select(0, rows)
    _update(win, ct.t(), block_rows, precision)


def _group_sizes(m: int, b: int, group_size: int) -> list[int]:
    """Panels in each composite group: full groups, then the tail."""
    num_panels = m // b
    group = max(1, min(group_size, num_panels))
    num_groups, tail = divmod(num_panels, group)
    return [group] * num_groups + ([tail] if tail else [])


def _augment(a: torch.Tensor, m: int, lo: int = 0,
             hi: int | None = None) -> torch.Tensor:
    """The driver's one (m, 2m) buffer, updated in place throughout. Left
    half: the A working set padded to blockdiag(A, I) (padded rows are
    zero in real columns, so they never win a pivot). Right half: the
    composite-transform columns in PIVOT ORDER (slot t tracks the t-th
    pivot row), deposited as each group finishes, so at the group starting
    at column kb0 the live columns are exactly [kb0+gw, m+kb0) -- one
    contiguous window of width m-gw. ``lo``/``hi`` build only its columns
    [lo, hi): a rank's shard on the sharded route."""
    n = a.shape[-1]
    hi = 2 * m if hi is None else hi
    aug = torch.zeros((m, hi - lo), dtype=a.dtype, device=a.device)
    if lo < n:
        aug[:n, :min(hi, n) - lo] = a[:, lo:min(hi, n)]
    if max(lo, n) < min(hi, m):
        pad = torch.arange(max(lo, n), min(hi, m), device=a.device)
        aug[pad, pad - lo] = aug.new_ones(())
    return aug


def _group_start(aug: torch.Tensor, kb0: int, gw: int) -> torch.Tensor:
    """The [O | G] working set of the group at column kb0: its columns of
    ``aug``, then gw zero probe columns."""
    og = torch.zeros((aug.shape[0], 2 * gw), dtype=aug.dtype,
                     device=aug.device)
    og[:, :gw] = aug[:, kb0:kb0 + gw]
    return og


def _apply_group(aug: torch.Tensor, og: torch.Tensor, pivtot: torch.Tensor,
                 *, kb0: int, precision: str) -> None:
    """Apply a finished group to ``aug`` in place: its composite transform
    C = G - E^T to the live window [kb0+gw, m+kb0) in one rank-gw GEMM,
    then the finished O to the group's columns and G to its slots."""
    m = aug.shape[0]
    gw = pivtot.shape[0]
    if m > gw:
        _update_window(aug, og, pivtot, kb0 + gw, kb0 + m, precision)
    aug[:, kb0:kb0 + gw] = og[:, :gw]
    aug[:, m + kb0:m + kb0 + gw] = og[:, gw:]


def _update_window(aug: torch.Tensor, og: torch.Tensor,
                   pivtot: torch.Tensor, lo: int, hi: int,
                   precision: str) -> None:
    """The group's composite transform C = G - E^T on ``aug``'s columns
    [lo, hi) in one rank-gw GEMM, in place. The window's pivot rows are
    gathered into their own buffer first, because the update overwrites
    them."""
    gw = pivtot.shape[0]
    rows = pivtot.long()
    c = og[:, gw:].clone()
    c[rows, torch.arange(gw, device=aug.device)] -= 1.0
    win = aug[:, lo:hi]
    _update(win, c, win.index_select(0, rows), precision)


def _unpermute(aug: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """Undo the logical permutation once: slot t is inverse column pos[t]
    and inverse row g lives at row pos[g]."""
    return _unpermute_slots(aug[:, aug.shape[0]:], pos, n)


def _unpermute_slots(slots: torch.Tensor, pos: torch.Tensor,
                     n: int) -> torch.Tensor:
    """:func:`_unpermute` of the (m, m) slot half alone."""
    rows = pos.long()
    invpos = torch.empty_like(rows)
    invpos[rows] = torch.arange(slots.shape[0], device=slots.device)
    return slots.index_select(1, invpos).index_select(0, rows)[:n, :n]


def _blocked_gj(a: torch.Tensor, *, pivot: bool, b: int, group_size: int,
                precision: str, use_kernels: bool, search_bf16: bool):
    """Invert one (n, n) fp32 or fp64 matrix; returns ``(inv, ok)``."""
    n = a.shape[-1]
    m = max(_round_up(n, b), b)
    dev, dtype = a.device, a.dtype
    with phase("make_augmented"):
        aug = _augment(a, m)
    # The FP64 f32-search tier where the f32 search reaches (blocked.py:
    # 940-942); single-chip only, as in the reference.
    route = dict(pivot=pivot, use_kernels=use_kernels,
                 search_bf16=search_bf16,
                 emit=_emit_fused(m, b, use_kernels, search_bf16),
                 search_f32=(pivot and not use_kernels
                             and dtype == torch.float64
                             and b * m <= 128 * 8192 and b % 8 == 0))

    used = torch.zeros(m, dtype=torch.int32, device=dev)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    kb0 = 0
    for gsize in _group_sizes(m, b, group_size):
        gw = gsize * b
        og = _group_start(aug, kb0, gw)
        pivtot, ok_g = _group_factor(og, kb0, used, gsize=gsize, gw=gw,
                                     b=b, precision=precision, **route)
        ok &= ok_g
        pos[kb0:kb0 + gw] = pivtot
        _apply_group(aug, og, pivtot, kb0=kb0, precision=precision)
        kb0 += gw
    inv = _unpermute(aug, pos, n)
    ok &= torch.isfinite(inv).all()
    return inv, ok


@compiled
def blocked_inverse(a: torch.Tensor, *, pivot: bool = True,
                    block_size: int = DEFAULT_BLOCK_SIZE,
                    precision: str = "highest",
                    search_bf16: bool = False,
                    group_size: int | None = None,
                    refine: int = 1):
    """Blocked Gauss-Jordan inverse; ``(..., n, n) -> (inverse, ok)``.

    The large-N path mirroring the reference's pivoted Gauss-Jordan
    (``matrix_inversion_FP32.cpp:12``); ``pivot=False`` mirrors
    ``matrix_inversion_no_pivots.cpp:10``. Runs on the input's device.

    Args:
      precision: GEMM precision of the trailing updates -- ``"highest"``
        (fp32 products accumulated in float64, see :func:`_mm`; the
        default) or ``"high"``/``"default"`` (TF32).
      search_bf16: run the pivot search (K3) on bf16 strips, the split
        path; forced past m = 16384.
      group_size: panels per composite trailing update (default:
        ``_default_group_size``, composite width ~1024).
      refine: Newton-Schulz polish steps applied to the result (default 1;
        0 disables).

    fp32 factors through the panel kernels, fp64 through the f32-search
    tier or the plain logical panel (see the module docstring). bf16 input
    computes in fp32 and returns bf16. A batch loops one matrix at a time;
    with ``MATINV_LOCKSTEP=1`` an fp32 batch in K2's reach goes through
    :func:`~gpu_matrix_inversion_tpu_torch.ops.lockstep.lockstep_inverse`,
    with the same result bit for bit.
    """
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) square matrix, got "
                         f"{tuple(a.shape)}")
    if a.dtype == torch.bfloat16:
        inv, ok = blocked_inverse(a.float(), pivot=pivot,
                                  block_size=block_size, precision=precision,
                                  search_bf16=search_bf16,
                                  group_size=group_size, refine=refine)
        return inv.to(torch.bfloat16), ok
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {set(PRECISIONS)}")
    n = a.shape[-1]
    b, use_kernels, search_bf16 = _select_block_params(
        n, block_size, a.dtype, search_bf16)
    m = max(_round_up(n, b), b)
    if group_size is None:
        group_size = _default_group_size(b, m // b)

    flat = a.reshape(-1, n, n)
    if a.ndim > 2 and use_kernels and not search_bf16:
        # The opt-in (MATINV_LOCKSTEP=1) lockstep route (blocked.py:
        # 1175-1192): k matrices per K6 launch, one block each;
        # _lockstep_k returns 0 unless opted in.
        from gpu_matrix_inversion_tpu_torch.ops.lockstep import (
            _lockstep_k, lockstep_inverse)
        k = _lockstep_k(flat.shape[0], n, b, a.dtype)
        if k:
            inv, ok = lockstep_inverse(flat, pivot=pivot, b=b, k=k,
                                       precision=precision,
                                       group_size=group_size, refine=refine)
            return inv.reshape(a.shape), ok.reshape(a.shape[:-2])
    invs, oks = [], []
    for one in flat:
        with matmul_precision(precision):
            inv, ok = _blocked_gj(one, pivot=pivot, b=b,
                                  group_size=group_size, precision=precision,
                                  use_kernels=use_kernels,
                                  search_bf16=search_bf16)
        if refine > 0:
            # Newton-Schulz polish, paying back the grouped-update
            # accuracy trade (blocked.py:1063-1068).
            inv = newton_schulz_refine(one, inv, iters=refine)
            ok = ok & torch.isfinite(inv).all()
        invs.append(inv)
        oks.append(ok)
    return (torch.stack(invs).reshape(a.shape),
            torch.stack(oks).reshape(a.shape[:-2]))
