"""Blocked right-looking Gauss-Jordan: kernel K2 plus FP32 GEMM updates.

Port of ``gpu_matrix_inversion_tpu/ops/blocked.py``, the large-N route. The
reference's ``fixColumnKernel`` performs the O(N^2) rank-1 trailing update
once per iteration, N times (``matrix_inversion_FP32.cpp:17-63``). Here the
same elimination is regrouped panel by panel:

1. *Panel factorization* (K2, ``csrc/panel_factor.cu``, one launch per
   panel): b swap-free packed-key pivot steps on the transposed (b, m)
   strip under the cross-panel used-row mask, emitting the pivot rows and
   the panel's composite transform C^T, such that X + C @ X[pivrows]
   eliminates the panel from any columns X and deposits its scaled pivot
   rows.
2. *Group composites*: ``group`` consecutive panels are factored against an
   [O | G] working set (O = the group's columns, G = identity-probe columns
   injected panel by panel); afterwards G - E^T is the group's composite
   transform, applied to the live window in ONE rank-(group*b) GEMM.
3. *Logical permutation*: rows never move. The windowed pivot-order slot
   layout keeps the live columns one contiguous window of width m - gw, so
   the trailing GEMMs touch half the columns of the classic [A | I] layout,
   and two gathers at the very end put the inverse in order.

The GEMMs (the outer rank-gw update and the internal rank-b panel updates)
are products the JAX package leaves to XLA outside any Pallas kernel; here
they are library GEMMs that update the ``aug`` / ``og`` buffers (see
:func:`_update` for their precision). What the reference runs
only to steer XLA:TPU and Mosaic (optimization barriers, x64 scopes, the
v1/v2 kernel split, group-loop unrolling, the (8, m) used tile, interpret
mode) has no counterpart. Where the reference would leave this slice (the
split K3 + K4 path, the FP64 f32-search tier, lockstep batching) the port
raises ``NotImplementedError`` instead of taking another route.
"""

from __future__ import annotations

import os

import torch

from gpu_matrix_inversion_tpu_torch.ops.fused import (_fms, _packed_argmax,
                                                      _round_up)
from gpu_matrix_inversion_tpu_torch.ops.refine import newton_schulz_refine
from gpu_matrix_inversion_tpu_torch.utils import cuda_build
from gpu_matrix_inversion_tpu_torch.utils.precision import (PRECISIONS,
                                                            matmul_precision)

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
    b*m <= 128*8192, fp32 search. Past it the reference takes the split
    search + small-inverse path (K3 + K4), which this port does not have
    yet."""
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
    past that the reference searches in bf16 (not ported)."""
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


def effective_gemm_flops(n: int, *, block_size: int = DEFAULT_BLOCK_SIZE,
                         search_bf16: bool = False,
                         group_size: int | None = None,
                         dtype=torch.float32) -> int:
    """Flops the windowed blocked algorithm actually schedules for one
    inversion (blocked.py:1072-1116): the outer composite GEMMs, the
    internal rank-b panel updates and K2's in-kernel deferred dots
    (counted as the reference counts them; K2 computes the first of the
    two dots as a gather)."""
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
    fl = 0
    for gsize in [group] * num_groups + ([tail] if tail else []):
        gw = gsize * b
        fl += 2 * m * gw * (m - gw)        # outer composite rank-gw GEMM
        fl += gsize * 2 * m * b * (gw + b)  # internal rank-b panel updates
        fl += gsize * (b // sub) * 2 * (2 * b * sub * m)  # deferred dots
        if not emit:
            fl += gsize * 2 * m * b * b     # split-path cmat assembly
    return fl


# --------------------------------------------------------------------------
# K2: panel factorization
# --------------------------------------------------------------------------


def panel_factor_twin(stripT: torch.Tensor, kb: int, used: torch.Tensor, *,
                      pivot: bool):
    """Plain PyTorch twin of K2: same steps, same pivot rule, on the input's
    device. Returns ``(pivrows (b,) int32, ct (b, m) fp32, ok 0-dim bool)``.

    The elimination rounds as the kernel's fmaf does; the deferred second
    dot is a ``torch.matmul``, so its summation order (and only that)
    differs from the kernel's FMA loop.
    """
    b, m = stripT.shape
    dev = stripT.device
    sub, kmask = _factor_geometry(m, b)
    ct = stripT.clone()          # the output doubles as the working buffer
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
            pivcol[sub + r2] += 1.0      # the probe's identity one-hot
            pv = pivcol[r2]
            ok &= pv != 0
            norm = pivcol / torch.where(pv == 0, torch.ones_like(pv), pv)
            factors = col.clone()
            factors[p] = 0.0
            wp = _fms(wp, norm[:, None], factors[None, :])
            wp[:, p] = norm
            col = wp[r2 + 1].clone()
        lanes = pivrows[r0:r0 + sub].long()
        ctl = wp[sub:].clone()
        ctl[torch.arange(sub, device=dev), lanes] -= 1.0   # probe - psel
        rest = torch.cat([torch.arange(0, r0, device=dev),
                          torch.arange(r0 + sub, b, device=dev)])
        if rest.numel():
            # Deferred rank-sub update: rows @ psel^T picks the rows'
            # values at the pivot lanes; then rows += g @ C_l^T in FP32.
            x = ct[rest]
            with matmul_precision("highest"):
                ct[rest] = x + x[:, lanes] @ ctl
        ct[r0:r0 + sub] = ctl
    ok &= torch.isfinite(ct).all()
    return pivrows, ct, ok


def panel_factor(stripT: torch.Tensor, kb: int, used: torch.Tensor, *,
                 pivot: bool):
    """K2 (``csrc/panel_factor.cu``): factor one panel.

    ``stripT`` is the panel's (b, m) fp32 strip, transposed; ``kb`` the
    panel's first column; ``used`` the (m,) int32 cross-panel mask, read
    only (the caller marks the returned pivot rows). Same outputs as
    :func:`panel_factor_twin`. A CUDA tensor launches the kernel; a CPU
    tensor takes the twin.
    """
    if stripT.ndim != 2 or stripT.dtype != torch.float32:
        raise TypeError(f"K2 takes a (b, m) float32 strip, got "
                        f"{tuple(stripT.shape)} {stripT.dtype}")
    b, m = stripT.shape
    if used.shape != (m,) or used.dtype != torch.int32:
        raise TypeError(f"K2 takes an ({m},) int32 used mask, got "
                        f"{tuple(used.shape)} {used.dtype}")
    if used.device != stripT.device:
        raise ValueError("strip and used mask must share a device")
    if not (stripT.is_contiguous() and used.is_contiguous()):
        raise ValueError("K2 needs contiguous inputs")
    if not 0 <= kb <= m - b:
        raise ValueError(f"kb={kb} outside [0, {m - b}]")
    if stripT.device.type == "cpu":
        return panel_factor_twin(stripT, kb, used, pivot=pivot)
    if stripT.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda (or its twin on cpu), not "
                         f"{stripT.device}")
    sub, kmask = _factor_geometry(m, b)
    lib = cuda_build.load()
    dev = stripT.device
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    ct = torch.empty((b, m), dtype=torch.float32, device=dev)
    ok = torch.empty(1, dtype=torch.int32, device=dev)
    wp = torch.empty((2 * sub, m), dtype=torch.float32, device=dev)
    err = lib.matinv_panel_factor(
        stripT.data_ptr(), used.data_ptr(), pivrows.data_ptr(),
        ct.data_ptr(), ok.data_ptr(), wp.data_ptr(), m, b, sub, kmask, kb,
        int(pivot), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "K2 panel_factor")
    panel_factor.launches += 1
    return pivrows, ct, ok[0] != 0


panel_factor.launches = 0


# --------------------------------------------------------------------------
# Blocked driver
# --------------------------------------------------------------------------


def _update(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            precision: str) -> None:
    """``out += a @ b`` in place: the driver's value-carrying GEMMs.

    ``"highest"`` accumulates the products in float64 and rounds the sum
    once into the fp32 buffer. Each update eliminates, so ``out`` and
    ``a @ b`` nearly cancel, and an FP32 GEMM's summation error survives
    that cancellation. The residual gates on the hollow protocol input
    were set on a TPU; plain FP32 GEMMs miss them elsewhere, in both
    packages: at n = 1950 (seed 1950) the JAX package on the CPU refines
    to 3.0e-7, and this driver with FP32 GEMMs to 2.2e-7 on the CPU and
    9.8e-7 on an H100 80GB HBM3 (700 W), against a gate of 1e-7; float64
    accumulation gives 1.7e-8 and 1.8e-8. On that card it adds at most
    ~6% to a raw call from n = 1950 to 16384 (``probes/gemm_precision.py``):
    Hopper runs float64 GEMMs on its tensor cores at the FP32 SIMT peak.
    ``"high"`` and ``"default"`` run one GEMM at the precision the
    caller's :func:`matmul_precision` scope sets (TF32 on the card, plain
    FP32 on the CPU).
    """
    if precision == "highest":
        out.copy_(torch.addmm(out.double(), a.double(), b.double()))
    else:
        out.addmm_(a, b)


def _group_factor(og: torch.Tensor, kb0: int, used: torch.Tensor, *,
                  gsize: int, gw: int, b: int, pivot: bool, precision: str):
    """Factor ``gsize`` consecutive panels on the [O | G] working set
    ``og`` (m, 2*gw), in place (blocked.py:783-835). Marks the pivot rows
    in ``used``; returns ``(pivtot (gw,) int32, ok)``."""
    dev = og.device
    pivtot = torch.empty(gw, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    probe_cols = torch.arange(b, device=dev)
    for i in range(gsize):
        ib = i * b
        strip_t = og[:, ib:ib + b].t().contiguous()
        pivrows, ct, ok_f = panel_factor(strip_t, kb0 + ib, used,
                                         pivot=pivot)
        ok &= ok_f
        pivtot[ib:ib + b] = pivrows
        rows = pivrows.long()
        used[rows] = 1
        # Inject this panel's identity probe columns BEFORE its own update
        # (prior transforms act as identity on them; the columns were 0).
        og[rows, gw + ib + probe_cols] = 1.0
        # Windowed internal update: O columns before this panel are frozen
        # and G probes beyond it still zero, so the live columns are
        # og[:, ib : gw+ib+b]. One rank-b GEMM eliminates AND deposits.
        # The pivot rows are gathered into their own buffer first
        # (index_select copies) because the update overwrites them.
        win = og[:, ib:gw + ib + b]
        block_rows = win.index_select(0, rows)
        _update(win, ct.t(), block_rows, precision)
    return pivtot, ok


def _blocked_gj(a: torch.Tensor, *, pivot: bool, b: int, group_size: int,
                precision: str):
    """Invert one (n, n) fp32 matrix; returns ``(inv, ok)``."""
    n = a.shape[-1]
    m = max(_round_up(n, b), b)
    dev = a.device
    # One (m, 2m) buffer, updated in place throughout. Left half: the A
    # working set padded to blockdiag(A, I) (padded rows are zero in real
    # columns, so they never win a pivot). Right half: the composite-
    # transform columns in PIVOT ORDER (slot t tracks the t-th pivot row),
    # deposited as each group finishes, so at group kk the live columns are
    # exactly [kb0+gw, m+kb0) -- one contiguous window of width m-gw.
    aug = torch.zeros((m, 2 * m), dtype=torch.float32, device=dev)
    aug[:n, :n] = a
    pad = torch.arange(n, m, device=dev)
    aug[pad, pad] = 1.0
    num_panels = m // b
    group = max(1, min(group_size, num_panels))
    num_groups, tail = divmod(num_panels, group)
    sizes = [group] * num_groups + ([tail] if tail else [])

    used = torch.zeros(m, dtype=torch.int32, device=dev)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    kb0 = 0
    for gsize in sizes:
        gw = gsize * b
        og = torch.zeros((m, 2 * gw), dtype=torch.float32, device=dev)
        og[:, :gw] = aug[:, kb0:kb0 + gw]
        pivtot, ok_g = _group_factor(og, kb0, used, gsize=gsize, gw=gw,
                                     b=b, pivot=pivot, precision=precision)
        ok &= ok_g
        pos[kb0:kb0 + gw] = pivtot
        # Composite transform C = G - E^T, applied to the live window
        # [kb0+gw, m+kb0) in one rank-gw GEMM, in place. The pivot rows of
        # the window are gathered into their own buffer first.
        rows = pivtot.long()
        c = og[:, gw:].clone()
        c[rows, torch.arange(gw, device=dev)] -= 1.0
        if m > gw:
            win = aug[:, kb0 + gw:kb0 + m]
            _update(win, c, win.index_select(0, rows), precision)
        # The group's own left columns get the finished O; its slots get G.
        aug[:, kb0:kb0 + gw] = og[:, :gw]
        aug[:, m + kb0:m + kb0 + gw] = og[:, gw:]
        kb0 += gw
    # Undo the logical permutation once: slot t is inverse column pos[t]
    # and inverse row g lives at row pos[g].
    rows = pos.long()
    invpos = torch.empty_like(rows)
    invpos[rows] = torch.arange(m, device=dev)
    inv = aug[:, m:].index_select(1, invpos).index_select(0, rows)[:n, :n]
    ok &= torch.isfinite(inv).all()
    return inv, ok


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
        (products accumulated in float64, see :func:`_update`; the
        default) or ``"high"``/``"default"`` (TF32).
      search_bf16: the reference's bf16 pivot-search tier (K3); not in this
        port yet, so True raises ``NotImplementedError``.
      group_size: panels per composite trailing update (default:
        ``_default_group_size``, composite width ~1024).
      refine: Newton-Schulz polish steps applied to the result (default 1;
        0 disables).

    bf16 input computes in fp32 and returns bf16. A batch loops one matrix
    at a time.
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
    if not use_kernels:
        raise NotImplementedError(
            f"blocked route for {a.dtype} n={n}: needs the FP64 f32-search "
            "tier over kernel K3 (ROADMAP Queue 2, K3), not ported yet")
    if not _emit_fused(m, b, use_kernels, search_bf16):
        raise NotImplementedError(
            f"blocked route at n={n} (b={b}, search_bf16={search_bf16}): "
            "needs the split path, kernels K3 + K4 (ROADMAP Queue 2), not "
            "ported yet")
    if a.ndim > 2 and os.environ.get("MATINV_LOCKSTEP") == "1":
        raise NotImplementedError(
            "MATINV_LOCKSTEP=1 needs the lockstep kernel K6 (ROADMAP "
            "Queue 2, K6), not ported yet")
    if group_size is None:
        group_size = _default_group_size(b, m // b)

    flat = a.reshape(-1, n, n)
    invs, oks = [], []
    for one in flat:
        with matmul_precision(precision):
            inv, ok = _blocked_gj(one, pivot=pivot, b=b,
                                  group_size=group_size, precision=precision)
        if refine > 0:
            # Newton-Schulz polish, paying back the grouped-update
            # accuracy trade (blocked.py:1063-1068).
            inv = newton_schulz_refine(one, inv, iters=refine)
            ok = ok & torch.isfinite(inv).all()
        invs.append(inv)
        oks.append(ok)
    return (torch.stack(invs).reshape(a.shape),
            torch.stack(oks).reshape(a.shape[:-2]))
