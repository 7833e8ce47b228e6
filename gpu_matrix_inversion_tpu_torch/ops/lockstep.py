"""Lockstep-batched blocked Gauss-Jordan: k matrices per panel-factor launch.

Port of ``gpu_matrix_inversion_tpu/ops/lockstep.py``, the opt-in route
(``MATINV_LOCKSTEP=1``) for batches of mid-size FP32 matrices past the
fused kernel's reach (the reference's ``main_file.cpp:73-78`` ramp: many
mid-size systems). Without it, a batch loops the single-matrix blocked
path one matrix at a time, and each panel's factor (kernel K2) occupies one
SM of the card.

Here k matrices advance through the blocked driver together, panel by
panel, and each panel of all k is factored by ONE launch of kernel K6
(``csrc/panel_factor.cu``): k thread-block clusters of K2's design, one
cluster of C CTAs per matrix (C from ``ops/blocked.cluster_plan``, as K2
takes it for one panel), so the k serial step chains run on k * C SMs at
once; a k past the clusters the card holds at once runs in waves. The reference refuted the route on a TPU
v5e, where one TensorCore ran the k matrices' merged step at about k
times the cost of one; that premise does not carry over to a GPU, where
each matrix has SMs of its own.

Contract (the reference's, ``tests/test_lockstep.py``): the lockstep route
equals the per-matrix route bit for bit, refine included. Everything but
the factor is the per-matrix driver's own code, called per matrix
(``ops/blocked.py``: the windowed slot layout, [O|G] groups, blockdiag
padding, the two final gathers, the value-carrying GEMMs at
:func:`~gpu_matrix_inversion_tpu_torch.ops.blocked._mm`'s precision and
the Newton-Schulz polish). A batched GEMM may sum in another order than
the per-matrix one, so the GEMMs stay per matrix: the route's parallelism
is in the factor. K6 itself computes for each matrix what K2 computes for
it alone.
"""

from __future__ import annotations

import os

import torch

from gpu_matrix_inversion_tpu_torch.ops.blocked import (
    _apply_group, _apply_panel, _augment, _check_panel_inputs,
    _factor_geometry, _group_sizes, _group_start,
    _select_block_params, _unpermute, cluster_plan, panel_factor_twin)
from gpu_matrix_inversion_tpu_torch.ops.fused import _round_up
from gpu_matrix_inversion_tpu_torch.ops.refine import newton_schulz_refine
from gpu_matrix_inversion_tpu_torch.utils import cuda_build
from gpu_matrix_inversion_tpu_torch.utils.precision import matmul_precision

# The reference's gate, copied unchanged so both packages route alike: the
# TPU kernel's VMEM budget caps k * b * m at the single-matrix fused
# kernel's product cap, and k at 8. On an H100 k could reach the SM count;
# re-deriving it is a later, measured change (ROADMAP Queue 3).
_LOCKSTEP_BM_CAP = 128 * 8192
_LOCKSTEP_MAX_K = 8


def _lockstep_k(nbatch: int, n: int, block_size: int, dtype,
                search_bf16: bool = False) -> int:
    """Matrices per lockstep launch (0 = route off) (lockstep.py:58-81).

    Off unless ``MATINV_LOCKSTEP=1``; then fp32 batches only (bf16-search
    and fp64 keep their routes), where k * b * m fits the cap."""
    if os.environ.get("MATINV_LOCKSTEP") != "1":
        return 0
    if dtype != torch.float32 or nbatch < 2 or search_bf16:
        return 0
    b, use_kernels, search_bf16 = _select_block_params(
        n, block_size, dtype, False)
    if not use_kernels or search_bf16:
        return 0
    m = max(_round_up(n, b), b)
    cap = _LOCKSTEP_BM_CAP // (b * m)
    k = min(nbatch, cap, _LOCKSTEP_MAX_K)
    return k if k >= 2 else 0


def lockstep_factor_twin(stripsT: torch.Tensor, kb: int, used: torch.Tensor,
                         *, pivot: bool):
    """Plain twin of K6: K2's twin applied to each matrix. Returns
    ``(pivrows (k, b) int32, ct (k, b, m) fp32, ok (k,) bool)``."""
    outs = [panel_factor_twin(s, kb, u, pivot=pivot)
            for s, u in zip(stripsT, used)]
    return tuple(torch.stack(x) for x in zip(*outs))


def lockstep_factor(stripsT: torch.Tensor, kb: int, used: torch.Tensor, *,
                    pivot: bool):
    """K6 (``csrc/panel_factor.cu``): factor one panel of k matrices.

    ``stripsT`` is the (k, b, m) fp32 stack of the matrices' transposed
    strips, ``kb`` the panel's first column, ``used`` the (k, m) int32
    cross-panel masks, read only. Returns what K2 returns for each matrix,
    stacked: ``(pivrows (k, b), ct (k, b, m), ok (k,))``. A CUDA tensor
    launches the kernel, k clusters of K2's geometry (``cluster_plan``); a
    CPU tensor takes :func:`lockstep_factor_twin`.
    """
    if stripsT.ndim != 3 or used.ndim != 2 or used.shape[0] != len(stripsT):
        raise TypeError(f"K6 takes (k, b, m) strips and (k, m) masks, got "
                        f"{tuple(stripsT.shape)} and {tuple(used.shape)}")
    _check_panel_inputs("K6", stripsT[0], used[0], (torch.float32,))
    if not (stripsT.is_contiguous() and used.is_contiguous()):
        raise ValueError("K6 needs contiguous inputs")
    k, b, m = stripsT.shape
    if not 0 <= kb <= m - b:
        raise ValueError(f"kb={kb} outside [0, {m - b}]")
    if stripsT.device.type == "cpu":
        return lockstep_factor_twin(stripsT, kb, used, pivot=pivot)
    return _launch(stripsT, kb, used, pivot)


def _launch(stripsT: torch.Tensor, kb: int, used: torch.Tensor,
            pivot: bool):
    """K6's launch on checked inputs: K2's cluster geometry for one
    (m, b) panel, k clusters of it."""
    k, b, m = stripsT.shape
    sub, kmask = _factor_geometry(m, b)
    geo, _ = cluster_plan(0, m, b, sub)
    lib = cuda_build.load()
    dev = stripsT.device
    pivrows = torch.empty((k, b), dtype=torch.int32, device=dev)
    ct = torch.empty((k, b, m), dtype=torch.float32, device=dev)
    ok = torch.empty(k, dtype=torch.int32, device=dev)
    wp = (None if geo.wp_shared else
          torch.empty((k, 2 * sub, m), dtype=torch.float32, device=dev))
    err = lib.matinv_lockstep_factor(
        stripsT.data_ptr(), used.data_ptr(), pivrows.data_ptr(),
        ct.data_ptr(), ok.data_ptr(), None if wp is None else wp.data_ptr(),
        k, m, b, sub, kmask, kb, int(pivot), geo.cluster, geo.threads,
        int(geo.wp_shared), int(geo.rows_shared), geo.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "K6 lockstep_factor")
    lockstep_factor.launches += 1
    return pivrows, ct, ok != 0


lockstep_factor.launches = 0


def _group_factor_lockstep(ogs: list, kb0: int, used: torch.Tensor, *,
                           gsize: int, gw: int, b: int, pivot: bool,
                           precision: str):
    """Factor ``gsize`` consecutive panels of k matrices (lockstep.py:
    243-274): one K6 launch per panel, then each matrix's panel applied to
    its own [O | G] working set ``ogs[i]`` as the per-matrix driver applies
    it. Marks the pivot rows in ``used`` (k, m); returns
    ``(pivtot (k, gw) int32, ok (k,))``."""
    k = len(ogs)
    dev = ogs[0].device
    pivtot = torch.empty((k, gw), dtype=torch.int32, device=dev)
    ok = torch.ones(k, dtype=torch.bool, device=dev)
    for i in range(gsize):
        ib = i * b
        strips = torch.stack([og[:, ib:ib + b].t() for og in ogs])
        pivrows, ct, ok_f = lockstep_factor(strips, kb0 + ib, used,
                                            pivot=pivot)
        ok &= ok_f
        pivtot[:, ib:ib + b] = pivrows
        for j, og in enumerate(ogs):
            _apply_panel(og, used[j], pivrows[j], ct[j], ib=ib, gw=gw,
                         precision=precision)
    return pivtot, ok


def _blocked_gj_lockstep(a: torch.Tensor, *, pivot: bool, b: int,
                         group_size: int, precision: str):
    """k (n, n) fp32 matrices through the blocked driver in lockstep
    (lockstep.py:277-352): the per-matrix driver's buffers, groups and
    gathers, with every panel factored for all k by one K6 launch. Returns
    ``(invs, ok (k,))``, ``invs`` the k (n, n) inverses as the per-matrix
    driver returns each (a view of its buffer), so that the polish
    multiplies the same operands."""
    k, n = a.shape[0], a.shape[-1]
    m = max(_round_up(n, b), b)
    dev = a.device
    augs = [_augment(x, m) for x in a]
    used = torch.zeros((k, m), dtype=torch.int32, device=dev)
    pos = torch.arange(m, dtype=torch.int32, device=dev).repeat(k, 1)
    ok = torch.ones(k, dtype=torch.bool, device=dev)
    kb0 = 0
    for gsize in _group_sizes(m, b, group_size):
        gw = gsize * b
        ogs = [_group_start(aug, kb0, gw) for aug in augs]
        pivtot, ok_g = _group_factor_lockstep(
            ogs, kb0, used, gsize=gsize, gw=gw, b=b, pivot=pivot,
            precision=precision)
        ok &= ok_g
        pos[:, kb0:kb0 + gw] = pivtot
        for j, (aug, og) in enumerate(zip(augs, ogs)):
            _apply_group(aug, og, pivtot[j], kb0=kb0, precision=precision)
        kb0 += gw
    invs = [_unpermute(aug, p, n) for aug, p in zip(augs, pos)]
    ok &= torch.stack([torch.isfinite(x).all() for x in invs])
    return invs, ok


def lockstep_inverse(a: torch.Tensor, *, pivot: bool, b: int, k: int,
                     precision: str, group_size: int, refine: int):
    """Invert a (B, n, n) fp32 batch in lockstep chunks of ``k``
    (lockstep.py:355-387); returns ``(inv (B, n, n), ok (B,))``.

    The last chunk, when k does not divide B, launches K6 on the matrices
    left (fewer clusters) instead of padding with identities. ``refine``
    Newton-Schulz steps polish each matrix as the per-matrix route does.
    """
    if a.ndim != 3 or a.dtype != torch.float32:
        raise TypeError(f"lockstep_inverse takes a (B, n, n) float32 batch, "
                        f"got {tuple(a.shape)} {a.dtype}")
    invs, oks = [], []
    for c0 in range(0, a.shape[0], k):
        chunk = a[c0:c0 + k]
        with matmul_precision(precision):
            inv_c, ok_c = _blocked_gj_lockstep(chunk, pivot=pivot, b=b,
                                               group_size=group_size,
                                               precision=precision)
        for one, inv, ok in zip(chunk, inv_c, ok_c):
            if refine > 0:
                inv = newton_schulz_refine(one, inv, iters=refine)
                ok = ok & torch.isfinite(inv).all()
            invs.append(inv)
            oks.append(ok)
    return torch.stack(invs), torch.stack(oks)
