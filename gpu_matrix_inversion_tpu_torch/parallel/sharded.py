"""Panel-sharded Gauss-Jordan inversion over a ``torch.distributed`` mesh.

Port of ``gpu_matrix_inversion_tpu/parallel/sharded.py``. The augmented
(m, 2m) slot-layout working set [A | slots] of ``ops/blocked.py`` is
column-sharded over a mesh axis: rank ``my`` of the axis holds the w = 2m/d
columns [my*w, my*w + w). Each rank runs the body below (the reference runs
it under ``shard_map``); the collectives are ``torch.distributed`` calls on
the axis's process group, NCCL on cards and gloo on the CPU.

Per panel *group* (gw = group*b columns):

1. *Strip gather*, exactly one collective: the (m, gw) outer strip of the
   group's columns, a ``broadcast`` from the single owner where the group
   lies inside one shard, else an ``all_reduce`` of each owner's columns
   over zeros (the reference's masked ``psum``; here the mask is a copy, so
   a non-owner's values never enter the sum).
2. *Replicated group factorization*: every rank runs the port's own
   ``ops/blocked._group_factor`` on identical data, so identical pivots;
   through K2 (``csrc/panel_factor.cu``) where ``_emit_fused`` holds, else
   the split path's K3 + K4, on a ``cuda`` mesh. A CPU mesh runs the plain
   logical panel (full-precision first max), as a JAX CPU mesh runs the jnp
   panel. No FP64 f32-search tier: it is single-chip only.
3. *Local windowed update*: the group's composite transform applied to the
   rank's slice of the live window [kb0+gw, m+kb0) in one GEMM at the
   blocked driver's precision (``_update``); a rank whose columns miss the
   window runs no GEMM.
4. *Deposits*: the finished group columns and its slot columns written into
   the owning ranks' local columns (a group may straddle two shards).

At the end each rank that holds slot columns broadcasts them into one
(m, m) buffer on every rank (a rank receives only the columns it lacks),
``_unpermute`` runs on every rank, and one reduction of the ranks' ``ok``
follows: the inverse comes back replicated on every rank (the reference
returns one sharded global array). The input must lie on the rank's device
of the mesh (a cuda mesh for a card tensor, a cpu mesh over gloo for a CPU
one); it is never moved. At world size 1 every operation is the blocked
route's own, so the result is bit for bit ``blocked_inverse`` with the
same ``group_size``. Each collective is counted in
``collective.calls``; each window GEMM in ``window_update.calls``.

The batched variant splits the batch over a ``dp`` axis and the columns
over ``tp``: each rank inverts its dp slice one matrix at a time over its
tp group (the reference's ``lax.map``/``vmap``), or, on a dp-only ``cuda``
mesh with n <= ``FUSED_MAX_N``, runs K1 (``fused_inverse``) on its slice;
the slices are gathered over dp.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from gpu_matrix_inversion_tpu_torch.ops.blocked import (_augment,
                                                        _default_group_size,
                                                        _emit_fused,
                                                        _group_factor,
                                                        _group_sizes,
                                                        _round_up,
                                                        _select_block_params,
                                                        _unpermute_slots,
                                                        _update_window)
from gpu_matrix_inversion_tpu_torch.ops.refine import newton_schulz_refine
from gpu_matrix_inversion_tpu_torch.parallel.mesh import (make_device_mesh,
                                                          require_world,
                                                          world_serves)
from gpu_matrix_inversion_tpu_torch.utils import graphs
from gpu_matrix_inversion_tpu_torch.utils.precision import (PRECISIONS,
                                                            matmul_precision)


def collective(call, *args, **kwargs) -> None:
    """Run one ``torch.distributed`` collective and count it."""
    collective.calls += 1
    call(*args, **kwargs)


collective.calls = 0


def _sharded_params(n: int, block_size: int, d: int, dtype,
                    search_bf16: bool, group_size):
    """Geometry for the sharded path (sharded.py:272-297): the single-chip
    gating of ``_select_block_params``, re-gated against m rounded up to a
    multiple of b*d until b stops shrinking (a rounded m can pass the
    budget its b was chosen for); group capped so gw <= w keeps a group on
    at most two shards. Returns (b, m, group, use_kernels, search_bf16)."""
    b, use_kernels, search_bf16 = _select_block_params(
        n, block_size, dtype, search_bf16)
    while True:
        m = _round_up(n, b * d)
        b2, use_kernels, search_bf16 = _select_block_params(
            m, min(block_size, b), dtype, search_bf16)
        if b2 == b and m % (b * d) == 0:
            break
        b = b2
    if group_size is None:
        group_size = _default_group_size(b)
    group = max(1, min(group_size, m // b, 2 * m // (d * b)))
    return b, m, group, use_kernels, search_bf16


def _overlap(g0: int, width: int, my: int, w: int):
    """Global columns of [g0, g0+width) that rank ``my`` holds, as
    (lo, hi); empty when lo >= hi."""
    return max(g0, my * w), min(g0 + width, my * w + w)


def _gather_strip(aug_loc: torch.Tensor, kb0: int, gw: int, *, w: int,
                  my: int, group, ranks) -> torch.Tensor:
    """The (m, gw) strip of global columns [kb0, kb0+gw) on every rank of
    the axis, in one collective (sharded.py:132-145)."""
    m = aug_loc.shape[0]
    first, last = kb0 // w, (kb0 + gw - 1) // w
    if first == last:
        if my == first:
            off = kb0 - my * w
            strip = aug_loc[:, off:off + gw].contiguous()
        else:
            strip = torch.empty((m, gw), dtype=aug_loc.dtype,
                                device=aug_loc.device)
        collective(dist.broadcast, strip, src=ranks[first], group=group)
        return strip
    strip = torch.zeros((m, gw), dtype=aug_loc.dtype, device=aug_loc.device)
    lo, hi = _overlap(kb0, gw, my, w)
    if lo < hi:
        strip[:, lo - kb0:hi - kb0] = aug_loc[:, lo - my * w:hi - my * w]
    collective(dist.all_reduce, strip, group=group)
    return strip


def window_update(aug_loc: torch.Tensor, og: torch.Tensor,
                  pivtot: torch.Tensor, *, off: int, ww: int,
                  precision: str) -> None:
    """The group's update on the local columns [off, off+ww)
    (sharded.py:170-189; ``ops/blocked._update_window``); counted."""
    window_update.calls += 1
    _update_window(aug_loc, og, pivtot, off, off + ww, precision)


window_update.calls = 0


def _deposit(aug_loc: torch.Tensor, chunk: torch.Tensor, g0: int, *,
             my: int, w: int) -> None:
    """Write the (m, gw) ``chunk`` of global columns [g0, g0+gw) into the
    part of them this rank holds (sharded.py:204-225)."""
    lo, hi = _overlap(g0, chunk.shape[1], my, w)
    if lo < hi:
        aug_loc[:, lo - my * w:hi - my * w] = chunk[:, lo - g0:hi - g0]


def _local_gj(aug_loc: torch.Tensor, *, m: int, b: int, w: int, group: int,
              my: int, pg, ranks, route: dict, precision: str):
    """Per-rank body (sharded.py:68-247) on the (m, w) local column shard
    ``aug_loc`` of [A | slots], updated in place; returns ``(pos, ok)``,
    replicated on every rank of the axis."""
    dev = aug_loc.device
    used = torch.zeros(m, dtype=torch.int32, device=dev)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    kb0 = 0
    for gsize in _group_sizes(m, b, group):
        gw = gsize * b
        strip = _gather_strip(aug_loc, kb0, gw, w=w, my=my, group=pg,
                              ranks=ranks)
        og = torch.zeros((m, 2 * gw), dtype=aug_loc.dtype, device=dev)
        og[:, :gw] = strip
        del strip
        pivtot, ok_g = _group_factor(og, kb0, used, gsize=gsize, gw=gw, b=b,
                                     precision=precision, **route)
        ok &= ok_g
        pos[kb0:kb0 + gw] = pivtot
        # The live window [kb0+gw, m+kb0) as a slice of width
        # ww = min(w, m-gw) clamped into the shard: the columns it
        # overhangs receive exact zero updates (finished columns are zero
        # at this group's pivot rows, later slots still zero).
        lo, hi = kb0 + gw, m + kb0
        ww = min(w, m - gw)
        if ww > 0 and my * w < hi and my * w + w > lo:
            window_update(aug_loc, og, pivtot,
                          off=min(max(lo - my * w, 0), w - ww), ww=ww,
                          precision=precision)
        _deposit(aug_loc, og[:, :gw], kb0, my=my, w=w)
        _deposit(aug_loc, og[:, gw:], m + kb0, my=my, w=w)
        kb0 += gw
    return pos, ok


def _gather_slots(aug_loc: torch.Tensor, *, m: int, w: int, my: int,
                  d: int, pg, ranks) -> torch.Tensor:
    """The (m, m) slot half on every rank (sharded.py:262-269, where XLA
    lowers the column gather to collectives), returned as the transpose of
    one contiguous (m, m) buffer: each rank that holds slot columns
    broadcasts them, as contiguous rows of that buffer, straight into
    place. So a rank receives only the slot columns it lacks, with no
    padding, list or concatenation: one collective per slot-holding rank
    (one at d = 1)."""
    out = torch.empty((m, m), dtype=aug_loc.dtype, device=aug_loc.device)
    for r in range(d):
        lo, hi = _overlap(m, m, r, w)
        if lo >= hi:
            continue
        if r == my:
            out[lo - m:hi - m] = aug_loc[:, lo - my * w:hi - my * w].T
        collective(dist.broadcast, out[lo - m:hi - m], src=ranks[r],
                   group=pg)
    return out.T


def _axis(mesh, axis: str):
    """(size, my coordinate, process group, its global ranks) of a mesh
    axis."""
    pg = mesh.get_group(axis)
    return (mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis), pg, dist.get_process_group_ranks(pg))


def _check_device(a: torch.Tensor, mesh) -> None:
    """Raise unless ``a`` lies on this rank's device of ``mesh``: the route
    never moves its input to another device."""
    want = (torch.device("cuda", torch.cuda.current_device())
            if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    if a.device != want:
        raise ValueError(f"input on {a.device} but this rank's device of "
                         f"the {mesh.device_type} mesh is {want}: move the "
                         f"input there or pass a mesh of its device type")


def _default_mesh(a: torch.Tensor, shape, names):
    """A mesh of ``shape`` over the initialized world on ``a``'s device
    type; ``ValueError`` when the world's backend does not serve it."""
    require_world()
    if not world_serves(a.device.type):
        raise ValueError(f"the process group's backend "
                         f"({dist.get_backend()}) does not serve "
                         f"{a.device.type} tensors: initialize NCCL for "
                         f"cuda input, gloo for cpu input, or pass mesh=")
    return make_device_mesh(shape, names, platform=a.device.type)


def _sharded_gj(a: torch.Tensor, *, m: int, b: int, group: int, pivot: bool,
                axis: tuple, use_kernels: bool, search_bf16: bool,
                precision: str):
    """One (n, n) matrix over one mesh axis (``axis`` as :func:`_axis`
    gives it); returns ``(inv, ok, pos)``, replicated on the axis."""
    d, my, pg, ranks = axis
    n = a.shape[-1]
    w = 2 * m // d
    route = dict(pivot=pivot, use_kernels=use_kernels,
                 search_bf16=search_bf16,
                 emit=_emit_fused(m, b, use_kernels, search_bf16),
                 search_f32=False)
    with matmul_precision(precision):
        aug_loc = _augment(a, m, my * w, my * w + w)
        pos, ok = _local_gj(aug_loc, m=m, b=b, w=w, group=group, my=my,
                            pg=pg, ranks=ranks, route=route,
                            precision=precision)
        slots = _gather_slots(aug_loc, m=m, w=w, my=my, d=d, pg=pg,
                              ranks=ranks)
        del aug_loc
        oks = ok.to(torch.int32)
        collective(dist.all_reduce, oks, op=dist.ReduceOp.MIN, group=pg)
        inv = _unpermute_slots(slots, pos, n)
        del slots
        ok = oks.bool() & torch.isfinite(inv).all()
    return inv, ok, pos


def sharded_blocked_inverse(a: torch.Tensor, *, mesh=None,
                            block_size: int = 128, pivot: bool = True,
                            axis: str = "x", precision: str = "highest",
                            search_bf16: bool = False,
                            group_size: Optional[int] = None,
                            refine: int = 1):
    """Invert a single (n, n) matrix column-sharded over ``mesh[axis]``
    (sharded.py:337-377); every rank passes the same ``a`` and gets the
    whole inverse.

    Returns ``(inverse, ok)`` like the single-chip paths, on ``a``'s
    device, which must be the rank's device of ``mesh`` (else
    ``ValueError``). ``mesh`` defaults to a 1-D mesh over the initialized
    world on ``a``'s device type, which the world's backend must serve;
    ``refine`` Newton-Schulz polish steps run on every rank on the
    replicated result (default 1, as ``blocked_inverse``). bf16 input
    computes in fp32 and returns bf16.
    """
    a = torch.as_tensor(a)
    if a.dtype == torch.bfloat16:
        inv, ok = sharded_blocked_inverse(
            a.float(), mesh=mesh, block_size=block_size, pivot=pivot,
            axis=axis, precision=precision, search_bf16=search_bf16,
            group_size=group_size, refine=refine)
        return inv.to(torch.bfloat16), ok
    if mesh is None:
        mesh = _default_mesh(a, (require_world(),), (axis,))
    inv, ok, _ = _sharded_raw(a, mesh=mesh, block_size=block_size,
                              pivot=pivot, axis=axis, precision=precision,
                              search_bf16=search_bf16, group_size=group_size)
    if refine > 0:
        # Eager, as the rest of the route: its graph (NCCL in a CUDA
        # graph) is later work.
        with graphs.disabled():
            inv = newton_schulz_refine(a, inv, iters=refine)
        ok = ok & torch.isfinite(inv).all()
    return inv, ok


def _sharded_raw(a: torch.Tensor, *, mesh, block_size: int = 128,
                 pivot: bool = True, axis: str = "x",
                 precision: str = "highest", search_bf16: bool = False,
                 group_size: Optional[int] = None):
    """:func:`sharded_blocked_inverse` of an fp32 or fp64 ``a`` on the
    rank's device, without the polish; returns ``(inv, ok, pos)`` (``pos``
    the pivot row of each slot)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {set(PRECISIONS)}")
    _check_device(a, mesh)
    ax = _axis(mesh, axis)
    b, m, group, use_kernels, search_bf16 = _sharded_params(
        a.shape[-1], block_size, ax[0], a.dtype, search_bf16, group_size)
    return _sharded_gj(a, m=m, b=b, group=group,
                       pivot=pivot, axis=ax,
                       use_kernels=use_kernels and mesh.device_type == "cuda",
                       search_bf16=search_bf16, precision=precision)


def _batched_fused_route(tp: int, n: int, dtype, cuda_mesh: bool) -> bool:
    """True when each rank should run K1 (``fused_inverse``) on its local
    batch instead of the column-sharded panel body (sharded.py:444-452): no
    tensor parallelism (tp == 1), a matrix within the fused route, fp32 or
    bf16, and a ``cuda`` mesh."""
    from gpu_matrix_inversion_tpu_torch.ops.fused import FUSED_MAX_N
    return (tp == 1 and n <= FUSED_MAX_N and cuda_mesh
            and dtype in (torch.float32, torch.bfloat16))


def sharded_batched_inverse(a: torch.Tensor, *, mesh=None,
                            block_size: int = 128, pivot: bool = True,
                            dp_axis: str = "dp", tp_axis: str = "tp",
                            precision: str = "highest",
                            group_size: Optional[int] = None):
    """Batched inversion on a 2-D (dp, tp) mesh (sharded.py:380-441): the
    batch split over ``dp``, each matrix's columns over ``tp``. ``a`` is
    (B, n, n) with B % dp == 0, the same on every rank; every rank gets the
    whole ``(inverse (B, n, n), ok (B,))``. No refinement, as in the
    reference. ``mesh`` defaults to (2, world/2) over an even world larger
    than 1, else (1, world), on ``a``'s device type; the input and the
    mesh must agree on the device as in :func:`sharded_blocked_inverse`.
    """
    a = torch.as_tensor(a)
    if a.dtype == torch.bfloat16:
        inv, ok = sharded_batched_inverse(
            a.float(), mesh=mesh, block_size=block_size, pivot=pivot,
            dp_axis=dp_axis, tp_axis=tp_axis, precision=precision,
            group_size=group_size)
        return inv.to(torch.bfloat16), ok
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {set(PRECISIONS)}")
    if mesh is None:
        size = require_world()
        dp = 2 if size % 2 == 0 and size > 1 else 1
        mesh = _default_mesh(a, (dp, size // dp), (dp_axis, tp_axis))
    _check_device(a, mesh)
    dp, my_dp, dp_pg, _ = _axis(mesh, dp_axis)
    tp_ax = _axis(mesh, tp_axis)
    bsz, n, _ = a.shape
    if bsz % dp != 0:
        raise ValueError(f"batch {bsz} not divisible by dp={dp}")
    per = bsz // dp
    local = a[my_dp * per:(my_dp + 1) * per]
    cuda_mesh = mesh.device_type == "cuda"
    if _batched_fused_route(tp_ax[0], n, a.dtype, cuda_mesh):
        from gpu_matrix_inversion_tpu_torch.ops.fused import fused_inverse
        inv, ok = fused_inverse(local, pivot=pivot)
    else:
        b, m, group, use_kernels, search_bf16 = _sharded_params(
            n, block_size, tp_ax[0], a.dtype, False, group_size)
        invs, oks = [], []
        for one in local:
            inv, ok, _ = _sharded_gj(
                one, m=m, b=b, group=group, pivot=pivot, axis=tp_ax,
                use_kernels=use_kernels and cuda_mesh,
                search_bf16=search_bf16, precision=precision)
            invs.append(inv)
            oks.append(ok)
        inv, ok = torch.stack(invs), torch.stack(oks)
    # Gathered over dp straight into one (B, n, n) output: each rank's
    # slice is a contiguous view of it, so no list of copies and no cat.
    inv_all = torch.empty((dp,) + inv.shape, dtype=inv.dtype,
                          device=inv.device)
    ok_all = torch.empty((dp, per), dtype=torch.int32, device=ok.device)
    collective(dist.all_gather, list(inv_all.unbind(0)), inv.contiguous(),
               group=dp_pg)
    collective(dist.all_gather, list(ok_all.unbind(0)), ok.to(torch.int32),
               group=dp_pg)
    return inv_all.reshape(a.shape), ok_all.reshape(bsz).bool()
