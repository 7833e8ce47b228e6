"""Observability: traces, the startup device dump, the per-phase report
and the device-time breakdown of one call.

Port of ``gpu_matrix_inversion_tpu/utils/profiling.py``. The reference
prints its CL_DEVICE_* attributes at startup and a per-phase trace with
derived GFLOPS afterwards (``matrix_inversion_FP32.cpp:304-333``,
``:711-723``). :func:`trace` replaces the JAX package's ``jax.profiler``
capture with a ``torch.profiler`` one. :func:`phase` marks the blocked
driver's phases for it and for ``benchmarks/phases.py``; :func:`span`
marks the layer boundaries of every call (the API, the dispatch, the graph
cache, the fused route's host code, the refined LU route) for any profiler
session; :func:`idle_by_span` puts the card's idle time in such a session
down to them, and :func:`launch_leads` checks that the session's host and
device records agree on the clock. :func:`device_kernels`,
:func:`device_ms` and :func:`events_ms` serve the measurement scripts
(``probes/``) and the on-card tests (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import bisect
import contextlib

import torch

# Whether phase() opens a record_function range; off outside trace() and
# phase_ranges(), so that the hot path pays one flag test a phase.
_ranges_on = False
# The profiler's own test of whether a session records (kineto's, and the
# legacy autograd profiler's).
_recording = torch._C._autograd._profiler_enabled
# The context span() and phase() return while they open no range.
_NO_RANGE = contextlib.nullcontext()


def _range(name: str):
    return torch.profiler.record_function(f"matinv::{name}")


def span(name: str):
    """A ``torch.profiler.record_function`` range ``matinv::<name>`` while
    a profiler session records, else a shared no-op context (one call of
    the profiler's enabled test: under 1 us a span on a CPU host, where an
    open range costs 12-14 us). The range is a host record of the
    session that records the device's operations, on its clock, so an idle
    gap on the card can be put down to the span open during it
    (:func:`idle_by_span`).

    The layer boundaries of a call, nested on the caller's thread:
    ``api.validate``, ``api.stage``, ``api.ok``, ``api.readback``,
    ``api.convert`` (``api._invert_flat``); ``solver.inverse`` (the whole
    dispatch); ``graphs.key``, ``graphs.copy_in``, ``graphs.replay``,
    ``graphs.copy_out`` (a compiled call served from the graph cache);
    ``fused.k1``, ``fused.gather`` (the fused route's host code);
    ``refine.inverse``, ``refine.factor``, ``refine.polish``
    (``ops/refine.lu_inverse_refined``). No switch turns them on and
    nothing of them enters a graph's key: a replayed graph runs as it does
    unprofiled."""
    if _recording():
        return _range(name)
    return _NO_RANGE


def phase(name: str):
    """A ``torch.profiler.record_function`` range ``matinv::<name>`` while
    phase ranges are on (:func:`phase_ranges`, :func:`trace`), else a
    no-op context. The blocked driver marks three of the reference's Res
    slots with it: ``make_augmented``, ``pivot`` and ``row``; the fourth,
    ``column``, is the rest of the call."""
    if _ranges_on:
        return _range(name)
    return _NO_RANGE


def idle_by_span(gaps, host) -> dict | None:
    """``{span name: seconds}``: the card's idle intervals ``gaps``
    (``(start_s, end_s)``, apart and in order) split by the innermost
    ``matinv::`` range of ``host`` (``(name, start_s, seconds)`` host
    records of the same profiler session) open over each part; None where
    ``host`` holds no such range. An interval that crosses a boundary
    between ranges is split at it. Idle time under no ``matinv::`` range
    is the caller's and goes to no name. The program opens its ranges on
    the caller's thread only, and they nest, so the innermost range open
    at a moment is the open one that started last."""
    spans = sorted((h for h in host if h[0].startswith("matinv::")),
                   key=lambda h: (h[1], -h[2]))
    if not spans:
        return None
    # The timeline as pieces (start, end, name) of the innermost range.
    pieces, stack, t = [], [], 0.0

    def close(until: float) -> None:
        nonlocal t
        while stack and stack[-1][1] <= until:
            name, end = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for name, start, dur in spans:
        close(start)
        if stack and start > t:
            pieces.append((t, start, stack[-1][0]))
        stack.append((name, start + dur))
        t = start
    close(float("inf"))
    out, j = {}, 0
    for lo, hi in gaps:
        while j < len(pieces) and pieces[j][1] <= lo:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < hi:
            start, end, name = pieces[k]
            part = min(hi, end) - max(lo, start)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
            k += 1
    return out


def launch_leads(events) -> list:
    """``(lead_us, launch, record)`` for each runtime launch
    (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync`` ...)
    made inside a ``matinv::`` range, from one session's
    ``prof.events()``: the microseconds from the launch's start on the host
    to the start of the first device record it made (linked by correlation
    id), its name and that record's. Every lead is at least 0 where the
    host and device records share a clock: a device operation cannot start
    before its launch. Some sessions put every device record early,
    kernels and copies alike (13 of 64 sessions, by up to 3.2 ms; H100
    80GB HBM3, 700 W), so a reader of a session's gaps checks it here
    first."""
    from torch.autograd import DeviceType
    merged = []
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events
                         if e.device_type == DeviceType.CPU
                         and e.name.startswith("matinv::")):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    starts = [lo for lo, _ in merged]

    def inside(t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]

    launched = {e.id: e for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")
                and inside(e.time_range.start)}
    first = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and e.id in launched
                and not getattr(e, "is_user_annotation", False)
                and (e.id not in first
                     or e.time_range.start < first[e.id].time_range.start)):
            first[e.id] = e
    return [(e.time_range.start - launched[i].time_range.start,
             launched[i].name, e.name) for i, e in first.items()]


@contextlib.contextmanager
def phase_ranges():
    """Turn :func:`phase`'s ranges on for the enclosed block, whose
    compiled calls run eagerly (``graphs.disabled()``): a replayed graph
    opens no range, so its kernels could not be told apart by phase."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    global _ranges_on
    prev, _ranges_on = _ranges_on, True
    try:
        with graphs.disabled():
            yield
    finally:
        _ranges_on = prev


def _activities(device) -> list:
    """Profiler activities for ``device``: CPU, plus CUDA on a CUDA device,
    which must be present (nothing carries on without the card)."""
    from torch.profiler import ProfilerActivity
    device = torch.device(device)
    if device.type == "cpu":
        return [ProfilerActivity.CPU]
    if device.type != "cuda":
        raise ValueError(f"trace records cpu or cuda, not {device}")
    if not torch.cuda.is_available() or (
            device.index is not None
            and device.index >= torch.cuda.device_count()):
        raise RuntimeError(f"trace on {device}: no such CUDA device")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (``*.pt.trace.json``, readable in TensorBoard's profiler
    plugin and in Perfetto), with the blocked driver's phase ranges on
    and so the compiled routes run eagerly (:func:`phase_ranges`).
    Records the CUDA activity of the block when ``device`` is a CUDA device
    (raising if it is absent), CPU activity only for ``device="cpu"``."""
    from torch.profiler import profile, tensorboard_trace_handler
    activities = _activities(device)
    cuda = len(activities) > 1
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        with phase_ranges():
            yield
        if cuda:
            torch.cuda.synchronize(device)


def device_info(device="cuda") -> dict:
    """Device-capability dump (reference FP32.cpp:304-333 prints max
    workgroup size, global/local memory and compute units). On a CUDA
    device the counterparts are the SM count, device memory and the
    opt-in shared memory per block, which bounds the panel kernels'
    strips (ops/blocked.py)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"backend": device.type, "device_count": 1}
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    props = torch.cuda.get_device_properties(index)
    entry = {
        "id": index,
        "name": props.name,
        "compute_capability": f"{props.major}.{props.minor}",
        "multi_processor_count": props.multi_processor_count,
        "total_memory_bytes": props.total_memory,
        "shared_memory_per_block_optin_bytes": getattr(
            props, "shared_memory_per_block_optin", None),
        "l2_cache_bytes": getattr(props, "L2_cache_size", None),
    }
    return {
        "backend": "cuda",
        "torch_cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "devices": [{k: v for k, v in entry.items() if v is not None}],
    }


def print_phase_report(res, order: int, out=None) -> None:
    """Per-phase stdout trace + derived GFLOPS (reference's verbose paths)."""
    import sys
    out = out or sys.stdout
    t = res.times
    print(f"matrix order: {order}", file=out)
    for key in ("buffers", "compile", "make_augmented", "pivot", "row",
                "column", "total_compute", "identity_check",
                "get_inverted", "total"):
        if key in t:
            print(f"  {key:>14}: {t[key] * 1e3:10.3f} ms", file=out)
    if getattr(res, "identity_error", None) is not None:
        # Strict identity self-check (reference FP32.cpp:814-835).
        print(f"  {'max|AX-I|':>14}: {res.identity_error:10.3e}", file=out)
    tc = t.get("total_compute")
    if tc:
        # The reference's fixColumn flop model: 4*N^3 total
        # (matrix_inversion_FP64.cpp:753-755).
        print(f"  {'gflops(4N^3)':>14}: {4 * order**3 / tc / 1e9:10.1f}",
              file=out)
    print(f"  {'status':>14}: {'ok' if res.ok else 'FAILED'}", file=out)


def is_marker(name: str) -> bool:
    """Whether a device record is one of :func:`bracketed`'s markers."""
    return "spin_kernel" in name


@contextlib.contextmanager
def bracketed(device="cuda"):
    """Launch a marker kernel (``torch.cuda._sleep``'s ``spin_kernel``)
    before and after the block on a CUDA device. On the H100 host a
    profiled session has come back without the record of one kernel at
    its start or end: a session of 20 GEMMs between two markers held all
    20 GEMMs and one marker, and without markers n back-to-back launches
    of one kernel read (n - 1)/n of CUDA events' time. The markers take
    that loss; device time leaves them out (:func:`is_marker`)."""
    on = torch.device(device).type == "cuda" and torch.cuda.is_available()
    if on:
        torch.cuda._sleep(1)
    yield
    if on:
        torch.cuda._sleep(1)


class NoDeviceTime(RuntimeError):
    """torch.profiler recorded no device activity for a profiled call, in
    every session :func:`device_kernels` tried."""


def device_kernels(fn, tries: int = 3) -> list[tuple[str, int, float]]:
    """(name, launches, ms) of every kernel and copy one call of ``fn``
    ran on the device, from ``torch.profiler``, largest device time first.
    Their sum is the call's device time; the rest of its time on the host
    clock the device waited. CUPTI drops a session's kernel records now and
    then (seen on the H100 host: one session of dozens in a process, the
    next one fine), so a session that saw no device time is profiled again,
    up to ``tries`` sessions (``fn`` runs once in each); then this raises
    :class:`NoDeviceTime`. ``fn`` runs between :func:`bracketed`'s
    markers, which the rows leave out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with bracketed():
                fn()
            torch.cuda.synchronize()
        # Kernel and memcpy entries only: an operator's own entry would
        # count its kernels' time a second time, and so would a range's
        # span on the device timeline (a span() or phase() range drawn
        # over the kernels launched inside it).
        rows = [(e.key, e.count,
                 getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not is_marker(e.key)
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("matinv::")]
        rows.sort(key=lambda row: -row[2])
        if rows and rows[0][2] > 0:
            return rows
    raise NoDeviceTime(f"torch.profiler recorded no device time in {tries} "
                       f"sessions")


# The port's kernels (csrc/) by the names the profiler records them under.
# K2 and K6 launch one kernel, K6 as k clusters of K2's.
KERNEL_NAMES = {"K1": ("fused_gj_regs_kernel", "fused_gj_cluster_kernel"),
                "K2/K6": ("panel_factor_cluster_kernel",),
                "K3": ("pivot_search_cluster_kernel",),
                "K4": ("small_inv_kernel",), "K5": ("small_lu_kernel",),
                "K7": ("matmul_f32_kernel", "matmul_bf16_kernel"),
                "L1": ("gauss_jordan_cluster_kernel",
                       "gauss_jordan_grid_kernel"),
                "L2": ("logical_panel_kernel",),
                "L3": ("lu_panel_kernel",),
                "L4": ("lu_factor_cluster_kernel", "lu_factor_grid_kernel"),
                "L5": ("lu_solve_kernel",)}


def kernel_launches(rows) -> dict:
    """``{kernel: launches}`` of the port's kernels (:data:`KERNEL_NAMES`)
    in :func:`device_kernels`' rows, those that ran at least once: what
    the device ran, a replayed graph's kernels included."""
    out = {}
    for key, count, _ in rows:
        for kernel, names in KERNEL_NAMES.items():
            if any(name in key for name in names):
                out[kernel] = out.get(kernel, 0) + count
    return out


def device_ms(fn, iters: int = 1, name: str | None = None) -> float | None:
    """Device ms per call of ``fn`` (after a warm-up call), from
    :func:`device_kernels` over ``iters`` calls: the summed time of the
    kernels and copies whose name holds ``name``, or of all of them; None
    (not measured) if the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    try:
        rows = device_kernels(lambda: [fn() for _ in range(iters)])
    except NoDeviceTime:
        return None
    return sum(ms for key, _, ms in rows
               if name is None or name in key) / iters


def events_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` between two CUDA events, over ``iters``
    calls after ``warmup`` calls. For a call much shorter than its host
    code (a launch wrapper) this times the host: compare
    :func:`device_ms`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
