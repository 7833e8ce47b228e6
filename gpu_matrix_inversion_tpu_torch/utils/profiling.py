"""Observability: the startup device dump, the per-phase report and the
device-time breakdown of one call.

Port of the two pieces of ``gpu_matrix_inversion_tpu/utils/profiling.py``
that the verbose ``matrix_inversion_fp32`` path uses. The reference prints
its CL_DEVICE_* attributes at startup and a per-phase trace with derived
GFLOPS afterwards (``matrix_inversion_FP32.cpp:304-333``, ``:711-723``).
:func:`device_kernels`, :func:`device_ms` and :func:`events_ms` serve the
measurement scripts (``chip_smoke.py``, ``probes/``).
"""

from __future__ import annotations

import torch


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
    :class:`NoDeviceTime`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # Kernel and memcpy entries only: an operator's own entry would
        # count its kernels' time a second time.
        rows = [(e.key, e.count,
                 getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows.sort(key=lambda row: -row[2])
        if rows and rows[0][2] > 0:
            return rows
    raise NoDeviceTime(f"torch.profiler recorded no device time in {tries} "
                       f"sessions")


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
