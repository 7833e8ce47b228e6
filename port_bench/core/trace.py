"""The traced segment of a ``--trace 1`` run, and what it is reduced to.

After the measured window, ``trace_calls`` more calls run under
``torch.profiler`` (CPU and CUDA activity), between two marker kernels:
on the H100 host a session has lost one kernel record at its start or
end, and the markers take that loss. The per-layer metrics
(``port_bench/metrics/<name>.py``) read the :class:`Segment`.

CUPTI loses records now and then, and has lost whole sessions. So the
records are held against what was launched: each graph kernel node times
the replays, and K1's eager launches as its wrapper counts them. A session
that comes up short is printed on standard error and profiled again, up
to three sessions; after that no traced metric is reported. No pass or
fail rests on the profiler.

This is the benchmark's own copy of the arithmetic of the program's
``utils/profiling.py`` (markers, a retry on a session short of records),
so that a change to the program cannot change the yardstick.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import sys
import time

import torch

from port_bench.core import kernels
from port_bench.reference import counts

MARKER = "spin_kernel"           # torch.cuda._sleep's kernel
SEGMENT = "port_bench::segment"
CALL = "port_bench::call"
TRIES = 3
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


@dataclasses.dataclass
class Segment:
    """What the traced calls ran. ``records``: ``(name, start_s,
    seconds)`` of every device operation but the markers."""
    calls: int
    window_s: float
    busy_s: float
    records: list
    counters: dict
    work: dict

    def host_copies(self) -> list:
        return [r for r in self.records if r[0].startswith(HOST_COPIES)]

    def device_s(self) -> float:
        """Device seconds of the calls' work: every operation but the
        copies between host and card."""
        return sum(r[2] for r in self.records
                   if not r[0].startswith(HOST_COPIES))

    def seconds_of(self, names) -> float:
        return sum(r[2] for r in self.records
                   if any(name in r[0] for name in names))

    def roofline_pct(self, route_kernels) -> float | None:
        """The calls' work (``work``: the segment's operations, bytes and
        dtype, from ``Load.work``) over their device time, as a share of
        the roofline (``reference/counts.py``); None where none of
        ``route_kernels`` ran, so that a route taken off the path reads
        nothing."""
        if not self.seconds_of(route_kernels):
            return None
        bound = counts.bound_s(self.work["flops"], self.work["bytes"],
                               self.work["dtype"])
        return 100.0 * bound / self.device_s()

    def idle_pct(self) -> float:
        """The share of the segment's wall time in which no operation ran
        on the card."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _times(event):
    """``(start_s, seconds)`` of a kineto event."""
    if hasattr(event, "start_ns"):
        return event.start_ns() * 1e-9, event.duration_ns() * 1e-9
    return event.start_us() * 1e-6, event.duration_us() * 1e-6


def records(prof):
    """``(device, host)`` records of a finished profile: each
    ``(name, start_s, seconds)``. A ``record_function`` range is also
    drawn on the device's timeline (a user annotation spanning the
    kernels it launched); those copies are no device operation and are
    left out."""
    from torch.autograd import DeviceType
    device, host = [], []
    for event in prof.profiler.kineto_results.events():
        start, dur = _times(event)
        row = (event.name(), start, dur)
        if event.device_type() == DeviceType.CUDA:
            if not _annotation(event):
                device.append(row)
        elif event.device_type() == DeviceType.CPU:
            host.append(row)
    return device, host


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag and flag()) or event.name() in (SEGMENT, CALL)


def union_s(rows, lo: float = -float("inf"), hi: float = float("inf")):
    """Seconds of ``[lo, hi]`` that some row covers, and the gaps between
    the covered spans as ``(start, end)``."""
    spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in rows)
    busy, gaps, cur = 0.0, [], None
    for s, e in spans:
        if e <= s:
            continue
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def base_name(mangled: str) -> str:
    """The function's own name inside an Itanium-mangled name
    (``_ZN2at6native13reduce_kernel...`` -> ``reduce_kernel``); a name
    that is not mangled comes back as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    s = mangled[2:].lstrip("NKL")
    last = mangled
    while True:
        m = re.match(r"(\d+)", s)
        if not m:
            return last
        size = int(m.group(1))
        start = len(m.group(1))
        last = s[start:start + size]
        s = s[start + size:]


def _k1_launches() -> int:
    from gpu_matrix_inversion_tpu_torch.ops import fused
    return fused.gj_kernel.launches


def _replays() -> int:
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    return sum(c["replays"] for c in graphs.stats().values())


def expected(replays: int, k1_launches: int) -> dict:
    """``{kernel name: records the session must hold at least}``: the
    nodes of the graph last replayed times ``replays``, and K1's eager
    launches (``|`` joins the names one entry stands for)."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    out = collections.Counter()
    if replays:
        for name, nodes in graphs.kernel_nodes(last=1).items():
            out[base_name(name)] += nodes * replays
    if k1_launches:
        out["|".join(kernels.K1)] += k1_launches
    return dict(out)


def shortfall(want: dict, device: list) -> dict:
    """``{name: (wanted, recorded)}`` where the records come up short."""
    short = {}
    for key, n in want.items():
        names = key.split("|")
        got = sum(1 for row in device if any(nm in row[0] for nm in names))
        if got < n:
            short[key] = (n, got)
    return short


def profile(load, calls: int):
    """Run ``calls`` calls of ``load`` under the profiler; the
    :class:`Segment` and its breakdown, or ``(None, None)`` where every
    session came up short."""
    work = load.work(calls)
    from torch.profiler import ProfilerActivity, profile as torch_profile
    for attempt in range(TRIES):
        k1_before, replays0 = _k1_launches(), _replays()
        replayed = 0
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            with torch.profiler.record_function(SEGMENT):
                t0 = time.perf_counter()
                for i in range(calls):
                    r0 = _replays()
                    with torch.profiler.record_function(CALL):
                        load.call(i)
                    replayed += _replays() > r0
                load.sync()
                window_s = time.perf_counter() - t0
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        device, host = records(prof)
        device = [r for r in device if MARKER not in r[0]]
        want = expected(_replays() - replays0, _k1_launches() - k1_before)
        short = shortfall(want, device)
        if device and not short:
            seg = [h for h in host if h[0] == SEGMENT]
            lo, hi = ((seg[0][1], seg[0][1] + seg[0][2]) if seg
                      else (-float("inf"), float("inf")))
            busy, gaps = union_s(device, lo, hi)
            segment = Segment(calls, window_s, busy, device,
                              {"replayed_calls": replayed}, work)
            return segment, breakdown(device, host, gaps)
        print(f"traced session {attempt + 1}: the profiler's records come "
              f"up short of the launches: {short or 'no device records'}",
              file=sys.stderr)
    return None, None


def breakdown(device: list, host: list, gaps: list, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by the innermost host operation running at each gap's middle."""
    ops = collections.Counter()
    for name, _, dur in device:
        ops[name] += dur
    idle = collections.Counter()
    # A sweep over the host spans in order of start: a stack of the open
    # ones, nested, whose top is the innermost span open at a moment.
    spans = sorted(host, key=lambda h: h[1])
    stack, j = [], 0
    for start, end in sorted(gaps):
        mid = (start + end) / 2
        while j < len(spans) and spans[j][1] <= mid:
            while stack and stack[-1][1] + stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] + stack[-1][2] < mid:
            stack.pop()
        idle[stack[-1][0] if stack else "(no host operation)"] += end - start
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
