"""The traced segment of a ``--trace 1`` run, and what it is reduced to.

After the measured window, ``trace_calls`` more calls run under
``torch.profiler`` (CPU and CUDA activity), between two marker kernels:
on the H100 host a session has lost one kernel record at its start or
end, and the markers take that loss. The per-layer metrics
(``port_bench/metrics/<name>.py``) read the :class:`Segment`.

CUPTI loses records now and then, and has lost whole sessions. So the
records are held against what was launched: the kernel nodes of each CUDA
graph the calls replayed, times that graph's own replays, and K1's eager
launches as its wrapper counts them. A session that comes up short is
printed on standard error and profiled again, up to three sessions; after
that no traced metric is reported. No pass or fail rests on the profiler.

The segment keeps the session's host records beside the device's, the
program's ``matinv::`` spans among them, and the card's idle gaps, so
that a reader can put idle time down to the span open over it.

This is the benchmark's own copy of the arithmetic of the program's
``utils/profiling.py`` (markers, a retry on a session short of records),
so that a change to the program cannot change the yardstick.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
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
    seconds)`` of every device operation but the markers; ``host``: the
    session's host records alike, its ranges (``matinv::`` spans,
    ``port_bench::call``) among them; ``gaps``: ``(start_s, end_s)`` of
    each interval of the segment in which no operation ran on the card
    between two that did, in order, on the clock of both."""
    calls: int
    window_s: float
    busy_s: float
    records: list
    counters: dict
    work: dict
    host: list = dataclasses.field(default_factory=list)
    gaps: list = dataclasses.field(default_factory=list)

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


def graph_state() -> tuple:
    """The program's graph cache as a call leaves it: ``({function:
    replays}, keys)``, the replays of ``graphs.stats()`` and the cached
    graphs' keys (each names its function, ``.fn``) in the order of their
    last use, oldest first. As cheap as a read of the counters: no graph
    is read."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    return ({fn: c["replays"] for fn, c in graphs.stats().items()},
            tuple(graphs._cache.entries))


def graph_replays(states: list) -> collections.Counter:
    """``{graph key: replays}`` over the calls between consecutive
    ``states`` (:func:`graph_state`, read before the first call and after
    each). A function replayed n times in a call replayed its n graphs
    used last, once each; replays beyond its cached graphs go to the one
    used last. Exact where no call replays one graph twice while another
    graph of its function is cached."""
    out = collections.Counter()
    for (before, _), (after, order) in zip(states, states[1:]):
        for fn, total in after.items():
            n = total - before.get(fn, 0)
            keys = [k for k in reversed(order) if k.fn == fn][:max(n, 0)]
            for key in keys:
                out[key] += 1
            if keys:
                out[keys[0]] += n - len(keys)
    return out


def replayed_calls(states: list) -> int:
    """The calls between consecutive ``states`` across which the program's
    graph replays rose."""
    totals = [sum(replays.values()) for replays, _ in states]
    return sum(1 for a, b in zip(totals, totals[1:]) if b > a)


def expected(replays: dict, order: tuple, k1_launches: int,
             kernel_nodes=None) -> dict:
    """``{kernel name: records the session must hold at least}``: the
    kernel nodes of each graph in ``replays`` (:func:`graph_replays`)
    times its own replays, and K1's eager launches (``|`` joins the names
    one entry stands for). ``order``: the cache's keys as the session left
    them, oldest first. A graph's nodes are read after the session, by
    ``kernel_nodes`` (``graphs.kernel_nodes``): the j-th graph used last
    is ``last=j`` less ``last=j - 1``. A graph no longer cached has no
    nodes to read and is left out."""
    if kernel_nodes is None:
        from gpu_matrix_inversion_tpu_torch.utils import graphs
        kernel_nodes = graphs.kernel_nodes
    recent = {key: j for j, key in enumerate(reversed(order), 1)}

    @functools.cache
    def last(j: int) -> dict:
        return kernel_nodes(last=j) if j else {}     # last=0: every graph

    out = collections.Counter()
    for key, n in replays.items():
        j = recent.get(key)
        if j is None or n <= 0:
            continue
        newer = last(j - 1)
        for name, nodes in last(j).items():
            out[base_name(name)] += (nodes - newer.get(name, 0)) * n
    if k1_launches:
        out["|".join(kernels.K1)] += k1_launches
    return {name: n for name, n in out.items() if n}


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
        k1_before, states = _k1_launches(), [graph_state()]
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            with torch.profiler.record_function(SEGMENT):
                t0 = time.perf_counter()
                for i in range(calls):
                    with torch.profiler.record_function(CALL):
                        load.call(i)
                    states.append(graph_state())
                load.sync()
                window_s = time.perf_counter() - t0
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        device, host = records(prof)
        device = [r for r in device if MARKER not in r[0]]
        want = expected(graph_replays(states), states[-1][1],
                        _k1_launches() - k1_before)
        short = shortfall(want, device)
        if device and not short:
            return assemble(calls, window_s, device, host,
                            {"replayed_calls": replayed_calls(states)}, work)
        print(f"traced session {attempt + 1}: the profiler's records come "
              f"up short of the launches: {short or 'no device records'}",
              file=sys.stderr)
    return None, None


def assemble(calls: int, window_s: float, device: list, host: list,
             counters: dict, work: dict):
    """The :class:`Segment` of a session's records and its breakdown: the
    card's busy time and idle gaps within the host's segment range."""
    seg = [h for h in host if h[0] == SEGMENT]
    lo, hi = ((seg[0][1], seg[0][1] + seg[0][2]) if seg
              else (-float("inf"), float("inf")))
    busy, gaps = union_s(device, lo, hi)
    segment = Segment(calls, window_s, busy, device, counters, work,
                      host, gaps)
    return segment, breakdown(device, host, gaps)


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
