"""Refined LU route (``ops/refine.py``): the card's idle ms a traced call
while the route's own host code runs. Each idle gap between the device
records is split by the innermost ``matinv::`` span open over it
(``Segment.host``); the parts under ``matinv::refine.*`` spans are summed.
Idle under a span nested in them (the graph cache's ``graphs.*``) is that
layer's, and idle under no span the caller's.

None where the session recorded no ``matinv::refine.`` span (a program
without them).

The device records reach the host's clock through the profiler's
conversion, and some sessions drift from it by up to a few ms over the
traced calls; their gaps would then sit under the wrong spans. So the
records are first put back on the host's clock (:func:`aligned`); where
the clocks agree that moves nothing.

The split is the benchmark's own copy of the program's
``utils/profiling.idle_by_span``, so that a change to the program cannot
change the yardstick.
"""

import re
import statistics

from port_bench.core import trace

PREFIX = "matinv::refine."
# Runtime calls that put work on the card, and those that wait for it: a
# call's device records start no earlier than its first launch and end
# before its last wait returns.
LAUNCH = re.compile(r"cu(da)?(Launch|GraphLaunch|Memcpy|Memset)")
WAIT = re.compile(r"cu(da)?(Stream|Device|Event|Ctx)?Synchronize")
TO_HOST = "Memcpy DtoH"


def read(segment):
    if not any(h[0].startswith(PREFIX) for h in segment.host):
        return None
    records = aligned(segment)
    if records is None:
        return None
    seg = [h for h in segment.host if h[0] == trace.SEGMENT]
    lo, hi = ((seg[0][1], seg[0][1] + seg[0][2]) if seg
              else (-float("inf"), float("inf")))
    _, gaps = trace.union_s(records, lo, hi)
    by_span = idle_by_span(gaps, segment.host)
    return 1e3 * sum(v for k, v in by_span.items()
                     if k.startswith(PREFIX)) / segment.calls


def aligned(segment):
    """The segment's device records on the host's clock; None where the
    session has no ``port_bench::call`` range or no record, and the
    records as they are where they cannot be cut into calls (:func:`shares`).

    Each traced call waits for its answer, so on one clock its records
    start after its first runtime launch (:data:`LAUNCH`: the call's
    lead) and end before its last wait (:data:`WAIT`) returns (its lag).
    Where every call's lead and lag are positive the clocks agree and
    nothing moves. Elsewhere the device clock has drifted from the host's
    at a steady rate, which on the H100 has read up to 0.15%, 0.35 ms a
    call (PERF.md, Findings). The records are then put back by one
    straight line, the device clock reading ``t + c + rate * (t - t0)``
    at the host's ``t``: the rate is the common slope of the leads and of
    the negated lags over the session, and ``c`` makes the median lead
    equal the median lag. Sound H100 sessions with such a drift planted
    into them read back within 8 us a call of their own reading in all
    but one (18 us), against readings of 150 to 300 us."""
    calls = sorted((h[1], h[1] + h[2]) for h in segment.host
                   if h[0] == trace.CALL)
    records = sorted(segment.records, key=lambda r: r[1])
    if not calls or not records:
        return None
    launches = sorted(h[1] for h in segment.host if LAUNCH.match(h[0]))
    waits = sorted(h[1] + h[2] for h in segment.host if WAIT.match(h[0]))
    runs = shares(records, len(calls))
    if len(runs) != len(calls):
        return records
    starts, ends = [], []   # (host time, lead) and (host time, lag)
    for (opened, closed), share in zip(calls, runs):
        first = next((t for t in launches if opened <= t < closed), opened)
        last = max((t for t in waits if opened < t <= closed),
                   default=closed)
        starts.append((first, share[0][1] - first))
        ends.append((last, last - max(s + d for _, s, d in share)))
    if all(v >= 0 for _, v in starts + ends):
        return records
    t0 = starts[0][0]
    rate = _slope([(t - t0, v) for t, v in starts],
                  [(t - t0, -v) for t, v in ends])
    c = (statistics.median(v - rate * (t - t0) for t, v in starts)
         - statistics.median(v + rate * (t - t0) for t, v in ends)) / 2
    return [(name, t0 + (start - t0 - c) / (1 + rate), dur / (1 + rate))
            for name, start, dur in records]


def _slope(*groups) -> float:
    """The least-squares slope common to ``groups`` of ``(x, y)`` points,
    each with an intercept of its own; 0 where the x do not vary."""
    num = den = 0.0
    for pts in groups:
        if not pts:
            continue
        mx = sum(x for x, _ in pts) / len(pts)
        my = sum(y for _, y in pts) / len(pts)
        num += sum((x - mx) * (y - my) for x, y in pts)
        den += sum((x - mx) ** 2 for x, _ in pts)
    return num / den if den else 0.0


def shares(records: list, calls: int) -> list:
    """``records`` (in order of start) cut into one run a call. The calls
    replay the same graphs, so where the profiler kept every record the
    runs are equal. Else each call's run ends at its copy to the host
    (the caller reads ``ok`` there), where there is one a call; else the
    records stay one run and nothing is cut."""
    if len(records) % calls == 0:
        m = len(records) // calls
        return [records[j * m:(j + 1) * m] for j in range(calls)]
    ends = [i + 1 for i, r in enumerate(records) if r[0].startswith(TO_HOST)]
    if len(ends) != calls:
        return [records]
    bounds = [0] + ends[:-1] + [len(records)]
    return [records[a:b] for a, b in zip(bounds, bounds[1:])]


def idle_by_span(gaps, host) -> dict:
    """``{span name: seconds}``: the idle intervals ``gaps`` (``(start_s,
    end_s)``, apart and in order) split by the innermost ``matinv::`` range
    of ``host`` (``(name, start_s, seconds)``) open over each part. The
    program opens its ranges on the caller's thread only, and they nest,
    so the innermost range open at a moment is the open one that started
    last."""
    spans = sorted((h for h in host if h[0].startswith("matinv::")),
                   key=lambda h: (h[1], -h[2]))
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
