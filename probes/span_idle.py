"""The card's idle time in a traced run of a benchmark cell, put down to
the port's layers by its profiler spans.

    python3 -m probes.span_idle --workload single4096.flat --seed 7 \
        --seconds 10 [--out span_idle.jsonl]

Runs one ``--trace 1`` run of a cell of ``BENCHMARK.json`` as
``port_bench/run.py`` does (the same window, traced segment, retry and
checks) and keeps the records of the traced session it accepted. Prints
the run's result line, then one JSON line (appended to ``--out`` too):

- ``idle_ms``: the card's idle time between its operations inside the
  segment, ms a traced call, by layer: ``api`` (innermost span
  ``api.*``), ``dispatch`` (``solver.*``, ``graphs.*``, ``fused.*``: the
  dispatch and the routes' host code), ``refine`` (``refine.*``: the
  refined LU route's own host code) and ``caller`` (no span open), and
  by span (``utils/profiling.idle_by_span``);
- ``wake_ms``: for each host synchronize (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``), how long after the last device operation
  before its end it returned: quantiles over the segment;
- ``lead_us``: how long after each runtime launch inside the spans its
  first device record started (``utils/profiling.launch_leads``): the
  smallest, the median, and the smallest for each pair of launch and
  record names. A negative smallest lead marks a session whose device
  records sit early against its host records, by at least that much; its
  idle split is off by as much at each gap's ends.

Needs a CUDA device and this checkout's port; imports no JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import run  # noqa: E402
from port_bench.core import spec, trace  # noqa: E402

from gpu_matrix_inversion_tpu_torch.utils.profiling import (  # noqa: E402
    idle_by_span, launch_leads)

LAYERS = {"api": ("matinv::api.",),
          "dispatch": ("matinv::solver.", "matinv::graphs.",
                       "matinv::fused."),
          "refine": ("matinv::refine.",)}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def _kept_sessions(kept: list):
    """``trace.records`` that also keeps each session's records and its
    runtime launches' leads in ``kept``."""
    records = trace.records

    def keep(prof):
        device, host = records(prof)
        kept.append((device, host, launch_leads(prof.events())))
        return device, host
    return keep


def split(device, host, leads, calls: int) -> dict:
    """The JSON line's numbers from one session's records, as
    ``trace.profile`` bounds and reduces them."""
    device = [r for r in device if trace.MARKER not in r[0]]
    seg = [h for h in host if h[0] == trace.SEGMENT]
    lo, hi = seg[0][1], seg[0][1] + seg[0][2]
    busy, gaps = trace.union_s(device, lo, hi)
    by_span = idle_by_span(gaps, host) or {}
    gap_s = sum(e - s for s, e in gaps)
    layers = {layer: sum(v for k, v in by_span.items()
                         if k.startswith(prefixes))
              for layer, prefixes in LAYERS.items()}
    layers["caller"] = gap_s - sum(layers.values())
    ends = sorted(s + d for _, s, d in device)
    wakes = []
    for name, start, dur in host:
        i = bisect.bisect_right(ends, start + dur)
        if name in SYNCS and lo <= start <= hi and i:
            wakes.append(start + dur - ends[i - 1])
    ms = 1e3 / calls
    out = {"calls": calls, "segment_ms": (hi - lo) * ms,
           "busy_ms": busy * ms, "gap_ms": gap_s * ms,
           "idle_ms": {k: v * ms for k, v in layers.items()},
           "idle_ms_by_span": {k: v * ms for k, v in sorted(
               by_span.items(), key=lambda kv: -kv[1])},
           "syncs": len(wakes)}
    if len(wakes) >= 2:
        q = statistics.quantiles(wakes, n=4)
        out["wake_ms"] = {"min": 1e3 * min(wakes), "q1": 1e3 * q[0],
                          "median": 1e3 * q[1], "q3": 1e3 * q[2],
                          "max": 1e3 * max(wakes)}
    if leads:
        lead_us = {}
        for lead, launch, record in sorted(leads, reverse=True):
            lead_us[f"{launch} -> {record}"] = lead
        out["lead_us"] = {"launches": len(leads),
                          "min": min(r[0] for r in leads),
                          "median": statistics.median(r[0] for r in leads),
                          "min_by_pair": dict(sorted(
                              lead_us.items(), key=lambda kv: kv[1])[:8])}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    cell = spec.cell(args.workload)
    run.need_chips(cell.chips)
    kept = []
    with mock.patch.object(trace, "records", _kept_sessions(kept)):
        out = run.measure(cell, args.seed, args.seconds, traced=True)
    print(json.dumps(out), flush=True)
    if "breakdown" not in out:
        print("span_idle: no traced session was accepted", file=sys.stderr)
        return 1
    line = {"workload": args.workload, "seed": args.seed,
            "card": run.card_line(), "window_s": out["device"]["window_s"],
            **split(*kept[-1], int(cell.traffic["trace_calls"]))}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
