"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The run makes its inputs from ``--seed``,
loads the port (``gpu_matrix_inversion_tpu_torch``, which builds its
kernels into ``build/torch_kernels`` on its first run in the checkout),
warms each signature of the cell's pool, then drives a closed loop of one
caller for ``--seconds``. Set-up (``setup_s``) runs from the start of this
process to the first timed call. With ``--trace 1`` a traced segment
follows the window and the line carries the per-layer metrics.

After the window the answers are held against the plain reference
(``core/check.py``). The numbers compared go, each beside its limit, to
the last lines of standard error and under ``checks``, the last key of
the result line, which is the last line of standard output. The run
exits nonzero with no result line without a CUDA card (or with fewer than
the cell asks for), where the port is not in this checkout, and where
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench.core import check, loop, spec, trace  # noqa: E402

PORT = "gpu_matrix_inversion_tpu_torch"
# Top-level module names that may not be loaded, compared whole: the port's
# name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_matrix_inversion_tpu")


class RunError(RuntimeError):
    """The run cannot give a result."""


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def import_port(root: Path = ROOT):
    """The port, imported from ``root``; raises :class:`RunError` where it
    is missing there or comes from elsewhere."""
    try:
        import gpu_matrix_inversion_tpu_torch as port
    except ImportError as err:
        raise RunError(f"the port ({PORT}) is not importable: {err}") from err
    where = Path(port.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RunError(f"the port comes from {where}, not from {root}")
    return port


def need_chips(chips: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are visible")


def card_line() -> str:
    """The card's name, power limit and clocks, from nvidia-smi."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        done = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"
    return f"nvidia-smi ({query}): {done.stdout.strip()}"


def end_to_end(cell, window, setup_s: float, root: Path = ROOT) -> dict:
    """The cell's end-to-end metrics: ``setup_s``, and the others from the
    window by their readers (``port_bench/metrics/``)."""
    out = {}
    for m in cell.end_to_end:
        value = (setup_s if m.name == "setup_s"
                 else spec.reader(m.name, root)(window))
        out[m.name] = {"value": value, "unit": m.unit}
    return out


def _json_number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def measure(cell, seed: int, seconds: float, traced: bool, device="cuda",
            t_start: float = T_START, root: Path = ROOT) -> dict:
    """One run of ``cell`` on ``device``; the result line's object."""
    marks = [("start", t_start), ("imports", time.perf_counter())]
    import_port(root)
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    device = torch.device(device)
    on_card = device.type == "cuda"
    marks.append(("port", time.perf_counter()))
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
        marks.append(("context", time.perf_counter()))
    load = loop.Load(cell, seed, device)
    load.sync()
    marks.append(("inputs", time.perf_counter()))
    load.warm()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("set-up s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (_, prev), (name, t)
        in zip(marks, marks[1:])), file=sys.stderr)

    window = load.window(seconds, int(cell.traffic["sample"]))
    load.sync()
    out = {"correct": False, "attempted": window.calls,
           "failed": sum(1 for ok in window.oks if not ok), "metrics": {},
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": int(
                          torch.cuda.max_memory_allocated(device)
                          if on_card else 0)}}
    if traced:
        segment, breakdown = trace.profile(
            load, int(cell.traffic["trace_calls"]))
        if segment is not None:
            for m in cell.per_layer:
                value = spec.reader(m.name, root)(segment)
                if value is not None:
                    out["metrics"][m.name] = {"value": value, "unit": m.unit}
            out["device"].update(busy_s=segment.busy_s,
                                 window_s=segment.window_s)
            out["breakdown"] = breakdown
    else:
        out["metrics"] = end_to_end(cell, window, setup_s, root)
    print(card_line() if on_card else "device: cpu", file=sys.stderr)

    # The program's state goes before the reference runs.
    graphs.clear()
    if on_card:
        torch.cuda.empty_cache()
    correct, checks = check.verdict(check.readings(load, window), cell.limits)
    out["correct"] = bool(correct)
    out["checks"] = {k: {"value": _json_number(c["value"]),
                         "limit": c["limit"]} for k, c in checks.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        cell = spec.cell(args.workload)
        need_chips(cell.chips)
        out = measure(cell, args.seed, args.seconds, bool(args.trace))
    except (RunError, KeyError, FileNotFoundError) as err:
        print(f"port_bench: {err}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
