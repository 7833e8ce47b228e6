"""Readings that the correctness limits of a cell are set from.

    python3 port_bench/calibrate.py --workload <cell> [--workload ...] \
        --seeds 1,2,... --control-seeds 7,8,9 [--seconds 2]

In one process, for each cell at its own size and load:

- ``program``: on each of ``--seeds``, the cell's timed path for a short
  window, its answers sampled and compared as a run compares them
  (``core/check.py``): the lower readings;
- ``reference_tf32``: on each of ``--control-seeds``, the control: the
  plain reference in the program's place, its GEMMs in TF32 (the precision
  below FP32 with TF32 off), on every pool input: the upper readings;
- ``program_tf32``: where the call is one matrix (the blocked route), the
  program's own TF32 path (``inverse(a, precision="high")``) on every pool
  input, which serves as the control there;
- ``reference_fp32``: the plain reference in FP32 with TF32 off, beside
  them: what a sound FP32 inverse reads;
- with ``--faults``, ``fault:<name>``: on each of ``--control-seeds``,
  the timed path for a short window with each fault of ``core/faults.py``
  that the cell can have planted under it, compared as a run compares;
- with ``--detail``, ``matrix``: each pool matrix's readings from one
  call of the program, beside its condition number ``||A||_F ||A^-1||_F``.

One JSON line a reading on standard output. The benchmark's runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench.core import check, faults, loop, spec  # noqa: E402
from port_bench.reference import inverse as reference  # noqa: E402


def _pool_window(load, fn) -> loop.Window:
    """A window whose calls are ``fn`` once on each pool input, every
    answer kept."""
    sample, oks = [], []
    for k in range(load.pool_size):
        x, ok = fn(load.input(k))
        sample.append((k, x, ok))
        oks.append(bool(ok.all()))
    return loop.Window(load.pool_size, load.pool_size * load.per_call, 0.0,
                       [], oks, sample)


def controls(load, refs=None) -> dict:
    """The control readings on ``load``'s pool (``refs``: its
    references, where they are worked out already)."""
    from gpu_matrix_inversion_tpu_torch.models import solver
    refs = check.references(load) if refs is None else refs
    out = {
        "reference_tf32": check.readings(load, _pool_window(
            load, lambda a: reference.inverse(a, gemm="tf32")), refs),
        "reference_fp32": check.readings(load, _pool_window(
            load, lambda a: reference.inverse(a, gemm="exact")), refs),
    }
    if load.batch is None:
        out["program_tf32"] = check.readings(load, _pool_window(
            load, lambda a: solver.inverse(a, precision="high")), refs)
    return out


def per_matrix(load):
    """Yield each pool matrix's readings from one call of the program,
    with its Frobenius condition number."""
    refs = check.references(load)
    for k in range(load.pool_size):
        a = load.input(k)
        x = check.answer_tensor(load, load.call(k)[0], a.shape)
        xref = refs[k][0]
        flat = [t.reshape(-1, a.shape[-2], a.shape[-1]) for t in (a, x, xref)]
        for j in range(flat[0].shape[0]):
            values = check.gaps(*(t[j] for t in flat))
            kappa = float(torch.linalg.matrix_norm(flat[0][j].double())
                          * torch.linalg.matrix_norm(flat[2][j]))
            yield {"pool": k, "matrix": j, **dict(zip(check.NAMES[1:],
                                                       values)),
                   "kappa": kappa}


def calibrate(name: str, seeds, control_seeds, seconds: float,
              device="cuda", detail: bool = False, planted: bool = False):
    """Yield one reading a line for cell ``name``."""
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    cell = spec.cell(name)
    sample = int(cell.traffic["sample"])
    for seed in seeds:
        load = loop.Load(cell, seed, device)
        load.warm()
        window = load.window(seconds, sample)
        yield {"cell": name, "seed": seed, "kind": "program",
               "calls": window.calls, **check.readings(load, window)}
        if detail:
            for row in per_matrix(load):
                yield {"cell": name, "seed": seed, "kind": "matrix", **row}
        del load, window
    graphs.clear()
    for seed in control_seeds:
        load = loop.Load(cell, seed, device)
        refs = check.references(load)
        for kind, values in controls(load, refs).items():
            yield {"cell": name, "seed": seed, "kind": kind, **values}
        if planted:
            for fault in faults.FAULTS:
                if not faults.applies(fault, load.batch):
                    continue
                with faults.planted(fault):
                    load.warm()
                    window = load.window(seconds, sample)
                    values = check.readings(load, window, refs)
                yield {"cell": name, "seed": seed, "kind": f"fault:{fault}",
                       "calls": window.calls, **values}
                del window
        del load, refs
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", action="append", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--detail", action="store_true")
    parser.add_argument("--faults", action="store_true")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for name in args.workload:
        for line in calibrate(name, seeds, control_seeds, args.seconds,
                              detail=args.detail, planted=args.faults):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
