"""Per-phase breakdown of the blocked inversion (reference Res slots).

Port of ``gpu_matrix_inversion_tpu/benchmarks/phases.py``. The reference
implementation times makeAugmented / pivot / row / column per kernel
enqueue (``FP32_bench.cpp:256-443``). The JAX package cannot see a kernel
boundary inside its one XLA program, so it re-traces the program with
stages stubbed out and differences the timings; that disagreed with the
device trace by about 2x on the TPU. Here the phase boundaries are visible
from the host, so nothing is stubbed: the real blocked call
(``blocked_inverse(..., refine=0)``) runs under ``torch.profiler`` with the
driver's phase ranges on (``utils/profiling.phase``), and each slot is the
time of the work inside its ranges:

- ``make_augmented``: building the padded working buffer (``_augment``).
- ``pivot``: the pivot search, kernels K2 and K3 (or the logical panel).
- ``row``: the (b, b) pivot-block inverse, kernel K4 or the plain FP64
  Gauss-Jordan.
- ``column``: the rest of the call -- the trailing GEMMs, the gathers and
  the driver's glue -- as the reference computes it, ``total_compute``
  less the other three.

On a CUDA device the slots and ``total_compute`` are device time (the
kernels' summed durations, per call); on the CPU, CPU time. Run::

    python -m gpu_matrix_inversion_tpu_torch.benchmarks.phases --n 2048
"""

from __future__ import annotations

import argparse
import bisect

import torch

SLOTS = ("make_augmented", "pivot", "row", "column")
_RANGED = SLOTS[:3]       # column is the rest of the call


def _slot_times(events, cuda: bool) -> tuple[dict, float]:
    """Microseconds of the ranged slots, and in all, of one profiled
    session.

    On the CPU a slot is its ranges' CPU time and the total the
    ``matinv::call`` ranges'. On a CUDA device each kernel, copy or fill
    goes to the range that launched it: the range holding the start of the
    runtime call (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaMemcpyAsync`` ...) with the kernel's correlation id. The
    profiler links kernels to the PyTorch operator that launched them,
    but not to a ``record_function`` range, and the hand-written kernels
    are launched from no operator. The total is every device event of the
    session."""
    from torch.autograd import DeviceType
    from gpu_matrix_inversion_tpu_torch.utils.profiling import is_marker
    out = dict.fromkeys(_RANGED, 0.0)
    spans = []
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("matinv::"):
            slot = e.name[len("matinv::"):]
            if slot in out:
                spans.append((e.time_range.start, e.time_range.end, slot))
                if not cuda:
                    out[slot] += e.cpu_time_total
    if not cuda:
        return out, sum(e.cpu_time_total for e in events
                        if e.name == "matinv::call")
    spans.sort()
    starts = [span[0] for span in spans]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    total = 0.0
    for e in events:
        if (e.device_type != DeviceType.CUDA or is_marker(e.name)
                or getattr(e, "is_user_annotation", False)):
            continue            # a range's own span on the device timeline
        dur = e.time_range.end - e.time_range.start
        total += dur
        t = launched.get(e.id)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            out[spans[i][2]] += dur
    return out, total


def _profile_call(call, k: int, device: torch.device,
                  tries: int = 3) -> dict:
    """One profiled session of ``k`` calls; seconds per call by slot. On a
    CUDA device a session in which the profiler saw no device time is
    profiled again, up to ``tries`` sessions (as ``device_kernels`` does),
    then this raises ``NoDeviceTime``."""
    from torch.profiler import profile, record_function
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        NoDeviceTime, _activities, bracketed, phase_ranges)
    cuda = device.type == "cuda"
    for _ in range(tries):
        with profile(activities=_activities(device)) as prof:
            with phase_ranges(), bracketed(device):
                for _ in range(k):
                    with record_function("matinv::call"):
                        call()
            if cuda:
                torch.cuda.synchronize(device)
        out, total = _slot_times(prof.events(), cuda)
        if total > 0 or not cuda:
            out["column"] = max(total - sum(out.values()), 0.0)
            out["total_compute"] = total
            return {key: us / 1e6 / k for key, us in out.items()}
    raise NoDeviceTime(f"torch.profiler recorded no device time in {tries} "
                       f"sessions")


def measure_phases(n: int = 2048, *, block_size: int = 128,
                   pivot: bool = True, precision: str = "highest",
                   seed: int = 0, k: int = 3, reps: int = 2,
                   device="cuda") -> dict:
    """Per-phase seconds of one fp32 blocked call on ``device``.

    Returns the reference's Res slots ``make_augmented / pivot / row /
    column`` and ``total_compute``, per call: ``reps`` profiled sessions
    of ``k`` calls each, after one warm-up call, keeping the session with
    the least ``total_compute``. The call runs eagerly
    (``graphs.disabled()``): a replayed graph launches its kernels from no
    profiler range, so none could be attributed to a slot.
    """
    from gpu_matrix_inversion_tpu_torch.ops.blocked import blocked_inverse
    from gpu_matrix_inversion_tpu_torch.utils import graphs
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    device = torch.device(device)
    a = torch.from_numpy(hollow_random_matrix(n, seed=seed)).to(device)

    def call():
        return blocked_inverse(a, pivot=pivot, block_size=block_size,
                               precision=precision, refine=0)

    with graphs.disabled():
        call()                   # kernel build, cluster plans, caches
        runs = [_profile_call(call, k, device) for _ in range(reps)]
    return min(runs, key=lambda got: got["total_compute"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--k", type=int, default=3)
    args = ap.parse_args(argv)
    phases = measure_phases(args.n, block_size=args.block_size,
                            precision=args.precision, k=args.k)
    for key, val in phases.items():
        print(f"{key:>16}: {val * 1e3:10.3f} ms (device time)")
    tc = phases["total_compute"]
    if tc:
        print(f"{'gflops(4N^3)':>16}: {4 * args.n ** 3 / tc / 1e9:10.1f}")


if __name__ == "__main__":
    main()
