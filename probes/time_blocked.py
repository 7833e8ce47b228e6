"""Device time of the blocked FP32 4096^2 call, raw and refined.

    PYTHONPATH=. python3 probes/time_blocked.py

Times ``blocked_inverse`` on the hollow 4096^2 matrix of seed 1 (the input
``chip_smoke.py`` times) with CUDA events, call by call after one
warm-up: five calls with ``refine=0``, then five refined, then one more
of each under ``torch.profiler`` for the summed device time of its
kernels (``*_device_ms``; the rest of a call's time is the device waiting
on the host) and the refined call's five largest kernels by device time
(``top``: name, launches, ms). Prints one JSON line: the card's name and
power limit, the package's file, and those numbers. The package is imported from
``PYTHONPATH``: name another checkout there to time that tree, and run it
in two checkouts alternately to compare them on one card. Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import json
import subprocess

import torch

import gpu_matrix_inversion_tpu_torch
from gpu_matrix_inversion_tpu_torch.ops.blocked import blocked_inverse
from gpu_matrix_inversion_tpu_torch.utils.generators import (
    hollow_random_matrix)
from gpu_matrix_inversion_tpu_torch.utils.profiling import device_kernels


def _call_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    x = torch.from_numpy(hollow_random_matrix(4096, seed=1)).to("cuda")
    out = {"card": card, "package": gpu_matrix_inversion_tpu_torch.__file__}
    for key, refine in (("raw_ms", 0), ("refined_ms", 1)):
        blocked_inverse(x, refine=refine)
        torch.cuda.synchronize()
        out[key] = [_call_ms(lambda: blocked_inverse(x, refine=refine))
                    for _ in range(5)]
    for key, refine in (("raw_device_ms", 0), ("refined_device_ms", 1)):
        rows = device_kernels(lambda: blocked_inverse(x, refine=refine))
        out[key] = sum(row[2] for row in rows)
    out["top"] = [(name[:80], count, ms) for name, count, ms in rows[:5]]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
