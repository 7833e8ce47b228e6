"""Device-time breakdown of the port's blocked, split, FP64, LU and batch
paths.

    python3 -m probes.profile_paths

Runs each path once to warm up, once on the host clock, then once under
``torch.profiler`` (CPU and CUDA activities) and prints, per path: the
unprofiled call's time on the host clock, the summed device time of its
kernels in the profiled call, the device's idle share (1 - device time /
host time; one stream, so kernels do not overlap), and
the ten top entries by self device time (``key_averages``). The inputs are
the hollow protocol matrices the on-card tests use: 4096^2 seed 1 in FP32
and FP64, 20000^2 seed 20000, and the (16, 1024^2) and (8, 2048^2)
batches (seeds n + i), each batch once per matrix and once through the
lockstep route (``MATINV_LOCKSTEP=1``). Needs a CUDA device; imports no
JAX.
"""

from __future__ import annotations

import os
import subprocess
import time

import torch

from gpu_matrix_inversion_tpu_torch import inverse, solve
from gpu_matrix_inversion_tpu_torch.utils.generators import (
    hollow_random_matrix)
from gpu_matrix_inversion_tpu_torch.utils.profiling import device_kernels


def _lockstep(fn):
    """``fn`` run with the lockstep route opted in."""
    def run():
        os.environ["MATINV_LOCKSTEP"] = "1"
        try:
            return fn()
        finally:
            del os.environ["MATINV_LOCKSTEP"]
    return run


def _paths(dev):
    import numpy as np
    x4k = torch.from_numpy(hollow_random_matrix(4096, seed=1)).to(dev)
    x4k64 = torch.from_numpy(
        hollow_random_matrix(4096, seed=1, dtype=np.float64)).to(dev)
    rhs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4096, 16)).astype(np.float32)).to(dev)
    x20k = torch.from_numpy(hollow_random_matrix(20000, seed=20000)).to(dev)
    batches = {(bsz, n): torch.from_numpy(np.stack([
        hollow_random_matrix(n, seed=n + i) for i in range(bsz)])).to(dev)
        for bsz, n in ((16, 1024), (8, 2048))}
    per_batch = []
    for (bsz, n), xs in batches.items():
        per_batch += [
            (f"inverse, FP32 ({bsz}, {n}, {n}), per matrix",
             lambda xs=xs: inverse(xs)),
            (f"inverse, FP32 ({bsz}, {n}, {n}), lockstep",
             _lockstep(lambda xs=xs: inverse(xs)))]
    return per_batch + [
        ("inverse, FP64 4096^2", lambda: inverse(x4k64)),
        ("inverse, FP32 20000^2 (split path)", lambda: inverse(x20k)),
        ("inverse, FP32 4096^2, search_bf16=True",
         lambda: inverse(x4k, search_bf16=True)),
        ("inverse, FP32 4096^2, method='lu'",
         lambda: inverse(x4k, method="lu")),
        ("solve, FP32 4096^2 x 16", lambda: solve(x4k, rhs)),
    ]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for label, fn in _paths(dev):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        rows = device_kernels(fn)
        device_ms = sum(ms for _, _, ms in rows)
        print(f"\n== {label}: host {host_ms:.2f} ms, device {device_ms:.2f} "
              f"ms, idle share {1 - device_ms / host_ms:.3f}")
        for name, count, ms in rows[:10]:
            if ms <= 0:
                break
            print(f"  {ms:10.3f} ms {100 * ms / device_ms:6.1f}% "
                  f"{count:7d}x  {name[:90]}")


if __name__ == "__main__":
    main()
