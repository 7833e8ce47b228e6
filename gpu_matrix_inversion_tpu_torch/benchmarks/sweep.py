"""Benchmark sweep CLI: the reference's experiment protocol on a CUDA card.

Port of ``gpu_matrix_inversion_tpu/benchmarks/sweep.py``, which reproduces
the reference implementation's drivers:

- C++ ``main()`` sweep: N = 10 -> 2000 step 10, then -> 16000 step 1000,
  hollow-diagonal random matrices, per-phase timings + residual per row,
  appended to a text file (``main_file.cpp:27-83``).
- PyOpenCL ``__main__`` sweep: same ramp, compute/total timings + residual
  (``matrix_inv_pyopencl.py:358-370``).
- NumPy baseline sweep: N = 10 -> 2000 step 10, then -> 5000 step 1000
  (``matrix_inv_numpy.py:7-34``).

Output paths are CLI flags; the error column reports both the reference's
``sqrt(N) - ||inv @ A||_F`` metric and the normalized residual. Every
timed span ends with a device synchronize, so it is the wall time a caller
waits for the result, host launches and device idle included.

Usage::

    python -m gpu_matrix_inversion_tpu_torch.benchmarks.sweep \\
        --method auto --max-n 4096 --out sweep_cuda.txt
    python -m gpu_matrix_inversion_tpu_torch.benchmarks.sweep --numpy-baseline
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def reference_sizes(max_n: int, *, coarse_step: int = 1000):
    """The reference's N ramp (main_file.cpp:73-78): 10..2000 step 10, then
    step 1000 up to max_n."""
    n = 10
    while n <= max_n:
        yield n
        n += 10 if n < 2000 else coarse_step


def _done_sizes(path: str) -> set:
    """Sizes already present in an output file, for ``--resume`` (the
    reference appends rows to a text file, main_file.cpp:39, :81)."""
    done = set()
    if path and path != "-" and os.path.exists(path):
        with open(path) as f:
            for line in f:
                head = line.split(None, 1)[0] if line.strip() else ""
                if head.isdigit():
                    done.add(int(head))
    return done


def sweep_numpy(max_n: int, out, *, repeat: int = 1, skip=(), sizes=None):
    """C14 parity: NumPy/LAPACK CPU baseline sweep (matrix_inv_numpy.py)."""
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        reference_error_metric, relative_residual)

    for n in (sizes if sizes is not None else reference_sizes(max_n)):
        if n in skip:
            continue
        a = hollow_random_matrix(n, seed=n)
        best = float("inf")
        for _ in range(repeat):
            t0 = time.monotonic()
            inv = np.linalg.inv(a)
            best = min(best, time.monotonic() - t0)
        err = reference_error_metric(a, inv)
        res = relative_residual(a, inv)
        out.write(f"{n} {best:.6f} {err:.6e} {res:.3e}\n")
        out.flush()


def _spd_matrix(n: int, *, seed: int, dtype=np.float32):
    """SPD test input for the Cholesky family: ``G Gᵀ/n + I`` (the hollow
    recipe has a zero diagonal and is never SPD)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    return (np.matmul(g, g.T) / n + np.eye(n)).astype(dtype)


def sweep_cuda(max_n: int, out, *, method: str = "auto", repeat: int = 3,
               dtype=np.float32, skip=(), sizes=None, amortize: int = 0,
               strict_verify: bool = False, spd: bool = False,
               device="cuda"):
    """C9/C13 parity: device sweep with Res-style phase timings per row.

    Row format: ``N t_buffers t_compile t_compute t_readback t_total
    err_reference resid_normalized [t_amortized] [max|AX-I|]`` in seconds
    -- the reference's Res.times slots (FP32_bench.cpp:256-443). t_compile
    is the first call (kernel build on first use, warm-up), t_compute the
    best of ``repeat`` calls. With ``amortize=k > 1`` a column reports the
    per-inversion time of k calls back to back in one synchronized window,
    net of the single call. ``strict_verify`` appends the on-device max
    elementwise |A@X - I| (the reference's identity self-check,
    FP32.cpp:814-835).
    """
    from gpu_matrix_inversion_tpu_torch.api import _strict_identity_error
    from gpu_matrix_inversion_tpu_torch.models.solver import inverse
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        reference_error_metric, relative_residual)

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Bring up the device before the first timed row, so that its context
    # start-up does not land in row one's t_buffers.
    torch.zeros((128, 128), device=device).sum().item()

    for n in (sizes if sizes is not None else reference_sizes(max_n)):
        if n in skip:
            continue
        a_host = (_spd_matrix(n, seed=n, dtype=dtype) if spd
                  else hollow_random_matrix(n, seed=n, dtype=dtype))

        t0 = time.perf_counter()
        a = torch.from_numpy(a_host).to(device)
        sync()
        t_buffers = time.perf_counter() - t0

        t0 = time.perf_counter()
        inv, _ = inverse(a, method=method)
        sync()
        t_compile = time.perf_counter() - t0

        t_compute = float("inf")
        for _ in range(repeat):
            t0 = time.perf_counter()
            inv, _ = inverse(a, method=method)
            sync()
            t_compute = min(t_compute, time.perf_counter() - t0)

        t0 = time.perf_counter()
        inv_host = inv.cpu().numpy()
        t_read = time.perf_counter() - t0

        err = reference_error_metric(a_host, inv_host)
        res = relative_residual(a_host, inv_host)
        total = t_buffers + t_compile + t_compute + t_read
        row = (f"{n} {t_buffers:.6f} {t_compile:.6f} {t_compute:.6f} "
               f"{t_read:.6f} {total:.6f} {err:.6e} {res:.3e}")

        if amortize > 1:
            t_k = float("inf")
            for _ in range(repeat):
                t0 = time.perf_counter()
                for _ in range(amortize):
                    inverse(a, method=method)
                sync()
                t_k = min(t_k, time.perf_counter() - t0)
            row += f" {max(t_k - t_compute, 0.0) / (amortize - 1):.6f}"

        if strict_verify:
            row += f" {_strict_identity_error(a, inv):.3e}"

        out.write(row + "\n")
        out.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Matrix-inversion benchmark sweep (reference protocol)")
    ap.add_argument("--max-n", type=int, default=2000,
                    help="largest matrix order (reference goes to 16000)")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "spec", "fused", "blocked", "lu",
                             "cholesky", "ns", "sharded"],
                    help="inversion path (models/solver.py METHODS); "
                         "'sharded' is not ported yet and raises")
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed repetitions per size (REP, main_file.cpp:16)")
    ap.add_argument("--out", default="-",
                    help="output file (reference: hardcoded txt paths)")
    ap.add_argument("--numpy-baseline", action="store_true",
                    help="run the NumPy CPU baseline sweep instead (C14)")
    ap.add_argument("--fp64", action="store_true",
                    help="FP64 sweep (reference FP64_bench path)")
    ap.add_argument("--resume", action="store_true",
                    help="skip sizes already present in --out")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated explicit sizes (overrides the "
                         "reference ramp)")
    ap.add_argument("--amortize", type=int, default=0,
                    help="if k > 1, append a per-inversion time of k calls "
                         "back to back, net of the single call")
    ap.add_argument("--strict-verify", action="store_true",
                    help="append the on-device max|A@X - I| column (the "
                         "reference's identity self-check, FP32.cpp:814-835)")
    ap.add_argument("--spd", action="store_true",
                    help="use SPD inputs (G G^T/n + I) instead of the "
                         "hollow recipe; pair with --method cholesky")
    args = ap.parse_args(argv)

    skip = _done_sizes(args.out) if args.resume else set()
    sizes = ([int(x) for x in args.sizes.split(",")] if args.sizes else None)
    out = sys.stdout if args.out == "-" else open(args.out, "a")
    try:
        if args.numpy_baseline:
            sweep_numpy(args.max_n, out, repeat=args.repeat, skip=skip,
                        sizes=sizes)
        else:
            sweep_cuda(args.max_n, out, method=args.method,
                       repeat=args.repeat,
                       dtype=np.float64 if args.fp64 else np.float32,
                       skip=skip, sizes=sizes, amortize=args.amortize,
                       strict_verify=args.strict_verify, spd=args.spd)
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    main()
