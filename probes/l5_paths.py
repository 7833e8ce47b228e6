"""L5 (``csrc/lu_solve.cu``) at the shapes its callers use, timed and held
to its twin on the card.

    PYTHONPATH=. python3 probes/l5_paths.py [--check] [--shapes SPEC ...]

A shape is ``batch,n,k,dtype`` (``1,4096,4096,float32``). For each: L4's
factor of a seeded normal (batch, n, n) matrix, seeded normal right-hand
sides, then L5 by CUDA events (``ms``: the mean of a launch over
``iters`` launches after one warm-up) and the profiler's device time of
its kernels (``device_ms``, None where the profiler recorded none), the
path it took (``_lu_solve_batched``'s counters and ``lu_solve_plan``,
where the checkout has them) and, with ``--check``, whether x's bits and
ok equal ``lu_solve_twin``'s run on the card. Prints the card's name and
power limit, then one JSON line a shape. The package is imported from
``PYTHONPATH``: name another checkout there to time its L5, and run the
probe in two checkouts alternately to compare them on one card. Needs a
CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import gpu_matrix_inversion_tpu_torch
from gpu_matrix_inversion_tpu_torch.ops import lu
from gpu_matrix_inversion_tpu_torch.utils.profiling import (NoDeviceTime,
                                                           device_kernels)

# solve(refine_iters=2)'s correction at 4096^2; lu_inverse_refined's
# identity (the cell refined4096.device), fp32 and fp64; a (64, 128^2)
# getri batch; ragged sizes; a vector right-hand side.
SHAPES = ("1,4096,16,float32", "1,4096,4096,float32", "64,128,128,float32",
          "1,4096,4096,float64", "1,1000,777,float32", "3,512,512,float32",
          "1,4096,1,float32", "16,1024,1024,float32", "1,200,1,float64")


def _same_bits(x, y) -> bool:
    """Bit for bit, except that NaN matches NaN whatever its payload."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return False
    ints = {4: torch.int32, 8: torch.int64}[x.element_size()]
    return torch.equal(x.view(ints)[~nan], y.view(ints)[~nan])


def _events_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _counts() -> dict:
    fn = lu._lu_solve_batched
    return {key: getattr(fn, key) for key in
            ("launches", "cluster_launches", "column_launches")
            if hasattr(fn, key)}


def run(spec: str, check: bool) -> dict:
    bsz, n, k, dtype = spec.split(",")
    bsz, n, k, dtype = int(bsz), int(n), int(k), getattr(torch, dtype)
    rng = np.random.default_rng(n + k)
    a = torch.from_numpy(rng.standard_normal((bsz, n, n))).to(dtype).cuda()
    fac, perm, _ = lu._lu_factor_batched(a, pivot=True)
    rhs = torch.from_numpy(rng.standard_normal((bsz, n, k))).to(
        dtype).cuda()
    out = {"shape": spec}
    plan = getattr(lu, "lu_solve_plan", None)
    if plan is not None:
        out["plan"] = str(plan(bsz, n, k, fac.element_size()))
    before = _counts()
    x, ok = lu._lu_solve_batched(fac, perm, rhs)
    torch.cuda.synchronize()
    out["counts"] = {key: v - before[key] for key, v in _counts().items()}
    if check:
        want, want_ok = lu.lu_solve_twin(fac, perm, rhs)
        out["bits"] = _same_bits(x, want) and torch.equal(ok, want_ok)
    call = lambda: lu._lu_solve_batched(fac, perm, rhs)  # noqa: E731
    iters = max(3, min(50, int(2e9 / (2 * bsz * n * n * k) + 1)))
    out["ms"] = _events_ms(call, iters)
    try:
        rows = device_kernels(call)
    except NoDeviceTime:
        rows = []
    out["device_ms"] = (sum(ms for name, _, ms in rows
                            if "lu_solve_kernel" in name) or None)
    out["kernels"] = sorted({name[:60] for name, _, _ in rows
                             if "lu_solve_kernel" in name})
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--shapes", nargs="*", default=list(SHAPES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card,
                      "package": gpu_matrix_inversion_tpu_torch.__file__}),
          flush=True)
    for spec in args.shapes:
        print(json.dumps(run(spec, args.check)), flush=True)


if __name__ == "__main__":
    main()
