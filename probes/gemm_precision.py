"""Accuracy and cost of the blocked driver's GEMM accumulation.

    python3 -m probes.gemm_precision [--device cuda|cpu] [--n 1950 4096 ...]

Runs the port's ``blocked_inverse`` on the hollow protocol input
(``hollow_random_matrix(n, seed)``) twice per size: once as shipped (the
driver's value-carrying GEMMs accumulate in float64, ``ops/blocked.py:
_update``) and once with those GEMMs in true FP32 (``out.addmm_`` with TF32
off), and prints, per size and mode, the raw and refined normalized
residuals, the gap between the two raw inverses, and the time of one raw
call after a warm-up call (CUDA events on the card, the host clock on the
CPU). On the CPU the panel kernel's plain twin stands in for the kernel,
so a CPU run and a card run of the same size separate the summation order
of the GEMM library from the kernel. Imports no JAX.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gpu_matrix_inversion_tpu_torch.ops import blocked
from gpu_matrix_inversion_tpu_torch.utils.generators import hollow_random_matrix

SHIPPED_UPDATE = blocked._update


def fp32_update(out, a, b, precision):
    """The driver's update with an FP32 GEMM at ``"highest"`` (TF32 off)."""
    out.addmm_(a, b)


def residual(a, x):
    """``||A X - I||_F / (||A||_F ||X||_F)`` in float64 on ``x``'s device
    (``utils/residual.py``'s metric; the host would take minutes at
    16384^2)."""
    a, x = a.double(), x.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    return float(torch.linalg.matrix_norm(a @ x - eye)
                 / (torch.linalg.matrix_norm(a) * torch.linalg.matrix_norm(x)))


def timed(fn, device):
    """(result, milliseconds) of one call, after the call has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def run(n, seed, device, mode):
    blocked._update = SHIPPED_UPDATE if mode == "fp64" else fp32_update
    try:
        a = hollow_random_matrix(n, seed=seed)
        x = torch.from_numpy(a).to(device)
        blocked.blocked_inverse(x, refine=0)           # warm-up
        (inv, ok), ms = timed(
            lambda: blocked.blocked_inverse(x, refine=0), device)
        ref, ok_ref = blocked.blocked_inverse(x)
        return {"raw": residual(x, inv), "refined": residual(x, ref),
                "ok": bool(ok) and bool(ok_ref), "raw_ms": ms,
                "inv": inv.cpu().numpy()}
    finally:
        blocked._update = SHIPPED_UPDATE


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, nargs="+", default=[1950, 4096])
    args = parser.parse_args()
    device = torch.device(args.device)
    for n in args.n:
        # Seed 1950 at n = 1950 (the regression input), else bench.py's 1.
        seed = 1950 if n == 1950 else 1
        res = {mode: run(n, seed, device, mode)
               for mode in ("fp64", "fp32")}
        gap = float(np.abs(res["fp32"]["inv"] - res["fp64"]["inv"]).max()
                    / np.abs(res["fp64"]["inv"]).max())
        for mode, r in res.items():
            print(f"{device.type} n={n} seed={seed} {mode} accumulation: "
                  f"raw {r['raw']:.3e} refined {r['refined']:.3e} "
                  f"ok {r['ok']} raw call {r['raw_ms']:.2f} ms", flush=True)
        print(f"{device.type} n={n}: max|X_fp32 - X_fp64| / max|X_fp64| = "
              f"{gap:.3e}", flush=True)


if __name__ == "__main__":
    main()
