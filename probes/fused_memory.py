"""Peak device memory of the fused route's batched calls.

    PYTHONPATH=<tree> python3 probes/fused_memory.py

Runs ``inverse`` on a (512, 256, 256) and a (64, 640, 640) FP32 batch
(standard normal, seed 0; the fused route, kernel K1) with the package
found on ``PYTHONPATH`` (so that two trees compare on one card) and prints,
for each, the peak of ``torch.cuda.max_memory_allocated`` during the call
above what was allocated before it (the input), in MB, and the card.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from gpu_matrix_inversion_tpu_torch import inverse
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    rng = np.random.default_rng(0)
    for shape in ((512, 256, 256), (64, 640, 640)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        inverse(x)                      # warm-up: build, plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, ok = inverse(x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 1e6
        print(f"inverse {shape}: peak {peak:.1f} MB above the "
              f"{before / 1e6:.1f} MB allocated before the call; all ok "
              f"{bool(ok.all())}")
        del x, out, ok


if __name__ == "__main__":
    main()
