"""A/B of two trees on one card: the bits of each kernel's output and of
the LU route's, and each kernel's time.

    PYTHONPATH=<tree> python3 probes/ab_outputs.py --out result.json
    python3 probes/ab_outputs.py --compare first.json second.json

The first form imports the package found on ``PYTHONPATH`` (this tree's or
another checkout's; it calls only entry points every tree since the third
slice has) and times it with this checkout's ``utils/profiling.py``, loaded
from its file, so both sides of an A/B are timed by the same rules. Run it
in each tree in turn (parent, change, change, parent) to compare them on
one card. It prints and writes to ``--out`` a JSON record:

- ``bits``: sha256 of the output bytes (ok flags and pivot rows included)
  of K1 on (256, 128, 128); K2 on a (128, 4096) strip; K3 on a (64, 20032)
  bf16 strip; K4 on 257 blocks of 64^2; K5 on 257-block batches at
  b = 128, 64, 40 and 8 (standard normal plus b I, the last block with a
  zero pivot at step 7, as ``chip_smoke.py`` phase 4c makes them); K6 on
  (8, 128, 1024); K7 in fp32 and bf16 at 4096^3 and 300 x 200 x 150; and
  ``inverse(method="lu")`` on the 4096^2 hollow matrix of seed 1.
- ``ms``: each kernel at its main path's shape (``chip_smoke.py`` phase
  7's) by CUDA events, mean of many calls after a warm-up, and its own
  kernel's device time per call from ``torch.profiler`` (``*_device``;
  null if the profiler saw none); the summed device time of one LU getri
  call at 4096^2.

``--compare`` prints, for each output, whether the two records hash it
alike, and the two records' times side by side. Needs a CUDA device for
the first form; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch


def _profiling():
    """This checkout's utils/profiling.py (it imports only torch), whichever
    package ``PYTHONPATH`` names."""
    path = (Path(__file__).resolve().parent.parent
            / "gpu_matrix_inversion_tpu_torch" / "utils" / "profiling.py")
    spec = importlib.util.spec_from_file_location("_ab_profiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sha(out) -> str:
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        # As bytes: numpy has no bfloat16.
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        h.update(raw.numpy().tobytes())
    return h.hexdigest()


def measure() -> dict:
    from gpu_matrix_inversion_tpu_torch import inverse
    from gpu_matrix_inversion_tpu_torch.ops import (blocked, fused, lockstep,
                                                    lu, matmul)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    prof = _profiling()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)

    def randn(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    def k5_batch(b):
        d = rng.standard_normal((257, b, b)).astype(np.float32)
        d += b * np.eye(b, dtype=np.float32)
        d[-1, :, 7] = 0.0
        d[-1, 7, :8] = 0.0
        return torch.from_numpy(d).to(dev)

    x1, x1_big = randn(256, 128, 128), randn(4096, 128, 128)
    s2, u2 = randn(128, 4096), torch.zeros(4096, dtype=torch.int32,
                                           device=dev)
    s3 = randn(64, 20032, dtype=torch.bfloat16)
    u3 = torch.zeros(20032, dtype=torch.int32, device=dev)
    x4, x4_b64 = randn(257, 64, 64), randn(64, 64)
    x5 = {b: k5_batch(b) for b in (128, 64, 40, 8)}
    x5_b128 = randn(128, 128) + 128 * torch.eye(128, device=dev)
    s6 = randn(8, 128, 1024)
    u6 = torch.zeros((8, 1024), dtype=torch.int32, device=dev)
    big = [randn(4096, 4096) for _ in range(2)]
    small = [randn(300, 200), randn(200, 150)]
    x4k = torch.from_numpy(hollow_random_matrix(4096, seed=1)).to(dev)

    bits = {
        "k1_256x128": fused.gj_kernel(x1, pivot=True),
        "k2_128x4096": blocked.panel_factor(s2, 0, u2, pivot=True),
        "k3_64x20032_bf16": blocked.pivot_search(s3, u3),
        "k4_257x64": blocked.invert_small(x4, pivot=True),
        **{f"k5_257x{b}": lu.small_lu(x) for b, x in x5.items()},
        "k6_8x128x1024": lockstep.lockstep_factor(s6, 0, u6, pivot=True),
        **{f"k7_{label}_{str(dtype)[6:]}": matmul.tiled_matmul(
            *(g.to(dtype) for g in pair))
           for label, pair in (("4096", big), ("300x200x150", small))
           for dtype in (torch.float32, torch.bfloat16)},
        "lu_inverse_4096": inverse(x4k, method="lu"),
    }
    bits = {key: _sha(out) for key, out in bits.items()}

    # (label, call, calls to time, the kernel's name in the profiler)
    xa16, xb16 = (g.bfloat16() for g in big)
    timed = [
        ("k1_4096x128", lambda: fused.gj_kernel(x1_big, pivot=True), 5,
         "fused_gj"),
        ("k2_128x4096", lambda: blocked.panel_factor(s2, 0, u2, pivot=True),
         10, "panel_factor"),
        ("k3_64x20032_bf16", lambda: blocked.pivot_search(s3, u3), 5,
         "pivot_search"),
        ("k4_b64", lambda: blocked.invert_small(x4_b64, pivot=True), 20,
         "small_inv"),
        ("k5_b128", lambda: lu.small_lu(x5_b128), 200, "small_lu"),
        ("k6_8x128x1024",
         lambda: lockstep.lockstep_factor(s6, 0, u6, pivot=True), 10,
         "panel_factor"),
        ("k7_4096_float32", lambda: matmul.tiled_matmul(*big), 20,
         "matmul_"),
        ("k7_4096_bfloat16", lambda: matmul.tiled_matmul(xa16, xb16), 20,
         "matmul_"),
    ]
    ms = {}
    for label, fn, iters, name in timed:
        ms[label] = prof.events_ms(fn, iters)
        ms[f"{label}_device"] = prof.device_ms(fn, min(iters, 50), name)
    ms["lu_inverse_4096_device"] = prof.device_ms(
        lambda: inverse(x4k, method="lu"))
    return {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), "bits": bits, "ms": ms}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out")
    parser.add_argument("--compare", nargs=2, metavar="JSON")
    args = parser.parse_args()
    if args.compare:
        first, second = (json.load(open(p)) for p in args.compare)
        for key, sha in first["bits"].items():
            same = sha == second["bits"].get(key)
            print(f"{key}: {'identical' if same else 'DIFFERENT'}")
        for key, val in first["ms"].items():
            print(f"{key}: {val} ms, then {second['ms'].get(key)} ms")
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    record = measure()
    print(json.dumps(record))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f)


if __name__ == "__main__":
    main()
