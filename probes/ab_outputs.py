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

- ``bits``: for each output (its tensors in turn: the inverse, then pivot
  rows or ``pos``, then ok flags), the sha256 of its bytes, the sha256 of
  its values with every -0 made +0, and the flat indices of its -0
  elements. The outputs: K1 on (4096, 128, 128) uniform [0, 100), on
  (64, 128, 128) bf16, on (512, 256, 256), (1, 256, 256) and
  (4, 640, 640) (the m = 256 .. 640 branch), on (2, 384, 384) integers in
  [-3, 3] with and without pivoting (plus 384 I for the latter), on
  (2, 512, 512) bf16, and its pivot rows and ok flags on a
  (3, 128, 128) batch with an all-ones and a NaN member; K2 on a (128, 4096) strip; K3 on a
  (64, 20032) bf16 strip and on K2's (128, 4096) fp32 one; K4 on 257
  blocks at b = 64 and 128 (standard
  normal; the last block singular, of which only its ok flag counts) and
  the ok flag of a block with a NaN; K5 on 257-block batches at b = 128, 64, 40 and 8
  (standard normal plus b I, the last block with a zero pivot at step 7,
  as ``chip_smoke.py`` phase 4c makes them); K6 on (8, 128, 1024) and
  (4, 128, 2048); K7 in
  fp32 and bf16 at 4096^3 and 300 x 200 x 150; ``inverse(method="lu")``
  and ``inverse(search_bf16=True)`` on the 4096^2 hollow matrix of seed
  1; ``inverse`` on the 20000^2 hollow matrix of seed 20000 (the
  split path); and the FP64 routes: ``matrix_inversion_fp64`` on the
  4096^2 hollow matrix of seed 1 (the f32-search tier),
  ``matrix_inversion_no_pivots`` on the 1024^2 hollow matrix of seed 5
  made diagonally dominant (the logical tier), and ``inverse`` on a
  (64, 256^2) FP64 batch of hollow matrices of seeds 0 .. 63 (spec).
- ``ms``: each kernel at its main path's shape (``chip_smoke.py`` phase
  7's) by CUDA events, mean of many calls after a warm-up, and its own
  kernel's device time per call from ``torch.profiler`` (``*_device``;
  null if the profiler saw none); ``torch.linalg.inv`` beside K1 (at
  (4096, 128^2) and (512, 256^2)) and K4;
  the summed device time of one call of the blocked 4096^2 inverse, raw
  and refined, of LU getri and of Newton-Schulz at 4096^2, and each of
  those calls by CUDA events (mean of three, after a warm-up); the same
  for the three FP64 calls above (through ``inverse`` on card tensors).

``--compare`` prints, for each output, whether the two records hash it
alike, else whether its values agree up to the sign of zeros (and how
many zeros differ in their sign), else DIFFERENT; then the two records'
times side by side. Needs a CUDA device for the first form; imports no
JAX.
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


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        # As bytes: numpy has no bfloat16.
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        h.update(raw.numpy().tobytes())
    return h.hexdigest()


def _fingerprint(out) -> dict:
    """The hashes of an output's bytes and of its values (-0 made +0), and
    the flat indices of each float tensor's -0 elements."""
    tensors = out if isinstance(out, tuple) else (out,)
    floats = [t.is_floating_point() for t in tensors]
    return {"sha": _sha(tensors),
            "sha_values": _sha([t + 0.0 if f else t
                                for t, f in zip(tensors, floats)]),
            "neg_zeros": [torch.nonzero(((t == 0) & t.signbit()).reshape(-1))
                          .flatten().tolist() if f else []
                          for t, f in zip(tensors, floats)]}


def _compare_bits(first: dict, second: dict) -> str:
    if first["sha"] == second["sha"]:
        return "identical"
    if first["sha_values"] != second["sha_values"]:
        return "DIFFERENT"
    signs = sum(len(set(a) ^ set(b)) for a, b in zip(first["neg_zeros"],
                                                     second["neg_zeros"]))
    return f"identical up to the sign of {signs} zeros"


def measure() -> dict:
    from gpu_matrix_inversion_tpu_torch import (inverse,
                                                matrix_inversion_fp64,
                                                matrix_inversion_no_pivots)
    from gpu_matrix_inversion_tpu_torch.ops import (blocked, fused, lockstep,
                                                    lu, matmul)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix, well_conditioned_matrix)
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

    x1_big = torch.from_numpy(rng.uniform(0.0, 100.0, (4096, 128, 128))
                              .astype(np.float32)).to(dev)
    x1_bf16 = randn(64, 128, 128, dtype=torch.bfloat16)
    x1_bad = randn(3, 128, 128)
    x1_bad[1] = 1.0
    x1_bad[2, 3, 4] = float("nan")
    x1_work = randn(512, 256, 256)
    x1_one = randn(1, 256, 256)
    x1_640 = randn(4, 640, 640)
    x1_ints = torch.from_numpy(rng.integers(-3, 4, (2, 384, 384)).astype(
        np.float32)).to(dev)
    x1_512_bf16 = randn(2, 512, 512, dtype=torch.bfloat16)
    s2, u2 = randn(128, 4096), torch.zeros(4096, dtype=torch.int32,
                                           device=dev)
    s3 = randn(64, 20032, dtype=torch.bfloat16)
    u3 = torch.zeros(20032, dtype=torch.int32, device=dev)
    x4 = {b: randn(257, b, b) for b in (64, 128)}
    for d in x4.values():
        d[-1, :, 7] = 0.0
    x4_nan = randn(1, 128, 128)
    x4_nan[0, 5, 9] = float("nan")
    x4_b64, x4_b128 = randn(64, 64), randn(128, 128)
    x5 = {b: k5_batch(b) for b in (128, 64, 40, 8)}
    x5_b128 = randn(128, 128) + 128 * torch.eye(128, device=dev)
    s6 = randn(8, 128, 1024)
    u6 = torch.zeros((8, 1024), dtype=torch.int32, device=dev)
    s6b = randn(4, 128, 2048)
    u6b = torch.zeros((4, 2048), dtype=torch.int32, device=dev)
    big = [randn(4096, 4096) for _ in range(2)]
    small = [randn(300, 200), randn(200, 150)]
    x4k = torch.from_numpy(hollow_random_matrix(4096, seed=1)).to(dev)
    x20k = torch.from_numpy(hollow_random_matrix(20000, seed=20000)).to(dev)
    wc4k = torch.from_numpy(well_conditioned_matrix(4096, seed=4096)).to(dev)
    a4k64 = hollow_random_matrix(4096, seed=1, dtype=np.float64)
    dom1k = hollow_random_matrix(1024, seed=5, dtype=np.float64)
    dom1k += 2.0 * np.abs(dom1k).sum(axis=1).max() * np.eye(1024)
    batch64 = torch.from_numpy(np.stack([
        hollow_random_matrix(256, seed=s, dtype=np.float64)
        for s in range(64)])).to(dev)
    x4k64, dom1k_dev = (torch.from_numpy(a).to(dev) for a in (a4k64, dom1k))

    def k4_batch(x):
        inv, ok = blocked.invert_small(x, pivot=True)
        return inv[:-1], ok

    # Of a singular or NaN input only what the contract fixes is compared:
    # K1's pivot rows and ok, K4's ok (and every K4 batch's ok).
    bits = {
        "k1_4096x128": fused.gj_kernel(x1_big, pivot=True),
        "k1_64x128_bf16": fused.gj_kernel(x1_bf16, pivot=True),
        "k1_ones_nan": fused.gj_kernel(x1_bad, pivot=True)[1:],
        "k1_512x256": fused.gj_kernel(x1_work, pivot=True),
        "k1_1x256": fused.gj_kernel(x1_one, pivot=True),
        "k1_4x640": fused.gj_kernel(x1_640, pivot=True),
        "k1_2x384_ints": fused.gj_kernel(x1_ints, pivot=True),
        "k1_2x384_ints_nopivot": fused.gj_kernel(
            x1_ints + 384 * torch.eye(384, device=dev), pivot=False),
        "k1_2x512_bf16": fused.gj_kernel(x1_512_bf16, pivot=True),
        "k2_128x4096": blocked.panel_factor(s2, 0, u2, pivot=True),
        "k3_64x20032_bf16": blocked.pivot_search(s3, u3),
        "k3_128x4096": blocked.pivot_search(s2, u2),
        **{f"k4_257x{b}": k4_batch(x) for b, x in x4.items()},
        "k4_nan": blocked.invert_small(x4_nan, pivot=True)[1],
        **{f"k5_257x{b}": lu.small_lu(x) for b, x in x5.items()},
        "k6_8x128x1024": lockstep.lockstep_factor(s6, 0, u6, pivot=True),
        "k6_4x128x2048": lockstep.lockstep_factor(s6b, 0, u6b, pivot=True),
        **{f"k7_{label}_{str(dtype)[6:]}": matmul.tiled_matmul(
            *(g.to(dtype) for g in pair))
           for label, pair in (("4096", big), ("300x200x150", small))
           for dtype in (torch.float32, torch.bfloat16)},
        "lu_inverse_4096": inverse(x4k, method="lu"),
        "bf16_search_4096": inverse(x4k, search_bf16=True),
    }
    bits = {key: _fingerprint(out) for key, out in bits.items()}
    bits["split_20000"] = _fingerprint(inverse(x20k))
    bits["fp64_4096"] = _fingerprint(torch.from_numpy(
        matrix_inversion_fp64(a4k64.reshape(-1), 4096, device="cuda")))
    bits["no_pivot_fp64_1024"] = _fingerprint(torch.from_numpy(
        matrix_inversion_no_pivots(dom1k.reshape(-1), 1024, device="cuda")))
    bits["spec_fp64_64x256"] = _fingerprint(inverse(batch64))

    # (label, call, calls to time, the kernel's name in the profiler)
    xa16, xb16 = (g.bfloat16() for g in big)
    timed = [
        ("k1_4096x128", lambda: fused.gj_kernel(x1_big, pivot=True), 5,
         "fused_gj"),
        ("k1_library_inv_4096x128", lambda: torch.linalg.inv(x1_big), 5,
         None),
        ("k1_512x256", lambda: fused.gj_kernel(x1_work, pivot=True), 3,
         "fused_gj"),
        ("k1_library_inv_512x256", lambda: torch.linalg.inv(x1_work), 3,
         None),
        ("k1_1x256", lambda: fused.gj_kernel(x1_one, pivot=True), 10,
         "fused_gj"),
        ("k1_4x640", lambda: fused.gj_kernel(x1_640, pivot=True), 3,
         "fused_gj"),
        ("k2_128x4096", lambda: blocked.panel_factor(s2, 0, u2, pivot=True),
         10, "panel_factor"),
        ("k3_64x20032_bf16", lambda: blocked.pivot_search(s3, u3), 5,
         "pivot_search"),
        ("k3_128x4096", lambda: blocked.pivot_search(s2, u2), 10,
         "pivot_search"),
        ("k4_b64", lambda: blocked.invert_small(x4_b64, pivot=True), 200,
         "small_inv"),
        ("k4_b128", lambda: blocked.invert_small(x4_b128, pivot=True), 200,
         "small_inv"),
        ("k4_library_inv_b64", lambda: torch.linalg.inv(x4_b64), 200, None),
        ("k4_library_inv_b128", lambda: torch.linalg.inv(x4_b128), 200,
         None),
        ("k5_b128", lambda: lu.small_lu(x5_b128), 200, "small_lu"),
        ("k6_8x128x1024",
         lambda: lockstep.lockstep_factor(s6, 0, u6, pivot=True), 10,
         "panel_factor"),
        ("k6_4x128x2048",
         lambda: lockstep.lockstep_factor(s6b, 0, u6b, pivot=True), 10,
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
    for label, fn in (
            ("blocked_4096_raw", lambda: blocked.blocked_inverse(x4k,
                                                                 refine=0)),
            ("blocked_4096_refined", lambda: blocked.blocked_inverse(x4k)),
            ("lu_inverse_4096", lambda: inverse(x4k, method="lu")),
            ("ns_4096", lambda: inverse(wc4k, method="ns")),
            ("fp64_4096", lambda: inverse(x4k64)),
            ("no_pivot_fp64_1024", lambda: inverse(dom1k_dev, pivot=False)),
            ("spec_fp64_64x256", lambda: inverse(batch64))):
        ms[label] = prof.events_ms(fn, 3)
        ms[f"{label}_device"] = prof.device_ms(fn)
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
        for key, rec in first["bits"].items():
            print(f"{key}: {_compare_bits(rec, second['bits'][key])}")
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
