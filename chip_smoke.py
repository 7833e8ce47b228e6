"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gpu_matrix_inversion_tpu_torch/csrc``,
holds each against its plain PyTorch twin on the card, drives the shipped
product call ``matrix_inv_32`` and ``inverse`` end to end (fused and blocked
routes, the contract probes), checks residual gates, repeat-run
determinism and that the main path launched every kernel, and times the
kernels beside their twins. Any failed check exits nonzero; nothing is
caught and passed over. The second-to-last line of stdout is the kernels'
JSON record, the last line ``{"ok": true, "device": {...}}``. Exits 1
without a CUDA device.
The port imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)
    log(f"  ok: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs difference, max abs difference / max|ref|)."""
    d = float((x.double() - ref.double()).abs().max())
    return d, d / float(ref.double().abs().max())


def batched_residual(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """relative_residual (utils/residual.py) per matrix of a batch, in
    float64 on the card: ||A X - I||_F / (||A||_F ||X||_F)."""
    a, x = a.double(), x.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    r = torch.linalg.matrix_norm(a @ x - eye)
    return r / (torch.linalg.matrix_norm(a) * torch.linalg.matrix_norm(x))


def main() -> None:
    # ---- phase 1: the card and the toolchain --------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA GPU")
    from gpu_matrix_inversion_tpu_torch import inverse, matrix_inv_32
    from gpu_matrix_inversion_tpu_torch.ops import blocked, fused
    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power.limit)"
    log("phase 1: card and toolchain")
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log("  " + nvcc.stdout.strip().splitlines()[-1])

    # ---- phase 2: build ------------------------------------------------
    log("phase 2: build")
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load()
    build_s = time.perf_counter() - t0
    log(f"  built {lib_path.name} in {build_s:.1f} s")
    report = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    for line in report.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())

    # ---- phase 3: K1 against its twin -----------------------------------
    # Tolerance: pos identical, ok equal, values within 1e-4 of max|twin|.
    # The twin rounds as the kernel does (one FMA per update, IEEE
    # division); it emulates the FMA in float64, which rounds twice in
    # rare halfway cases, so the two may differ by a few ulps.
    log("phase 3: K1 fused_gj vs its twin")
    rng = np.random.default_rng(0)
    k1_abs = 0.0
    # The main path's own shapes come first: the (4096, 128, 128) headline
    # batch and the single 256 x 256 matrix of phase 5's fused call.
    cases = [("(4096,128,128) shared-memory branch", (4096, 128), True,
              torch.float32),
             ("single 256x256 (m=256) global workspace", (1, 256), True,
              torch.float32),
             ("(64,128,128) no pivot", (64, 128), False, torch.float32),
             ("(64,128,128) bf16", (64, 128), True, torch.bfloat16),
             ("(4,640,640) global workspace", (4, 640), True, torch.float32),
             ("single 300x300 (m=384) global workspace", (1, 300), True,
              torch.float32)]
    for name, (bsz, n), pivot, dtype in cases:
        a = rng.standard_normal((bsz, n, n)).astype(np.float32)
        if not pivot:
            a += n * np.eye(n, dtype=np.float32)
        m = fused._round_up(n, 128)
        pad = np.broadcast_to(np.eye(m, dtype=np.float32), (bsz, m, m)).copy()
        pad[:, :n, :n] = a
        x = torch.from_numpy(pad).to(dev).to(dtype)
        inv_k, pos_k, ok_k = fused.gj_kernel(x, pivot=pivot)
        torch.cuda.synchronize()
        inv_t, pos_t, ok_t = fused.gj_twin(x, pivot=pivot)
        d_abs, d_rel = rel_err(inv_k, inv_t)
        k1_abs = max(k1_abs, d_abs)
        log(f"  {name}: max abs {d_abs:.3e}, rel {d_rel:.3e}")
        check(torch.equal(pos_k, pos_t), f"K1 {name}: pos identical")
        check(torch.equal(ok_k, ok_t) and bool(ok_k.all()),
              f"K1 {name}: ok equal (all true)")
        check(d_rel <= 1e-4, f"K1 {name}: values within 1e-4")

    # ---- phase 4: K2 against its twin -----------------------------------
    # Tolerance: pivrows identical, ok equal, C^T within 1e-4 of max|twin|
    # (the twin's deferred dot is a cuBLAS FP32 matmul, summed in another
    # order than the kernel's FMA loop).
    log("phase 4: K2 panel_factor vs its twin")
    k2_abs = 0.0
    for m, b in ((4096, 128), (16384, 64)):
        strip = torch.from_numpy(
            rng.standard_normal((b, m)).astype(np.float32)).to(dev)
        used = torch.zeros(m, dtype=torch.int32, device=dev)
        runs = [("empty mask", 0, used)]
        if m == 4096:
            first, _, _ = blocked.panel_factor_twin(strip, 0, used,
                                                    pivot=True)
            prior = used.clone()
            prior[first.long()] = 1
            runs.append(("prior panel's mask", b, prior))
        for label, kb, mask in runs:
            p_k, ct_k, ok_k = blocked.panel_factor(strip, kb, mask,
                                                   pivot=True)
            torch.cuda.synchronize()
            p_t, ct_t, ok_t = blocked.panel_factor_twin(strip, kb, mask,
                                                        pivot=True)
            d_abs, d_rel = rel_err(ct_k, ct_t)
            k2_abs = max(k2_abs, d_abs)
            name = f"m={m} b={b} {label}"
            log(f"  {name}: max abs {d_abs:.3e}, rel {d_rel:.3e}")
            check(torch.equal(p_k, p_t), f"K2 {name}: pivrows identical")
            check(bool(ok_k) == bool(ok_t) and bool(ok_k),
                  f"K2 {name}: ok equal (true)")
            check(d_rel <= 1e-4, f"K2 {name}: C^T within 1e-4")
            if label != "empty mask":
                check(not bool(mask[p_k.long()].any()),
                      f"K2 {name}: no used row chosen")

    # ---- phase 5: the main path through the public API ------------------
    log("phase 5: main path (matrix_inv_32 / inverse on cuda)")
    fused.gj_kernel.launches = 0
    blocked.panel_factor.launches = 0

    a256 = hollow_random_matrix(256, seed=256)
    out = matrix_inv_32(a256.reshape(-1), 256, device="cuda")
    r = relative_residual(a256, out.reshape(256, 256))
    log(f"  n=256 fused route: residual {r:.3e}")
    check(out.shape == (65536,) and r <= 1e-5, "n=256 fused residual <= 1e-5")

    batch = rng.uniform(0.0, 100.0, (4096, 128, 128)).astype(np.float32)
    batch[:, np.arange(128), np.arange(128)] = 0.0        # hollow protocol
    xb = torch.from_numpy(batch).to(dev)
    inv_b, ok_b = inverse(xb)
    res_b = batched_residual(xb, inv_b)
    log(f"  (4096,128,128) batched fused: max residual "
        f"{float(res_b.max()):.3e}")
    check(bool(ok_b.all()) and bool(torch.isfinite(inv_b).all()),
          "batched: all ok, all finite")
    check(float(res_b.max()) <= 1e-5, "batched residual <= 1e-5")

    a4k = hollow_random_matrix(4096, seed=1)    # bench.py's 4096^2 input
    x4k = torch.from_numpy(a4k).to(dev)
    raw, ok_raw = blocked.blocked_inverse(x4k, refine=0)
    r_raw = relative_residual(a4k, raw.cpu().numpy())
    out4k = matrix_inv_32(a4k.reshape(-1), 4096, device="cuda")
    r_ref = relative_residual(a4k, out4k.reshape(4096, 4096))
    log(f"  n=4096 blocked: raw residual {r_raw:.3e}, refined {r_ref:.3e}")
    check(bool(ok_raw) and r_raw <= 1e-4, "4096 raw residual <= 1e-4")
    check(out4k.size == 4096 * 4096 and r_ref <= 1e-6,
          "4096 refined residual <= 1e-6")

    a1950 = hollow_random_matrix(1950, seed=1950)
    out1950 = matrix_inv_32(a1950.reshape(-1), 1950, device="cuda")
    r1950 = relative_residual(a1950, out1950.reshape(1950, 1950))
    log(f"  n=1950 seed=1950 refined: residual {r1950:.3e}")
    check(out1950.size == 1950 * 1950 and r1950 <= 1e-7,
          "1950 refined residual <= 1e-7")

    nan_in = hollow_random_matrix(64, seed=3)
    nan_in[5, 7] = np.nan
    probes = {"order 0": ([1.0, 2.0, 3.0, 4.0], 0),
              "non-square length": ([1.0, 2.0, 3.0], 2),
              "all-ones singular": (np.ones(64 * 64, np.float32), 64),
              "NaN input": (nan_in.reshape(-1), 64)}
    for name, (flat, order) in probes.items():
        got = matrix_inv_32(flat, order, device="cuda")
        check(got.size == 0, f"contract probe {name}: empty array")

    launches = {"K1": fused.gj_kernel.launches,
                "K2": blocked.panel_factor.launches}
    log(f"  launches on the main path: {launches}")
    check(launches["K1"] > 0, "K1 launched on the main path")
    check(launches["K2"] > 0, "K2 launched on the main path")

    # ---- phase 6: determinism -------------------------------------------
    log("phase 6: repeat runs")
    first, _ = inverse(x4k)
    second, _ = inverse(x4k)
    check(torch.equal(first, second), "4096^2 blocked: bit-identical repeat")
    del first, second, raw

    # ---- phase 7: timings -----------------------------------------------
    log(f"phase 7: timings (CUDA events, after warm-up) on {card}")
    times = {}
    times["k1_batch4096_ms"] = cuda_ms(
        lambda: fused.gj_kernel(xb, pivot=True), iters=5)
    times["k1_twin_batch4096_ms"] = cuda_ms(
        lambda: fused.gj_twin(xb, pivot=True), iters=1)
    times["fused_inverse_batch4096_ms"] = cuda_ms(lambda: inverse(xb),
                                                  iters=5)
    # K1's global-workspace branch on a batch that fills the card: 512
    # (256, 512) workspaces, 268 MB, far past the 50 MB L2.
    xw = torch.from_numpy(
        rng.standard_normal((512, 256, 256)).astype(np.float32)).to(dev)
    times["k1_batch512_m256_ms"] = cuda_ms(
        lambda: fused.gj_kernel(xw, pivot=True), iters=5)
    times["k1_twin_batch512_m256_ms"] = cuda_ms(
        lambda: fused.gj_twin(xw, pivot=True), iters=1)
    del xw
    strip = torch.from_numpy(
        rng.standard_normal((128, 4096)).astype(np.float32)).to(dev)
    used = torch.zeros(4096, dtype=torch.int32, device=dev)
    times["k2_panel_4096_ms"] = cuda_ms(
        lambda: blocked.panel_factor(strip, 0, used, pivot=True), iters=10)
    times["k2_twin_panel_4096_ms"] = cuda_ms(
        lambda: blocked.panel_factor_twin(strip, 0, used, pivot=True),
        iters=3)
    times["blocked_4096_raw_ms"] = cuda_ms(
        lambda: blocked.blocked_inverse(x4k, refine=0), iters=3)
    times["blocked_4096_refined_ms"] = cuda_ms(
        lambda: blocked.blocked_inverse(x4k), iters=3)
    with matmul_precision("highest"):
        gemm = torch.randn(4096, 4096, device=dev)
        times["fp32_gemm_4096_ms"] = cuda_ms(lambda: gemm @ gemm, iters=10)
    rates = {
        "k1_batch4096_inv_per_s": 4096 / (times["k1_batch4096_ms"] / 1e3),
        "k1_twin_batch4096_inv_per_s":
            4096 / (times["k1_twin_batch4096_ms"] / 1e3),
        "fused_inverse_batch4096_inv_per_s":
            4096 / (times["fused_inverse_batch4096_ms"] / 1e3),
        "k2_us_per_pivot_step": times["k2_panel_4096_ms"] * 1e3 / 128,
    }
    for key, val in {**times, **rates}.items():
        log(f"  {key}: {val:.4f}   [{card}]")

    kernels = [
        {"name": "K1 fused_gj", "route": "cuda",
         "source": "gpu_matrix_inversion_tpu_torch/csrc/fused_gj.cu",
         "replaces": "gpu_matrix_inversion_tpu/ops/fused.py:140",
         "launches": launches["K1"], "max_abs_err": k1_abs,
         "ms": times["k1_batch4096_ms"],
         "plain_ms": times["k1_twin_batch4096_ms"]},
        {"name": "K2 panel_factor", "route": "cuda",
         "source": "gpu_matrix_inversion_tpu_torch/csrc/panel_factor.cu",
         "replaces": "gpu_matrix_inversion_tpu/ops/blocked.py:255",
         "launches": launches["K2"], "max_abs_err": k2_abs,
         "ms": times["k2_panel_4096_ms"],
         "plain_ms": times["k2_twin_panel_4096_ms"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
