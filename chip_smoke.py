"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gpu_matrix_inversion_tpu_torch/csrc``,
holds each (K1 to K5) against its plain PyTorch twin on the card, and
drives the public entry points end to end: the shipped product call
``matrix_inv_32`` and ``inverse`` (fused and blocked routes, the contract
probes), then the second slice's paths -- FP64 through K3's f32-search
tier, no-pivot FP64, ``matrix_inv_32`` at n = 20000 (the split path, K3 on
bf16 strips + K4), the bf16-search blocked call, the LU route (``inverse``
with ``method="lu"``, ``solve``, ``slogdet``; K3 + K5). Each path runs with
the kernels' launch counts zeroed just before it and read just after, and
must have launched its kernels. It checks residual gates, repeat-run
determinism, and times the kernels beside their twins, their bounds and
the library call that computes the same function, where there is one. Any
failed check exits nonzero; nothing is caught and passed over. Each
phase prints its seconds. The second-to-last line of stdout is the
kernels' JSON record, the last line ``{"ok": true, "device": {...}}``.
Exits 1 without a CUDA device.
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


# Published peaks of one H100 SXM at 700 W: FP32 outside the tensor cores
# (the on-chip-measurement table), BF16 outside the tensor cores (NVIDIA's
# H100 architecture whitepaper: packed bf16x2 operations, each rounded, as
# the bf16 pivot search rounds; a per-op-rounded rank-1 update cannot run
# on the tensor cores), and HBM bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 133.8e12}
PEAK_HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float,
          dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations the function needs over the peak for their type and the
    bytes (each input read once, each output written once) over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def panel_lu_flops(m: int, b: int) -> float:
    """Operations of an LU with partial pivoting of an (m, b) panel: step k
    divides the m - k - 1 rows below it and updates them across the
    b - k - 1 columns right of it. That is the least work that finds a
    panel's b pivot rows (K3), and for m = b the work of K5."""
    return sum((m - k - 1) * (2 * (b - k - 1) + 1) for k in range(b))


_PHASE = {"name": None, "t": 0.0}


def phase(name: str) -> None:
    """Start a phase; print the seconds the previous one took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        log(f"  [{_PHASE['name']}: {now - _PHASE['t']:.1f} s]")
    _PHASE.update(name=name.split(":")[0], t=now)
    log(name)


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
    from gpu_matrix_inversion_tpu_torch import (
        inverse, matrix_inv_32, matrix_inversion_fp64,
        matrix_inversion_no_pivots, slogdet, solve)
    from gpu_matrix_inversion_tpu_torch.ops import blocked, fused, lu
    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)

    wrappers = {"K1": fused.gj_kernel, "K2": blocked.panel_factor,
                "K3": blocked.pivot_search, "K4": blocked.invert_small,
                "K5": lu.small_lu}

    def zero_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts(path: str, expect: tuple[str, ...]) -> dict:
        counts = {k: fn.launches for k, fn in wrappers.items()}
        log(f"  launches on {path}: {counts}")
        for k in expect:
            check(counts[k] > 0, f"{k} launched on {path}")
        return counts

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power.limit)"
    phase("phase 1: card and toolchain")
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log("  " + nvcc.stdout.strip().splitlines()[-1])

    # ---- phase 2: build ------------------------------------------------
    phase("phase 2: build")
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
    phase("phase 3: K1 fused_gj vs its twin")
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
    phase("phase 4: K2 panel_factor vs its twin")
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

    # ---- phase 4b: K3 against its twin ----------------------------------
    # Tolerance: pivot rows identical (max_abs_err counts mismatches). The
    # shapes are the new paths' own: (4096, 128) of the LU route (fp32) and
    # of the 4096^2 bf16-search call, (20032, 64) bf16 of the n = 20000
    # split path, (4096, 256) fp32 of the FP64 tier; the second run of
    # each uses a prior panel's mask.
    phase("phase 4b: K3 pivot_search vs its twin")
    k3_mismatch = 0
    for m, b, dtype in ((4096, 128, torch.float32),
                        (4096, 128, torch.bfloat16),
                        (20032, 64, torch.bfloat16),
                        (4096, 256, torch.float32)):
        strip = torch.from_numpy(
            rng.standard_normal((b, m)).astype(np.float32)).to(dev).to(dtype)
        used = torch.zeros(m, dtype=torch.int32, device=dev)
        prior = used.clone()
        prior[blocked.pivot_search_twin(strip, used).long()] = 1
        for label, mask in (("empty mask", used), ("prior panel's mask",
                                                   prior)):
            p_k = blocked.pivot_search(strip, mask)
            torch.cuda.synchronize()
            p_t = blocked.pivot_search_twin(strip, mask)
            miss = int((p_k != p_t).sum())
            k3_mismatch = max(k3_mismatch, miss)
            name = f"m={m} b={b} {str(dtype)[6:]} {label}"
            log(f"  {name}: {miss} pivot rows differ")
            check(miss == 0, f"K3 {name}: pivot rows identical")
            check(not bool(mask[p_k.long()].any()),
                  f"K3 {name}: no used row chosen")

    # ---- phase 4c: K4 and K5 against their twins ------------------------
    # Tolerance: ok equal; values within 1e-4 of max|twin| (the twins round
    # as the kernels do -- one FMA per update, IEEE division -- but emulate
    # the FMA in float64, which rounds twice in rare halfway cases). Each
    # batch holds 256 random blocks (K5: made diagonally dominant, as K3's
    # pivot order makes the blocks getrf hands it), so that many blocks are
    # in flight at once and K4 swaps rows at nearly every step, and one
    # singular block.
    phase("phase 4c: K4 small_inv and K5 small_lu vs their twins")
    k4_abs = k5_abs = 0.0
    for name, b, kernel, twin in (
            ("K4 b=64", 64, blocked.invert_small,
             lambda x: blocked.invert_small_twin(x, pivot=True)),
            ("K4 b=128", 128, blocked.invert_small,
             lambda x: blocked.invert_small_twin(x, pivot=True)),
            ("K5 b=128", 128, lu.small_lu, lu.small_lu_twin)):
        d = rng.standard_normal((257, b, b)).astype(np.float32)
        if name.startswith("K5"):
            d += b * np.eye(b, dtype=np.float32)
        d[-1, :, 7] = 0.0
        if name.startswith("K5"):
            d[-1, 7, :8] = 0.0
        x = torch.from_numpy(d).to(dev)
        out_k, ok_k = (kernel(x, pivot=True) if name.startswith("K4")
                       else kernel(x))
        torch.cuda.synchronize()
        out_t, ok_t = twin(x)
        d_abs, d_rel = rel_err(out_k[:-1], out_t[:-1])
        if name.startswith("K4"):
            k4_abs = max(k4_abs, d_abs)
        else:
            k5_abs = max(k5_abs, d_abs)
        log(f"  {name}: max abs {d_abs:.3e}, rel {d_rel:.3e}, ok false "
            f"at {torch.nonzero(~ok_k).flatten().tolist()}")
        check(ok_k.tolist() == ok_t.tolist() == [True] * 256 + [False],
              f"{name}: ok equal (256 true, the singular block false)")
        check(d_rel <= 1e-4, f"{name}: values within 1e-4")

    # ---- phase 5: the main path through the public API ------------------
    phase("phase 5: main path (matrix_inv_32 / inverse on cuda)")
    zero_counts()

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

    launches = read_counts("the main path", ("K1", "K2"))

    # ---- phase 5b: the FP64 tier and no-pivot FP64 ----------------------
    # FP64 gate: the blocked FP32 path's raw residual is ~150 FP32 eps
    # (1.8e-5 at 4096^2); the same algorithm in FP64 should land near
    # 150 * 2.2e-16 = 3e-14 before its polish step, so 1e-12 leaves two
    # orders of headroom and still fails any FP32-grade result.
    phase("phase 5b: FP64 (K3 f32-search tier) and no-pivot FP64")
    a4k64 = hollow_random_matrix(4096, seed=1, dtype=np.float64)
    zero_counts()
    t0 = time.perf_counter()
    out64 = matrix_inversion_fp64(a4k64.reshape(-1), 4096, device="cuda")
    fp64_s = time.perf_counter() - t0
    counts_fp64 = read_counts("matrix_inversion_fp64 4096^2", ("K3",))
    r64 = relative_residual(a4k64, out64.reshape(4096, 4096))
    log(f"  n=4096 FP64: residual {r64:.3e} ({fp64_s:.2f} s host clock)")
    check(out64.size == 4096 * 4096 and r64 <= 1e-12,
          "4096 FP64 residual <= 1e-12")
    del out64
    n_np = 1024
    dom = hollow_random_matrix(n_np, seed=5, dtype=np.float64)
    dom += 2.0 * np.abs(dom).sum(axis=1).max() * np.eye(n_np)
    zero_counts()
    out_np = matrix_inversion_no_pivots(dom.reshape(-1), n_np, device="cuda")
    read_counts("matrix_inversion_no_pivots 1024^2 (logical panel)", ())
    r_np = relative_residual(dom, out_np.reshape(n_np, n_np))
    log(f"  n=1024 no-pivot FP64, diagonally dominant: residual {r_np:.3e}")
    check(out_np.size == n_np * n_np and r_np <= 1e-12,
          "1024 no-pivot FP64 residual <= 1e-12")
    hollow64 = hollow_random_matrix(n_np, seed=5, dtype=np.float64)
    check(matrix_inversion_no_pivots(hollow64.reshape(-1), n_np,
                                     device="cuda").size == 0,
          "contract probe: no-pivot on a zero diagonal returns empty")

    # ---- phase 5c: the split path at n = 20000 --------------------------
    # m = 20032, b = 64, bf16 search: K3 on bf16 strips + K4. Gates: the
    # refined residual <= 1e-6, as at 4096^2; raw printed.
    phase("phase 5c: split path, matrix_inv_32 at n = 20000")
    n20 = 20000
    a20 = hollow_random_matrix(n20, seed=20000)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out20 = matrix_inv_32(a20.reshape(-1), n20, device="cuda")
    split_s = time.perf_counter() - t0
    peak20 = torch.cuda.max_memory_allocated(dev) - live
    counts_split = read_counts("matrix_inv_32 20000^2", ("K3", "K4"))
    log(f"  peak device memory of that call: {peak20 / 1e9:.3f} GB above "
        f"what was live ({peak20 / 20032 ** 2:.2f} bytes per m^2, "
        f"m = 20032)")
    x20 = torch.from_numpy(a20).to(dev)
    r20 = float(batched_residual(x20, torch.from_numpy(out20.reshape(
        n20, n20)).to(dev)))
    del out20
    raw20, ok20 = blocked.blocked_inverse(x20, refine=0)
    r20_raw = float(batched_residual(x20, raw20))
    del raw20
    log(f"  n=20000 split path: raw residual {r20_raw:.3e}, refined "
        f"{r20:.3e} ({split_s:.2f} s host clock, flat API)")
    check(bool(ok20) and r20 <= 1e-6, "20000 refined residual <= 1e-6")

    # ---- phase 5d: bf16 search at 4096^2 --------------------------------
    phase("phase 5d: inverse(x4k, search_bf16=True)")
    zero_counts()
    bf_raw, ok_bf_raw = blocked.blocked_inverse(x4k, search_bf16=True,
                                                refine=0)
    bf_ref, ok_bf = inverse(x4k, search_bf16=True)
    read_counts("the 4096^2 bf16-search call", ("K3", "K4"))
    r_bf_raw = relative_residual(a4k, bf_raw.cpu().numpy())
    r_bf = relative_residual(a4k, bf_ref.cpu().numpy())
    log(f"  n=4096 bf16 search: raw residual {r_bf_raw:.3e}, refined "
        f"{r_bf:.3e}")
    check(bool(ok_bf_raw) and r_bf_raw <= 1e-4,
          "4096 bf16-search raw residual <= 1e-4")
    check(bool(ok_bf) and r_bf <= 1e-6,
          "4096 bf16-search refined residual <= 1e-6")
    del bf_raw, bf_ref

    # ---- phase 5e: the LU route -----------------------------------------
    # Gates: getri residual <= 1e-5 (the JAX package's own gate,
    # tests/test_lu_blocked.py:44); the solve's normwise backward error
    # ||Ax - b|| / (||A|| ||x||) <= 1e-5 likewise; slogdet against numpy.
    phase("phase 5e: LU route (inverse method=lu, solve, slogdet)")
    zero_counts()
    inv_lu, ok_lu = inverse(x4k, method="lu")
    counts_lu = read_counts("inverse(method='lu') 4096^2", ("K3", "K5"))
    r_lu = relative_residual(a4k, inv_lu.cpu().numpy())
    log(f"  n=4096 LU getri: residual {r_lu:.3e}")
    check(bool(ok_lu) and r_lu <= 1e-5, "4096 LU getri residual <= 1e-5")
    del inv_lu
    rhs = torch.from_numpy(
        rng.standard_normal((4096, 16)).astype(np.float32)).to(dev)
    zero_counts()
    x_s, ok_s = solve(x4k, rhs)
    read_counts("solve 4096^2 x 16", ("K3", "K5"))
    xs64, a64, b64 = x_s.double(), x4k.double(), rhs.double()
    berr = float(torch.linalg.norm(a64 @ xs64 - b64)
                 / (torch.linalg.norm(a64) * torch.linalg.norm(xs64)))
    log(f"  solve 4096^2 x 16: ||Ax-b|| / (||A|| ||x||) = {berr:.3e}")
    check(bool(ok_s) and berr <= 1e-5, "solve backward error <= 1e-5")
    a1k = hollow_random_matrix(1024, seed=7) / 50
    zero_counts()
    sign, logabs, ok_d = slogdet(torch.from_numpy(a1k).to(dev))
    read_counts("slogdet 1024^2", ("K3", "K5"))
    want_sign, want_log = np.linalg.slogdet(a1k.astype(np.float64))
    log(f"  slogdet 1024^2: sign {float(sign)} logabsdet "
        f"{float(logabs):.6f}; numpy {want_sign} {want_log:.6f}")
    check(bool(ok_d) and float(sign) == want_sign
          and abs(float(logabs) - want_log) <= 1e-4 * abs(want_log),
          "slogdet 1024 matches numpy (sign equal, log within 1e-4)")

    # ---- phase 6: determinism -------------------------------------------
    phase("phase 6: repeat runs")
    first, _ = inverse(x4k)
    second, _ = inverse(x4k)
    check(torch.equal(first, second), "4096^2 blocked: bit-identical repeat")
    del first, second, raw

    # ---- phase 7: timings -----------------------------------------------
    phase(f"phase 7: timings (CUDA events, after warm-up) on {card}")
    times = {}
    times["k1_batch4096_ms"] = cuda_ms(
        lambda: fused.gj_kernel(xb, pivot=True), iters=5)
    times["k1_twin_batch4096_ms"] = cuda_ms(
        lambda: fused.gj_twin(xb, pivot=True), iters=1)
    times["k1_library_inv_batch4096_ms"] = cuda_ms(
        lambda: torch.linalg.inv(xb), iters=5)
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
    # K3 per panel at the LU route's (4096, 128) fp32 and the split path's
    # (20032, 64) bf16 shapes.
    s20 = torch.from_numpy(rng.standard_normal((64, 20032)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    u20 = torch.zeros(20032, dtype=torch.int32, device=dev)
    times["k3_panel_4096_fp32_ms"] = cuda_ms(
        lambda: blocked.pivot_search(strip, used), iters=10)
    times["k3_twin_panel_4096_fp32_ms"] = cuda_ms(
        lambda: blocked.pivot_search_twin(strip, used), iters=3)
    times["k3_panel_20032_bf16_ms"] = cuda_ms(
        lambda: blocked.pivot_search(s20, u20), iters=5)
    times["k3_twin_panel_20032_bf16_ms"] = cuda_ms(
        lambda: blocked.pivot_search_twin(s20, u20), iters=2)
    # K4 per launch at the split path's b = 64 (n = 20000) and b = 128
    # (the 4096^2 bf16-search call); K5 at getrf's b = 128. Yardsticks:
    # torch.linalg.inv and torch.linalg.lu_factor(pivot=False) on the same
    # block (timed here only; the port never calls them).
    blocks = {b: torch.from_numpy(rng.standard_normal((b, b)).astype(
        np.float32)).to(dev) for b in (64, 128)}
    for b, d in blocks.items():
        times[f"k4_b{b}_ms"] = cuda_ms(
            lambda: blocked.invert_small(d, pivot=True), iters=20)
        times[f"k4_twin_b{b}_ms"] = cuda_ms(
            lambda: blocked.invert_small_twin(d[None], pivot=True), iters=3)
        times[f"k4_library_inv_b{b}_ms"] = cuda_ms(
            lambda: torch.linalg.inv(d), iters=20)
    dlu = blocks[128] + 128 * torch.eye(128, device=dev)
    times["k5_b128_ms"] = cuda_ms(lambda: lu.small_lu(dlu), iters=20)
    times["k5_twin_b128_ms"] = cuda_ms(lambda: lu.small_lu_twin(dlu[None]),
                                       iters=3)
    times["k5_library_lu_nopivot_b128_ms"] = cuda_ms(
        lambda: torch.linalg.lu_factor(dlu, pivot=False), iters=20)
    x4k64 = torch.from_numpy(a4k64).to(dev)
    times["fp64_4096_ms"] = cuda_ms(lambda: inverse(x4k64), iters=1)
    times["split_20000_ms"] = cuda_ms(lambda: inverse(x20), iters=1)
    times["lu_inverse_4096_ms"] = cuda_ms(
        lambda: inverse(x4k, method="lu"), iters=2)
    times["lu_solve_4096x16_ms"] = cuda_ms(lambda: solve(x4k, rhs), iters=2)
    rates = {
        "k1_batch4096_inv_per_s": 4096 / (times["k1_batch4096_ms"] / 1e3),
        "k1_twin_batch4096_inv_per_s":
            4096 / (times["k1_twin_batch4096_ms"] / 1e3),
        "fused_inverse_batch4096_inv_per_s":
            4096 / (times["fused_inverse_batch4096_ms"] / 1e3),
        "k2_us_per_pivot_step": times["k2_panel_4096_ms"] * 1e3 / 128,
        "k3_us_per_pivot_step_20032_bf16":
            times["k3_panel_20032_bf16_ms"] * 1e3 / 64,
    }
    for key, val in {**times, **rates}.items():
        log(f"  {key}: {val:.4f}   [{card}]")

    # Bounds from this run's shapes, at the operations each function needs
    # (not those of the algorithm that computes it): an n x n inverse
    # (K1, K4) 2 n^3; K2's Gauss-Jordan factor of an (m, b) panel into its
    # pivot rows and C^T, b steps over the m - 1 other rows and b columns,
    # 2 (m - 1) b^2; K3 and K5 panel_lu_flops. Bytes count each input read
    # once and each output written once.
    bounds = {
        "K1": bound(4096 * 2 * 128 ** 3,
                    4096 * (2 * 128 * 128 * 4 + 128 * 4 + 4)),
        "K2": bound(2 * (4096 - 1) * 128 ** 2,
                    2 * 128 * 4096 * 4 + 4096 * 4 + 128 * 4 + 4),
        "K3": bound(panel_lu_flops(20032, 64),
                    64 * 20032 * 2 + 20032 * 4 + 64 * 4, torch.bfloat16),
        "K4": bound(2 * 64 ** 3, 2 * 64 * 64 * 4 + 4),
        "K5": bound(panel_lu_flops(128, 128), 2 * 128 * 128 * 4 + 4),
    }
    k3_fp32 = bound(panel_lu_flops(4096, 128),
                    128 * 4096 * 4 + 4096 * 4 + 128 * 4)
    log(f"  K3 bound at (4096, 128) fp32: {k3_fp32[0]:.6f} ms ({k3_fp32[1]})")
    k4_128 = bound(2 * 128 ** 3, 2 * 128 * 128 * 4 + 4)
    log(f"  K4 bound at b = 128: {k4_128[0]:.6f} ms ({k4_128[1]})")
    for k, (ms, by) in bounds.items():
        log(f"  {k} bound: {ms:.6f} ms ({by})")
    log("  K3 launches: fp64 4096 {}, split 20000 {}, LU 4096 {}".format(
        counts_fp64["K3"], counts_split["K3"], counts_lu["K3"]))

    def record(name, src, replaces, launched, err, ms, plain, library):
        return {"name": name, "route": "cuda",
                "source": f"gpu_matrix_inversion_tpu_torch/csrc/{src}",
                "replaces": f"gpu_matrix_inversion_tpu/ops/{replaces}",
                "launches": launched, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bounds[name[:2]][0],
                "bound_by": bounds[name[:2]][1], "library_ms": library}

    kernels = [
        record("K1 fused_gj", "fused_gj.cu", "fused.py:140", launches["K1"],
               k1_abs, times["k1_batch4096_ms"],
               times["k1_twin_batch4096_ms"],
               times["k1_library_inv_batch4096_ms"]),
        # No PyTorch call computes a panel's pivot rows and C^T (K2) or a
        # packed-key pivot search (K3): library_ms is null for both.
        record("K2 panel_factor", "panel_factor.cu", "blocked.py:255",
               launches["K2"], k2_abs, times["k2_panel_4096_ms"],
               times["k2_twin_panel_4096_ms"], None),
        record("K3 pivot_search", "panel_factor.cu", "blocked.py:556",
               counts_split["K3"], k3_mismatch,
               times["k3_panel_20032_bf16_ms"],
               times["k3_twin_panel_20032_bf16_ms"], None),
        record("K4 small_inv", "small_inv.cu", "blocked.py:642",
               counts_split["K4"], k4_abs, times["k4_b64_ms"],
               times["k4_twin_b64_ms"], times["k4_library_inv_b64_ms"]),
        record("K5 small_lu", "small_lu.cu", "lu.py:173", counts_lu["K5"],
               k5_abs, times["k5_b128_ms"], times["k5_twin_b128_ms"],
               times["k5_library_lu_nopivot_b128_ms"]),
    ]
    phase("done")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
