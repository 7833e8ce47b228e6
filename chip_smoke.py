"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gpu_matrix_inversion_tpu_torch/csrc``,
holds each (K1 to K7) against its plain PyTorch twin on the card (K6 also
against K2 run per matrix and its twin on the CPU, bit for bit; K7's fp32
results against the float64 product), and drives the public entry points
end to end: the shipped product call ``matrix_inv_32`` and ``inverse``
(fused and blocked routes, the contract probes), then the second slice's
paths -- FP64 through K3's f32-search tier, no-pivot FP64,
``matrix_inv_32`` at n = 20000 (the split path, K3 on bf16 strips + K4),
the bf16-search blocked call, the LU route (``inverse`` with
``method="lu"``, ``solve``, ``slogdet``; K3 + K5) -- and the third slice's:
the opt-in lockstep route (``MATINV_LOCKSTEP=1``, K6) on (16, 1024^2) and
(8, 2048^2) batches against the per-matrix route, K7 as the verification
GEMM of the 4096^2 inverse, ``inverse(method="ns")`` and ``Inverter``.
The fourth slice redesigned K7 (bf16 on the tensor cores, fp32 as a
pipelined FMA loop; checked also at ragged, stride-padded and k = 0
shapes) and K5 (the block in registers; checked at b = 128, 64, 40, 8),
and times both by CUDA events and by the profiler's device time. The
fifth slice redesigned K1 (its m = 128 branch: the matrix in registers,
two blocks an SM) and K4 (the block in registers, rows kept in place):
both are held elementwise to their twins (bits equal up to the sign of a
zero) and timed also by the profiler's device time, K1 beside its
occupancy.
Each path runs with the kernels' launch counts zeroed just before it and
read just after, and must have launched its kernels. It checks residual
gates, repeat-run determinism, and times the kernels beside their twins,
their bounds and the library call that computes the same function, where
there is one. Any
failed check exits nonzero; nothing is caught and passed over. Each
phase prints its seconds. The second-to-last line of stdout is the
kernels' JSON record, the last line ``{"ok": true, "device": {...}}``.
Exits 1 without a CUDA device.
The port imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
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


# Published peaks of one H100 SXM at 700 W: FP32 outside the tensor cores
# (the on-chip-measurement table), BF16 outside the tensor cores (NVIDIA's
# H100 architecture whitepaper: packed bf16x2 operations, each rounded, as
# the bf16 pivot search rounds; a per-op-rounded rank-1 update cannot run
# on the tensor cores), and HBM bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 133.8e12}
# A bf16 matrix product can run on the tensor cores (dense peak, NVIDIA's
# H100 architecture whitepaper).
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float, dtype: torch.dtype = torch.float32,
          peak: float | None = None) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations the function needs over the peak for their type (or
    ``peak``) and the bytes (each input read once, each output written
    once) over the memory rate."""
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    t_bytes = nbytes / PEAK_HBM_BYTES
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


def bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Bit for bit equality of two fp32 tensors (NaNs included)."""
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def hold_to_twin(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """K1 and K4 elementwise against their twins: the kernels take the
    twin's operations in the twin's order, and part from it only where the
    twin's float64 emulation of fmaf rounds twice (a halfway case, about
    once in 2^28 updates) or where a zero carries the other sign (the
    kernels skip the dead entries of [X | I], so such a zero starts from
    +0 where the twin's may be -0). So every element within
    1e-6 (|twin| + 1), and at most 1 in 1000 elements differing in their
    bits other than by the sign of a zero; the signed zeros are counted.
    One skipped update or a multiplier off by a percent breaks the first
    bound, a division that rounds otherwise the second."""
    g, w = got.double(), want.double()
    scaled = float(((g - w).abs() / (w.abs() + 1)).max()) / 1e-6
    del g, w
    ints = torch.int32 if got.element_size() == 4 else torch.int16
    differ = got.view(ints) != want.view(ints)
    zeros = (got == 0) & (want == 0)
    other = int((differ & ~zeros).sum())
    signed = int((differ & zeros).sum())
    log(f"  {name}: {other} of {got.numel()} elements differ in their bits "
        f"(and {signed} zeros in their sign); at most {scaled:.4f} of "
        f"1e-6 (|twin| + 1)")
    check(scaled <= 1.0, f"{name}: every element within 1e-6 (|twin| + 1)")
    check(other * 1000 <= got.numel(), f"{name}: at most 1 in 1000 elements "
          f"differ in their bits, zeros aside")


@contextlib.contextmanager
def lockstep_on():
    """Opt in to the lockstep route (MATINV_LOCKSTEP=1) for the block."""
    prev = os.environ.get("MATINV_LOCKSTEP")
    os.environ["MATINV_LOCKSTEP"] = "1"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["MATINV_LOCKSTEP"]
        else:
            os.environ["MATINV_LOCKSTEP"] = prev


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
        Inverter, inverse, matrix_inv_32, matrix_inversion_fp64,
        matrix_inversion_no_pivots, slogdet, solve)
    from gpu_matrix_inversion_tpu_torch.models.newton_schulz import (
        newton_schulz_inverse)
    from gpu_matrix_inversion_tpu_torch.ops import (blocked, fused, lockstep,
                                                    lu, matmul)
    from gpu_matrix_inversion_tpu_torch.utils import cuda_build
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix, well_conditioned_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    # events_ms: CUDA events around the calls, after a warm-up; device_ms:
    # the profiler's device time, None ("not measured") if it saw none.
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        device_ms, events_ms)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)

    wrappers = {"K1": fused.gj_kernel, "K2": blocked.panel_factor,
                "K3": blocked.pivot_search, "K4": blocked.invert_small,
                "K5": lu.small_lu, "K6": lockstep.lockstep_factor,
                "K7": matmul.tiled_matmul}

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
    # Tolerance: pos identical, ok equal, values within 1e-4 of max|twin|,
    # and elementwise as hold_to_twin says. The twin rounds as the kernel
    # does (one FMA per update, IEEE division); it emulates the FMA in
    # float64, which rounds twice in rare halfway cases, so the two may
    # differ by a few ulps.
    phase("phase 3: K1 fused_gj vs its twin")
    k1_per_sm = fused.blocks_per_sm()
    log(f"  K1 m = 128 branch: {k1_per_sm} blocks resident per SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    check(k1_per_sm >= 2, "K1 m = 128: at least two blocks resident per SM")
    rng = np.random.default_rng(0)
    k1_abs = 0.0
    # The main path's own shapes come first: the (4096, 128, 128) headline
    # batch and the single 256 x 256 matrix of phase 5's fused call.
    cases = [("(4096,128,128) register branch", (4096, 128), True,
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
        hold_to_twin(f"K1 {name}", inv_k, inv_t)
        del inv_k, inv_t

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
    # Tolerance: ok equal; values within 1e-4 of max|twin|, and K4
    # elementwise as hold_to_twin says (the twins round
    # as the kernels do -- one FMA per update, IEEE division -- but emulate
    # the FMA in float64, which rounds twice in rare halfway cases). Each
    # batch holds 256 random blocks (K5: made diagonally dominant, as K3's
    # pivot order makes the blocks getrf hands it), so that many blocks are
    # in flight at once and K4 swaps rows at nearly every step, and one
    # singular block.
    # K5 also at b = 64, 40 and 8, which leave warps, row slots and column
    # slots of its register layout empty. The 1e-4 of max|twin| is far
    # wider than K5's own error, so K5 is also held elementwise to its twin
    # run on the CPU: every element goes through the same operations in the
    # same order in both, and they part only where the twin's float64
    # emulation of fmaf rounds twice (a halfway case, about once in 2^28
    # updates), by an ulp or so of the values the element went through,
    # which are of order one (standard normal entries, multipliers below
    # one). So |K5 - twin| <= 1e-6 (|twin| + 1), about 16 ulps of one; one
    # skipped update (f a_rj, with f ~ 1/b) or a multiplier off by a
    # percent moves some element by 1e-4 or more. The elements whose bits
    # differ from the twin's are counted, and at most one in a thousand may:
    # a division or update that rounds otherwise than K5's parts from the
    # twin by an ulp in far more.
    phase("phase 4c: K4 small_inv and K5 small_lu vs their twins")
    k4_abs = k5_abs = 0.0
    k4 = (blocked.invert_small,
          lambda x: blocked.invert_small_twin(x, pivot=True))
    for name, b, kernel, twin in (
            ("K4 b=64", 64, *k4), ("K4 b=128", 128, *k4),
            *((f"K5 b={b}", b, lu.small_lu, lu.small_lu_twin)
              for b in (128, 64, 40, 8))):
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
        if name.startswith("K4"):
            hold_to_twin(name, out_k[:-1], out_t[:-1])
            continue
        got, want = out_k[:-1].cpu(), lu.small_lu_twin(x[:-1].cpu())[0]
        scaled = float(((got.double() - want.double()).abs()
                        / (want.double().abs() + 1)).max()) / 1e-6
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        log(f"  {name}: against the twin on the CPU, {differ} of "
            f"{got.numel()} elements differ in their bits; at most "
            f"{scaled:.4f} of 1e-6 (|twin| + 1)")
        check(scaled <= 1.0, f"{name}: every element within 1e-6 (|twin| + 1) "
              f"of the twin on the CPU")
        check(differ * 1000 <= got.numel(),
              f"{name}: at most 1 in 1000 elements differ in their bits")

    # ---- phase 4d: K6 against K2 run per matrix, and its twin -----------
    # Tolerance: bit for bit against K2 run on each matrix alone and against
    # the twin run on the CPU (pivot rows, C^T, ok). The twin on the card
    # differs from both at m = 1024 (its deferred dot is a cuBLAS product,
    # which sums in another order at that shape), so it is held to K2's
    # tolerance: pivot rows identical, ok equal, C^T within 1e-4 of
    # max|twin|. The lockstep gate's full shapes, k = 8 at m = 1024 and
    # k = 4 at m = 2048 (b = 128), each with an empty and a prior panel's
    # mask; no pivoting once, on strips made diagonally dominant at the
    # pivot rows.
    phase("phase 4d: K6 lockstep_factor vs K2 per matrix and its twin")
    k6_abs = 0.0
    for k, m in ((8, 1024), (4, 2048)):
        b = 128
        strips = torch.from_numpy(
            rng.standard_normal((k, b, m)).astype(np.float32)).to(dev)
        empty = torch.zeros((k, m), dtype=torch.int32, device=dev)
        prior = empty.clone()
        for i in range(k):
            prior[i, blocked.panel_factor_twin(strips[i], 0, empty[i],
                                               pivot=True)[0].long()] = 1
        runs = [("empty mask", 0, empty, True, strips),
                ("prior panel's mask", b, prior, True, strips)]
        if m == 1024:
            dom = strips.clone()
            dom[:, :, b:2 * b] += b * torch.eye(b, device=dev)
            runs.append(("no pivot", b, prior, False, dom))
        for label, kb, mask, pivot, s in runs:
            p6, ct6, ok6 = lockstep.lockstep_factor(s, kb, mask, pivot=pivot)
            torch.cuda.synchronize()
            same = True
            for i in range(k):
                p2, ct2, ok2 = blocked.panel_factor(s[i], kb, mask[i],
                                                    pivot=pivot)
                same &= (torch.equal(p6[i], p2) and bits_equal(ct6[i], ct2)
                         and bool(ok6[i]) == bool(ok2))
            p_c, ct_c, ok_c = lockstep.lockstep_factor_twin(
                s.cpu(), kb, mask.cpu(), pivot=pivot)
            p_t, ct_t, ok_t = lockstep.lockstep_factor_twin(s, kb, mask,
                                                            pivot=pivot)
            d_abs, d_rel = rel_err(ct6, ct_t)
            k6_abs = max(k6_abs, d_abs)
            name = f"k={k} m={m} b={b} {label}"
            log(f"  {name}: against the twin on the card max abs "
                f"{d_abs:.3e}, rel {d_rel:.3e}")
            check(same, f"K6 {name}: bit-identical to K2 run per matrix")
            check(torch.equal(p6.cpu(), p_c) and bits_equal(ct6.cpu(), ct_c)
                  and ok6.tolist() == ok_c.tolist() == [True] * k,
                  f"K6 {name}: bit-identical to the twin on the CPU")
            check(torch.equal(p6, p_t), f"K6 {name}: twin's pivrows identical")
            check(ok6.tolist() == ok_t.tolist() == [True] * k,
                  f"K6 {name}: ok equal (all true)")
            check(d_rel <= 1e-4,
                  f"K6 {name}: C^T within 1e-4 of the twin on the card")

    # ---- phase 4e: K7 against its twin -----------------------------------
    # Tolerance, fp32: matmul.fp32_error_bound elementwise against the
    # float64 product (a statistical bound on an fp32 sum of terms of random
    # sign, which a TF32 product or one of bf16-rounded operands exceeds on
    # most elements: two controls below must fail it). bf16:
    # matmul.error_bound against the twin (both sum exact products in fp32,
    # in other orders, then may round to neighbouring bf16 values). 4096^3
    # (the timed shape), 300 x 200 @ 200 x 150 (edge tiles; B's rows are
    # not 16-byte multiples), 1000 x 1001 @ 1001 x 999 (k and n not
    # multiples of 8: both operands take the stride-pad copy), and k = 0
    # (zeros; fp32 exactly, so no controls).
    phase("phase 4e: K7 tiled_matmul vs its twin")
    k7_abs = k7_abs_bf16 = 0.0
    big = [torch.from_numpy(rng.standard_normal((4096, 4096)).astype(
        np.float32)).to(dev) for _ in range(2)]
    shapes = {"300x200 @ 200x150": (300, 200, 150),
              "1000x1001 @ 1001x999": (1000, 1001, 999),
              "64x0 @ 0x48": (64, 0, 48)}
    operands = {"4096x4096 @ 4096x4096": big, **{
        label: [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for shape in ((m, k), (k, n))]
        for label, (m, k, n) in shapes.items()}}
    for label, (ga, gb) in operands.items():
        for dtype in (torch.float32, torch.bfloat16):
            xa, xb = ga.to(dtype), gb.to(dtype)
            padded = matmul.tiled_matmul.padded
            out = matmul.tiled_matmul(xa, xb)
            torch.cuda.synchronize()
            padded = matmul.tiled_matmul.padded - padded
            twin = matmul.tiled_matmul_twin(xa, xb)
            err = (out.float() - twin.float()).abs()
            diff = float(err.max())
            name = f"{label} {str(dtype)[6:]}"
            check(out.dtype == dtype and out.shape == twin.shape,
                  f"K7 {name}: dtype and shape")
            if dtype == torch.bfloat16:
                k7_abs_bf16 = max(k7_abs_bf16, diff)
                tol = matmul.error_bound(xa, xb)
                worst = float((err / tol)[tol > 0].max()) if bool(
                    (tol > 0).any()) else 0.0
                log(f"  {name}: {padded} stride-pad copies; max abs "
                    f"{diff:.3e} against the twin, at most {worst:.3f} of "
                    f"matmul.error_bound")
                check(bool((err <= tol).all()),
                      f"K7 {name}: within the bound")
                continue
            k7_abs = max(k7_abs, diff)
            if xa.shape[1] == 0:
                log(f"  {name}: {padded} stride-pad copies")
                check(not bool(out.any()) and bits_equal(out, twin),
                      f"K7 {name}: zeros, bit-identical to the twin")
                continue
            exact = xa.double() @ xb.double()
            tol = matmul.fp32_error_bound(xa, xb)
            with matmul_precision("high"):
                tf32 = xa @ xb
            ratios = {
                key: (c.double() - exact).abs() / tol
                for key, c in (("K7", out), ("twin", twin),
                               ("TF32 control", tf32),
                               ("bf16-operand control", matmul.tiled_matmul(
                                   xa.bfloat16().float(),
                                   xb.bfloat16().float())))}
            log(f"  {name}: {padded} stride-pad copies; max abs "
                f"{diff:.3e} against the twin (bit-identical: "
                f"{bits_equal(out, twin)}); against the "
                f"float64 product, at most this share of fp32_error_bound "
                f"(elements over it): " + ", ".join(
                    f"{key} {float(r.max()):.3f} "
                    f"({float((r > 1).double().mean()):.4f})"
                    for key, r in ratios.items()))
            check(float(ratios["K7"].max()) <= 1.0,
                  f"K7 {name}: within fp32_error_bound of the exact product")
            for key in ("TF32 control", "bf16-operand control"):
                check(float((ratios[key] > 1).double().mean()) > 0.5,
                      f"K7 {name}: the {key} fails fp32_error_bound on most "
                      f"elements")
            del exact, tol, tf32, ratios
    # A one-row view of a wider tensor counts as contiguous whatever its
    # row stride; read in place, its row's last 16-byte unit would bring
    # in what lies past its k columns, inf here (0 * inf would poison the
    # row), so the wrapper copies it.
    ga, gb = operands["1000x1001 @ 1001x999"]
    for dtype in (torch.float32, torch.bfloat16):
        wide = torch.full((1, 1008), float("inf"), dtype=dtype, device=dev)
        wide[:, :1001] = ga[:1]
        xa, xb = wide[:, :1001], gb.to(dtype)
        out = matmul.tiled_matmul(xa, xb)
        diff = (out.float() - matmul.tiled_matmul_twin(xa, xb).float()).abs()
        check(bool(torch.isfinite(out).all())
              and bool((diff <= matmul.error_bound(xa, xb)).all()),
              f"K7 1x1001 view of a 1x1008 row with inf past k, "
              f"{str(dtype)[6:]}: finite, within matmul.error_bound")
    del operands, out, wide

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

    # ---- phase 5f: the lockstep route ------------------------------------
    # inverse on FP32 hollow batches at the JAX package's recorded lockstep
    # shapes, opted in (MATINV_LOCKSTEP=1) and not: the two must agree bit
    # for bit, raw (refine=0) and refined (the default); the lockstep call
    # launches K6 (k = 8 at n = 1024: 2 chunks x 8 panels; k = 4 at
    # n = 2048: 2 x 16) and never K2. Gates: refined <= 1e-6, raw <= 1e-4,
    # as at 4096^2. Then a batch of 5 at n = 2048 (an odd tail: chunks of 4
    # and 1) and one with an all-ones member, whose ok alone is false.
    phase("phase 5f: lockstep route (MATINV_LOCKSTEP=1) vs per-matrix")
    lockstep_in, counts_ls = {}, {}
    for bsz, n, want in ((16, 1024, 16), (8, 2048, 32)):
        xs = torch.from_numpy(np.stack([
            hollow_random_matrix(n, seed=n + i) for i in range(bsz)])).to(dev)
        lockstep_in[(bsz, n)] = xs
        off, ok_off = inverse(xs)
        off_raw, _ = blocked.blocked_inverse(xs, refine=0)
        with lockstep_on():
            zero_counts()
            on, ok_on = inverse(xs)
            counts_ls[n] = read_counts(f"lockstep inverse ({bsz}, {n}, {n})",
                                       ("K6",))
            on_raw, ok_on_raw = blocked.blocked_inverse(xs, refine=0)
        name = f"({bsz}, {n}, {n})"
        check(counts_ls[n]["K6"] == want and counts_ls[n]["K2"] == 0,
              f"lockstep {name}: K6 launched {want} times, K2 never")
        check(bits_equal(on, off) and bits_equal(on_raw, off_raw),
              f"lockstep {name}: bit-identical to the per-matrix route, "
              f"refined and raw")
        check(bool(ok_on.all()) and bool(ok_on_raw.all())
              and bool(ok_off.all()), f"lockstep {name}: all ok")
        res, res_raw = batched_residual(xs, on), batched_residual(xs, on_raw)
        log(f"  {name}: max residual raw {float(res_raw.max()):.3e}, "
            f"refined {float(res.max()):.3e}")
        check(float(res.max()) <= 1e-6 and float(res_raw.max()) <= 1e-4,
              f"lockstep {name}: refined <= 1e-6, raw <= 1e-4")
    del off, off_raw, on, on_raw
    x5 = lockstep_in[(8, 2048)][:5]
    off, _ = inverse(x5)
    with lockstep_on():
        zero_counts()
        on, ok5 = inverse(x5)
        read_counts("lockstep inverse (5, 2048, 2048)", ("K6",))
    check(bits_equal(on, off) and bool(ok5.all()),
          "lockstep (5, 2048, 2048) odd tail: bit-identical, all ok")
    xsing = lockstep_in[(16, 1024)][:4].clone()
    xsing[2] = 1.0
    off, ok_off = inverse(xsing)
    with lockstep_on():
        on, ok_on = inverse(xsing)
    log(f"  all-ones member 2: ok {ok_on.tolist()}")
    check(ok_on.tolist() == ok_off.tolist() == [True, True, False, True],
          "lockstep with an all-ones member: its ok alone false")
    check(bits_equal(on, off), "lockstep with an all-ones member: "
          "bit-identical to the per-matrix route")
    del x5, xsing, off, on

    # ---- phase 5g: K7 as the verification GEMM --------------------------
    # The reference's C8 use: A @ X of the 4096^2 blocked inverse through
    # K7 in fp32, and the normalized residual from it; it must agree with
    # utils/residual.py's float64 one within 1% (fp32 rounding of A X adds
    # about u / sqrt(n) of ||A|| ||X||, far below the raw 1.8e-5).
    phase("phase 5g: K7 as the verification GEMM of the 4096^2 inverse")
    zero_counts()
    prod = matmul.tiled_matmul(x4k, raw)
    counts_k7 = read_counts("the verification GEMM A @ X at 4096^2", ("K7",))
    eye = torch.eye(4096, dtype=torch.float64, device=dev)
    r_k7 = float(torch.linalg.matrix_norm(prod.double() - eye)
                 / (torch.linalg.matrix_norm(x4k.double())
                    * torch.linalg.matrix_norm(raw.double())))
    log(f"  raw 4096^2 inverse: residual from K7 {r_k7:.6e}, "
        f"utils/residual.py {r_raw:.6e}")
    check(abs(r_k7 - r_raw) <= 1e-2 * r_raw,
          "K7 residual agrees with utils/residual.py within 1%")
    del prod, eye

    # ---- phase 5h: Newton-Schulz and Inverter ---------------------------
    # Gates of the JAX package's tests: ns residual <= 1e-5 and ok (also
    # mixed=True), ok false on an all-ones matrix; Inverter on the blocked
    # route (polished twice) <= 1e-6 as at 4096^2, and with ns <= 1e-5.
    phase("phase 5h: Newton-Schulz (inverse method=ns) and Inverter")
    w4k = well_conditioned_matrix(4096, seed=4096)
    xwc = torch.from_numpy(w4k).to(dev)
    zero_counts()
    x_ns, ok_ns = inverse(xwc, method="ns")
    read_counts("inverse(method='ns') 4096^2", ())
    x_mx, ok_mx = newton_schulz_inverse(xwc, mixed=True)
    _, ok_one = inverse(torch.ones(1024, 1024, device=dev), method="ns")
    r_ns, r_mx = (float(batched_residual(xwc, x)) for x in (x_ns, x_mx))
    log(f"  ns 4096^2: residual {r_ns:.3e}; mixed {r_mx:.3e}")
    check(bool(ok_ns) and r_ns <= 1e-5, "ns 4096^2: ok, residual <= 1e-5")
    check(bool(ok_mx) and r_mx <= 1e-5,
          "ns mixed=True 4096^2: ok, residual <= 1e-5")
    check(not bool(ok_one), "ns on an all-ones 1024^2 matrix: ok false")
    zero_counts()
    x_iv, ok_iv = Inverter(method="blocked", refine_iters=1).inverse(a4k)
    read_counts("Inverter(method='blocked', refine_iters=1) 4096^2",
                ("K2",))
    x_in, ok_in = Inverter(method="ns").inverse(w4k)
    r_iv = float(batched_residual(x4k, x_iv))
    r_in = float(batched_residual(xwc, x_in))
    log(f"  Inverter 4096^2: blocked + 1 polish {r_iv:.3e}; ns {r_in:.3e}")
    check(bool(ok_iv) and r_iv <= 1e-6,
          "Inverter blocked refine_iters=1: ok, residual <= 1e-6")
    check(bool(ok_in) and r_in <= 1e-5, "Inverter ns: ok, residual <= 1e-5")
    del x_ns, x_mx, x_iv, x_in

    # ---- phase 6: determinism -------------------------------------------
    phase("phase 6: repeat runs")
    first, _ = inverse(x4k)
    second, _ = inverse(x4k)
    check(torch.equal(first, second), "4096^2 blocked: bit-identical repeat")
    del first, second, raw

    # ---- phase 7: timings -----------------------------------------------
    phase(f"phase 7: timings (CUDA events, after warm-up) on {card}")
    times = {}
    times["k1_batch4096_ms"] = events_ms(
        lambda: fused.gj_kernel(xb, pivot=True), iters=5)
    times["k1_twin_batch4096_ms"] = events_ms(
        lambda: fused.gj_twin(xb, pivot=True), iters=1)
    times["k1_library_inv_batch4096_ms"] = events_ms(
        lambda: torch.linalg.inv(xb), iters=5)
    # By the profiler too: K1's own kernel, every kernel of the library
    # call.
    times["k1_batch4096_device_ms"] = device_ms(
        lambda: fused.gj_kernel(xb, pivot=True), 3, "fused_gj")
    times["k1_library_inv_batch4096_device_ms"] = device_ms(
        lambda: torch.linalg.inv(xb), 3)
    times["fused_inverse_batch4096_ms"] = events_ms(lambda: inverse(xb),
                                                    iters=5)
    # K1's global-workspace branch on a batch that fills the card: 512
    # (256, 512) workspaces, 268 MB, far past the 50 MB L2.
    xw = torch.from_numpy(
        rng.standard_normal((512, 256, 256)).astype(np.float32)).to(dev)
    times["k1_batch512_m256_ms"] = events_ms(
        lambda: fused.gj_kernel(xw, pivot=True), iters=5)
    times["k1_twin_batch512_m256_ms"] = events_ms(
        lambda: fused.gj_twin(xw, pivot=True), iters=1)
    del xw
    strip = torch.from_numpy(
        rng.standard_normal((128, 4096)).astype(np.float32)).to(dev)
    used = torch.zeros(4096, dtype=torch.int32, device=dev)
    times["k2_panel_4096_ms"] = events_ms(
        lambda: blocked.panel_factor(strip, 0, used, pivot=True), iters=10)
    times["k2_twin_panel_4096_ms"] = events_ms(
        lambda: blocked.panel_factor_twin(strip, 0, used, pivot=True),
        iters=3)
    times["blocked_4096_raw_ms"] = events_ms(
        lambda: blocked.blocked_inverse(x4k, refine=0), iters=3)
    times["blocked_4096_refined_ms"] = events_ms(
        lambda: blocked.blocked_inverse(x4k), iters=3)
    with matmul_precision("highest"):
        gemm = torch.randn(4096, 4096, device=dev)
        times["fp32_gemm_4096_ms"] = events_ms(lambda: gemm @ gemm, iters=10)
    # K3 per panel at the LU route's (4096, 128) fp32 and the split path's
    # (20032, 64) bf16 shapes.
    s20 = torch.from_numpy(rng.standard_normal((64, 20032)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    u20 = torch.zeros(20032, dtype=torch.int32, device=dev)
    times["k3_panel_4096_fp32_ms"] = events_ms(
        lambda: blocked.pivot_search(strip, used), iters=10)
    times["k3_twin_panel_4096_fp32_ms"] = events_ms(
        lambda: blocked.pivot_search_twin(strip, used), iters=3)
    times["k3_panel_20032_bf16_ms"] = events_ms(
        lambda: blocked.pivot_search(s20, u20), iters=5)
    times["k3_twin_panel_20032_bf16_ms"] = events_ms(
        lambda: blocked.pivot_search_twin(s20, u20), iters=2)
    # K4 per launch at the split path's b = 64 (n = 20000) and b = 128
    # (the 4096^2 bf16-search call); K5 at getrf's b = 128. Yardsticks:
    # torch.linalg.inv and torch.linalg.lu_factor(pivot=False) on the same
    # block (timed here only; the port never calls them). At tens of us a
    # call, CUDA events around the Python wrapper may time the host, so
    # both also by the profiler's device time.
    blocks = {b: torch.from_numpy(rng.standard_normal((b, b)).astype(
        np.float32)).to(dev) for b in (64, 128)}
    for b, d in blocks.items():
        times[f"k4_b{b}_ms"] = events_ms(
            lambda: blocked.invert_small(d, pivot=True), iters=200)
        times[f"k4_b{b}_device_ms"] = device_ms(
            lambda: blocked.invert_small(d, pivot=True), 50, "small_inv")
        times[f"k4_twin_b{b}_ms"] = events_ms(
            lambda: blocked.invert_small_twin(d[None], pivot=True), iters=3)
        times[f"k4_library_inv_b{b}_ms"] = events_ms(
            lambda: torch.linalg.inv(d), iters=200)
        times[f"k4_library_inv_b{b}_device_ms"] = device_ms(
            lambda: torch.linalg.inv(d), 50)
    # K5 and its yardstick also by torch.profiler: at ~20-100 us a call,
    # CUDA events around the Python wrapper may time the host. K5's own
    # kernel, and every kernel of the library call.
    dlu = blocks[128] + 128 * torch.eye(128, device=dev)
    times["k5_b128_ms"] = events_ms(lambda: lu.small_lu(dlu), iters=200)
    times["k5_b128_device_ms"] = device_ms(
        lambda: lu.small_lu(dlu), 50, "small_lu")
    times["k5_twin_b128_ms"] = events_ms(
        lambda: lu.small_lu_twin(dlu[None]), iters=3)
    times["k5_library_lu_nopivot_b128_ms"] = events_ms(
        lambda: torch.linalg.lu_factor(dlu, pivot=False), iters=200)
    times["k5_library_lu_nopivot_b128_device_ms"] = device_ms(
        lambda: torch.linalg.lu_factor(dlu, pivot=False), 50)
    x4k64 = torch.from_numpy(a4k64).to(dev)
    times["fp64_4096_ms"] = events_ms(lambda: inverse(x4k64), iters=1)
    times["split_20000_ms"] = events_ms(lambda: inverse(x20), iters=1)
    times["lu_inverse_4096_ms"] = events_ms(
        lambda: inverse(x4k, method="lu"), iters=2)
    times["lu_solve_4096x16_ms"] = events_ms(lambda: solve(x4k, rhs), iters=2)
    # K6 per launch at the lockstep shapes beside K2 on one of its strips
    # (k x K2 is the per-matrix route's factor time for the same panels),
    # and K6 on that strip alone (k = 1: K2's step chain in K6's build);
    # then the batch calls, lockstep against per-matrix: CUDA events around
    # the call, and the profiler's summed device time of one call.
    for k, m in ((8, 1024), (4, 2048), (1, 4096)):
        s6 = torch.from_numpy(rng.standard_normal((k, 128, m)).astype(
            np.float32)).to(dev)
        u6 = torch.zeros((k, m), dtype=torch.int32, device=dev)
        times[f"k2_m{m}_ms"] = events_ms(
            lambda: blocked.panel_factor(s6[0], 0, u6[0], pivot=True),
            iters=10)
        times[f"k6_k1_m{m}_ms"] = events_ms(
            lambda: lockstep.lockstep_factor(s6[:1], 0, u6[:1], pivot=True),
            iters=10)
        if k == 1:
            continue
        times[f"k6_k{k}_m{m}_ms"] = events_ms(
            lambda: lockstep.lockstep_factor(s6, 0, u6, pivot=True), iters=10)
        times[f"k6_twin_k{k}_m{m}_ms"] = events_ms(
            lambda: lockstep.lockstep_factor_twin(s6, 0, u6, pivot=True),
            iters=1)
        times[f"k2_times_k{k}_m{m}_ms"] = k * times[f"k2_m{m}_ms"]
    for (bsz, n), xs in lockstep_in.items():
        key = f"batch{bsz}_n{n}"
        times[f"{key}_per_matrix_ms"] = events_ms(lambda: inverse(xs), iters=2)
        times[f"{key}_per_matrix_device_ms"] = device_ms(lambda: inverse(xs))
        with lockstep_on():
            times[f"{key}_lockstep_ms"] = events_ms(lambda: inverse(xs),
                                                    iters=2)
            times[f"{key}_lockstep_device_ms"] = device_ms(
                lambda: inverse(xs))
    # K7 at 4096^3 beside its twin and the library GEMM: fp32 with TF32 off
    # (the twin is that same call), bf16 against bf16 torch.matmul; by
    # events and by the profiler's device time (K7's kernel alone, every
    # kernel of the library call).
    for dtype in (torch.float32, torch.bfloat16):
        xa, xb = (g.to(dtype) for g in big)
        tag = str(dtype)[6:]
        times[f"k7_4096_{tag}_ms"] = events_ms(
            lambda: matmul.tiled_matmul(xa, xb), iters=20)
        times[f"k7_4096_{tag}_device_ms"] = device_ms(
            lambda: matmul.tiled_matmul(xa, xb), 10, "matmul_")
        times[f"k7_twin_4096_{tag}_ms"] = events_ms(
            lambda: matmul.tiled_matmul_twin(xa, xb), iters=5)
        with matmul_precision("highest"):
            times[f"k7_library_matmul_4096_{tag}_ms"] = events_ms(
                lambda: xa @ xb, iters=20)
            times[f"k7_library_matmul_4096_{tag}_device_ms"] = (
                device_ms(lambda: xa @ xb, 10))
    del big, xa, xb
    times["ns_4096_ms"] = events_ms(lambda: inverse(xwc, method="ns"), iters=1)
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
        shown = "not measured" if val is None else f"{val:.4f}"
        log(f"  {key}: {shown}   [{card}]")

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
        # K6: k x K2's at the n = 1024 batch's k = 8, m = 1024.
        "K6": bound(8 * 2 * (1024 - 1) * 128 ** 2,
                    8 * (2 * 128 * 1024 * 4 + 1024 * 4 + 128 * 4 + 4)),
        # K7: 2 m n k at the FP32 peak outside the tensor cores.
        "K7": bound(2 * 4096 ** 3, 3 * 4096 * 4096 * 4),
    }
    k6_2048 = bound(4 * 2 * (2048 - 1) * 128 ** 2,
                    4 * (2 * 128 * 2048 * 4 + 2048 * 4 + 128 * 4 + 4))
    log(f"  K6 bound at k = 4, m = 2048: {k6_2048[0]:.6f} ms ({k6_2048[1]})")
    k7_bf16 = bound(2 * 4096 ** 3, 3 * 4096 * 4096 * 2,
                    peak=PEAK_BF16_TENSOR_FLOPS)
    log(f"  K7 bound at 4096^3 bf16 (tensor cores): {k7_bf16[0]:.6f} ms "
        f"({k7_bf16[1]})")
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
        {**record("K1 fused_gj", "fused_gj.cu", "fused.py:140",
                  launches["K1"], k1_abs, times["k1_batch4096_ms"],
                  times["k1_twin_batch4096_ms"],
                  times["k1_library_inv_batch4096_ms"]),
         "kernel_device_ms": times["k1_batch4096_device_ms"],
         "library_device_ms": times["k1_library_inv_batch4096_device_ms"],
         "blocks_per_sm": k1_per_sm},
        # No PyTorch call computes a panel's pivot rows and C^T (K2) or a
        # packed-key pivot search (K3): library_ms is null for both.
        record("K2 panel_factor", "panel_factor.cu", "blocked.py:255",
               launches["K2"], k2_abs, times["k2_panel_4096_ms"],
               times["k2_twin_panel_4096_ms"], None),
        record("K3 pivot_search", "panel_factor.cu", "blocked.py:556",
               counts_split["K3"], k3_mismatch,
               times["k3_panel_20032_bf16_ms"],
               times["k3_twin_panel_20032_bf16_ms"], None),
        # K4's record is b = 64 (the split path's block); b = 128 (the
        # bf16-search call's) in the *_b128 keys.
        {**record("K4 small_inv", "small_inv.cu", "blocked.py:642",
                  counts_split["K4"], k4_abs, times["k4_b64_ms"],
                  times["k4_twin_b64_ms"], times["k4_library_inv_b64_ms"]),
         "kernel_device_ms": times["k4_b64_device_ms"],
         "library_device_ms": times["k4_library_inv_b64_device_ms"],
         "ms_b128": times["k4_b128_ms"],
         "plain_ms_b128": times["k4_twin_b128_ms"],
         "bound_ms_b128": k4_128[0], "bound_by_b128": k4_128[1],
         "library_ms_b128": times["k4_library_inv_b128_ms"],
         "kernel_device_ms_b128": times["k4_b128_device_ms"],
         "library_device_ms_b128": times["k4_library_inv_b128_device_ms"]},
        {**record("K5 small_lu", "small_lu.cu", "lu.py:173",
                  counts_lu["K5"], k5_abs, times["k5_b128_ms"],
                  times["k5_twin_b128_ms"],
                  times["k5_library_lu_nopivot_b128_ms"]),
         "kernel_device_ms": times["k5_b128_device_ms"],
         "library_device_ms": times["k5_library_lu_nopivot_b128_device_ms"]},
        # No PyTorch call factors panels of k matrices into pivot rows and
        # C^T (K6).
        record("K6 lockstep_factor", "panel_factor.cu", "lockstep.py:84",
               counts_ls[1024]["K6"], k6_abs, times["k6_k8_m1024_ms"],
               times["k6_twin_k8_m1024_ms"], None),
        # K7's record is its fp32 branch (the verification GEMM's dtype);
        # its bf16 branch, on the tensor cores, in the *_bf16 keys.
        {**record("K7 tiled_matmul", "tiled_matmul.cu", "matmul.py:30",
                  counts_k7["K7"], k7_abs, times["k7_4096_float32_ms"],
                  times["k7_twin_4096_float32_ms"],
                  times["k7_library_matmul_4096_float32_ms"]),
         "max_abs_err_bf16": k7_abs_bf16,
         "ms_bf16": times["k7_4096_bfloat16_ms"],
         "plain_ms_bf16": times["k7_twin_4096_bfloat16_ms"],
         "bound_ms_bf16": k7_bf16[0], "bound_by_bf16": k7_bf16[1],
         "library_ms_bf16": times["k7_library_matmul_4096_bfloat16_ms"]},
    ]
    phase("done")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
