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
occupancy. The sixth slice redesigned K2 and K3 as one thread-block
cluster a panel: phase 1 prints each cluster's geometry and the
occupancy query's answer, every path prints the clusters it launched,
phases 4 and 4b hold both byte-identical to their twins run on the CPU
and C = 8 to C = 16, and phase 7 times them by events and device time
with the microseconds a pivot step takes. The seventh slice redesigned
K1's m = 256 .. 640 branch (one thread-block cluster per matrix, the
matrix on chip; no workspace) and K6 (k clusters of K2's body): phase 1
prints their geometries and how many clusters the card holds, phase 3
holds K1's branch at the smallest C byte-identical to the largest and
checks tie-heavy inputs at m = 256 and 640, phase 4d holds K6 bit for bit
to K2 per matrix and to its twin on the CPU, and phase 7 times K1 at
(512, 256^2) and (1, 256^2) beside batched ``torch.linalg.inv``, the
product call at n = 256, K6 at both lockstep shapes, the lockstep calls'
idle share, and the fused calls' peak memory. The eighth slice added the
Cholesky route (phase 5i: potri at 4096^2 and 8192^2, an SPD batch, an
indefinite input, potrf against numpy, ``solve`` and ``Inverter`` with
``method="cholesky"``, a junk upper triangle changing no bit), the race
check (phase 6: ``check_deterministic`` with the caching allocator's free
blocks and every SM's shared memory poisoned between runs, over K1-K7 and
every route, after a control that must drift), and the host layer in
phase 7 (potri under both product schedules beside its bound and the
library's, ``measure_phases(4096)``, the sweep CLI's rows, and CUDA events
against the profiler's device time on one GEMM, K7 and the blocked call).
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
import io
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
        Inverter, api, cholesky_factor, cholesky_inverse, inverse,
        matrix_inv_32, matrix_inversion_fp64, matrix_inversion_no_pivots,
        slogdet, solve)
    from gpu_matrix_inversion_tpu_torch.benchmarks.phases import (
        SLOTS, measure_phases)
    from gpu_matrix_inversion_tpu_torch.benchmarks.sweep import sweep_cuda
    from gpu_matrix_inversion_tpu_torch.models.newton_schulz import (
        newton_schulz_inverse)
    from gpu_matrix_inversion_tpu_torch.ops import (blocked, cholesky, fused,
                                                    lockstep, lu, matmul)
    from gpu_matrix_inversion_tpu_torch.utils import (cuda_build, determinism,
                                                      profiling)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix, well_conditioned_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    # events_ms: CUDA events around the calls, after a warm-up; device_ms:
    # the profiler's device time, None ("not measured") if it saw none.
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        device_kernels, device_ms, events_ms)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)

    wrappers = {"K1": fused.gj_kernel, "K2": blocked.panel_factor,
                "K3": blocked.pivot_search, "K4": blocked.invert_small,
                "K5": lu.small_lu, "K6": lockstep.lockstep_factor,
                "K7": matmul.tiled_matmul}

    def zero_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0
        blocked._plans.clear()    # so read_counts sees this path's clusters

    def read_counts(path: str, expect: tuple[str, ...]) -> dict:
        counts = {k: fn.launches for k, fn in wrappers.items()}
        log(f"  launches on {path}: {counts}")
        kernel = {0: "K2", 1: "K3 fp32", 2: "K3 bf16"}
        for (kind, m, b, *_), (geo, _) in blocked._plans.items():
            log(f"  {kernel[kind]} cluster on {path} at (m, b) = ({m}, {b}):"
                f" C = {geo.cluster}")
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
    # K2 and K3 run one thread-block cluster a panel: C = 16 CTAs where
    # cudaOccupancyMaxActiveClusters admits one cluster of 16 (non-portable
    # size), else 8. The query needs the kernels, so they build here.
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load()
    build_s = time.perf_counter() - t0
    clusters = {}
    for label, kind, m, b in (("K2 (4096, 128)", 0, 4096, 128),
                              ("K2 (16384, 64)", 0, 16384, 64),
                              ("K3 (4096, 128) fp32", 1, 4096, 128),
                              ("K3 (20032, 64) bf16", 2, 20032, 64),
                              ("K3 (65536, 32) bf16", 2, 65536, 32)):
        geo, resident = blocked.cluster_plan(
            kind, m, b, blocked._factor_geometry(m, b)[0])
        clusters[label] = geo.cluster
        log(f"  {label}: C = {geo.cluster} CTAs of {geo.threads} threads, "
            f"{geo.lanes} lanes and {geo.smem} bytes of shared memory each "
            f"(working set {'shared' if geo.wp_shared else 'global'}, "
            f"strip rows {'shared' if geo.rows_shared else 'global'}); "
            f"cudaOccupancyMaxActiveClusters: {resident}")
        check(resident >= 1, f"{label}: the card admits the cluster")
    # K6 runs k clusters of K2's geometry, one per matrix; past the
    # resident count they run in waves.
    for k, m in ((8, 1024), (4, 2048)):
        geo, resident = blocked.cluster_plan(
            0, m, 128, blocked._factor_geometry(m, 128)[0])
        clusters[f"K6 (k={k}, {m}, 128)"] = geo.cluster
        log(f"  K6 k = {k} at (m, b) = ({m}, 128): {k} clusters of C = "
            f"{geo.cluster} CTAs ({k * geo.cluster} SMs); "
            f"cudaOccupancyMaxActiveClusters: {resident}")
        check(resident >= 1, f"K6 at m = {m}: the card admits the cluster")
    # K1 at m = 256 .. 640: one cluster per matrix, C by the batch.
    for m, bsz in ((256, 1), (256, 512), (384, 1), (384, 64), (512, 1),
                   (640, 64)):
        geo, resident = fused.cluster_plan(m, bsz)
        clusters[f"K1 ({bsz}, {m}^2)"] = geo.cluster
        log(f"  K1 ({bsz}, {m}^2): C = {geo.cluster} CTAs of {geo.rows} "
            f"rows, {geo.smem} bytes of shared memory each; "
            f"cudaOccupancyMaxActiveClusters: {resident}")
        check(resident >= 1, f"K1 ({bsz}, {m}^2): the card admits the "
              f"cluster")

    # ---- phase 2: build report -----------------------------------------
    phase("phase 2: build report")
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
             ("single 256x256 (m=256) cluster", (1, 256), True,
              torch.float32),
             ("(64,128,128) no pivot", (64, 128), False, torch.float32),
             ("(64,128,128) bf16", (64, 128), True, torch.bfloat16),
             ("(4,640,640) cluster", (4, 640), True, torch.float32),
             ("single 300x300 (m=384) cluster", (1, 300), True,
              torch.float32),
             ("(2,256,256) cluster, integers in [-3, 3]", (2, 256), True,
              torch.float32),
             ("(2,640,640) cluster, integers in [-3, 3]", (2, 640), True,
              torch.float32),
             ("(2,512,512) cluster bf16, no pivot", (2, 512), False,
              torch.bfloat16)]
    for name, (bsz, n), pivot, dtype in cases:
        if "integers" in name:     # exact ties in |column|
            a = rng.integers(-3, 4, (bsz, n, n)).astype(np.float32)
        else:
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
    # The cluster branch at the smallest C that fits against the C a small
    # batch grows to: byte-identical.
    for m, bsz, c_min in ((256, 1, 2), (256, 4, 2), (384, 1, 4)):
        x = torch.from_numpy(rng.integers(-3, 4, (bsz, m, m)).astype(
            np.float32) + rng.standard_normal((bsz, m, m)).astype(
            np.float32)).to(dev)
        runs = {}
        for cmax in (c_min, fused.MAX_CLUSTER):
            cap = fused.MAX_CLUSTER
            fused.MAX_CLUSTER = cmax
            try:
                c = fused.cluster_plan(m, bsz)[0].cluster
                runs[c] = fused.gj_kernel(x, pivot=True)
            finally:
                fused.MAX_CLUSTER = cap
        (c1, (i1, p1, o1)), (c2, (i2, p2, o2)) = runs.items()
        check(c1 != c2 and bits_equal(i1, i2) and torch.equal(p1, p2)
              and torch.equal(o1, o2) and bool(o1.all()),
              f"K1 ({bsz}, {m}^2): C = {c1} byte-identical to C = {c2}")

    # ---- phase 4: K2 against its twin -----------------------------------
    # Tolerance: pivrows identical, ok equal, C^T within 1e-4 of max|twin|
    # (the twin's deferred dot is a cuBLAS FP32 matmul, summed in another
    # order than the kernel's FMA loop). And bit for bit against the twin
    # run on the CPU, whose dot sums in the kernel's order (pivrows, C^T,
    # ok), and at C = 8 against C = 16.
    phase("phase 4: K2 panel_factor vs its twin")

    def twin_on_cpu(strip, kb, mask, pivot):
        p, ct, ok = blocked.panel_factor_twin(strip.cpu(), kb, mask.cpu(),
                                              pivot=pivot)
        return p, ct, bool(ok)

    def at_cluster_8(fn):
        """fn() with the panel kernels' clusters capped at 8 CTAs."""
        cap = blocked.MAX_CLUSTER
        blocked.MAX_CLUSTER = 8
        try:
            return fn()
        finally:
            blocked.MAX_CLUSTER = cap

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
            p_c, ct_c, ok_c = twin_on_cpu(strip, kb, mask, True)
            check(torch.equal(p_k.cpu(), p_c) and bits_equal(ct_k.cpu(), ct_c)
                  and bool(ok_k) == ok_c,
                  f"K2 {name}: bit-identical to the twin on the CPU")
            p8, ct8, ok8 = at_cluster_8(
                lambda: blocked.panel_factor(strip, kb, mask, pivot=True))
            check(torch.equal(p_k, p8) and bits_equal(ct_k, ct8)
                  and bool(ok_k) == bool(ok8),
                  f"K2 {name}: C = 8 bit-identical to C = "
                  f"{clusters[f'K2 ({m}, {b})']}")
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
            check(torch.equal(at_cluster_8(
                lambda: blocked.pivot_search(strip, mask)), p_k),
                f"K3 {name}: C = 8 pivot rows identical")
            if dtype == torch.float32:
                # K3 runs K2's steps: on an fp32 strip its pivot rows are
                # K2's.
                check(torch.equal(p_k, blocked.panel_factor(
                    strip, 0, mask, pivot=True)[0]),
                      f"K3 {name}: pivot rows identical to K2's")

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

    # ---- phase 5i: the Cholesky route ------------------------------------
    # Input G G^T / n + I (G standard normal from seed n, the product in
    # float64 on the card, then cast to fp32; condition number <= 5).
    # Gates: potri normalized residual <= 1e-6 (the JAX package's SPD tier,
    # tests/test_cholesky.py), each member of an (8, 512^2) batch too; the
    # factor within 1e-5 relative Frobenius of float64 numpy.linalg.cholesky;
    # solve's backward error <= 1e-5 as the LU route's; Inverter <= 1e-6.
    # Only the lower triangle is read: a random upper triangle changes no
    # bit. An indefinite input (a diagonal entry of -50) gives ok false and
    # no exception, and the flat API's empty vector.
    phase("phase 5i: Cholesky route (potrf, potrs, potri)")

    def spd(n: int, seed: int, batch: int = 0) -> torch.Tensor:
        shape = (batch, n, n) if batch else (n, n)
        g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            shape)).to(dev)
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        return (g @ g.mT / n + eye).float()

    spd4k, spd8k = spd(4096, 4096), spd(8192, 8192)
    zero_counts()
    for n, xs in ((4096, spd4k), (8192, spd8k)):
        inv_c, ok_c = cholesky_inverse(xs)
        r_c = float(batched_residual(xs, inv_c))
        log(f"  potri {n}^2: residual {r_c:.3e}")
        check(bool(ok_c) and r_c <= 1e-6, f"potri {n}^2: ok, residual <= 1e-6")
        if n == 4096:
            inv_4k = inv_c
        del inv_c
    read_counts("cholesky_inverse 4096^2 and 8192^2 (library calls)", ())
    inv_d, ok_d = inverse(spd4k, method="cholesky")
    check(bool(ok_d) and bits_equal(inv_d, inv_4k),
          "inverse(method='cholesky') bit-identical to cholesky_inverse")
    junk = spd4k + torch.triu(torch.from_numpy(rng.uniform(
        -50.0, 50.0, (4096, 4096)).astype(np.float32)).to(dev), 1)
    inv_j, ok_j = cholesky_inverse(junk)
    check(bool(ok_j) and bits_equal(inv_j, inv_4k),
          "potri 4096^2 with a random upper triangle: bit-identical")
    del inv_d, inv_j
    xb8 = spd(512, 512, batch=8)
    inv_b8, ok_b8 = cholesky_inverse(xb8)
    r_b8 = batched_residual(xb8, inv_b8)
    log(f"  potri (8, 512^2): max residual {float(r_b8.max()):.3e}")
    check(bool(ok_b8.all()) and float(r_b8.max()) <= 1e-6,
          "potri (8, 512^2): all ok, each residual <= 1e-6")
    bad = spd(1024, 1024)
    bad[517, 517] = -50.0
    _, ok_bad = cholesky_inverse(bad)
    _, ok_bad_f = cholesky_factor(bad)
    flat_bad = api._invert_flat(bad.cpu().numpy().reshape(-1), 1024,
                                np.float32, pivot=True, device="cuda",
                                method="cholesky")
    check(not bool(ok_bad) and not bool(ok_bad_f) and flat_bad.size == 0,
          "indefinite 1024^2: potrf and potri ok false, no exception, the "
          "flat API returns an empty vector")
    low, ok_l = cholesky_factor(spd4k)
    want_l = np.linalg.cholesky(spd4k.cpu().double().numpy())
    d_l = float(np.linalg.norm(low.cpu().double().numpy() - want_l)
                / np.linalg.norm(want_l))
    log(f"  potrf 4096^2: relative Frobenius {d_l:.3e} from float64 numpy")
    check(bool(ok_l) and d_l <= 1e-5,
          "potrf 4096^2 within 1e-5 of float64 numpy.linalg.cholesky")
    del low, want_l
    rhs16 = torch.from_numpy(
        rng.standard_normal((4096, 16)).astype(np.float32)).to(dev)
    x_c, ok_xc = solve(spd4k, rhs16, method="cholesky", refine_iters=1)
    x_cj, _ = solve(junk, rhs16, method="cholesky", refine_iters=1)
    a64c, x64c = spd4k.double(), x_c.double()
    berr_c = float(torch.linalg.norm(a64c @ x64c - rhs16.double())
                   / (torch.linalg.norm(a64c) * torch.linalg.norm(x64c)))
    log(f"  solve(method='cholesky', refine_iters=1) 4096^2 x 16: "
        f"||Ax-b|| / (||A|| ||x||) = {berr_c:.3e}")
    check(bool(ok_xc) and berr_c <= 1e-5,
          "Cholesky solve backward error <= 1e-5")
    check(bits_equal(x_cj, x_c),
          "Cholesky solve with a junk upper triangle: bit-identical x")
    x_ic, ok_ic = Inverter(method="cholesky", refine_iters=1).inverse(spd4k)
    r_ic = float(batched_residual(spd4k, x_ic))
    log(f"  Inverter(method='cholesky', refine_iters=1) 4096^2: residual "
        f"{r_ic:.3e}")
    check(bool(ok_ic) and r_ic <= 1e-6,
          "Inverter cholesky refine_iters=1: ok, residual <= 1e-6")
    del junk, xb8, inv_b8, bad, x_c, x_cj, x_ic, a64c, x64c, inv_4k

    # ---- phase 6: determinism --------------------------------------------
    # check_deterministic (utils/determinism.py) with perturb=True: before
    # every run after the first, every free block of the caching allocator
    # and every SM's shared memory are filled with 0xFF (NaN). A read of
    # scratch, output or shared memory before it is written then drifts.
    # The control, an uninitialised torch.empty, must drift (the first run
    # reads a cached block zeroed here). Each kernel at its main path's
    # shape, then each route; 3 runs, 2 for the split and FP64 routes.
    phase("phase 6: check_deterministic over K1-K7 and every route")
    scratch = torch.empty(1 << 22, device=dev)
    del scratch
    determinism.poison_allocator(dev, 0)
    same, diff = determinism.check_deterministic(
        lambda: torch.empty(1 << 22, device="cuda"), runs=3)
    log(f"  control torch.empty(1 << 22): identical {same}, max_diff {diff}")
    check(not same, "control: an uninitialised torch.empty drifts under the "
          "poison")
    sms_hit, smem_poison = determinism.poison_shared_memory(dev)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    filled = determinism.poison_allocator(dev)
    log(f"  shared-memory poison: {sms_hit} of {sm_count} SMs, {smem_poison} "
        f"bytes a block; allocator poison: {filled} free bytes")
    check(sms_hit == sm_count and smem_poison >= 227 * 1024,
          "the shared-memory poison fills 227 KiB on every SM")
    k1_256 = torch.from_numpy(rng.standard_normal((512, 256, 256)).astype(
        np.float32)).to(dev)
    s2 = torch.from_numpy(rng.standard_normal((128, 4096)).astype(
        np.float32)).to(dev)
    u2 = torch.zeros(4096, dtype=torch.int32, device=dev)
    s3 = torch.from_numpy(rng.standard_normal((64, 20032)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    u3 = torch.zeros(20032, dtype=torch.int32, device=dev)
    d128 = torch.from_numpy(rng.standard_normal((256, 128, 128)).astype(
        np.float32)).to(dev)
    d128_lu = d128 + 128 * torch.eye(128, device=dev)
    s6 = torch.from_numpy(rng.standard_normal((8, 128, 1024)).astype(
        np.float32)).to(dev)
    u6 = torch.zeros((8, 1024), dtype=torch.int32, device=dev)
    g7 = [torch.from_numpy(rng.standard_normal((4096, 4096)).astype(
        np.float32)).to(dev) for _ in range(2)]
    g7_bf16 = [g.bfloat16() for g in g7]
    xs16 = lockstep_in[(16, 1024)]
    x4k64_dev = torch.from_numpy(a4k64).to(dev)

    def lockstep_inverse():
        with lockstep_on():
            return inverse(xs16)

    det_cases = [
        ("K1 (4096, 128^2)", lambda: fused.gj_kernel(xb, pivot=True), 3),
        ("K1 (512, 256^2)", lambda: fused.gj_kernel(k1_256, pivot=True), 3),
        ("K2 (4096, 128)",
         lambda: blocked.panel_factor(s2, 0, u2, pivot=True), 3),
        ("K3 (20032, 64) bf16", lambda: blocked.pivot_search(s3, u3), 3),
        ("K4 b=128 x 256", lambda: blocked.invert_small(d128, pivot=True), 3),
        ("K5 b=128 x 256", lambda: lu.small_lu(d128_lu), 3),
        ("K6 k=8 (1024, 128)",
         lambda: lockstep.lockstep_factor(s6, 0, u6, pivot=True), 3),
        ("K7 4096^3 fp32", lambda: matmul.tiled_matmul(*g7), 3),
        ("K7 4096^3 bf16", lambda: matmul.tiled_matmul(*g7_bf16), 3),
        ("fused inverse 4096 x 128^2", lambda: inverse(xb), 3),
        ("blocked 4096^2 refined", lambda: inverse(x4k), 3),
        ("split 20000^2", lambda: inverse(x20), 2),
        ("FP64 4096^2", lambda: inverse(x4k64_dev), 2),
        ("bf16 search 4096^2", lambda: inverse(x4k, search_bf16=True), 3),
        ("LU getri 4096^2", lambda: inverse(x4k, method="lu"), 3),
        ("LU solve 4096^2 x 16", lambda: solve(x4k, rhs), 3),
        ("lockstep (16, 1024^2)", lockstep_inverse, 3),
        ("ns 4096^2", lambda: inverse(xwc, method="ns"), 3),
        ("Cholesky potri 4096^2", lambda: cholesky_inverse(spd4k), 3),
    ]
    shared_before = determinism.poison_shared_memory.launches
    for name, fn, runs in det_cases:
        t0 = time.perf_counter()
        same, diff = determinism.check_deterministic(fn, runs=runs)
        log(f"  {name}: identical {same}, max_diff {diff}, "
            f"{time.perf_counter() - t0:.2f} s ({runs} runs)")
        check(same, f"{name}: bit-identical over {runs} poisoned runs")
    poisons = determinism.poison_shared_memory.launches - shared_before
    check(poisons == sum(runs - 1 for _, _, runs in det_cases),
          f"shared memory poisoned before every repeat ({poisons} launches)")
    del k1_256, s2, s3, d128, d128_lu, s6, g7, g7_bf16, raw

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
    # K1's cluster branch on a batch that fills the card (512 matrices at
    # m = 256, C = 2) and on one matrix (C = 8), beside batched
    # torch.linalg.inv on the same batch (the port never calls it), by
    # events and by device time; the product call matrix_inv_32 at
    # n = 256 end to end (host transfer and readback included); one 512^2
    # matrix at C = 8 (the geometry's cap for a growing C) and at 16.
    xw = torch.from_numpy(
        rng.standard_normal((512, 256, 256)).astype(np.float32)).to(dev)
    x1 = xw[:1].contiguous()
    times["k1_batch512_m256_ms"] = events_ms(
        lambda: fused.gj_kernel(xw, pivot=True), iters=5)
    times["k1_batch512_m256_device_ms"] = device_ms(
        lambda: fused.gj_kernel(xw, pivot=True), 3, "fused_gj")
    times["k1_twin_batch512_m256_ms"] = events_ms(
        lambda: fused.gj_twin(xw, pivot=True), iters=1)
    times["k1_library_inv_batch512_m256_ms"] = events_ms(
        lambda: torch.linalg.inv(xw), iters=5)
    times["k1_library_inv_batch512_m256_device_ms"] = device_ms(
        lambda: torch.linalg.inv(xw), 3)
    times["k1_one_m256_ms"] = events_ms(
        lambda: fused.gj_kernel(x1, pivot=True), iters=20)
    times["k1_one_m256_device_ms"] = device_ms(
        lambda: fused.gj_kernel(x1, pivot=True), 10, "fused_gj")
    times["k1_library_inv_one_m256_ms"] = events_ms(
        lambda: torch.linalg.inv(x1), iters=20)
    flat256 = a256.reshape(-1)
    times["matrix_inv_32_n256_ms"] = events_ms(
        lambda: matrix_inv_32(flat256, 256, device="cuda"), iters=10)
    x512 = torch.from_numpy(
        rng.standard_normal((1, 512, 512)).astype(np.float32)).to(dev)
    for grow in (8, 16):
        cap = fused.GROW_CLUSTER
        fused.GROW_CLUSTER = grow
        try:
            c = fused.cluster_plan(512, 1)[0].cluster
            times[f"k1_one_m512_C{c}_ms"] = events_ms(
                lambda: fused.gj_kernel(x512, pivot=True), iters=10)
        finally:
            fused.GROW_CLUSTER = cap
    # Peak device memory of the fused calls (input, output and all).
    peak = {}
    for key, shape in (("batch512_n256", (512, 256, 256)),
                       ("batch64_n640", (64, 640, 640))):
        xp = (xw if shape[0] == 512 else torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 1e6
        inverse(xp)
        torch.cuda.synchronize()
        peak[key] = torch.cuda.max_memory_allocated() / 1e6 - base_mb
        log(f"  fused inverse {shape}: peak device memory {peak[key]:.1f} MB "
            f"above the {base_mb:.1f} MB held before the call")
        times[f"k1_{key}_ms"] = events_ms(
            lambda: fused.gj_kernel(xp, pivot=True), iters=2)
    del xw, x1, x512, xp
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
    # By the profiler too: the cluster kernels' own device time.
    times["k2_panel_4096_device_ms"] = device_ms(
        lambda: blocked.panel_factor(strip, 0, used, pivot=True), 10,
        "panel_factor_cluster")
    times["k3_panel_4096_fp32_device_ms"] = device_ms(
        lambda: blocked.pivot_search(strip, used), 10, "pivot_search")
    times["k3_panel_20032_bf16_device_ms"] = device_ms(
        lambda: blocked.pivot_search(s20, u20), 10, "pivot_search")
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
    for k, m in ((8, 1024), (4, 2048)):
        s6 = torch.from_numpy(rng.standard_normal((k, 128, m)).astype(
            np.float32)).to(dev)
        u6 = torch.zeros((k, m), dtype=torch.int32, device=dev)
        times[f"k2_m{m}_ms"] = events_ms(
            lambda: blocked.panel_factor(s6[0], 0, u6[0], pivot=True),
            iters=10)
        times[f"k6_k{k}_m{m}_ms"] = events_ms(
            lambda: lockstep.lockstep_factor(s6, 0, u6, pivot=True), iters=10)
        times[f"k6_k{k}_m{m}_device_ms"] = device_ms(
            lambda: lockstep.lockstep_factor(s6, 0, u6, pivot=True), 10,
            "panel_factor_cluster")
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
        for route in ("per_matrix", "lockstep"):
            dev_ms = times[f"{key}_{route}_device_ms"]
            times[f"{key}_{route}_idle_share"] = (
                None if dev_ms is None
                else 1 - dev_ms / times[f"{key}_{route}_ms"])
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

    # The eighth slice's timings, each line with the card's name and power
    # limit. potri at 4096^2 and 8192^2 under both product schedules
    # (MATINV_POTRI_PRODUCT, read at import; set on the module here): CUDA
    # events, the profiler's device time, the idle share and the top
    # kernels, beside the bound (potri_effective_flops of that schedule at
    # the FP32 peak, or the bytes) and torch.cholesky_inverse after
    # torch.linalg.cholesky as a yardstick (the route never calls it).
    def profile_call(fn):
        """(device ms, top kernels) of one call after a warm-up; (None,
        []) when the profiler saw no device time ("not measured")."""
        fn()
        torch.cuda.synchronize()
        try:
            rows = device_kernels(fn)
        except profiling.NoDeviceTime:
            return None, []
        return sum(ms for _, _, ms in rows), rows[:5]

    def show(val) -> str:
        return "not measured" if val is None else f"{val:.4f}"

    schedule = cholesky._POTRI_PRODUCT_2D
    for n, xs in ((4096, spd4k), (8192, spd8k)):
        for name in ("cols", "2d"):
            cholesky._POTRI_PRODUCT_2D = name == "2d"
            ev = events_ms(lambda: cholesky_inverse(xs), iters=3)
            dv, top = profile_call(lambda: cholesky_inverse(xs))
            fl = cholesky.potri_effective_flops(n)
            b_ms, b_by = bound(fl, 2 * n * n * 4)
            log(f"  potri {n}^2 schedule {name}: {ev:.4f} ms events, "
                f"{show(dv)} ms device, idle share "
                f"{show(None if dv is None else 1 - dv / ev)}; bound "
                f"{b_ms:.4f} ms ({b_by}: {fl / 1e9:.1f} GFLOP)   [{card}]")
            for key, count, ms in top:
                log(f"    {ms:10.4f} ms  {count:5d}x  {key[:90]}")
            times[f"potri_{n}_{name}_ms"] = ev
            times[f"potri_{n}_{name}_device_ms"] = dv
        cholesky._POTRI_PRODUCT_2D = schedule
        with matmul_precision("highest"):
            lib = lambda: torch.cholesky_inverse(torch.linalg.cholesky(xs))
            ev = events_ms(lib, iters=3)
            dv, _ = profile_call(lib)
        log(f"  torch.cholesky_inverse(torch.linalg.cholesky(a)) {n}^2 "
            f"(yardstick): {ev:.4f} ms events, {show(dv)} ms device   "
            f"[{card}]")
        times[f"potri_{n}_library_ms"] = ev
        times[f"potri_{n}_library_device_ms"] = dv

    # measure_phases(4096): device time per Res slot of the raw blocked
    # call on the hollow matrix of seed 0.
    ph = measure_phases(4096, device=dev)
    xh0 = torch.from_numpy(hollow_random_matrix(4096, seed=0)).to(dev)

    def raw0():
        return blocked.blocked_inverse(xh0, block_size=128, refine=0)

    call_ms = device_ms(raw0, 3)
    k2_ms = device_ms(raw0, 3, "panel_factor")
    slot_ms = sum(ph[k] for k in SLOTS) * 1e3
    log("  measure_phases(4096), device ms: " + ", ".join(
        f"{k} {v * 1e3:.4f}" for k, v in ph.items())
        + f"; slots' sum {slot_ms:.4f}, the call profiled alone "
        f"{show(call_ms)}, K2 in it {show(k2_ms)}   [{card}]")
    # The slots against total_compute, the call's device time in the same
    # profiled sessions; another session differs by the profiler's own
    # spread (PERF.md section 7), so the call profiled alone is printed,
    # and K2's share of it must land in the pivot slot (a lost
    # attribution read 0.25 of 10.4 ms).
    check(abs(slot_ms - ph["total_compute"] * 1e3)
          <= 0.01 * ph["total_compute"] * 1e3,
          "measure_phases(4096): the slots add up to the call's device time "
          "within 1%")
    check(k2_ms is not None and ph["pivot"] * 1e3 >= 0.9 * k2_ms,
          "measure_phases(4096): the pivot slot holds K2's device time")
    del xh0

    # The sweep CLI's rows (seconds; each span ends with a synchronize):
    # auto at 256 (fused), 1024 and 4096 (blocked), and potri on SPD input.
    rows = io.StringIO()
    sweep_cuda(0, rows, sizes=[256, 1024, 4096], method="auto")
    sweep_cuda(0, rows, sizes=[4096], method="cholesky", spd=True)
    for row, gate in zip(rows.getvalue().splitlines(),
                         (1e-5, 1e-6, 1e-6, 1e-6)):
        log(f"  sweep row: {row}   [{card}]")
        check(float(row.split()[7]) <= gate,
              f"sweep row n = {row.split()[0]}: residual <= {gate}")

    # Which clock: CUDA events around back-to-back calls against the
    # profiler's summed device time, for the 4096^3 FP32 GEMM, K7 fp32 and
    # the blocked 4096^2 refined call, twice each in turns (events,
    # profiler, events, profiler), with the SM clock and power read before
    # and after.
    def smi_state() -> str:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()

    log(f"  clocks before: {smi_state()}")
    ga = torch.from_numpy(rng.standard_normal((4096, 4096)).astype(
        np.float32)).to(dev)
    with matmul_precision("highest"):
        for name, fn, iters in (
                ("torch.matmul 4096^3 fp32", lambda: ga @ ga, 20),
                ("K7 4096^3 fp32", lambda: matmul.tiled_matmul(ga, ga), 20),
                ("blocked 4096^2 refined", lambda: inverse(x4k), 5)):
            reads = []
            for _ in range(2):
                reads.append(events_ms(fn, iters=iters))
                reads.append(device_ms(fn, iters))
            log(f"  clock check {name}: events {show(reads[0])}, device "
                f"{show(reads[1])}, events {show(reads[2])}, device "
                f"{show(reads[3])} ms   [{card}]")
            times[f"clock_{name.split()[0].replace('.', '_')}_events_ms"] = (
                reads[2])
            times[f"clock_{name.split()[0].replace('.', '_')}_device_ms"] = (
                reads[3])
        # Does the profiler return every launch? The records of one
        # session of 20 GEMMs, alone and between profiling.bracketed's two
        # marker kernels (device_ms and measure_phases bracket every
        # session and leave the markers out).
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for bracket in (False, True):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with (profiling.bracketed() if bracket
                      else contextlib.nullcontext()):
                    for _ in range(20):
                        ga @ ga
                torch.cuda.synchronize()
            seen = [(e.key, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            where = "between markers" if bracket else "alone"
            log(f"  kernel records of 20 GEMMs {where}: " + "; ".join(
                f"{count}x {key[:70]}" for key, count in seen))
    log(f"  clocks after: {smi_state()}")
    del ga
    rates = {
        "k1_batch4096_inv_per_s": 4096 / (times["k1_batch4096_ms"] / 1e3),
        "k1_twin_batch4096_inv_per_s":
            4096 / (times["k1_twin_batch4096_ms"] / 1e3),
        "fused_inverse_batch4096_inv_per_s":
            4096 / (times["fused_inverse_batch4096_ms"] / 1e3),
        "k2_us_per_pivot_step": times["k2_panel_4096_ms"] * 1e3 / 128,
        "k3_us_per_pivot_step_4096_fp32":
            times["k3_panel_4096_fp32_ms"] * 1e3 / 128,
        "k3_us_per_pivot_step_20032_bf16":
            times["k3_panel_20032_bf16_ms"] * 1e3 / 64,
    }
    for key, val in {**times, **rates}.items():
        shown = "not measured" if val is None else f"{val:.4f}"
        log(f"  {key}: {shown}   [{card}]")
    for label, c in clusters.items():
        log(f"  {label}: C = {c} CTAs a cluster")

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
    k1_512 = bound(512 * 2 * 256 ** 3,
                   512 * (2 * 256 * 256 * 4 + 256 * 4 + 4))
    k1_one = bound(2 * 256 ** 3, 2 * 256 * 256 * 4 + 256 * 4 + 4)
    log(f"  K1 bound at (512, 256^2): {k1_512[0]:.6f} ms ({k1_512[1]}); at "
        f"(1, 256^2): {k1_one[0]:.6f} ms ({k1_one[1]})")
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
         "blocks_per_sm": k1_per_sm,
         # The m = 256 .. 640 branch (one cluster per matrix): the
         # (512, 256^2) batch and one 256^2 matrix.
         "ms_512x256": times["k1_batch512_m256_ms"],
         "kernel_device_ms_512x256": times["k1_batch512_m256_device_ms"],
         "plain_ms_512x256": times["k1_twin_batch512_m256_ms"],
         "library_ms_512x256": times["k1_library_inv_batch512_m256_ms"],
         "library_device_ms_512x256":
             times["k1_library_inv_batch512_m256_device_ms"],
         "bound_ms_512x256": k1_512[0], "bound_by_512x256": k1_512[1],
         "cluster_512x256": clusters["K1 (512, 256^2)"],
         "ms_1x256": times["k1_one_m256_ms"],
         "kernel_device_ms_1x256": times["k1_one_m256_device_ms"],
         "library_ms_1x256": times["k1_library_inv_one_m256_ms"],
         "bound_ms_1x256": k1_one[0], "bound_by_1x256": k1_one[1],
         "cluster_1x256": clusters["K1 (1, 256^2)"],
         "matrix_inv_32_n256_ms": times["matrix_inv_32_n256_ms"],
         "peak_mb_inverse_512x256": peak["batch512_n256"],
         "peak_mb_inverse_64x640": peak["batch64_n640"]},
        # No PyTorch call computes a panel's pivot rows and C^T (K2) or a
        # packed-key pivot search (K3): library_ms is null for both.
        {**record("K2 panel_factor", "panel_factor.cu", "blocked.py:255",
                  launches["K2"], k2_abs, times["k2_panel_4096_ms"],
                  times["k2_twin_panel_4096_ms"], None),
         "kernel_device_ms": times["k2_panel_4096_device_ms"],
         "cluster": clusters["K2 (4096, 128)"],
         "us_per_pivot_step": rates["k2_us_per_pivot_step"]},
        # K3's record is (20032, 64) bf16 (the split path's panel);
        # (4096, 128) fp32 (the LU route's) in the *_4096_fp32 keys.
        {**record("K3 pivot_search", "panel_factor.cu", "blocked.py:556",
                  counts_split["K3"], k3_mismatch,
                  times["k3_panel_20032_bf16_ms"],
                  times["k3_twin_panel_20032_bf16_ms"], None),
         "kernel_device_ms": times["k3_panel_20032_bf16_device_ms"],
         "cluster": clusters["K3 (20032, 64) bf16"],
         "us_per_pivot_step": rates["k3_us_per_pivot_step_20032_bf16"],
         "ms_4096_fp32": times["k3_panel_4096_fp32_ms"],
         "kernel_device_ms_4096_fp32": times["k3_panel_4096_fp32_device_ms"],
         "plain_ms_4096_fp32": times["k3_twin_panel_4096_fp32_ms"],
         "bound_ms_4096_fp32": k3_fp32[0], "bound_by_4096_fp32": k3_fp32[1],
         "cluster_4096_fp32": clusters["K3 (4096, 128) fp32"],
         "us_per_pivot_step_4096_fp32":
             rates["k3_us_per_pivot_step_4096_fp32"]},
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
        {**record("K6 lockstep_factor", "panel_factor.cu", "lockstep.py:84",
                  counts_ls[1024]["K6"], k6_abs, times["k6_k8_m1024_ms"],
                  times["k6_twin_k8_m1024_ms"], None),
         "kernel_device_ms": times["k6_k8_m1024_device_ms"],
         "cluster": clusters["K6 (k=8, 1024, 128)"],
         "launches_k4_m2048": counts_ls[2048]["K6"],
         "ms_k4_m2048": times["k6_k4_m2048_ms"],
         "kernel_device_ms_k4_m2048": times["k6_k4_m2048_device_ms"],
         "plain_ms_k4_m2048": times["k6_twin_k4_m2048_ms"],
         "bound_ms_k4_m2048": k6_2048[0], "bound_by_k4_m2048": k6_2048[1],
         "cluster_k4_m2048": clusters["K6 (k=4, 2048, 128)"]},
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
