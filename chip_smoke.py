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
The ninth slice added the sharded route (phase 5j: a world of one rank
over NCCL and a 1-D cuda mesh; ``sharded_blocked_inverse`` at 4096^2 (K2)
and 20000^2 (K3 + K4) bit for bit ``blocked_inverse`` at the same group
size, ``inverse`` with a mesh routing 32768^2 to ``sharded`` (refined,
its peak memory printed), the dp-only batch bit for bit ``fused_inverse``
(K1) and a batch through the panel body (K2); the sharded calls in phase
6's race check; phase 7 times them beside the blocked route at the same
group size, with the NCCL kernels' share of device time). The tenth slice
made the routes compiled (``utils/graphs.py``: one CUDA graph per static
signature, captured once and replayed, as the JAX package runs one
``jax.jit`` program per signature), so every route call on the card below
runs a graph unless it is under ``graphs.disabled()``; phase 6's race check
holds its first, eager run to the replays; phase 8 runs each compiled route
eagerly, at its first call and replayed, bit for bit, a replay running the
port's kernels as the eager call does by the profiler's records, an A, B, A
replay that leaves a held result unchanged, the first call's parts, the
idle shares that set the graphs' size gate, and what the cache holds after
the sweep's sizes. The eleventh slice added kernels L1
(``csrc/gauss_jordan.cu``) and L2 (``csrc/logical_panel.cu``), the JAX
package's two device-side loops outside Pallas, which the FP64 routes run:
phase 1 prints their geometries, phase 4f holds them to their twins (L1
bit for bit up to the sign of a zero, L2's pivot rows and ok identical),
phase 5b drives the FP64 paths (FP64 4096^2 and 8192^2, no-pivot 1024^2
and 4096^2, an FP64 (64, 256^2) batch) with their launch counts and the
plain loops' call counts at 0, phase 6 repeats them poisoned, phase 7
times L1 and L2 beside their bounds, twins and (L1) torch.linalg.inv, and
phase 8 runs the FP64 routes eager, at their first call and replayed.
The twelfth slice added kernels L3 (``csrc/lu_panel.cu``), L4 (the LU
mode of ``csrc/gauss_jordan.cu``) and L5 (``csrc/lu_solve.cu``), the LU
module's device-side loops (the blocked getrf's panel for every dtype but
fp32's kernel route, the spec getrf and getrs): phase 1 prints their
geometries, phase 4g holds them to their twins bit for bit, phase 5e
drives FP64 LU, ``solve(refine_iters=2)``, ``lu_inverse_refined`` and
the spec on a (64, 128^2) batch with their launch counts, phase 6
repeats them poisoned, phase 7 times them beside their bounds, twins and
``torch.linalg.lu_factor`` / ``lu_solve``, and phase 8 runs the five
newly compiled spec sites and the LU routes eager, at their first call
and replayed.
Each path runs with the kernels' launch counts zeroed and the graph cache
emptied just before it, and the counts read just after: it must have
launched its kernels. The wrappers count launches from the host, so a
compiled call counts its first call's eager warm-up; a replay runs no
wrapper, and phases 5f and 8 count its kernels from the graph's nodes and
the profiler. It checks residual gates, repeat-run determinism, and times
the kernels beside their twins, their bounds and the library call that
computes the same function, where there is one. Any
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
import torch.distributed as dist


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
# FP64 outside the tensor cores: 34 TFLOP/s (NVIDIA's H100 SXM data
# sheet); L1 and L2 round a product and a difference apart, which the
# tensor cores' FP64 matrix rate (67) cannot serve.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 133.8e12,
              torch.float64: 34e12}
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
    from gpu_matrix_inversion_tpu_torch.benchmarks.sweep import (
        reference_sizes, sweep_cuda)
    from gpu_matrix_inversion_tpu_torch.models import solver
    from gpu_matrix_inversion_tpu_torch.models.newton_schulz import (
        newton_schulz_inverse)
    from gpu_matrix_inversion_tpu_torch.ops import (blocked, cholesky, fused,
                                                    gauss_jordan, lockstep,
                                                    lu, matmul)
    from gpu_matrix_inversion_tpu_torch.ops.refine import lu_inverse_refined
    from gpu_matrix_inversion_tpu_torch.parallel import (
        launch, make_device_mesh, sharded, sharded_batched_inverse,
        sharded_blocked_inverse)
    from gpu_matrix_inversion_tpu_torch.utils import (cuda_build, determinism,
                                                      graphs, profiling)
    from gpu_matrix_inversion_tpu_torch.utils.generators import (
        hollow_random_matrix, ill_conditioned_matrix,
        well_conditioned_matrix)
    from gpu_matrix_inversion_tpu_torch.utils.precision import (
        matmul_precision)
    # events_ms: CUDA events around the calls, after a warm-up; device_ms:
    # the profiler's device time, None ("not measured") if it saw none.
    from gpu_matrix_inversion_tpu_torch.utils.profiling import (
        device_kernels, device_ms, events_ms, kernel_launches)
    from gpu_matrix_inversion_tpu_torch.utils.residual import (
        relative_residual)

    wrappers = {"K1": fused.gj_kernel, "K2": blocked.panel_factor,
                "K3": blocked.pivot_search, "K4": blocked.invert_small,
                "K5": lu.small_lu, "K6": lockstep.lockstep_factor,
                "K7": matmul.tiled_matmul,
                "L1": gauss_jordan._gauss_jordan_aug,
                "L2": blocked._panel_pivots_logical, "L3": lu._lu_panel,
                "L4": lu._lu_factor_batched, "L5": lu._lu_solve_batched}
    # The plain loops L1 to L5 replace, counted by calls: on the card no
    # path may run them.
    twins = {"L1": gauss_jordan.gauss_jordan_twin,
             "L2": blocked.logical_panel_twin, "L3": lu.lu_panel_twin,
             "L4": lu.lu_factor_twin, "L5": lu.lu_solve_twin}

    def zero_counts() -> None:
        """Zero the launch counts, and drop the compiled routes' graphs:
        each path's compiled calls then start with a first call, whose
        eager warm-up launches the kernels the wrappers count (a replay
        runs no wrapper; phases 5f and 8 read a replay's kernels from
        the profiler's records)."""
        for fn in wrappers.values():
            fn.launches = 0
        for fn in twins.values():
            fn.calls = 0
        graphs.clear()
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
        calls = {k: fn.calls for k, fn in twins.items()}
        check(not any(calls.values()), f"{path}: the plain loops of L1 to "
              f"L5 ran no time ({calls})")
        return counts

    def hold_records(what: str, got: dict, want: dict) -> None:
        """The profiler's records of the port's kernels (``got``, from
        profiling.kernel_launches) held to an exact count ``want`` (the
        wrappers' eager launches, or a graph's kernel nodes). The profiler
        can drop a record (one of 256 K2 launches in an eager session, one
        of FP64's 16 K3 in a replay) and never adds one: no kernel may show
        more often than ``want``, and a shortfall is printed."""
        if any(n > want.get(k, 0) for k, n in got.items()):
            fail(f"{what}: the profiler recorded {got}, more than {want}")
        if got != want:
            log(f"  {what}: the profiler recorded {got} of {want}")

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

    # L1's cluster branch at the FP64 tier's block (b = 256), the (64, 256^2)
    # batch and spec's largest FP64 n; its grid branch and L2's grids.
    for n, bsz in ((256, 1), (256, 64), (511, 1), (1000, 1)):
        geo, resident = gauss_jordan.loop_plan(n, bsz, torch.float64, dev)
        clusters[f"L1 ({bsz}, {n}^2) fp64"] = geo.ctas
        log(f"  L1 ({bsz}, {n}^2) fp64: {geo.branch} of {geo.ctas} CTAs of "
            f"{geo.rows} rows, {geo.smem} bytes of shared memory each"
            + (f"; cudaOccupancyMaxActiveClusters: {resident}"
               if resident is not None else ""))
    for m, b in ((4096, 256), (8192, 256), (16384, 256)):
        geo = blocked.logical_geometry(m, b, 8, gauss_jordan.sm_count(0))
        clusters[f"L2 ({m}, {b}) fp64"] = geo.ctas
        log(f"  L2 ({m}, {b}) fp64: a grid of {geo.ctas} CTAs of {geo.rows} "
            f"rows (in {'shared' if geo.rows_shared else 'device'} memory)")
    # L4 on L1's geometry (the occupancy of its LU mode's cluster kernel),
    # L3 on L2's grid, L5 one CTA a (matrix, tile of columns).
    for n, bsz, dtype in ((128, 64, torch.float32), (200, 1, torch.float64),
                          (4096, 1, torch.float32)):
        geo, resident = gauss_jordan.loop_plan(n, bsz, dtype, dev,
                                               lu=True)
        clusters[f"L4 ({bsz}, {n}^2) {str(dtype)[6:]}"] = geo.ctas
        log(f"  L4 ({bsz}, {n}^2) {str(dtype)[6:]}: {geo.branch} of "
            f"{geo.ctas} CTAs of {geo.rows} rows, {geo.smem} bytes of shared "
            f"memory each (rows in "
            f"{'shared' if geo.rows_shared else 'device'} memory)"
            + (f"; cudaOccupancyMaxActiveClusters: {resident}"
               if resident is not None else ""))
    for m, b in ((4096, 128), (1024, 128)):
        geo = blocked.logical_geometry(m, b, 8, gauss_jordan.sm_count(0))
        clusters[f"L3 ({m}, {b}) fp64"] = geo.ctas
        log(f"  L3 ({m}, {b}) fp64: a grid of {geo.ctas} CTAs of {geo.rows} "
            f"rows (in {'shared' if geo.rows_shared else 'device'} memory)")
    for bsz, k in ((1, 16), (1, 4096), (64, 128)):
        kc = lu.lu_solve_geometry(bsz, k, gauss_jordan.sm_count(0))
        clusters[f"L5 ({bsz}, k = {k})"] = bsz * -(-k // kc)
        log(f"  L5 ({bsz} matrices, k = {k}): {kc} columns a CTA, "
            f"{bsz * -(-k // kc)} CTAs")

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
        """fn() with the panel kernels' clusters capped at 8 CTAs, eagerly
        (a compiled route would capture a graph for the cap)."""
        cap = blocked.MAX_CLUSTER
        blocked.MAX_CLUSTER = 8
        try:
            with graphs.disabled():
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

    # ---- phase 4f: L1 and L2 against their twins ------------------------
    # L1 (csrc/gauss_jordan.cu) and L2 (csrc/logical_panel.cu), the
    # kernels of the JAX package's two device-side loops outside Pallas,
    # against their plain twins on the card on the same inputs. Tolerance:
    # none. The kernels take the twins' operations in the twins' order
    # (x - f * v rounded twice, IEEE division, the first maximum as
    # torch.argmax picks it), so L1's inverse equals the twin's bit for bit
    # up to the sign of a zero with ok equal, and L2's pivot rows and ok
    # are identical. On the singular and the NaN block only ok is held
    # (the note of csrc/gauss_jordan.cu). L1 at n <= 511 runs its cluster
    # branch, at 640 and 1000 its grid branch.
    phase("phase 4f: L1 gauss_jordan and L2 logical_panel vs their twins")

    def zero_sign_bits(x: torch.Tensor, y: torch.Tensor) -> tuple[int, int]:
        """(elements whose bits differ other than by a zero's sign, zeros
        that differ in their sign)."""
        ints = torch.int64 if x.element_size() == 8 else torch.int32
        differ = x.view(ints) != y.view(ints)
        zeros = (x == 0) & (y == 0)
        return int((differ & ~zeros).sum()), int((differ & zeros).sum())

    l1_abs = 0.0
    for dtype in (torch.float64, torch.float32):
        for n in (8, 100, 256, 511, 640, 1000):
            seen = []
            for bsz in (1, 64):
                geo = gauss_jordan.loop_plan(n, bsz, dtype, dev)[0]
                for pivot in (True, False):
                    a = rng.standard_normal((bsz, n, n))
                    if not pivot:
                        a += n * np.eye(n)
                    x = torch.from_numpy(a).to(dtype).to(dev)
                    inv_k, ok_k = gauss_jordan._gauss_jordan_aug(
                        x, pivot=pivot)
                    torch.cuda.synchronize()
                    inv_t, ok_t = gauss_jordan.gauss_jordan_twin(
                        x, pivot=pivot)
                    other, signed = zero_sign_bits(inv_k, inv_t)
                    l1_abs = max(l1_abs, rel_err(inv_k, inv_t)[0])
                    seen.append(f"B={bsz} {geo.branch} {geo.ctas} "
                                f"{'pivot' if pivot else 'no pivot'}: "
                                f"{signed} signed zeros")
                    check(other == 0 and torch.equal(ok_k, ok_t)
                          and bool(ok_k.all()),
                          f"L1 ({bsz}, {n}^2) {str(dtype)[6:]} "
                          f"{'pivot' if pivot else 'no pivot'}: the twin's "
                          f"bits up to the sign of a zero, ok equal")
                    del inv_k, inv_t, x
            log(f"  L1 {str(dtype)[6:]} n = {n}: " + "; ".join(seen))
    # Ties (integers in [-3, 3]), a singular block (a zero row: its pivot
    # is exactly 0) and a NaN block beside a regular one.
    for dtype in (torch.float64, torch.float32):
        for n in (256, 640):
            a = rng.integers(-3, 4, (4, n, n)).astype(np.float64)
            x = torch.from_numpy(a).to(dtype).to(dev)
            inv_k, ok_k = gauss_jordan._gauss_jordan_aug(x, pivot=True)
            inv_t, ok_t = gauss_jordan.gauss_jordan_twin(x, pivot=True)
            other, signed = zero_sign_bits(inv_k, inv_t)
            check(other == 0 and torch.equal(ok_k, ok_t),
                  f"L1 (4, {n}^2) {str(dtype)[6:]}, integers in [-3, 3]: "
                  f"the twin's bits up to the sign of {signed} zeros, ok "
                  f"equal ({ok_k.tolist()})")
            a = rng.standard_normal((3, n, n))
            a[1, 5] = 0.0
            a[2, n // 2, n // 3] = np.nan
            x = torch.from_numpy(a).to(dtype).to(dev)
            ok_k = gauss_jordan._gauss_jordan_aug(x, pivot=True)[1]
            ok_t = gauss_jordan.gauss_jordan_twin(x, pivot=True)[1]
            check(torch.equal(ok_k, ok_t) and ok_k.tolist() == [True, False,
                                                                 False],
                  f"L1 (3, {n}^2) {str(dtype)[6:]}: a regular, a singular "
                  f"and a NaN block, ok equal to the twin's {ok_t.tolist()}")
            del inv_k, inv_t, x
    l2_mismatch = 0
    for m, b, dtype in ((512, 64, torch.float64), (4096, 256, torch.float64),
                        (8192, 256, torch.float64),
                        (16384, 256, torch.float64),
                        (65600, 32, torch.float32)):
        geo = blocked.logical_geometry(m, b, dtype.itemsize,
                                       gauss_jordan.sm_count(0))
        strip = torch.from_numpy(rng.standard_normal((m, b))).to(dtype).to(
            dev)
        seen = []
        for mask in ("empty", "half"):
            for pivot in (True, False):
                used = torch.zeros(m, dtype=torch.int32, device=dev)
                kb = 0
                if mask == "half" and pivot:
                    used[torch.from_numpy(rng.permutation(m)[:m // 2]).to(
                        dev)] = 1
                elif mask == "half":      # a later panel's mask
                    used[:m // 2] = 1
                    kb = m // 2
                p_k, ok_k = blocked._panel_pivots_logical(strip, used, kb,
                                                          b=b, pivot=pivot)
                torch.cuda.synchronize()
                p_t, ok_t = blocked.logical_panel_twin(strip, used, kb, b=b,
                                                       pivot=pivot)
                l2_mismatch += int((p_k != p_t).sum())
                seen.append(f"{mask} {'pivot' if pivot else 'no pivot'} ok "
                            f"{bool(ok_k)}")
                check(torch.equal(p_k, p_t) and bool(ok_k) == bool(ok_t),
                      f"L2 ({m}, {b}) {str(dtype)[6:]}, {mask} mask, "
                      f"{'pivot' if pivot else 'no pivot'}: pivot rows and "
                      f"ok identical to the twin's")
        log(f"  L2 ({m}, {b}) {str(dtype)[6:]} on {geo.ctas} CTAs of "
            f"{geo.rows} rows ({'shared' if geo.rows_shared else 'device'}"
            f" memory, {geo.smem} bytes shared): " + "; ".join(seen))
    del strip, used

    # ---- phase 4g: L3, L4 and L5 against their twins --------------------
    # L3 (csrc/lu_panel.cu), L4 (csrc/gauss_jordan.cu's LU mode) and L5
    # (csrc/lu_solve.cu), the kernels of the LU module's device-side
    # loops, against their plain twins on the card on the same inputs.
    # Tolerance: none. The kernels take the twins' operations in the
    # twins' order (x - f * v rounded twice on every row, f = 0 on the
    # rows a step does not eliminate, IEEE division, the first maximum as
    # torch.argmax picks it), so every output is the twin's bit for bit,
    # NaN where the twin has NaN (a batch with a singular, a NaN and an
    # infinite member, an infinity in a panel's first pivot row), and
    # perm, the pivot rows, the mask and ok are identical. The shapes are
    # the routes': L4 on the (64, 128^2) batch of inverse(method="lu"),
    # (1, 200^2) fp64 and ragged n = 130 on clusters, and (1, 4096^2) fp32
    # (lu_inverse_refined at full width) on the grid; L5 on those factors
    # with k = 16 (solve(refine_iters=2)), the identity (k = 4096 and 128)
    # and k = 1; L3 at FP64 getrf 4096^2's and slogdet 1024^2's panels,
    # without pivoting, ragged (200, 64) and (130, 32), and (16384, 256)
    # (rows in a workspace). max_abs_err is the largest difference over the
    # elements finite in both.
    phase("phase 4g: L3 lu_panel, L4 lu_factor and L5 lu_solve vs their "
          "twins")

    def same_bits_nan(x: torch.Tensor, y: torch.Tensor) -> bool:
        """Bit for bit, NaN matching NaN whatever its payload."""
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        nan = torch.isnan(x)
        if not torch.equal(nan, torch.isnan(y)):
            return False
        ints = torch.int64 if x.element_size() == 8 else torch.int32
        return torch.equal(x.view(ints)[~nan], y.view(ints)[~nan])

    def finite_err(x: torch.Tensor, y: torch.Tensor) -> float:
        fin = torch.isfinite(x) & torch.isfinite(y)
        if not bool(fin.any()):
            return 0.0
        return float((x[fin].double() - y[fin].double()).abs().max())

    def lu_members(bsz: int, n: int, kind: str) -> np.ndarray:
        if kind == "integers":
            return rng.integers(-3, 4, (bsz, n, n)).astype(np.float64)
        a = rng.standard_normal((bsz, n, n))
        if kind == "dominant":
            a += n * np.eye(n)
        if kind == "special":    # regular, singular, NaN, infinite
            a[1, 3] = 0.0
            a[2, n // 2, n // 3] = np.nan
            a[3, n // 3, n // 2] = np.inf
        return a

    l4_abs = 0.0
    factors = {}
    for bsz, n, dtype, pivot, kind in (
            (64, 128, torch.float32, True, "normal"),
            (1, 200, torch.float64, True, "normal"),
            (1, 200, torch.float64, False, "dominant"),
            (1, 130, torch.float32, False, "dominant"),
            (4, 256, torch.float64, True, "integers"),
            (4, 200, torch.float64, True, "special"),
            (4, 130, torch.float32, True, "special"),
            (1, 4096, torch.float32, True, "normal")):
        x = torch.from_numpy(lu_members(bsz, n, kind)).to(dtype).to(dev)
        geo = gauss_jordan.loop_plan(n, bsz, dtype, dev, lu=True)[0]
        got = lu._lu_factor_batched(x, pivot=pivot)
        torch.cuda.synchronize()
        want = lu.lu_factor_twin(x, pivot=pivot)
        l4_abs = max(l4_abs, finite_err(got[0], want[0]))
        oks = got[2].tolist()
        check(same_bits_nan(got[0], want[0]) and torch.equal(got[1], want[1])
              and torch.equal(got[2], want[2])
              and oks == ([True, False, False, False] if kind == "special"
                          else oks if kind == "integers" else [True] * bsz),
              f"L4 ({bsz}, {n}^2) {str(dtype)[6:]} "
              f"{'pivot' if pivot else 'no pivot'} {kind} on {geo.branch} "
              f"of {geo.ctas} CTAs: the twin's bits, perm and ok ({oks})")
        factors[(bsz, n, kind)] = got[:2]
        del x, got, want
    l5_abs = 0.0
    for (bsz, n, kind), k in (((1, 4096, "normal"), 16),
                              ((1, 4096, "normal"), 4096),
                              ((64, 128, "normal"), 128),
                              ((1, 200, "normal"), 1),
                              ((4, 200, "special"), 5),
                              ((4, 130, "special"), 33)):
        fac, perm = factors[(bsz, n, kind)]
        if k == n:   # the identity: lu_inverse's right-hand side
            rhs_k = torch.eye(n, dtype=fac.dtype, device=dev).expand(
                bsz, n, n).contiguous()
        else:
            rhs_k = torch.from_numpy(rng.standard_normal((bsz, n, k))).to(
                fac.dtype).to(dev)
        got = lu._lu_solve_batched(fac, perm, rhs_k)
        torch.cuda.synchronize()
        want = lu.lu_solve_twin(fac, perm, rhs_k)
        l5_abs = max(l5_abs, finite_err(got[0], want[0]))
        oks = got[1].tolist()
        # The infinite member's factor may hold its infinity as a pivot
        # with zero multipliers below it: x is then finite and ok true, in
        # the twin as in the kernel.
        check(same_bits_nan(got[0], want[0]) and torch.equal(got[1], want[1])
              and oks[:3] == ([True, False, False] if kind == "special"
                              else [True] * min(bsz, 3)),
              f"L5 ({bsz}, {n}^2, k = {k}) {str(fac.dtype)[6:]} {kind}: the "
              f"twin's bits and ok ({oks})")
        del got, want, rhs_k
    del factors
    l3_abs = 0.0
    for m, b, dtype, pivot, mask in (
            (4096, 128, torch.float64, True, "empty"),
            (4096, 128, torch.float64, True, "prior"),
            (1024, 128, torch.float64, True, "empty"),
            (1024, 128, torch.float64, False, "later"),
            (200, 64, torch.float64, True, "prior"),
            (130, 32, torch.float32, True, "empty"),
            (1024, 128, torch.float64, True, "inf"),
            (16384, 256, torch.float64, True, "prior")):
        a = rng.standard_normal((m, b))
        used = torch.zeros(m, dtype=torch.int32, device=dev)
        kb = 0
        if mask == "prior":
            used[torch.from_numpy(rng.permutation(m)[:m // 3]).to(dev)] = 1
        elif mask == "later":   # a later no-pivot panel, its rows dominant
            kb = m // 2
            used[:kb] = 1
            a += 4 * b * (np.arange(m)[:, None] == np.arange(b) + kb)
        elif mask == "inf":     # an infinity in the first pivot row
            a[int(np.abs(a[:, 0]).argmax()), 5] = np.inf
        strip = torch.from_numpy(a).to(dtype).to(dev)
        geo = blocked.logical_geometry(m, b, dtype.itemsize,
                                       gauss_jordan.sm_count(0))
        got = lu._lu_panel(strip, used, kb, b=b, pivot=pivot)
        torch.cuda.synchronize()
        want = lu.lu_panel_twin(strip, used, kb, b=b, pivot=pivot)
        l3_abs = max(l3_abs, finite_err(got[0], want[0]))
        check(same_bits_nan(got[0], want[0]) and torch.equal(got[1], want[1])
              and torch.equal(got[2], want[2])
              and bool(got[3]) == bool(want[3]),
              f"L3 ({m}, {b}) {str(dtype)[6:]} "
              f"{'pivot' if pivot else 'no pivot'}, {mask} mask, on "
              f"{geo.ctas} CTAs ({'shared' if geo.rows_shared else 'device'}"
              f" memory): the twin's bits, pivot rows, mask and ok "
              f"({bool(got[3])})")
        del strip, used, got, want

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
    # Each FP64 path runs on the kernels alone: the f32-search tier (n up
    # to 4096 at b = 256) K3 and L1 once a panel, the logical tier (FP64
    # past it, and every no-pivot FP64 call from 512) L2 and L1 once a
    # panel, spec (a batch of FP64 256^2) one L1 launch; the plain loops
    # run no time (read_counts).
    phase("phase 5b: FP64 (K3 f32-search and L2 logical tiers, L1 block "
          "inverses) and no-pivot FP64")
    a4k64 = hollow_random_matrix(4096, seed=1, dtype=np.float64)
    zero_counts()
    t0 = time.perf_counter()
    out64 = matrix_inversion_fp64(a4k64.reshape(-1), 4096, device="cuda")
    fp64_s = time.perf_counter() - t0
    counts_fp64 = read_counts("matrix_inversion_fp64 4096^2", ("K3", "L1"))
    check(counts_fp64["K3"] == 16 and counts_fp64["L1"] == 16
          and counts_fp64["L2"] == 0, "FP64 4096^2: 16 K3 and 16 L1 "
          "launches, no L2")
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
    counts_np = read_counts("matrix_inversion_no_pivots 1024^2 (logical "
                            "tier)", ("L1", "L2"))
    check(counts_np["L2"] == 4 and counts_np["L1"] == 4,
          "no-pivot FP64 1024^2: 4 L2 and 4 L1 launches")
    r_np = relative_residual(dom, out_np.reshape(n_np, n_np))
    log(f"  n=1024 no-pivot FP64, diagonally dominant: residual {r_np:.3e}")
    check(out_np.size == n_np * n_np and r_np <= 1e-12,
          "1024 no-pivot FP64 residual <= 1e-12")
    # FP64 8192^2 (b * m past 128 * 8192: the logical tier), no-pivot FP64
    # 4096^2 (diagonally dominant) and spec on a (64, 256^2) FP64 batch;
    # residuals in float64 on the card.
    fp64_paths = {}
    a8k64 = hollow_random_matrix(8192, seed=3, dtype=np.float64)
    dom4k = hollow_random_matrix(4096, seed=6, dtype=np.float64)
    dom4k += 2.0 * np.abs(dom4k).sum(axis=1).max() * np.eye(4096)
    batch64 = np.stack([hollow_random_matrix(256, seed=s, dtype=np.float64)
                        for s in range(64)])
    for name, fn, a_np, want in (
            ("matrix_inversion_fp64 8192^2",
             lambda: matrix_inversion_fp64(a8k64.reshape(-1), 8192,
                                           device="cuda"),
             a8k64, {"L1": 32, "L2": 32, "K3": 0}),
            ("matrix_inversion_no_pivots 4096^2",
             lambda: matrix_inversion_no_pivots(dom4k.reshape(-1), 4096,
                                                device="cuda"),
             dom4k, {"L1": 16, "L2": 16, "K3": 0}),
            ("inverse on a (64, 256^2) FP64 batch (spec)",
             lambda: inverse(torch.from_numpy(batch64).to(dev))[0],
             batch64, {"L1": 1, "L2": 0, "K3": 0})):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts(name, ("L1",))
        fp64_paths[name] = counts
        check({k: counts[k] for k in want} == want,
              f"{name}: launches {want}")
        x_dev = (out if isinstance(out, torch.Tensor)
                 else torch.from_numpy(out).to(dev)).reshape(a_np.shape)
        res = float(batched_residual(torch.from_numpy(a_np).to(dev),
                                     x_dev).max())
        log(f"  {name}: residual {res:.3e} ({secs:.2f} s host clock, the "
            f"first call)")
        check(res <= 1e-12, f"{name}: residual <= 1e-12")
        del out, x_dev
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
    phase("phase 5e: LU route (inverse method=lu, solve, slogdet; FP64 on "
          "L3, refinement and the spec on L4 and L5)")
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
    # The LU routes on L3, L4 and L5 (twelfth slice). FP64 at n >= 256 runs
    # the blocked getrf's panel loop on L3 (32 panels at 4096^2, 8 at
    # 1024^2); solve(refine_iters=2) each correction on L5; the spec (any
    # LU call under 256, lu_inverse_refined at any n) L4 and L5. Gates:
    # FP64 getri residual and solve backward error <= 1e-12 (as phase 5b's
    # FP64 gate); slogdet FP64 against numpy within 1e-10 relative; the
    # refined solve's backward error <= 1e-5 (its residual is FP32's);
    # lu_inverse_refined on ill_conditioned_matrix(4096, cond=1e4,
    # seed=55) with 4 float64 Newton-Schulz steps: refined residual
    # < 1e-10 and < raw / 10 (the JAX package's gates,
    # tests/test_lu.py:69-80); the (64, 128^2) batch's inverses <= 1e-5
    # and its slogdet against numpy within 1e-4.
    x4k64_dev = torch.from_numpy(a4k64).to(dev)
    zero_counts()
    inv64, ok64 = inverse(x4k64_dev, method="lu")
    counts_lu64 = read_counts("inverse(method='lu') FP64 4096^2", ("L3",))
    r_lu64 = float(batched_residual(x4k64_dev, inv64))
    log(f"  n=4096 FP64 LU getri: residual {r_lu64:.3e}")
    check(counts_lu64["L3"] == 32 and counts_lu64["K3"] == 0
          and counts_lu64["K5"] == 0, "FP64 LU getri 4096^2: 32 L3 launches, "
          "no K3 or K5")
    check(bool(ok64) and r_lu64 <= 1e-12, "FP64 LU getri 4096^2 residual "
          "<= 1e-12")
    del inv64
    rhs64 = rhs.double()
    zero_counts()
    x64, okx64 = solve(x4k64_dev, rhs64, method="lu")
    counts_solve64 = read_counts("solve FP64 4096^2 x 16", ("L3",))
    berr64 = float(torch.linalg.norm(x4k64_dev @ x64 - rhs64)
                   / (torch.linalg.norm(x4k64_dev) * torch.linalg.norm(x64)))
    log(f"  solve FP64 4096^2 x 16: ||Ax-b|| / (||A|| ||x||) = {berr64:.3e}")
    check(counts_solve64["L3"] == 32 and bool(okx64) and berr64 <= 1e-12,
          "solve FP64 4096^2 x 16: 32 L3 launches, backward error <= 1e-12")
    a1k64 = hollow_random_matrix(1024, seed=7, dtype=np.float64) / 50
    a1k64_dev = torch.from_numpy(a1k64).to(dev)
    zero_counts()
    sign64, logabs64, ok_d64 = slogdet(a1k64_dev)
    counts_det64 = read_counts("slogdet FP64 1024^2", ("L3",))
    want_sign64, want_log64 = np.linalg.slogdet(a1k64)
    log(f"  slogdet FP64 1024^2: sign {float(sign64)} logabsdet "
        f"{float(logabs64):.12f}; numpy {want_sign64} {want_log64:.12f}")
    check(counts_det64["L3"] == 8 and bool(ok_d64)
          and float(sign64) == want_sign64
          and abs(float(logabs64) - want_log64) <= 1e-10 * abs(want_log64),
          "slogdet FP64 1024^2: 8 L3 launches, matches numpy (sign equal, "
          "log within 1e-10)")
    zero_counts()
    x_ref, ok_ref = solve(x4k, rhs, method="lu", refine_iters=2)
    counts_ref = read_counts("solve(x4k, rhs, refine_iters=2)",
                             ("K3", "K5", "L5"))
    berr_ref = float(torch.linalg.norm(a64 @ x_ref.double() - b64)
                     / (torch.linalg.norm(a64)
                        * torch.linalg.norm(x_ref.double())))
    log(f"  solve 4096^2 x 16, refine_iters=2: ||Ax-b|| / (||A|| ||x||) = "
        f"{berr_ref:.3e} (unrefined {berr:.3e})")
    check(counts_ref["L5"] == 2 and counts_ref["K3"] == 32
          and bool(ok_ref) and berr_ref <= 1e-5,
          "solve refine_iters=2: 32 K3, 2 L5 launches, backward error "
          "<= 1e-5")
    t0 = time.perf_counter()
    a_ill = ill_conditioned_matrix(4096, cond=1e4, seed=55,
                                   dtype=np.float64)
    log(f"  ill_conditioned_matrix(4096, cond=1e4, seed=55) made on the host "
        f"in {time.perf_counter() - t0:.1f} s")
    x_ill = torch.from_numpy(a_ill).to(dev)
    zero_counts()
    x_lir, ok_lir = lu_inverse_refined(x_ill, iters=4,
                                       residual_dtype=torch.float64)
    counts_lir = read_counts("lu_inverse_refined 4096^2", ("L4", "L5"))
    r_lir = float(batched_residual(x_ill, x_lir))
    x_raw, ok_raw_lir = lu.lu_inverse(x_ill.float())
    r_raw_lir = float(batched_residual(x_ill, x_raw))
    log(f"  lu_inverse_refined 4096^2 (cond 1e4): raw residual "
        f"{r_raw_lir:.3e}, refined {r_lir:.3e}")
    check(counts_lir["L4"] == 1 and counts_lir["L5"] == 1 and bool(ok_lir)
          and bool(ok_raw_lir) and r_lir < 1e-10 and r_lir < r_raw_lir / 10,
          "lu_inverse_refined 4096^2: one L4 and one L5 launch, refined "
          "residual < 1e-10 and < raw / 10")
    del x_lir, x_raw
    b128 = np.stack([hollow_random_matrix(128, seed=s) for s in range(64)])
    b128_dev = torch.from_numpy(b128).to(dev)
    zero_counts()
    inv128, ok128 = inverse(b128_dev, method="lu")
    counts_b128 = read_counts("inverse(method='lu') (64, 128^2)",
                              ("L4", "L5"))
    res128 = float(batched_residual(b128_dev, inv128).max())
    log(f"  inverse(method='lu') (64, 128^2): max residual {res128:.3e}")
    check(counts_b128["L4"] == 1 and counts_b128["L5"] == 1
          and bool(ok128.all()) and res128 <= 1e-5,
          "inverse(method='lu') (64, 128^2): one L4 and one L5 launch, "
          "residual <= 1e-5")
    zero_counts()
    sign128, logabs128, ok_d128 = slogdet(b128_dev)
    counts_det128 = read_counts("slogdet (64, 128^2)", ("L4",))
    want_s128, want_l128 = np.linalg.slogdet(b128.astype(np.float64))
    err128 = float(np.abs(logabs128.cpu().numpy() - want_l128).max()
                   / np.abs(want_l128).max())
    check(counts_det128["L4"] == 1 and bool(ok_d128.all())
          and np.array_equal(sign128.cpu().numpy(), want_s128)
          and err128 <= 1e-4,
          f"slogdet (64, 128^2): one L4 launch, matches numpy (signs equal, "
          f"logs within {err128:.2e} <= 1e-4)")

    # ---- phase 5f: the lockstep route ------------------------------------
    # inverse on FP32 hollow batches at the JAX package's recorded lockstep
    # shapes, opted in (MATINV_LOCKSTEP=1) and not: the two must agree bit
    # for bit, raw (refine=0) and refined (the default); the lockstep call
    # launches K6 (k = 8 at n = 1024: 2 chunks x 8 panels; k = 4 at
    # n = 2048: 2 x 16) and never K2: the wrappers count the first call's
    # eager warm-up (utils/graphs.py), the replayed graph holds the panel
    # kernel as often (graphs.kernel_nodes; per matrix, K2 would launch it
    # bsz times as often) and the profiler's records of a replay no more
    # often, bit for bit. Gates: refined <= 1e-6, raw <= 1e-4,
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
            replayed = []
            try:
                rows = device_kernels(
                    lambda: replayed.append(inverse(xs)[0]))
            except profiling.NoDeviceTime as exc:
                fail(f"lockstep replay: {exc}")
            held = kernel_launches([(k, c, 0.0) for k, c in
                                    graphs.kernel_nodes(1).items()])
            on_raw, ok_on_raw = blocked.blocked_inverse(xs, refine=0)
        name = f"({bsz}, {n}, {n})"
        check(counts_ls[n]["K6"] == want and counts_ls[n]["K2"] == 0,
              f"lockstep {name}: K6 launched {want} times, K2 never")
        check(held == {"K2/K6": want}
              and all(bits_equal(r, on) for r in replayed),
              f"lockstep {name}: the replayed graph holds the panel kernel "
              f"{want} times and no other of the port's, bit for bit the "
              f"first call")
        hold_records(f"lockstep {name} replayed", kernel_launches(rows),
                     held)
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

    # ---- phase 5j: the sharded route --------------------------------------
    # A world of one rank over NCCL (a FileStore in a temporary directory)
    # and a 1-D cuda mesh; either failing fails the run (no gloo, no
    # single-card fallback). At world size 1 every operation of the sharded
    # body is the blocked route's own, so each call is held bit for bit to
    # blocked_inverse at the same group size (the sharded default is
    # gw ~ 1536, the blocked one gw ~ 1024). Gates: refined residual
    # <= 1e-6, as at 4096^2 and 20000^2; collectives one per group plus the
    # slot gather and the ok reduction. Then auto at its own gate (32768^2
    # with a mesh -> sharded), the dp-only batch (K1) and the batched panel
    # body (K2).
    phase("phase 5j: sharded route (NCCL world of one, 1-D cuda mesh)")
    nccl_world = contextlib.ExitStack()
    nccl_world.enter_context(launch.world("nccl"))
    mesh = make_device_mesh(1, ("x",))
    mesh11 = make_device_mesh((1, 1), ("dp", "tp"))
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda"
          and mesh11.device_type == "cuda",
          "NCCL world of one rank, 1-D and (1, 1) cuda meshes")

    def sharded_path(name, fn, expect, collectives=None):
        """Run one call with the launch and collective counts zeroed."""
        zero_counts()
        sharded.collective.calls = 0
        out = fn()
        counts = read_counts(name, expect)
        log(f"  collectives on {name}: {sharded.collective.calls}")
        if collectives is not None:
            check(sharded.collective.calls == collectives,
                  f"{name}: {collectives} collectives (a strip a group, "
                  f"the slot gather, the ok reduction)")
        return out, counts

    (sh4k, ok_sh4k), counts_sh4k = sharded_path(
        "sharded 4096^2 (b = 128, group 12)",
        lambda: sharded_blocked_inverse(x4k, mesh=mesh), ("K2",), 3 + 2)
    bl4k, ok_bl4k = blocked.blocked_inverse(x4k, block_size=128,
                                            group_size=12)
    r_sh4k = relative_residual(a4k, sh4k.cpu().numpy())
    log(f"  sharded 4096^2: refined residual {r_sh4k:.3e}")
    check(bool(ok_sh4k) and bool(ok_bl4k) and bits_equal(sh4k, bl4k),
          "sharded 4096^2 bit-identical to blocked_inverse(group_size=12)")
    check(r_sh4k <= 1e-6, "sharded 4096^2 refined residual <= 1e-6")
    del sh4k, bl4k
    (sh20, ok_sh20), counts_sh20 = sharded_path(
        "sharded 20000^2 (b = 64, group 24)",
        lambda: sharded_blocked_inverse(x20, mesh=mesh), ("K3", "K4"),
        14 + 2)
    bl20, ok_bl20 = blocked.blocked_inverse(x20, group_size=24)
    r_sh20 = float(batched_residual(x20, sh20))
    log(f"  sharded 20000^2: refined residual {r_sh20:.3e}")
    check(bool(ok_sh20) and bool(ok_bl20) and bits_equal(sh20, bl20),
          "sharded 20000^2 bit-identical to blocked_inverse(group_size=24)")
    check(r_sh20 <= 1e-6, "sharded 20000^2 refined residual <= 1e-6")
    del sh20, bl20
    torch.cuda.empty_cache()

    # auto at its own gate: a single 32768^2 matrix with a mesh -> sharded
    # (b = 64, group 24: 21 groups and a tail of 8, 512 panels). Residual
    # in float64 on the card, a column chunk at a time.
    n32 = 32768
    x32 = torch.from_numpy(hollow_random_matrix(n32, seed=n32)).to(dev)
    check(solver._resolve("auto", x32, mesh) == "sharded",
          "auto routes 32768^2 with a mesh to sharded")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    live32 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    (inv32, ok32), counts_32 = sharded_path(
        "inverse(x, mesh=mesh) 32768^2", lambda: inverse(x32, mesh=mesh),
        ("K3", "K4"), 22 + 2)
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    peak32 = torch.cuda.max_memory_allocated(dev)
    a64 = x32.double()
    sq = 0.0
    for j in range(0, n32, 4096):
        blk = a64 @ inv32[:, j:j + 4096].double()
        blk[j:j + 4096].diagonal().sub_(1.0)
        sq += float((blk * blk).sum())
    del a64, blk
    r32 = sq ** 0.5 / (
        float(torch.linalg.vector_norm(x32, dtype=torch.float64))
        * float(torch.linalg.vector_norm(inv32, dtype=torch.float64)))
    log(f"  32768^2 through auto: refined residual {r32:.3e}, "
        f"{t32:.2f} s host clock (first call); peak device memory "
        f"{peak32 / 1e9:.3f} GB (torch.cuda.max_memory_allocated), "
        f"{(peak32 - live32) / 1e9:.3f} GB above the {live32 / 1e9:.3f} GB "
        f"live before the call   [{card}]")
    check(counts_32["K3"] == 512 and counts_32["K4"] == 512,
          "32768^2: 512 K3 and 512 K4 launches")
    check(bool(ok32) and r32 <= 1e-6, "32768^2 refined residual <= 1e-6")
    del inv32
    torch.cuda.empty_cache()

    # dp-only (1, 1) mesh, n <= 640: K1 on the local batch.
    (shb, ok_shb), counts_shb = sharded_path(
        "sharded_batched_inverse (4096, 128^2) on (1, 1)",
        lambda: sharded_batched_inverse(xb, mesh=mesh11), ("K1",))
    fb, ok_fb = fused.fused_inverse(xb)
    check(bits_equal(shb, fb) and torch.equal(ok_shb, ok_fb)
          and bool(ok_shb.all()),
          "dp-only (4096, 128^2) bit-identical to fused_inverse, all ok")
    del shb, fb
    # The batched panel body: (4, 1024^2) on (1, 1), group 8.
    x4b = lockstep_in[(16, 1024)][:4]
    (shp, ok_shp), _ = sharded_path(
        "sharded_batched_inverse (4, 1024^2) on (1, 1)",
        lambda: sharded_batched_inverse(x4b, mesh=mesh11), ("K2",))
    blp, ok_blp = blocked.blocked_inverse(x4b, block_size=128, group_size=8,
                                          refine=0)
    check(bits_equal(shp, blp) and bool(ok_shp.all()) and bool(ok_blp.all()),
          "(4, 1024^2) panel body bit-identical to blocked_inverse("
          "group_size=8, refine=0)")
    del shp, blp

    # ---- phase 6: determinism --------------------------------------------
    # check_deterministic (utils/determinism.py) with perturb=True: before
    # every run after the first, every free block of the caching allocator
    # and every SM's shared memory are filled with 0xFF (NaN). A read of
    # scratch, output or shared memory before it is written then drifts.
    # The control, an uninitialised torch.empty, must drift (the first run
    # reads a cached block zeroed here). Each kernel at its main path's
    # shape, then each route; 3 runs, 2 for the split and FP64 routes.
    phase("phase 6: check_deterministic over K1-K7, L1-L5 and every route")
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
    x8k64_dev = torch.from_numpy(a8k64).to(dev)
    dom4k_dev = torch.from_numpy(dom4k).to(dev)
    b64_dev = torch.from_numpy(batch64).to(dev)
    x1k64 = torch.from_numpy(rng.standard_normal((1, 1000, 1000))).to(dev)
    s8k = torch.from_numpy(rng.standard_normal((8192, 256))).to(dev)
    u8k = torch.zeros(8192, dtype=torch.int32, device=dev)
    s3l = torch.from_numpy(rng.standard_normal((4096, 128))).to(dev)
    u3l = torch.zeros(4096, dtype=torch.int32, device=dev)
    x4k_1 = x4k[None]
    f4k, p4k, _ = lu._lu_factor_batched(x4k_1, pivot=True)
    rhs_1 = rhs[None]
    eye4k = torch.eye(4096, device=dev)[None]

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
        ("L1 (64, 256^2) fp64",
         lambda: gauss_jordan._gauss_jordan_aug(b64_dev, pivot=True), 3),
        ("L1 (1, 1000^2) fp64 (grid branch)",
         lambda: gauss_jordan._gauss_jordan_aug(x1k64, pivot=True), 3),
        ("L2 (8192, 256) fp64",
         lambda: blocked._panel_pivots_logical(s8k, u8k, 0, b=256,
                                               pivot=True), 3),
        ("L3 (4096, 128) fp64",
         lambda: lu._lu_panel(s3l, u3l, 0, b=128, pivot=True), 3),
        ("L4 (64, 128^2) fp32",
         lambda: lu._lu_factor_batched(b128_dev, pivot=True), 3),
        ("L4 (1, 4096^2) fp32 (grid branch)",
         lambda: lu._lu_factor_batched(x4k_1, pivot=True), 2),
        ("L5 (1, 4096^2) k = 16",
         lambda: lu._lu_solve_batched(f4k, p4k, rhs_1), 3),
        ("L5 (1, 4096^2) k = 4096",
         lambda: lu._lu_solve_batched(f4k, p4k, eye4k), 3),
        ("FP64 LU getri 4096^2", lambda: inverse(x4k64_dev, method="lu"), 2),
        ("LU solve 4096^2 x 16, refine_iters=2",
         lambda: solve(x4k, rhs, method="lu", refine_iters=2), 3),
        ("lu_inverse_refined 4096^2",
         lambda: lu_inverse_refined(x_ill, iters=4,
                                    residual_dtype=torch.float64), 2),
        ("LU spec inverse (64, 128^2)",
         lambda: inverse(b128_dev, method="lu"), 3),
        ("FP64 8192^2", lambda: inverse(x8k64_dev), 2),
        ("no-pivot FP64 4096^2", lambda: inverse(dom4k_dev, pivot=False), 2),
        ("spec FP64 (64, 256^2)", lambda: inverse(b64_dev), 3),
        ("bf16 search 4096^2", lambda: inverse(x4k, search_bf16=True), 3),
        ("LU getri 4096^2", lambda: inverse(x4k, method="lu"), 3),
        ("LU solve 4096^2 x 16", lambda: solve(x4k, rhs), 3),
        ("lockstep (16, 1024^2)", lockstep_inverse, 3),
        ("ns 4096^2", lambda: inverse(xwc, method="ns"), 3),
        ("Cholesky potri 4096^2", lambda: cholesky_inverse(spd4k), 3),
        ("sharded 4096^2 (NCCL, 1-D mesh)",
         lambda: sharded_blocked_inverse(x4k, mesh=mesh), 3),
        ("sharded dp-only (4096, 128^2) (NCCL, (1, 1) mesh)",
         lambda: sharded_batched_inverse(xb, mesh=mesh11), 3),
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
    # torch.linalg.cholesky as a yardstick (the route never calls it). The
    # schedules run eagerly: the switch is part of a graph's key, and these
    # are the eager numbers the compiled phase compares with. A call whose
    # device time the profiler loses fails the run.
    def profile_call(fn):
        """(device ms, top kernels) of one call after a warm-up."""
        fn()
        torch.cuda.synchronize()
        try:
            rows = device_kernels(fn)
        except profiling.NoDeviceTime as exc:
            fail(f"potri timing: {exc}")
        return sum(ms for _, _, ms in rows), rows[:5]

    def show(val) -> str:
        return "not measured" if val is None else f"{val:.4f}"

    schedule = cholesky._POTRI_PRODUCT_2D
    for n, xs in ((4096, spd4k), (8192, spd8k)):
        for name in ("cols", "2d"):
            cholesky._POTRI_PRODUCT_2D = name == "2d"
            with graphs.disabled():
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

    # The ninth slice's timings, each line with the card's name and power
    # limit: the sharded calls at world size 1 (NCCL) beside the blocked
    # route at the same group size, by CUDA events (after a warm-up) and by
    # the profiler's device time in one session, with the idle share and
    # the NCCL kernels' share of the device time.
    # A call whose device time the profiler loses fails the run: these
    # are the numbers the slice reports.
    def time_call(name, fn, iters):
        ev = events_ms(fn, iters=iters)
        try:
            rows = device_kernels(lambda: [fn() for _ in range(iters)])
        except profiling.NoDeviceTime as exc:
            fail(f"{name}: {exc}")
        dv = sum(ms for _, _, ms in rows) / iters
        nccl = sum(ms for key, _, ms in rows
                   if "nccl" in key.lower()) / iters
        log(f"  {name}: {ev:.4f} ms events, {dv:.4f} ms device, idle "
            f"share {1 - dv / ev:.4f}, NCCL kernels {nccl:.4f} ms "
            f"({nccl / dv:.4f} of device time)   [{card}]")
        for key, count, ms in rows[:6]:
            log(f"    {ms / iters:10.4f} ms  {count // iters:5d}x  {key[:90]}")
        times[f"{name.split()[0]}_ms"] = ev
        times[f"{name.split()[0]}_device_ms"] = dv
        times[f"{name.split()[0]}_nccl_device_ms"] = nccl

    time_call("sharded_4096 (NCCL world of one, group 12)",
              lambda: sharded_blocked_inverse(x4k, mesh=mesh), 5)
    time_call("blocked_4096_group12",
              lambda: blocked.blocked_inverse(x4k, block_size=128,
                                              group_size=12), 5)
    time_call("sharded_32768 (inverse with a mesh, group 24)",
              lambda: inverse(x32, mesh=mesh), 1)
    time_call("blocked_32768_group24",
              lambda: blocked.blocked_inverse(x32, group_size=24), 1)
    del x32
    # L1 at the FP64 tier's pivot block (1, 256^2) and the (64, 256^2)
    # batch, and its grid branch at (1, 1000^2); L2 at the FP64 8192^2
    # panel (8192, 256) and the no-pivot 4096^2 one (4096, 256), by CUDA
    # events and the profiler's device time, beside the twins and
    # (L1) torch.linalg.inv on the same blocks, which the port never calls.
    b1_dev = b64_dev[:1].contiguous()
    l1_cases = {"1x256": b1_dev, "64x256": b64_dev, "1x1000": x1k64}
    for key, xs in l1_cases.items():
        iters = 20 if key == "1x256" else 3
        times[f"l1_{key}_ms"] = events_ms(
            lambda: gauss_jordan._gauss_jordan_aug(xs, pivot=True),
            iters=iters)
        times[f"l1_{key}_device_ms"] = device_ms(
            lambda: gauss_jordan._gauss_jordan_aug(xs, pivot=True), iters,
            "gauss_jordan")
        times[f"l1_twin_{key}_ms"] = events_ms(
            lambda: gauss_jordan.gauss_jordan_twin(xs, pivot=True), iters=1)
        times[f"l1_library_inv_{key}_ms"] = events_ms(
            lambda: torch.linalg.inv(xs), iters=iters)
        times[f"l1_library_inv_{key}_device_ms"] = device_ms(
            lambda: torch.linalg.inv(xs), iters)
    s4k = s8k[:4096].contiguous()
    u4k = torch.zeros(4096, dtype=torch.int32, device=dev)
    u4k[:2048] = 1                   # the no-pivot tier's 9th panel
    for key, (st, us, kb, pivot) in {
            "8192": (s8k, u8k, 0, True),
            "4096_no_pivot": (s4k, u4k, 2048, False)}.items():
        times[f"l2_{key}_ms"] = events_ms(
            lambda: blocked._panel_pivots_logical(st, us, kb, b=256,
                                                  pivot=pivot), iters=10)
        times[f"l2_{key}_device_ms"] = device_ms(
            lambda: blocked._panel_pivots_logical(st, us, kb, b=256,
                                                  pivot=pivot), 10,
            "logical_panel")
        times[f"l2_twin_{key}_ms"] = events_ms(
            lambda: blocked.logical_panel_twin(st, us, kb, b=256,
                                               pivot=pivot), iters=2)
    # L2's (8192, 256) record has no row used before it (kb = 0), so
    # getrf of the strip, which the port never calls, computes its pivot
    # rows (as LAPACK's row swaps) with the factor besides.
    times["l2_library_lu_factor_8192_ms"] = events_ms(
        lambda: torch.linalg.lu_factor(s8k), iters=10)
    times["l2_library_lu_factor_8192_device_ms"] = device_ms(
        lambda: torch.linalg.lu_factor(s8k), 10)
    # L3 at FP64 getrf 4096^2's first panel (4096, 128); L4 at the
    # (64, 128^2) batch of inverse(method="lu"), one fp64 200^2 matrix and
    # its grid branch at (1, 4096^2) fp32 (lu_inverse_refined's); L5 at
    # (1, 4096^2) with k = 16 (each correction of solve(refine_iters=2))
    # and k = 4096 (lu_inverse_refined's identity) and at (64, 128^2)
    # with k = 128; by CUDA events and the profiler's device time, beside
    # the twins and beside torch.linalg.lu_factor (L3, L4) and
    # torch.linalg.lu_solve on torch's own factor (L5) of the same
    # matrices, which the port never calls. L3's panel has no row used
    # before it (kb = 0), so getrf of the strip computes its function: the
    # same first-max pivots, multipliers and U rows, stored in swapped row
    # order.
    times["l3_4096_ms"] = events_ms(
        lambda: lu._lu_panel(s3l, u3l, 0, b=128, pivot=True), iters=10)
    times["l3_4096_device_ms"] = device_ms(
        lambda: lu._lu_panel(s3l, u3l, 0, b=128, pivot=True), 10,
        "lu_panel")
    times["l3_twin_4096_ms"] = events_ms(
        lambda: lu.lu_panel_twin(s3l, u3l, 0, b=128, pivot=True), iters=1)
    times["l3_library_lu_factor_4096_ms"] = events_ms(
        lambda: torch.linalg.lu_factor(s3l), iters=10)
    times["l3_library_lu_factor_4096_device_ms"] = device_ms(
        lambda: torch.linalg.lu_factor(s3l), 10)
    x200 = torch.from_numpy(rng.standard_normal((1, 200, 200))).to(dev)
    eye128 = torch.eye(128, device=dev).expand(64, 128, 128).contiguous()
    f128, p128, _ = lu._lu_factor_batched(b128_dev, pivot=True)
    for key, xs, iters in (("64x128", b128_dev, 10), ("1x200", x200, 10),
                           ("1x4096", x4k_1, 2)):
        times[f"l4_{key}_ms"] = events_ms(
            lambda: lu._lu_factor_batched(xs, pivot=True), iters=iters)
        times[f"l4_{key}_device_ms"] = device_ms(
            lambda: lu._lu_factor_batched(xs, pivot=True), iters,
            "lu_factor")
        times[f"l4_twin_{key}_ms"] = events_ms(
            lambda: lu.lu_factor_twin(xs, pivot=True), iters=1)
        times[f"l4_library_lu_factor_{key}_ms"] = events_ms(
            lambda: torch.linalg.lu_factor(xs), iters=iters)
        times[f"l4_library_lu_factor_{key}_device_ms"] = device_ms(
            lambda: torch.linalg.lu_factor(xs), iters)
    for key, (xs, fac, perm, rhs_k), iters in (
            ("4096_k16", (x4k_1, f4k, p4k, rhs_1), 10),
            ("4096_k4096", (x4k_1, f4k, p4k, eye4k), 3),
            ("64x128_k128", (b128_dev, f128, p128, eye128), 10)):
        times[f"l5_{key}_ms"] = events_ms(
            lambda: lu._lu_solve_batched(fac, perm, rhs_k), iters=iters)
        times[f"l5_{key}_device_ms"] = device_ms(
            lambda: lu._lu_solve_batched(fac, perm, rhs_k), iters,
            "lu_solve")
        times[f"l5_twin_{key}_ms"] = events_ms(
            lambda: lu.lu_solve_twin(fac, perm, rhs_k), iters=1)
        lib_lu, lib_piv = torch.linalg.lu_factor(xs)
        times[f"l5_library_lu_solve_{key}_ms"] = events_ms(
            lambda: torch.linalg.lu_solve(lib_lu, lib_piv, rhs_k),
            iters=iters)
        times[f"l5_library_lu_solve_{key}_device_ms"] = device_ms(
            lambda: torch.linalg.lu_solve(lib_lu, lib_piv, rhs_k), iters)
        del lib_lu, lib_piv
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
        "l1_us_per_step_1x256": times["l1_1x256_ms"] * 1e3 / 256,
        "l2_us_per_step_8192": times["l2_8192_ms"] * 1e3 / 256,
        "l3_us_per_step_4096": times["l3_4096_ms"] * 1e3 / 128,
        "l4_us_per_step_64x128": times["l4_64x128_ms"] * 1e3 / 128,
        "l4_us_per_step_1x200": times["l4_1x200_ms"] * 1e3 / 200,
        "l4_us_per_step_1x4096": times["l4_1x4096_ms"] * 1e3 / 4096,
        "l5_us_per_step_4096_k16": times["l5_4096_k16_ms"] * 1e3 / 8192,
        "l5_us_per_step_4096_k4096": times["l5_4096_k4096_ms"] * 1e3 / 8192,
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
    # L1: 2 n^3 a matrix at the FP64 peak, or its input and output once.
    # L2: what this run's data needs, each step's update of the rows that
    # can still be chosen across the columns right of the step (2
    # operations an element; with an empty mask m - r - 1 rows after step
    # r), or the strip and mask read once.
    def l1_bound(bsz, n):
        return bound(bsz * 2 * n ** 3, bsz * (2 * n * n * 8 + 4),
                     torch.float64)

    def l2_bound(m, b, unused):
        ops = sum(2 * (unused - r - 1) * (b - r - 1) for r in range(b))
        return bound(ops, m * b * 8 + m * 4 + b * 4 + 4, torch.float64)

    bounds["L1"] = l1_bound(1, 256)
    bounds["L2"] = l2_bound(8192, 256, 8192)
    # L3: a panel LU of the strip (panel_lu_flops, an empty mask) at the
    # FP64 peak, or the strip, mask and pivot rows read and written once.
    # L4: a pivoted LU, panel_lu_flops(n, n) ~ 2 n^3 / 3 a matrix, or the
    # matrix read and its factor, perm and ok written once. L5: 2 n^2 k a
    # matrix (both substitutions), or the factor, perm, b read and x
    # written once.
    def l4_bound(bsz, n, dtype):
        return bound(bsz * panel_lu_flops(n, n),
                     bsz * (2 * n * n * dtype.itemsize + 8 * n + 4), dtype)

    def l5_bound(bsz, n, k, dtype):
        return bound(bsz * 2 * n * n * k,
                     bsz * (n * n * dtype.itemsize + 8 * n
                            + 2 * n * k * dtype.itemsize + 4), dtype)

    bounds["L3"] = bound(panel_lu_flops(4096, 128),
                         2 * 4096 * 128 * 8 + 2 * 4096 * 4 + 128 * 4 + 4,
                         torch.float64)
    bounds["L4"] = l4_bound(1, 4096, torch.float32)
    bounds["L5"] = l5_bound(1, 4096, 16, torch.float32)
    l4_64 = l4_bound(64, 128, torch.float32)
    l4_200 = l4_bound(1, 200, torch.float64)
    l5_4096 = l5_bound(1, 4096, 4096, torch.float32)
    l5_64 = l5_bound(64, 128, 128, torch.float32)
    log(f"  L4 bound at (64, 128^2) fp32: {l4_64[0]:.6f} ms ({l4_64[1]}); "
        f"(1, 200^2) fp64: {l4_200[0]:.6f} ms ({l4_200[1]}); L5 at "
        f"(1, 4096^2, k = 4096): {l5_4096[0]:.6f} ms ({l5_4096[1]}); "
        f"(64, 128^2, k = 128): {l5_64[0]:.6f} ms ({l5_64[1]})")
    l1_64 = l1_bound(64, 256)
    l1_1000 = l1_bound(1, 1000)
    l2_4096 = l2_bound(4096, 256, 2048)
    log(f"  L1 bound at (64, 256^2): {l1_64[0]:.6f} ms ({l1_64[1]}); at "
        f"(1, 1000^2): {l1_1000[0]:.6f} ms ({l1_1000[1]}); L2 at (4096, "
        f"256) with 2048 rows used: {l2_4096[0]:.6f} ms ({l2_4096[1]})")
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
         # The dp-only sharded batch (4096, 128^2) on a (1, 1) mesh.
         "launches_sharded_dp_only": counts_shb["K1"],
         "peak_mb_inverse_512x256": peak["batch512_n256"],
         "peak_mb_inverse_64x640": peak["batch64_n640"]},
        # No PyTorch call computes a panel's pivot rows and C^T (K2) or a
        # packed-key pivot search (K3): library_ms is null for both.
        {**record("K2 panel_factor", "panel_factor.cu", "blocked.py:255",
                  launches["K2"], k2_abs, times["k2_panel_4096_ms"],
                  times["k2_twin_panel_4096_ms"], None),
         "kernel_device_ms": times["k2_panel_4096_device_ms"],
         "cluster": clusters["K2 (4096, 128)"],
         "us_per_pivot_step": rates["k2_us_per_pivot_step"],
         "launches_sharded_4096": counts_sh4k["K2"]},
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
             rates["k3_us_per_pivot_step_4096_fp32"],
         "launches_sharded_20000": counts_sh20["K3"],
         "launches_sharded_32768": counts_32["K3"]},
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
         "library_device_ms_b128": times["k4_library_inv_b128_device_ms"],
         "launches_sharded_20000": counts_sh20["K4"],
         "launches_sharded_32768": counts_32["K4"]},
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
        # L1's record is the FP64 tier's (1, 256^2) pivot block; the
        # (64, 256^2) batch and the grid branch at (1, 1000^2) in the
        # *_64x256 and *_1x1000 keys. Launches: FP64 4096^2 (16 blocks);
        # the other FP64 paths in launches_*.
        {**record("L1 gauss_jordan", "gauss_jordan.cu", "gauss_jordan.py:98",
                  counts_fp64["L1"], l1_abs, times["l1_1x256_ms"],
                  times["l1_twin_1x256_ms"],
                  times["l1_library_inv_1x256_ms"]),
         "kernel_device_ms": times["l1_1x256_device_ms"],
         "library_device_ms": times["l1_library_inv_1x256_device_ms"],
         "us_per_step": rates["l1_us_per_step_1x256"],
         "cluster": clusters["L1 (1, 256^2) fp64"],
         **{f"{k}_{key}": times[f"l1_{t}{key}_{u}"]
            for key in ("64x256", "1x1000")
            for k, t, u in (("ms", "", "ms"),
                            ("kernel_device_ms", "", "device_ms"),
                            ("plain_ms", "twin_", "ms"),
                            ("library_ms", "library_inv_", "ms"),
                            ("library_device_ms", "library_inv_",
                             "device_ms"))},
         "bound_ms_64x256": l1_64[0], "bound_by_64x256": l1_64[1],
         "bound_ms_1x1000": l1_1000[0], "bound_by_1x1000": l1_1000[1],
         "launches_fp64_8192": fp64_paths["matrix_inversion_fp64 8192^2"][
             "L1"],
         "launches_no_pivot_1024": counts_np["L1"],
         "launches_no_pivot_4096":
             fp64_paths["matrix_inversion_no_pivots 4096^2"]["L1"],
         "launches_spec_64x256": fp64_paths[
             "inverse on a (64, 256^2) FP64 batch (spec)"]["L1"]},
        # L2's record is the FP64 8192^2 panel (8192, 256), its launches
        # that path's; max_abs_err counts pivot rows that differ from the
        # twin's over phase 4f; library_ms is torch.linalg.lu_factor of
        # that strip (no row used before it).
        {**record("L2 logical_panel", "logical_panel.cu", "blocked.py:675",
                  fp64_paths["matrix_inversion_fp64 8192^2"]["L2"],
                  l2_mismatch, times["l2_8192_ms"], times["l2_twin_8192_ms"],
                  times["l2_library_lu_factor_8192_ms"]),
         "kernel_device_ms": times["l2_8192_device_ms"],
         "library_device_ms": times["l2_library_lu_factor_8192_device_ms"],
         "us_per_step": rates["l2_us_per_step_8192"],
         "grid": clusters["L2 (8192, 256) fp64"],
         "ms_4096_no_pivot": times["l2_4096_no_pivot_ms"],
         "kernel_device_ms_4096_no_pivot":
             times["l2_4096_no_pivot_device_ms"],
         "plain_ms_4096_no_pivot": times["l2_twin_4096_no_pivot_ms"],
         "bound_ms_4096_no_pivot": l2_4096[0],
         "bound_by_4096_no_pivot": l2_4096[1],
         "launches_no_pivot_1024": counts_np["L2"],
         "launches_no_pivot_4096":
             fp64_paths["matrix_inversion_no_pivots 4096^2"]["L2"]},
        # L3's record is FP64 getrf 4096^2's panel (4096, 128), its
        # launches FP64 LU getri 4096^2's; library_ms is
        # torch.linalg.lu_factor of that strip (no row used before it).
        {**record("L3 lu_panel", "lu_panel.cu", "lu.py:227",
                  counts_lu64["L3"], l3_abs, times["l3_4096_ms"],
                  times["l3_twin_4096_ms"],
                  times["l3_library_lu_factor_4096_ms"]),
         "kernel_device_ms": times["l3_4096_device_ms"],
         "library_device_ms": times["l3_library_lu_factor_4096_device_ms"],
         "us_per_step": rates["l3_us_per_step_4096"],
         "grid": clusters["L3 (4096, 128) fp64"],
         "launches_solve_fp64_4096": counts_solve64["L3"],
         "launches_slogdet_fp64_1024": counts_det64["L3"]},
        # L4's record is lu_inverse_refined's (1, 4096^2) fp32 factor on
        # the grid, its launches that path's; the (64, 128^2) batch and one
        # fp64 200^2 matrix (clusters) in the *_64x128 and *_1x200 keys.
        {**record("L4 lu_factor", "gauss_jordan.cu", "lu.py:29",
                  counts_lir["L4"], l4_abs, times["l4_1x4096_ms"],
                  times["l4_twin_1x4096_ms"],
                  times["l4_library_lu_factor_1x4096_ms"]),
         "kernel_device_ms": times["l4_1x4096_device_ms"],
         "library_device_ms": times["l4_library_lu_factor_1x4096_device_ms"],
         "us_per_step": rates["l4_us_per_step_1x4096"],
         "grid": clusters["L4 (1, 4096^2) float32"],
         **{f"{k}_{key}": times[f"l4_{t}{key}_{u}"]
            for key in ("64x128", "1x200")
            for k, t, u in (("ms", "", "ms"),
                            ("kernel_device_ms", "", "device_ms"),
                            ("plain_ms", "twin_", "ms"),
                            ("library_ms", "library_lu_factor_", "ms"),
                            ("library_device_ms", "library_lu_factor_",
                             "device_ms"))},
         "bound_ms_64x128": l4_64[0], "bound_by_64x128": l4_64[1],
         "bound_ms_1x200": l4_200[0], "bound_by_1x200": l4_200[1],
         "us_per_step_64x128": rates["l4_us_per_step_64x128"],
         "launches_inverse_lu_64x128": counts_b128["L4"],
         "launches_slogdet_64x128": counts_det128["L4"]},
        # L5's record is one correction of solve(x4k, rhs, refine_iters=2)
        # (1, 4096^2, k = 16), its launches that path's; lu_inverse_refined's
        # identity (k = 4096) and the (64, 128^2) batch's in the
        # *_4096_k4096 and *_64x128_k128 keys.
        {**record("L5 lu_solve", "lu_solve.cu", "lu.py:92",
                  counts_ref["L5"], l5_abs, times["l5_4096_k16_ms"],
                  times["l5_twin_4096_k16_ms"],
                  times["l5_library_lu_solve_4096_k16_ms"]),
         "kernel_device_ms": times["l5_4096_k16_device_ms"],
         "library_device_ms": times["l5_library_lu_solve_4096_k16_device_ms"],
         "us_per_step": rates["l5_us_per_step_4096_k16"],
         **{f"{k}_{key}": times[f"l5_{t}{key}_{u}"]
            for key in ("4096_k4096", "64x128_k128")
            for k, t, u in (("ms", "", "ms"),
                            ("kernel_device_ms", "", "device_ms"),
                            ("plain_ms", "twin_", "ms"),
                            ("library_ms", "library_lu_solve_", "ms"),
                            ("library_device_ms", "library_lu_solve_",
                             "device_ms"))},
         "bound_ms_4096_k4096": l5_4096[0], "bound_by_4096_k4096": l5_4096[1],
         "bound_ms_64x128_k128": l5_64[0], "bound_by_64x128_k128": l5_64[1],
         "launches_lu_inverse_refined_4096": counts_lir["L5"],
         "launches_inverse_lu_64x128": counts_b128["L5"]},
    ]
    nccl_world.close()

    # ---- phase 8: the compiled routes (CUDA graphs) ---------------------
    # Each compiled route (utils/graphs.py, the port's counterpart of the
    # JAX package's jax.jit per static signature) at its PERF.md section 4
    # shape, in three legs: eager (graphs.disabled()), the first call (the
    # warm-up, the capture and one replay) and replays. Checks: outputs and
    # ok bit for bit across the three legs (a library call that parted
    # under capture would fail here, by name of route); the profiler's
    # records of the port's kernels in the eager leg show none more often
    # than the wrappers counted, the route's graphs hold those kernels as
    # nodes (graphs.kernel_nodes), a replay's profiler records show none
    # more often (the profiler can drop a record, never adds one: a
    # shortfall is printed), and a replay runs no wrapper; graphs.stats()
    # counts one capture and then one replay a call for each of the route's
    # graphs, so an eager run cannot pass for a replay; A, B, A with A's
    # first result held leaves it unchanged, and B's replay gives B's eager
    # bits (a step left out of the graph would replay its value for A);
    # check_deterministic (the first run eager, the rest replays; the
    # allocator and the graphs' pool poisoned between runs). Reported with
    # the card: CUDA events and the profiler's device ms of the eager and
    # the replayed leg (a lost device time fails the run), their idle
    # shares, the first call's ms by the host clock and its parts
    # (graphs.first_calls(): warm-up, capture, first replay), the bytes the
    # graphs' pool gained, and the peak device memory of each leg above
    # what was live (a replay allocates only its outputs' clones). Then the
    # gate's evidence: the blocked route's eager idle share at 4096^2,
    # 8192^2 and 16384^2, LU getri's and potri's at 8192^2, and those three
    # replayed at 8192^2 (inside the gate). Last, what the cache holds
    # after the sweep's sizes (650 .. 2000 by 10): its graphs (at most
    # graphs.MAX_GRAPHS), the pool's bytes, and the device memory reserved
    # and allocated before and after.
    phase(f"phase 8: compiled routes, eager against replayed, on {card}")
    graphs.clear()

    def leaves(out) -> list:
        return list(out) if isinstance(out, tuple) else [out]

    def same_bits(x, y) -> bool:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        for a, b in zip(leaves(x), leaves(y), strict=True):
            if a.dtype != b.dtype or a.shape != b.shape:
                return False
            if a.is_floating_point():
                a, b = (t.view(ints[t.element_size()]) for t in (a, b))
            if not torch.equal(a, b):
                return False
        return True

    def counted(fn):
        """fn()'s result and the launches the wrappers counted in it."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items()}

    def as_records(counts: dict, times: int) -> dict:
        """Wrapper counts of one call as the profiler's records of
        ``times`` calls (K2 and K6 launch one kernel)."""
        out = {}
        for k, c in counts.items():
            key = "K2/K6" if k in ("K2", "K6") else k
            if c:
                out[key] = out.get(key, 0) + c * times
        return out

    def peak_of(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - live

    def leg(name, fn, iters):
        """(events ms, device ms a call, the kernels of ``iters`` calls)."""
        ev = events_ms(fn, iters=iters)
        try:
            rows = device_kernels(lambda: [fn() for _ in range(iters)])
        except profiling.NoDeviceTime as exc:
            fail(f"{name}: {exc}")
        return ev, sum(ms for _, _, ms in rows) / iters, rows

    def locked(x):
        with lockstep_on():
            return inverse(x)

    x4k_b = torch.from_numpy(hollow_random_matrix(4096, seed=2)).to(dev)
    x4k64_b = x4k_b.double()
    x8k64_b = torch.from_numpy(hollow_random_matrix(
        8192, seed=4, dtype=np.float64)).to(dev)
    dom4k_b = dom4k_dev.flip(0).flip(1)      # still diagonally dominant
    b64_b = b64_dev.flip(0)
    spd4k_b = spd(4096, 2)
    xwc_b = torch.from_numpy(well_conditioned_matrix(4096, seed=2)).to(dev)
    rhs_b = rhs.flip(0)
    xs8 = lockstep_in[(8, 2048)]
    xs16_b, xs8_b = xs16.flip(0), xs8.flip(0)
    x256 = torch.from_numpy(hollow_random_matrix(
        256, seed=256, dtype=np.float64)).to(dev)
    x256_b = torch.from_numpy(hollow_random_matrix(
        256, seed=257, dtype=np.float64)).to(dev)
    rhs64_b = rhs64.flip(0)
    x_ill_b = x_ill.flip(0)
    b128_b = b128_dev.flip(0)
    r128 = torch.from_numpy(rng.standard_normal((64, 128, 3)).astype(
        np.float32)).to(dev)
    # Another matrix: a row permutation of a1k64 has the same factor and
    # logabsdet.
    a1k64_b = torch.from_numpy(hollow_random_matrix(
        1024, seed=8, dtype=np.float64) / 50).to(dev)
    lu_fns = ("lu_factor_blocked", "lu_solve_fast")
    chol_fns = ("cholesky_factor", "cholesky_solve")
    routes = [
        # (name, the compiled functions it calls, call on A, on B, iters)
        ("blocked 4096^2 refined", ("blocked_inverse",),
         lambda: inverse(x4k), lambda: inverse(x4k_b), 3),
        ("bf16 search 4096^2", ("blocked_inverse",),
         lambda: inverse(x4k, search_bf16=True),
         lambda: inverse(x4k_b, search_bf16=True), 3),
        ("FP64 4096^2", ("blocked_inverse",), lambda: inverse(x4k64),
         lambda: inverse(x4k64_b), 1),
        ("per-matrix (16, 1024^2)", ("blocked_inverse",),
         lambda: inverse(xs16), lambda: inverse(xs16_b), 2),
        ("lockstep (16, 1024^2)", ("blocked_inverse",),
         lambda: locked(xs16), lambda: locked(xs16_b), 2),
        ("per-matrix (8, 2048^2)", ("blocked_inverse",),
         lambda: inverse(xs8), lambda: inverse(xs8_b), 2),
        ("lockstep (8, 2048^2)", ("blocked_inverse",),
         lambda: locked(xs8), lambda: locked(xs8_b), 2),
        ("LU getri 4096^2", ("lu_inverse_fast",),
         lambda: inverse(x4k, method="lu"),
         lambda: inverse(x4k_b, method="lu"), 3),
        ("solve 4096^2 x 16", lu_fns, lambda: solve(x4k, rhs),
         lambda: solve(x4k_b, rhs_b), 3),
        ("potri 4096^2", ("cholesky_inverse",),
         lambda: cholesky_inverse(spd4k), lambda: cholesky_inverse(spd4k_b),
         3),
        ("Cholesky solve 4096^2 x 16", chol_fns,
         lambda: solve(spd4k, rhs, method="cholesky"),
         lambda: solve(spd4k_b, rhs_b, method="cholesky"), 3),
        ("Newton-Schulz 4096^2", ("newton_schulz_inverse",),
         lambda: inverse(xwc, method="ns"),
         lambda: inverse(xwc_b, method="ns"), 1),
        ("FP64 8192^2", ("blocked_inverse",), lambda: inverse(x8k64_dev),
         lambda: inverse(x8k64_b), 1),
        ("no-pivot FP64 4096^2", ("blocked_inverse",),
         lambda: inverse(dom4k_dev, pivot=False),
         lambda: inverse(dom4k_b, pivot=False), 1),
        ("spec FP64 (64, 256^2)", ("gauss_jordan_inverse",),
         lambda: inverse(b64_dev), lambda: inverse(b64_b), 3),
        ("spec FP64 256^2", ("gauss_jordan_inverse",),
         lambda: inverse(x256), lambda: inverse(x256_b), 3),
        # The twelfth slice: the LU routes on L3, L4 and L5, and the five
        # spec sites newly compiled (the JAX package's jit at lu.py:80,
        # 127, 138, 152, 1072).
        ("FP64 LU getri 4096^2", ("lu_inverse_fast",),
         lambda: inverse(x4k64, method="lu"),
         lambda: inverse(x4k64_b, method="lu"), 1),
        ("FP64 solve 4096^2 x 16", lu_fns,
         lambda: solve(x4k64, rhs64, method="lu"),
         lambda: solve(x4k64_b, rhs64_b, method="lu"), 1),
        ("solve 4096^2 x 16, refine_iters=2", lu_fns + ("refine_solve",),
         lambda: solve(x4k, rhs, method="lu", refine_iters=2),
         lambda: solve(x4k_b, rhs_b, method="lu", refine_iters=2), 3),
        ("lu_inverse_refined 4096^2", ("lu_inverse", "newton_schulz_refine"),
         lambda: lu_inverse_refined(x_ill, iters=4,
                                    residual_dtype=torch.float64),
         lambda: lu_inverse_refined(x_ill_b, iters=4,
                                    residual_dtype=torch.float64), 1),
        ("LU spec inverse (64, 128^2)", ("lu_inverse",),
         lambda: inverse(b128_dev, method="lu"),
         lambda: inverse(b128_b, method="lu"), 3),
        ("lu_factor (64, 128^2)", ("lu_factor",),
         lambda: lu.lu_factor(b128_dev), lambda: lu.lu_factor(b128_b), 3),
        ("lu_solve 4096^2 x 16", ("lu_solve",),
         lambda: lu.lu_solve(f4k, p4k, rhs),
         lambda: lu.lu_solve(f4k, p4k, rhs_b), 3),
        ("lu_solve_matrix (64, 128^2) x 3", ("lu_solve_matrix",),
         lambda: lu.lu_solve_matrix(b128_dev, r128),
         lambda: lu.lu_solve_matrix(b128_b, r128), 3),
        ("slogdet (64, 128^2)", ("slogdet",), lambda: slogdet(b128_dev),
         lambda: slogdet(b128_b), 3),
        ("slogdet FP64 1024^2", ("slogdet",), lambda: slogdet(a1k64_dev),
         lambda: slogdet(a1k64_b), 3),
    ]
    def grown(before: dict, fns) -> list:
        """Captures and replays of each of ``fns`` since ``before``."""
        now = graphs.stats()
        zero = {"captures": 0, "replays": 0}
        return [{k: now.get(fn, zero)[k] - before.get(fn, zero)[k]
                 for k in zero} for fn in fns]

    # Routes whose compiled functions an earlier route already captured at
    # the same signature (solve's getrf and getrs at 4096^2 fp32) start
    # from an empty cache, so that their first call captures.
    fresh = {"solve 4096^2 x 16, refine_iters=2"}
    compiled_rows = {}
    for name, fns, call_a, call_b, iters in routes:
        if name in fresh:
            graphs.clear()
        st0 = graphs.stats()
        with graphs.disabled():
            eager, eager_counts = counted(call_a)
            eager_peak = peak_of(call_a)
            ev_e, dv_e, rows_e = leg(f"{name} eager", call_a, iters)
        check(graphs.stats() == st0, f"{name}: the eager leg captured and "
              f"replayed nothing")
        hold_records(f"{name} eager ({iters} calls)",
                     kernel_launches(rows_e), as_records(eager_counts, iters))
        pool_before = graphs.pool_bytes()
        firsts_before = len(graphs.first_calls())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = call_a()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        pool_gain = graphs.pool_bytes() - pool_before
        parts = graphs.first_calls()[firsts_before:]
        check(grown(st0, fns) == [{"captures": 1, "replays": 1}] * len(fns),
              f"{name}: the first call captured {'+'.join(fns)} once and "
              f"replayed it")
        st1 = graphs.stats()
        replay, replay_counts = counted(call_a)
        check(grown(st1, fns) == [{"captures": 0, "replays": 1}] * len(fns),
              f"{name}: the next call replayed, capturing nothing")
        log(f"  {name}: launches eager {eager_counts}; first call "
            f"{first_ms:.2f} ms: " + "; ".join(
                f"{sig[:60]} warm-up {p['warmup_ms']:.2f}, capture "
                f"{p['capture_ms']:.2f}, first replay {p['replay_ms']:.2f}"
                for sig, p in parts))
        check(not any(replay_counts.values()),
              f"{name}: a replay ran no kernel wrapper")
        held_nodes = kernel_launches([(k, n, 0.0) for k, n in
                                      graphs.kernel_nodes(len(fns)).items()])
        check(held_nodes == as_records(eager_counts, 1),
              f"{name}: the route's graphs hold the port's kernels as the "
              f"eager call launches them ({held_nodes})")
        check(same_bits(first, eager) and same_bits(replay, eager),
              f"{name}: eager, first call and replay bit-identical "
              f"(outputs and ok)")
        replay_peak = peak_of(call_a)
        ev_r, dv_r, rows_r = leg(f"{name} replayed", call_a, iters)
        ran_r = kernel_launches(rows_r)
        hold_records(f"{name} replayed ({iters} calls)", ran_r,
                     {k: n * iters for k, n in held_nodes.items()})
        with graphs.disabled():
            eager_b = call_b()
        held = call_a()
        keep = [t.clone() for t in leaves(held)]
        other = call_b()
        again = call_a()
        check(same_bits(held, tuple(keep)) and same_bits(again, held)
              and not same_bits(other, held),
              f"{name}: A, B, A leaves A's held result unchanged")
        check(same_bits(other, eager_b), f"{name}: B's replay is B's eager "
              f"bits (the graph recomputes every step from its input)")
        t0 = time.perf_counter()
        same, diff = determinism.check_deterministic(call_a, runs=3)
        check(same, f"{name}: check_deterministic (eager, then replays, "
              f"poisoned between) bit-identical, max_diff {diff} "
              f"({time.perf_counter() - t0:.2f} s)")
        row = {"events_ms_eager": ev_e, "device_ms_eager": dv_e,
               "idle_eager": 1 - dv_e / ev_e, "events_ms_replayed": ev_r,
               "device_ms_replayed": dv_r, "idle_replayed": 1 - dv_r / ev_r,
               "first_call_ms": first_ms,
               "first_call_parts": [p for _, p in parts],
               "kernel_nodes": held_nodes,
               "kernels_recorded": ran_r,
               "records_eager": sum(c for _, c, _ in rows_e) / iters,
               "records_replayed": sum(c for _, c, _ in rows_r) / iters,
               "pool_bytes_gained": pool_gain,
               "peak_bytes_eager": eager_peak,
               "peak_bytes_replayed": replay_peak}
        compiled_rows[name] = row
        log(f"  {name}: eager {ev_e:.4f} ms events / {dv_e:.4f} ms device "
            f"(idle {row['idle_eager']:.4f}); replayed {ev_r:.4f} / "
            f"{dv_r:.4f} (idle {row['idle_replayed']:.4f}); first call "
            f"{first_ms:.2f} ms; pool +{pool_gain / 1e6:.1f} MB; peak above "
            f"live: eager {eager_peak / 1e6:.1f} MB, replayed "
            f"{replay_peak / 1e6:.1f} MB   [{card}]")
        for key, count, ms in rows_r[:4]:
            log(f"    replayed: {ms / iters:10.4f} ms  {count // iters:5d}x"
                f"  {key[:80]}")
        del eager, first, replay, held, keep, other, again, eager_b
    log(f"  graphs' pool: {graphs.pool_bytes() / 1e6:.1f} MB after "
        f"{len(routes)} routes; stats {graphs.stats()}")

    # The gate (graphs.GATE_ELEMENTS: one matrix to 8192^2): capture where
    # the eager idle share is 10% or more.
    gate = {}
    for n in (4096, 8192, 16384):
        xg = x4k if n == 4096 else torch.from_numpy(
            hollow_random_matrix(n, seed=n)).to(dev)
        sized = [("blocked", lambda: inverse(xg))]
        if n == 8192:
            sized += [("LU getri", lambda: inverse(xg, method="lu")),
                      ("potri", lambda: cholesky_inverse(spd8k))]
        for route, fn in sized:
            with graphs.disabled():
                ev, dv, _ = leg(f"{route} {n}^2 eager", fn, 1)
            gate[f"{route} {n}^2 eager"] = (ev, dv, 1 - dv / ev)
            if n == 8192:
                ev, dv, _ = leg(f"{route} {n}^2 replayed", fn, 1)
                gate[f"{route} {n}^2 replayed"] = (ev, dv, 1 - dv / ev)
        del xg
    for key, (ev, dv, idle) in gate.items():
        log(f"  gate: {key}: {ev:.4f} ms events, {dv:.4f} ms device, idle "
            f"share {idle:.4f}   [{card}]")

    # The cache after the sweep's sizes: one blocked_inverse graph a size
    # (sweep_cuda's method="auto" past the fused route), the oldest
    # dropped past graphs.MAX_GRAPHS.
    del spd8k
    graphs.clear()
    torch.cuda.synchronize()
    mem0 = (torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev))
    sizes = [n for n in reference_sizes(2000) if n > fused.FUSED_MAX_N]
    t0 = time.perf_counter()
    for n in sizes:
        xn = torch.rand(n, n, device=dev)
        xn.fill_diagonal_(0.0)
        if not bool(inverse(xn)[1]):
            fail(f"sweep size {n}: ok false")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    mem1 = (torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev))
    st = graphs.stats().get("blocked_inverse", {})
    log(f"  cache after {len(sizes)} sweep sizes ({sizes[0]} .. "
        f"{sizes[-1]}; {sweep_s:.2f} s): {graphs.cached()} graphs, "
        f"{st.get('captures')} captures, pool {graphs.pool_bytes() / 1e6:.1f}"
        f" MB; reserved {mem0[0] / 1e6:.1f} -> {mem1[0] / 1e6:.1f} MB, "
        f"allocated {mem0[1] / 1e6:.1f} -> {mem1[1] / 1e6:.1f} MB   [{card}]")
    check(graphs.cached() == min(len(sizes), graphs.MAX_GRAPHS)
          and st.get("captures") == len(sizes),
          f"the cache keeps the {graphs.MAX_GRAPHS} graphs used last")
    graphs.clear()
    log("  compiled routes: " + json.dumps(compiled_rows))
    phase("done")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
