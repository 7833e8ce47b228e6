"""Where a step of L1 to L4 goes: clock64 phase times on the card; L5's
time a step.

    python3 -m probes.loop_phases

Copies ``csrc/gj_loop.cuh``, ``csrc/gauss_jordan.cu`` (L1 and L4),
``csrc/logical_panel.cu`` and ``csrc/lu_panel.cu`` into ``build/loop_phases/`` with timers added to the step loop
(``clock64`` laps by thread 0 of member 0 of each group, summed over the
launch into a device array), builds one library per kernel with ``nvcc``,
runs L1 to L4 through their C entry points at the routes' shapes (L3 at
FP64 getrf 4096^2's panel, L4's cluster branch at the (64, 128^2) fp32
batch; past n = 511 L4 is the blocked csrc/lu_factor.cu, no step loop,
timed by probes/l5_paths.py) and the geometry the wrappers choose,
and prints for each:
ms per launch by CUDA events (the timers cost a little) and the cycles of
each phase per step. Phases: ``barrier`` (the group barrier: the cluster's,
or the grid's atomic), ``winner`` (the members' headers read and reduced),
``normalize`` (the pivot row read, divided, the position maps),
``update`` (the member's rows and each warp's best candidate for the next
step) and ``propose`` (the block's best candidate, the proposal's
stores). L5 (``csrc/lu_solve.cu``, no step loop of gj_loop.cuh) runs
from the package at (1, 4096^2) with k = 16 and 4096: ms a launch and us
a step (2 n steps). The timers go in at fixed lines
of the source; if those lines change, the copy step fails and says which.
Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from gpu_matrix_inversion_tpu_torch.ops import blocked, gauss_jordan, lu
from gpu_matrix_inversion_tpu_torch.utils import cuda_build

OUT = cuda_build.BUILD_DIR.parent / "loop_phases"
PHASES = ("barrier", "winner", "normalize", "update", "propose")


def _instrumented_header() -> str:
    src = (cuda_build.CSRC / "gj_loop.cuh").read_text()

    def insert(anchor: str, code: str, before: bool = False) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"loop_phases: anchor found {src.count(anchor)}"
                             f" times, not once:\n{anchor}")
        src = src.replace(anchor, code + anchor if before else anchor + code)

    insert("namespace matinv::loop {\n",
           "\n__device__ unsigned long long g_phase[8];\n"
           "#define LAP(i) do { if (lap_on) { long long n_ = clock64(); "
           "laps[i] += n_ - lap_t; lap_t = n_; } } while (0)\n")
    insert("  const int members = comm.members();\n",
           "  const bool lap_on = comm.rank() == 0 && threadIdx.x == 0;\n"
           "  long long laps[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
           "  long long lap_t = clock64();\n")
    insert("    comm.sync();\n", "    LAP(0);\n")
    insert("      prow_id = warp_best(best).row;\n    }\n", "    LAP(1);\n")
    insert("pivrows[r] = prow_id;\n      }\n    }\n    __syncthreads();\n",
           "    LAP(2);\n")
    insert("jb.red[warp] = wbest;\n    __syncthreads();\n", "    LAP(3);\n")
    insert("    if (tn < jb.steps) propose<T, INV, LU>(comm, jb, tn, keys);\n",
           "    LAP(4);\n")
    insert("  __syncthreads();\n  return ok;\n",
           "  if (lap_on)\n    for (int i = 0; i < 5; ++i)\n"
           "      atomicAdd(&g_phase[i], (unsigned long long)laps[i]);\n",
           before=True)
    src += ("\nextern \"C\" int loop_phases_take(unsigned long long* out) {\n"
            "  cudaError_t err = cudaMemcpyFromSymbol(\n"
            "      out, matinv::loop::g_phase,\n"
            "      sizeof(matinv::loop::g_phase));\n"
            "  static const unsigned long long zero[8] = {};\n"
            "  if (err == cudaSuccess)\n"
            "    err = cudaMemcpyToSymbol(matinv::loop::g_phase, zero,\n"
            "                             sizeof(zero));\n"
            "  return err;\n}\n")
    return src


def _build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gj_loop.cuh").write_text(_instrumented_header())
    libs = {}
    for name in ("gauss_jordan", "logical_panel", "lu_panel"):
        (OUT / f"{name}.cu").write_text(
            (cuda_build.CSRC / f"{name}.cu").read_text())
        lib = OUT / f"lib_{name}.so"
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                        "-shared", "-o", str(lib), str(OUT / f"{name}.cu")],
                       check=True, capture_output=True)
        cdll = ctypes.CDLL(str(lib))
        entry = f"matinv_{name}"
        getattr(cdll, entry).argtypes = list(cuda_build.SIGNATURES[entry])
        cdll.loop_phases_take.argtypes = [ctypes.c_void_p]
        libs[name] = cdll
    return libs


def _take(lib) -> np.ndarray:
    out = (ctypes.c_ulonglong * 8)()
    assert lib.loop_phases_take(out) == 0
    return np.array(out[:len(PHASES)], dtype=np.float64)


def _events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    libs = _build()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    sms = gauss_jordan.sm_count(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    def l1(x):
        bsz, n, _ = x.shape
        geo = gauss_jordan.loop_geometry(n, bsz, 8, sms)
        inv = torch.empty_like(x)
        ok = torch.empty(bsz, dtype=torch.int32, device=dev)
        grid = geo.branch == "grid"
        work = (torch.empty((n, n), dtype=x.dtype, device=dev)
                if grid and not geo.rows_shared else None)
        props = torch.empty(gauss_jordan.grid_props_bytes(geo.ctas, n, 8),
                            dtype=torch.uint8, device=dev)
        flags = torch.empty(geo.ctas, dtype=torch.int32, device=dev)

        def run():
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            err = libs["gauss_jordan"].matinv_gauss_jordan(
                x.data_ptr(), inv.data_ptr(), None, ok.data_ptr(),
                None if work is None else work.data_ptr(), props.data_ptr(),
                bar.data_ptr(), flags.data_ptr(), bsz, n, 1, 0, 1, int(grid),
                geo.ctas, int(geo.rows_shared), geo.smem, stream)
            assert err == 0, err
        return geo, run, bsz * n

    def l2(m, b):
        strip = torch.from_numpy(rng.standard_normal((m, b))).to(dev)
        used = torch.zeros(m, dtype=torch.int32, device=dev)
        geo = blocked.logical_geometry(m, b, 8, sms)
        piv = torch.empty(b, dtype=torch.int32, device=dev)
        ok = torch.empty(1, dtype=torch.int32, device=dev)
        work = (None if geo.rows_shared else
                torch.empty((m, b), dtype=torch.float64, device=dev))
        props = torch.empty(gauss_jordan.grid_props_bytes(geo.ctas, b, 8),
                            dtype=torch.uint8, device=dev)

        def run():
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            err = libs["logical_panel"].matinv_logical_panel(
                strip.data_ptr(), b, used.data_ptr(), piv.data_ptr(),
                ok.data_ptr(), None if work is None else work.data_ptr(),
                props.data_ptr(), bar.data_ptr(), m, b, 0, 1, 1, geo.ctas,
                int(geo.rows_shared), geo.smem, stream)
            assert err == 0, err
        return geo, run, b

    def l3(m, b):
        strip = torch.from_numpy(rng.standard_normal((m, b))).to(dev)
        used = torch.zeros(m, dtype=torch.int32, device=dev)
        geo = blocked.logical_geometry(m, b, 8, sms)
        w = torch.empty_like(strip)
        used_out = torch.empty_like(used)
        piv = torch.empty(b, dtype=torch.int32, device=dev)
        ok = torch.empty(1, dtype=torch.int32, device=dev)
        work = (None if geo.rows_shared else torch.empty_like(strip))
        props = torch.empty(gauss_jordan.grid_props_bytes(geo.ctas, b, 8),
                            dtype=torch.uint8, device=dev)

        def run():
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            err = libs["lu_panel"].matinv_lu_panel(
                strip.data_ptr(), b, used.data_ptr(), w.data_ptr(),
                used_out.data_ptr(), piv.data_ptr(), ok.data_ptr(),
                None if work is None else work.data_ptr(), props.data_ptr(),
                bar.data_ptr(), m, b, 0, 1, 1, geo.ctas,
                int(geo.rows_shared), geo.smem, stream)
            assert err == 0, err
        return geo, run, b

    def l4(x):  # the cluster branch (n <= 511)
        bsz, n, _ = x.shape
        fp64 = x.dtype == torch.float64
        geo = gauss_jordan.loop_geometry(n, bsz, x.element_size(), sms)
        fac = torch.empty_like(x)
        perm = torch.empty((bsz, n), dtype=torch.long, device=dev)
        ok = torch.empty(bsz, dtype=torch.int32, device=dev)

        def run():
            err = libs["gauss_jordan"].matinv_gauss_jordan(
                x.data_ptr(), fac.data_ptr(), perm.data_ptr(), ok.data_ptr(),
                None, None, None, None, bsz, n, int(fp64), 1, 1, 0, geo.ctas,
                1, geo.smem, stream)
            assert err == 0, err
        return geo, run, bsz * n

    cases = [(f"L1 ({bsz}, {n}^2) fp64", "gauss_jordan",
              l1(torch.from_numpy(rng.standard_normal((bsz, n, n))).to(dev)))
             for bsz, n in ((1, 32), (1, 256), (64, 256), (1, 511),
                            (1, 1000))]
    cases += [(f"L2 ({m}, {b}) fp64", "logical_panel", l2(m, b))
              for m, b in ((4096, 256), (8192, 256), (16384, 256))]
    cases += [("L3 (4096, 128) fp64", "lu_panel", l3(4096, 128))]
    cases += [(f"L4 ({bsz}, {n}^2) fp32", "gauss_jordan", l4(torch.from_numpy(
        rng.standard_normal((bsz, n, n)).astype(np.float32)).to(dev)))
              for bsz, n in ((64, 128),)]
    for label, name, (geo, run, steps) in cases:
        ms = _events_ms(run, 5)
        torch.cuda.synchronize()
        _take(libs[name])
        run()
        torch.cuda.synchronize()
        cycles = _take(libs[name]) / steps
        print(f"{label}: {geo.branch} of {geo.ctas} CTAs, {ms:.4f} ms a "
              f"launch; cycles a step of a group: " + ", ".join(
                  f"{p} {c:.0f}" for p, c in zip(PHASES, cycles))
              + f" (sum {cycles.sum():.0f})")
    x = torch.from_numpy(rng.standard_normal((1, 4096, 4096)).astype(
        np.float32)).to(dev)
    fac, perm, _ = lu._lu_factor_batched(x, pivot=True)
    for k in (16, 4096):
        rhs = torch.from_numpy(rng.standard_normal((1, 4096, k)).astype(
            np.float32)).to(dev)
        plan = lu.lu_solve_plan(1, 4096, k, 4, sms)
        ms = _events_ms(lambda: lu._lu_solve_batched(fac, perm, rhs), 5)
        print(f"L5 (1, 4096^2, k = {k}) fp32: {plan.ctas} CTAs"
              + (f" in clusters of {plan.cluster}" if plan.cluster else "")
              + f", {plan.kc} columns a tile, {ms:.4f} ms a launch, "
              f"{ms * 1e3 / 256:.3f} us a block of 32 steps")


if __name__ == "__main__":
    main()
