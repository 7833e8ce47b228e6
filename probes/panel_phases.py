"""Where a pivot step of K2 and K3 goes: clock64 phase times on the card.

    python3 -m probes.panel_phases

Copies ``csrc/panel_factor.cu`` into ``build/panel_phases/`` with timers
added (``clock64`` laps by thread 0 of CTA 0, summed over the launch into a
device array), builds it alone with ``nvcc``, runs K2 and K3 through their C
entry points at the paths' shapes and the geometry the wrappers choose
(``cluster_geometry``, at C = 16 and at C = 8), and prints for each: ms per
launch by CUDA events (the timers cost a little), and the cycles of each
phase, in all and per pivot step. Phases: ``choose`` (wait for the C slots,
pick the pivot, normalize its column), ``eliminate`` (the CTA's own lanes
and the next keys), ``reduce`` (the block max), ``publish`` (the slot
stores into every CTA), ``push`` (g into every CTA and
the cluster barrier, once a sub-panel), ``update`` (the rank-sub update)
and ``load`` (the sub-panel's working set). The timers go in at fixed
lines of the source; if those lines change, the copy step fails and says
which. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from gpu_matrix_inversion_tpu_torch.ops import blocked
from gpu_matrix_inversion_tpu_torch.utils import cuda_build

OUT = cuda_build.BUILD_DIR.parent / "panel_phases"
PHASES = ("choose", "eliminate", "reduce", "publish", "push", "update",
          "load")


def _instrumented() -> str:
    """The kernel source with the phase timers."""
    src = (cuda_build.CSRC / "panel_factor.cu").read_text()

    def after(anchor: str, code: str) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"panel_phases: anchor found {src.count(anchor)}"
                             f" times, not once:\n{anchor}")
        src = src.replace(anchor, anchor + code)

    after('#include "common.cuh"\n',
          "\n__device__ unsigned long long g_phase[8];\n"
          "#define LAP(i) do { if (lap_on) { long long n_ = clock64(); "
          "laps[i] += n_ - lap_t; lap_t = n_; } } while (0)\n")
    after("  int t = 0;       // the step being published next\n",
          "  const bool lap_on = rank == 0 && tid == 0;\n"
          "  long long laps[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
          "  long long lap_t = clock64();\n")
    after("        if (rank == owner) pivrows[r0 + r2] = p;\n      }\n",
          "      LAP(0);\n")
    after("      best = cta_max(best, red);\n", "      LAP(2);\n")
    after("      const int par = (t - 1) & 1;\n", "      LAP(3);\n")
    after("          cluster.map_shared_rank(g, d)[q * gs + k] = gv;\n"
          "      }\n    }\n    cluster.sync();\n", "    LAP(4);\n")
    after("    // The next load pass reads, lane by lane, what this thread "
          "wrote.\n", "    LAP(5);\n")
    for anchor, lap in (("      if (more) publish(best, p + 1);\n", 1),
                        ("    publish(best, kb + r0);\n", 6)):
        if src.count(anchor) != 1:
            raise SystemExit(f"panel_phases: anchor not found:\n{anchor}")
        src = src.replace(anchor, f"      LAP({lap});\n" + anchor)
    anchor = "  if constexpr (kEmitCt) {\n    // C^T out"
    if src.count(anchor) != 1:
        raise SystemExit(f"panel_phases: anchor not found:\n{anchor}")
    src = src.replace(anchor, "  if (lap_on) for (int i = 0; i < 8; ++i) "
                      "atomicAdd(&g_phase[i], (unsigned long long)laps[i]);\n"
                      + anchor)
    return src + '''
extern "C" int matinv_phase_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return e;
}
'''


def _build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "panel_factor_phases.cu").write_text(_instrumented())
    lib_path = OUT / "libpanel_phases.so"
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-I",
         str(cuda_build.CSRC), "-o", str(lib_path),
         str(OUT / "panel_factor_phases.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("matinv_panel_factor", "matinv_pivot_search"):
        getattr(lib, name).argtypes = list(cuda_build.SIGNATURES[name])
    lib.matinv_phase_read.argtypes = [ctypes.c_void_p]
    return lib


def _run(lib, kind: int, m: int, b: int, dtype, cmax: int, reps: int = 20):
    dev = torch.device("cuda", 0)
    sub, kmask = blocked._factor_geometry(m, b)
    geo = blocked.cluster_geometry(m, b, sub, 2 if dtype == torch.bfloat16
                                   else 4, cmax)
    rng = np.random.default_rng(m + b)
    strip = torch.from_numpy(rng.standard_normal((b, m)).astype(
        np.float32)).to(dev).to(dtype)
    used = torch.zeros(m, dtype=torch.int32, device=dev)
    pivrows = torch.empty(b, dtype=torch.int32, device=dev)
    rows = torch.empty((b, m), dtype=dtype, device=dev)
    ok = torch.empty(1, dtype=torch.int32, device=dev)
    wp = torch.empty((2 * sub, m), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (geo.cluster, geo.threads, int(geo.wp_shared),
             int(geo.rows_shared), geo.smem, stream)

    def launch():
        if kind == 0:
            err = lib.matinv_panel_factor(
                strip.data_ptr(), used.data_ptr(), pivrows.data_ptr(),
                rows.data_ptr(), ok.data_ptr(), wp.data_ptr(), m, b, sub,
                kmask, 0, 1, *shape)
        else:
            err = lib.matinv_pivot_search(
                strip.data_ptr(), used.data_ptr(), pivrows.data_ptr(),
                rows.data_ptr(), wp.data_ptr(), m, b, sub, kmask,
                int(dtype == torch.bfloat16), *shape)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    counts = (ctypes.c_ulonglong * 8)()
    launch()
    torch.cuda.synchronize()
    lib.matinv_phase_read(ctypes.addressof(counts))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    lib.matinv_phase_read(ctypes.addressof(counts))
    cycles = [counts[i] / reps for i in range(len(PHASES))]
    name = "K2" if kind == 0 else f"K3 {str(dtype)[6:]}"
    print(f"{name} (m, b) = ({m}, {b}), C = {geo.cluster} ({geo.lanes} lanes,"
          f" {geo.threads} threads, working set "
          f"{'shared' if geo.wp_shared else 'global'}, strip rows "
          f"{'shared' if geo.rows_shared else 'global'}): {ms:.4f} ms a "
          f"launch, {sum(cycles):.0f} cycles of thread 0")
    for phase, c in zip(PHASES, cycles):
        print(f"  {phase:10s} {c:10.0f} cycles {c / b:8.0f} a step")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    lib = _build()
    for kind, m, b, dtype in ((0, 4096, 128, torch.float32),
                              (0, 1024, 128, torch.float32),
                              (1, 4096, 128, torch.float32),
                              (2, 20032, 64, torch.bfloat16),
                              (2, 65536, 32, torch.bfloat16)):
        for cmax in (16, 8):
            _run(lib, kind, m, b, dtype, cmax)


if __name__ == "__main__":
    main()
