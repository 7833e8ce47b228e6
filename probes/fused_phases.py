"""Where a Gauss-Jordan step of K1's cluster branch goes: clock64 phase
times on the card.

    python3 -m probes.fused_phases

Copies ``csrc/fused_gj.cu`` into ``build/fused_phases/`` with timers added
(``clock64`` laps by one thread, summed over the launch into a device
array), builds it alone with ``nvcc``, runs K1 through its C entry point at
the (batch, m) shapes and cluster sizes below, and prints for each: ms per
launch by CUDA events (the timers cost a little) and the cycles of each
phase per pivot step, for thread 0 of CTA 0 and thread 37 of CTA 1.
Phases: ``wait`` (for the C slots of the step), ``normalize`` (the pivot,
the normalized row a column a thread, the factors), ``column`` (column
t + 1 of each row slot and its key), ``choose`` (the block reduction of
the keys), ``publish`` (the warp owning the CTA's best row updates it and
stores it into every CTA; 0 for other warps) and ``update`` (the rest of
the CTA's rows). The timers go in at fixed lines of the source; if those
lines change, the copy step fails and says which. Needs a CUDA device and
nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from gpu_matrix_inversion_tpu_torch.ops import fused
from gpu_matrix_inversion_tpu_torch.utils import cuda_build

OUT = cuda_build.BUILD_DIR.parent / "fused_phases"
PHASES = ("wait", "normalize", "column", "choose", "publish", "update")
# (batch, m, largest C allowed, largest C a small batch grows to)
SHAPES = ((1, 256, 16, 8), (1, 256, 4, 8), (1, 256, 2, 8),
          (512, 256, 16, 8), (1, 512, 16, 8), (1, 512, 16, 16),
          (4, 640, 16, 8))


def _instrumented(block: int, thread: int) -> str:
    """The kernel source with the phase timers of one thread."""
    src = (cuda_build.CSRC / "fused_gj.cu").read_text()

    def insert(anchor: str, code: str, after: bool = True) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"fused_phases: anchor found {src.count(anchor)}"
                             f" times, not once:\n{anchor}")
        src = src.replace(anchor, anchor + code if after else code + anchor)

    insert('#include "gj_regs.cuh"\n',
           "\n__device__ unsigned long long g_phase[8];\n"
           "#define LAP(i) do { if (lap_on) { long long n_ = clock64(); "
           "laps[i] += n_ - lap_t; lap_t = n_; } } while (0)\n")
    insert("  // Reduces each lane's key",
           f"  const bool lap_on = blockIdx.x == {block} && tid == {thread};\n"
           "  long long laps[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
           "  long long lap_t = clock64();\n", after=False)
    insert("    matinv::bar_wait(&bars[par], (t >> 1) & 1);\n", "    LAP(0);\n")
    insert("    __syncwarp();  // read before the lane owning column t "
           "rewrites it\n", "    LAP(1);\n")
    insert("    key = __reduce_max_sync(kFull, key);\n"
           "    if (lane == 0) r[warp] = key;", "    LAP(2);\n", after=False)
    insert("    best = __reduce_max_sync(kFull, lane < kCWarps ? r[lane] : "
           "-1);\n", "    LAP(3);\n")
    insert("      publish(c, tn, best);\n    }\n", "    LAP(4);\n")
    insert("  }\n  __syncthreads();  // order[] complete", "    LAP(5);\n",
           after=False)
    insert("  __syncthreads();  // order[] complete, every row final\n",
           "  if (lap_on) for (int i = 0; i < 8; ++i) "
           "atomicAdd(&g_phase[i], (unsigned long long)laps[i]);\n")
    return src + '''
extern "C" int matinv_phase_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return e;
}
'''


def _build(block: int, thread: int) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    name = f"fused_gj_phases_{block}_{thread}"
    (OUT / f"{name}.cu").write_text(_instrumented(block, thread))
    lib_path = OUT / f"lib{name}.so"
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-I",
         str(cuda_build.CSRC), "-o", str(lib_path), str(OUT / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.matinv_fused_gj.argtypes = list(
        cuda_build.SIGNATURES["matinv_fused_gj"])
    lib.matinv_phase_read.argtypes = [ctypes.c_void_p]
    return lib


def _run(lib, label: str, bsz: int, m: int, cmax: int, grow: int,
         reps: int = 5):
    dev = torch.device("cuda", 0)
    cap = fused.GROW_CLUSTER
    fused.GROW_CLUSTER = grow
    try:
        geo = fused.cluster_geometry(
            m, bsz, cmax, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    finally:
        fused.GROW_CLUSTER = cap
    x = torch.randn(bsz, m, m, device=dev,
                    generator=torch.Generator(dev).manual_seed(m))
    inv = torch.empty_like(x)
    pos = torch.empty((bsz, m), dtype=torch.int32, device=dev)
    ok = torch.empty(bsz, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.matinv_fused_gj(x.data_ptr(), inv.data_ptr(),
                                  pos.data_ptr(), ok.data_ptr(), bsz, m, 1,
                                  0, geo.cluster, geo.smem, stream)
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
    cycles = [counts[i] / reps / m for i in range(len(PHASES))]
    print(f"{label} ({bsz}, {m}^2), C = {geo.cluster} ({geo.rows} rows a "
          f"CTA): {ms:.4f} ms a launch; cycles a step: "
          + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, cycles))
          + f"; sum {sum(cycles):.0f}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for block, thread in ((0, 0), (1, 37)):
        lib = _build(block, thread)
        for bsz, m, cmax, grow in SHAPES:
            _run(lib, f"CTA {block} thread {thread}", bsz, m, cmax, grow)


if __name__ == "__main__":
    main()
