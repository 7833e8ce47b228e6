// L2: the logical panel's pivot search: the pivot rows and ok of an (m, b)
// strip under a used-row mask, fp64 or fp32, with or without pivoting.
//
// Replaces the device-side loop of gpu_matrix_inversion_tpu/ops/
// blocked.py:_panel_pivots_logical (its lax.fori_loop), which reaches no
// Pallas kernel. The port's plain twin (ops/blocked.py logical_panel_twin)
// issues each of its b steps as ~15 tensor operations from the host. L2
// serves the logical tier: FP64 with pivoting past the f32-search tier
// (b * m > 128 * 8192), FP64 without pivoting from n = 512, fp32 past
// m = 65536 (b = 32).
//
// Same choices as the twin: b Gauss-Jordan steps on the strip, rows never
// move; step r takes the first maximum of |column r| over the unused rows
// (NaN counted as the maximum, as torch.argmax does), or row kb + r
// without pivoting, marks it used, divides it by its pivot (IEEE
// division) and eliminates column r from the other rows with x - f * v
// rounded twice (__dmul_rn, __dsub_rn), as the twin's `w -= col * norm`.
// So its pivot rows and ok equal the twin's. The twin's strip is a scratch
// copy it never returns, so L2 keeps current only what later steps read:
// columns > r of the rows that can still be chosen (gj_loop.cuh). One
// exception follows from that: if every row is used before the panel, the
// twin picks row 0 on its updated values and L2 on stale ones (no route
// gives a panel fewer unused rows than b).
//
// What bounds it on an H100: about m b^2 operations (34 GFLOP-equivalent
// of FMA pairs at (8192, 256) fp64: ~0.5 ms at the FP64 peak) or the strip
// read once (16 MB, ~5 us); the b steps are a serial chain with a
// reduction over all m rows in each, so the chain's latency bounds it. One
// persistent grid (at most one CTA an SM, a cooperative launch), each
// CTA's rows of the strip in its shared memory where they fit (to about
// 132 x 200 KB: (8192, 256) fp64, (65600, 32) fp32) and in a device
// workspace past that (L2-resident to ~50 MB), proposals in device memory,
// one grid barrier a step. Measured on an H100 80GB HBM3 at 700 W
// (probes/loop_phases.py): a step at (8192, 256) fp64 on 131 CTAs takes
// ~14,000 cycles (~7.5 us): the grid barrier ~2,800, the 131 headers
// ~3,000, the pivot row ~1,200, the update ~5,600.
#include <cuda_runtime.h>

#include "gj_loop.cuh"

namespace {

using namespace matinv::loop;

// strip: (m, b) with row stride lds; used: (m,) int32; work: the (m, b)
// workspace of the rows when they do not fit in shared memory; props:
// (2, g) proposals; bar: one unsigned, zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
logical_panel_kernel(const T* __restrict__ strip, int lds,
                     const int* __restrict__ used, int* __restrict__ pivrows,
                     int* __restrict__ ok_out, T* work, char* props,
                     unsigned* bar, int m, int b, int kb, int pivot,
                     int rows_shared) {
  extern __shared__ __align__(16) char smem[];
  const int g = (int)gridDim.x;
  const int rank = (int)blockIdx.x;
  const int rows_per = (m + g - 1) / g;
  const int lo = min(m, rank * rows_per);
  const int hi = min(m, lo + rows_per);
  size_t off = 0;
  T* v = rows_shared ? reinterpret_cast<T*>(smem) : work + (size_t)lo * b;
  if (rows_shared) off += align16((size_t)rows_per * b * sizeof(T));
  T* nr = reinterpret_cast<T*>(smem + off);
  off += align16((size_t)b * sizeof(T));
  int* state = reinterpret_cast<int*>(smem + off);
  off += align16((size_t)rows_per * sizeof(int));
  Cand* red = reinterpret_cast<Cand*>(smem + off);

  for (size_t idx = threadIdx.x; idx < (size_t)(hi - lo) * b;
       idx += kThreads) {
    const size_t i = idx / b;
    v[idx] = strip[(lo + i) * lds + (idx - i * b)];
  }
  for (int i = threadIdx.x; i < hi - lo; i += kThreads)
    state[i] = used[lo + i] != 0 ? 1 : 0;
  __syncthreads();

  GridComm comm{props, prop_bytes(b, sizeof(T)), bar, nullptr, g, rank};
  Job<T> jb;
  jb.v = v;
  jb.lo = lo;
  jb.hi = hi;
  jb.rows_per = rows_per;
  jb.w = b;
  jb.steps = b;
  jb.pivot = pivot;
  jb.nr = nr;
  jb.red = red;
  jb.pos_of = jb.phys_at = jb.order = nullptr;
  jb.state = state;
  jb.kb = kb;
  const int ok = run_steps<T, false>(comm, jb, pivrows);
  if (rank == 0 && threadIdx.x == 0) *ok_out = ok;
}

}  // namespace

// strip: (m, b) values with row stride lds (fp64 != 0: double, else
// float); used: (m,) int32, read only; pivrows: (b,) int32; ok: one int32.
// A persistent grid of `ctas` CTAs with work ((m, b) values, unused when
// rows_shared), props ((2, ctas) proposals) and bar (one unsigned, zero);
// it launches cooperatively. smem: the bytes of shared memory a CTA gets
// (ops/blocked.py logical_geometry). Returns the cudaError_t of the
// launch.
extern "C" int matinv_logical_panel(const void* strip, int lds,
                                    const int* used, int* pivrows, int* ok,
                                    void* work, void* props, void* bar, int m,
                                    int b, int kb, int fp64, int pivot,
                                    int ctas, int rows_shared, int smem,
                                    void* stream) {
  const size_t tsize = fp64 ? sizeof(double) : sizeof(float);
  const int rows_per = ctas > 0 ? (m + ctas - 1) / ctas : 0;
  if (m < 1 || b < 1 || lds < b || ctas < 1 || props == nullptr ||
      bar == nullptr || (!rows_shared && work == nullptr) || smem < 0 ||
      (size_t)smem > kMaxShared ||
      (size_t)smem < smem_bytes(rows_per, b, rows_per, (int)tsize,
                                rows_shared, false))
    return cudaErrorInvalidValue;
  const void* kernel =
      fp64 ? reinterpret_cast<const void*>(&logical_panel_kernel<double>)
           : reinterpret_cast<const void*>(&logical_panel_kernel<float>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  char* pr = static_cast<char*>(props);
  unsigned* br = static_cast<unsigned*>(bar);
  void* args[] = {&strip, &lds, &used, &pivrows, &ok,
                  &work, &pr, &br, &m, &b, &kb, &pivot, &rows_shared};
  err = launch_grid(kernel, ctas, smem, static_cast<cudaStream_t>(stream),
                    args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
