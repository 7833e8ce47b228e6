// L3: the blocked getrf's panel, an (m, b) strip factored under a used-row
// mask with no row swaps, fp64 or fp32, with or without pivoting.
//
// Replaces the device-side loop of gpu_matrix_inversion_tpu/ops/lu.py:
// _lu_panel (its lax.fori_loop), which reaches no Pallas kernel. The port's
// plain twin (ops/lu.py lu_panel_twin) issues each of its b steps as ~12
// tensor operations from the host. L3 serves lu_factor_blocked for every
// dtype but fp32 (FP64 LU at n >= 256: inverse(method="lu"), solve,
// slogdet and det), and fp32 past m = 65536.
//
// Same operations as the twin, in its order, so (w, pivrows, used, ok)
// equal it bit for bit: step r takes the first maximum of |column r| over
// the unused rows by row index (NaN counted as the maximum, as torch.argmax
// does), or row kb + r without pivoting, marks it used, takes the
// multipliers f = x_r / pivot (IEEE division; a zero pivot divides by 1
// and clears ok) of the unused rows other than the pivot row and 0 on
// every other row, subtracts f * v from the columns > r of every row with
// two roundings (__dmul_rn, __dsub_rn), as the twin's
// `w[:, r + 1:] -= f * w[p, r + 1:]` (so 0 * inf spreads NaN into the used
// rows as there), and deposits f in column r of the eliminated rows. ok =
// every pivot nonzero (the caller checks the factor's finiteness).
//
// What bounds it on an H100: about m b^2 operations (4096 x 128 fp64:
// 67 MFLOP, 2 us at the FP64 peak) or the strip read and written once
// (8.4 MB, 2.5 us); the b steps are a serial chain with a reduction over
// all m rows in each, so the chain's latency bounds it. L2's geometry
// (ops/blocked.py logical_geometry): one persistent grid (at most one CTA
// an SM, a cooperative launch), each CTA's rows in its shared memory where
// they fit and in a device workspace past that, proposals in device
// memory, one grid barrier a step. Measured on an H100 80GB HBM3 at 700 W
// (CUDA events; probes/loop_phases.py for a step): 0.77 ms at (4096, 128)
// fp64 on 128 CTAs, 6.0 us a step (~11,700 cycles: grid barrier ~2,800,
// headers ~3,100, pivot row ~1,100, update ~3,500, proposal ~1,200).
#include <cuda_runtime.h>

#include "gj_loop.cuh"

namespace {

using namespace matinv::loop;

// strip: (m, b) with row stride lds; used: (m,) int32; w: (m, b) output;
// used_out: (m,) int32 output; work: the (m, b) workspace of the rows when
// they do not fit in shared memory; props: (2, g) proposals; bar: one
// unsigned, zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_panel_kernel(const T* __restrict__ strip, int lds,
                const int* __restrict__ used, T* __restrict__ w,
                int* __restrict__ used_out, int* __restrict__ pivrows,
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
  const int ok = run_steps<T, false, true>(comm, jb, pivrows);
  for (size_t idx = threadIdx.x; idx < (size_t)(hi - lo) * b;
       idx += kThreads)
    w[(size_t)lo * b + idx] = v[idx];
  // The twin's mask: used before the panel as given, the pivot rows 1.
  for (int i = threadIdx.x; i < hi - lo; i += kThreads)
    used_out[lo + i] = (state[i] & 2) ? 1 : used[lo + i];
  if (rank == 0 && threadIdx.x == 0) *ok_out = ok;
}

}  // namespace

// strip: (m, b) values with row stride lds (fp64 != 0: double, else
// float); used: (m,) int32, read only; w: (m, b) values, the factored
// panel; used_out: (m,) int32, the mask with this panel's pivot rows set;
// pivrows: (b,) int32; ok: one int32. A persistent grid of `ctas` CTAs
// with work ((m, b) values, unused when rows_shared), props ((2, ctas)
// proposals) and bar (one unsigned, zero); it launches cooperatively.
// smem: the bytes of shared memory a CTA gets (ops/blocked.py
// logical_geometry). Returns the cudaError_t of the launch.
extern "C" int matinv_lu_panel(const void* strip, int lds, const int* used,
                               void* w, int* used_out, int* pivrows, int* ok,
                               void* work, void* props, void* bar, int m,
                               int b, int kb, int fp64, int pivot, int ctas,
                               int rows_shared, int smem, void* stream) {
  const size_t tsize = fp64 ? sizeof(double) : sizeof(float);
  const int rows_per = ctas > 0 ? (m + ctas - 1) / ctas : 0;
  if (m < 1 || b < 1 || lds < b || ctas < 1 || props == nullptr ||
      bar == nullptr || (!rows_shared && work == nullptr) || smem < 0 ||
      (size_t)smem > kMaxShared ||
      (size_t)smem < smem_bytes(rows_per, b, rows_per, (int)tsize,
                                rows_shared, false))
    return cudaErrorInvalidValue;
  const void* kernel =
      fp64 ? reinterpret_cast<const void*>(&lu_panel_kernel<double>)
           : reinterpret_cast<const void*>(&lu_panel_kernel<float>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  char* pr = static_cast<char*>(props);
  unsigned* br = static_cast<unsigned*>(bar);
  void* args[] = {&strip, &lds,  &used, &w,  &used_out, &pivrows,
                  &ok,    &work, &pr,   &br, &m,        &b,
                  &kb,    &pivot, &rows_shared};
  err = launch_grid(kernel, ctas, smem, static_cast<cudaStream_t>(stream),
                    args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
