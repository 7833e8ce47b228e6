// K5: no-pivot LU of small (b, b) blocks, LAPACK-packed, one thread block
// per block.
//
// Replaces gpu_matrix_inversion_tpu/ops/lu.py:_small_lu_kernel (launched by
// _small_lu), the base case of the blocked getrf: the pivot search (K3) has
// already fixed the row order, so the block factors without pivoting. Per
// step r the multipliers f_i = a_ir / a_rr (IEEE division) of the rows
// below r go to column r below the diagonal, and the trailing block
// a_ij -= f_i a_rj is one fmaf per element (a single rounding, as XLA's CPU
// code contracts the TPU kernel's update). ok = every pivot nonzero and
// every value finite.
//
// What bounds it on an H100: the work is tiny (about 2 b^3 / 3 flops, 1.4
// MFLOP at b = 128) and the b steps are a serial chain, so one launch is
// bound by the latency of a step and the instructions its warps issue. The
// design keeps the whole block in registers: 16 warps, warp w owning rows
// i = w (mod 16) (cyclic, so the shrinking trailing block stays balanced)
// and lane l columns l + 32 q, q < 4; at b = 128 that is 8 x 4 values a
// thread. A step costs one block barrier: the warp that owns row r (final
// since step r - 1) publishes it to a shared buffer (double-buffered by the
// parity of r), and after the barrier every warp takes a_ir of its rows
// from lane r mod 32 by shuffles, divides them lane-parallel (lane s of the
// warp divides for its row slot s, one division a thread), and updates its
// rows with the published row. The steps run in four phases of 32, one per
// column slot q0 = r / 32, each compiled for its q0: rows and columns left
// of the phase are never touched and need no test, and a_ir sits in a
// register known at compile time. Every element sees the same operations in
// the same order whatever the layout (its multiplier by __fdiv_rn, then one
// fmaf per step), so the factor does not depend on how the block is spread
// over threads. The grid has one block per matrix of a
// batch; getrf launches it with one. b <= 128, the largest block the getrf
// geometry hands it.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kRows = 8;   // row slots a warp owns: kWarps * kRows = kMaxB
constexpr int kCols = 4;   // column slots a lane owns: 32 * kCols = kMaxB
constexpr int kMaxB = 128;
constexpr unsigned kFull = 0xffffffffu;

// Steps r in [r0, r1), all in column slot Q0 (32 Q0 <= r < 32 Q0 + 32).
// Rows of slot s < 2 Q0 lie above r and are final; rows of slot s >=
// 2 Q0 + 2 lie below r; slots 2 Q0 and 2 Q0 + 1 straddle it.
template <int Q0>
__device__ __forceinline__ void lu_phase(float (&v)[kRows][kCols],
                                         float (&u)[2][kMaxB], int r0, int r1,
                                         int warp, int lane, int& ok) {
  constexpr int kS0 = 2 * Q0;
  for (int r = r0; r < r1; ++r) {
    float* ur = u[r & 1];
    if (warp == (r % kWarps)) {
      // Publish row r (slot r / 16, which is kS0 or kS0 + 1), columns from
      // slot Q0 on: the only ones later steps read.
      const bool hi = (r / kWarps) & 1;
#pragma unroll
      for (int q = Q0; q < kCols; ++q)
        ur[lane + 32 * q] = hi ? v[kS0 + 1][q] : v[kS0][q];
    }
    __syncthreads();
    const float piv = ur[r];
    ok &= (piv != 0.f);
    const float ps = piv == 0.f ? 1.f : piv;
    float urow[kCols];
#pragma unroll
    for (int q = Q0; q < kCols; ++q) urow[q] = ur[lane + 32 * q];

    // a_ir of each row slot, from lane r mod 32; lane s & 7 divides for
    // slot s; the quotients go back to every lane.
    const int lr = r & 31;
    float air[kRows], f[kRows];
#pragma unroll
    for (int s = kS0; s < kRows; ++s)
      air[s] = __shfl_sync(kFull, v[s][Q0], lr);
    float mine = air[kS0];
#pragma unroll
    for (int s = kS0 + 1; s < kRows; ++s)
      mine = (lane & 7) == s ? air[s] : mine;
    const float fl = __fdiv_rn(mine, ps);
#pragma unroll
    for (int s = kS0; s < kRows; ++s) f[s] = __shfl_sync(kFull, fl, s);

#pragma unroll
    for (int s = kS0; s < kRows; ++s) {
      const bool live = s >= kS0 + 2 || warp + kWarps * s > r;
      // Column slot Q0 holds column r (the multiplier) and the columns
      // either side of it; later slots lie right of r.
      const int j = lane + 32 * Q0;
      const float x = v[s][Q0];
      const float y = j > r ? fmaf(-f[s], urow[Q0], x) : (j == r ? f[s] : x);
      v[s][Q0] = live ? y : x;
#pragma unroll
      for (int q = Q0 + 1; q < kCols; ++q) {
        const float z = fmaf(-f[s], urow[q], v[s][q]);
        v[s][q] = live ? z : v[s][q];
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
small_lu_kernel(const float* __restrict__ a, float* __restrict__ out,
                int* __restrict__ ok_out, int b) {
  __shared__ float u[2][kMaxB];  // the published pivot row, by parity of r
  const size_t item = blockIdx.x;
  const float* A = a + item * b * b;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Rows and columns past b hold zeros (or values derived from them, never
  // read back into the block): no step needs to test for them.
  float v[kRows][kCols];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = warp + kWarps * s;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = lane + 32 * q;
      v[s][q] = (i < b && j < b) ? A[(size_t)i * b + j] : 0.f;
    }
  }

  int ok = 1;
  lu_phase<0>(v, u, 0, min(b, 32), warp, lane, ok);
  lu_phase<1>(v, u, 32, min(b, 64), warp, lane, ok);
  lu_phase<2>(v, u, 64, min(b, 96), warp, lane, ok);
  lu_phase<3>(v, u, 96, b, warp, lane, ok);

  int finite = 1;
  float* o = out + item * b * b;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = warp + kWarps * s;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = lane + 32 * q;
      if (i < b && j < b) {
        finite &= isfinite(v[s][q]) ? 1 : 0;
        o[(size_t)i * b + j] = v[s][q];
      }
    }
  }
  finite = __syncthreads_and(finite);
  if (threadIdx.x == 0) ok_out[item] = ok && finite;
}

}  // namespace

// a: (batch, b, b) float32; out: (batch, b, b) float32, the packed factor
// (unit-lower L strictly below the diagonal, U on and above it); ok:
// (batch,) int32 out. 1 <= b <= 128. Returns the cudaError_t of the launch.
extern "C" int matinv_small_lu(const float* a, float* out, int* ok, int batch,
                               int b, void* stream) {
  if (batch < 1 || b < 1 || b > kMaxB) return cudaErrorInvalidValue;
  small_lu_kernel<<<batch, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, out, ok, b);
  return cudaGetLastError();
}
