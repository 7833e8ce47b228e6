// L5: the spec getrs, x = U^-1 L^-1 P b for (B, n, n) packed factors and
// (B, n, k) right-hand sides, fp64 or fp32.
//
// Replaces the device-side loops of gpu_matrix_inversion_tpu/ops/lu.py:
// _lu_solve_2d (its two lax.fori_loops), which reach no Pallas kernel. The
// port's plain twin (ops/lu.py lu_solve_twin) issues each of its 2 n steps
// as a few tensor operations from the host. L5 serves lu_solve,
// lu_inverse, lu_solve_matrix, refine_solve (every correction of
// solve(..., refine_iters=k) on the LU route) and lu_inverse_refined.
//
// Same operations as the twin in each element's order, so x equals it bit
// for bit: y = P b; forward, y_i = y_i - L_ij * y_j for j = 0 .. i - 1 in
// that order; back, for j = n - 1 .. 0, x_j = y_j / u_jj (IEEE division; a
// zero u_jj divides by 1 and clears ok), then y_i = y_i - U_ij * x_j for
// i < j; each x - f * v rounded twice (__dmul_rn, __dsub_rn; __fmul_rn,
// __fsub_rn in fp32). ok = every u_jj nonzero and x finite. Right-hand
// side columns are independent, and any schedule that keeps each element's
// chain in this order gives the twin's bits: so the steps go in blocks of
// 32. One warp finalizes the block's 32 rows of a column (lane = row, the
// step's value passed by a shuffle), then every thread applies the block's
// 32 updates in order to its (row, column) elements below (forward) or
// above (back), reading L_i,j0:j0+32 contiguously: two block barriers per
// 32 steps instead of one per step.
//
// What bounds it on an H100: 2 n^2 k operations (k = 4096 at n = 4096:
// 137 GFLOP, 2.05 ms at the FP32 peak) or the factor read once (67 MB at
// n = 4096 fp32: 20 us at k = 16). One CTA a (matrix, tile of kc columns),
// kc <= 16 chosen by the wrapper (ops/lu.py lu_solve_geometry) so that the
// card has at least a CTA an SM where the columns allow; y lives in the
// output in device memory (L2-resident at these sizes), each CTA reading
// the whole factor once. At k = 16 the tiles are single columns: 16 CTAs,
// each bound by its chain of 2 n / 32 blocks and its SM's read of the
// factor. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 7):
// 10.4 ms at (1, 4096^2, k = 16), 1.27 us a step, against 2.2 ms for
// torch.linalg.lu_solve; 36.2 ms at k = 4096 (bound 2.05). Staging the
// block's columns in shared memory with whole-line loads, and holding a
// row's 32 values in registers, left both times as they were (timed with
// probes/loop_phases.py): the chain of a few SMs reading the factor's
// 32-column slabs bounds it. More SMs a column tile (a cluster sharing the
// finished values) is the next design.
#include <cuda_runtime.h>

#include "gj_loop.cuh"

namespace {

using matinv::loop::div;
using matinv::loop::kFull;
using matinv::loop::kThreads;
using matinv::loop::kWarps;
using matinv::loop::mul;
using matinv::loop::sub;

constexpr int kBlk = 32;      // steps a block
constexpr int kMaxCols = 16;  // columns a CTA

// lu: (B, n, n); perm: (B, n) int64; b and x: (B, n, k); flags: (B, tiles)
// int32, each CTA's share of ok. CTA item * tiles + t solves columns
// [t kc, t kc + kc) of matrix item.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_solve_kernel(const T* __restrict__ lu, const long long* __restrict__ perm,
                const T* __restrict__ b, T* __restrict__ x,
                int* __restrict__ flags, int n, int k, int kc) {
  __shared__ T yb[kBlk][kMaxCols];  // the block's finished values
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = (k + kc - 1) / kc;
  const size_t item = blockIdx.x / tiles;
  const int col0 = (int)(blockIdx.x - item * tiles) * kc;
  const int nc = min(kc, k - col0);
  const T* a = lu + item * n * n;
  T* y = x + item * n * k + col0;
  const T* rhs = b + item * n * k + col0;
  const long long* pm = perm + item * n;

  for (int idx = tid; idx < n * nc; idx += kThreads) {
    const int i = idx / nc;
    const int c = idx - i * nc;
    y[(size_t)i * k + c] = rhs[(size_t)pm[i] * k + c];
  }
  __syncthreads();

  // Forward: L unit lower.
  for (int j0 = 0; j0 < n; j0 += kBlk) {
    const int bs = min(kBlk, n - j0);
    for (int c = warp; c < nc; c += kWarps) {
      const int i = j0 + lane;
      T v = lane < bs ? y[(size_t)i * k + c] : T(0);
      for (int jj = 0; jj < bs; ++jj) {
        const T vj = __shfl_sync(kFull, v, jj);
        if (lane > jj && lane < bs)
          v = sub(v, mul(a[(size_t)i * n + j0 + jj], vj));
      }
      if (lane < bs) {
        y[(size_t)i * k + c] = v;
        yb[lane][c] = v;
      }
    }
    __syncthreads();
    const int below = n - j0 - bs;
    for (int idx = tid; idx < below * nc; idx += kThreads) {
      const int i = j0 + bs + idx / nc;
      const int c = idx % nc;
      const T* l = a + (size_t)i * n + j0;
      T acc = y[(size_t)i * k + c];
      if (bs == kBlk) {
#pragma unroll
        for (int jj = 0; jj < kBlk; ++jj)
          acc = sub(acc, mul(l[jj], yb[jj][c]));
      } else {
        for (int jj = 0; jj < bs; ++jj)
          acc = sub(acc, mul(l[jj], yb[jj][c]));
      }
      y[(size_t)i * k + c] = acc;
    }
    __syncthreads();
  }

  // Back substitution: U x = y, the blocks from the last.
  for (int j0 = ((n - 1) / kBlk) * kBlk; j0 >= 0; j0 -= kBlk) {
    const int bs = min(kBlk, n - j0);
    for (int c = warp; c < nc; c += kWarps) {
      const int i = j0 + lane;
      T v = lane < bs ? y[(size_t)i * k + c] : T(0);
      for (int jj = bs - 1; jj >= 0; --jj) {
        if (lane == jj) {
          const T u = a[(size_t)i * n + i];
          v = div(v, u == T(0) ? T(1) : u);
        }
        const T xj = __shfl_sync(kFull, v, jj);
        if (lane < jj) v = sub(v, mul(a[(size_t)i * n + j0 + jj], xj));
      }
      if (lane < bs) {
        y[(size_t)i * k + c] = v;
        yb[lane][c] = v;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < j0 * nc; idx += kThreads) {
      const int i = idx / nc;
      const int c = idx % nc;
      const T* u = a + (size_t)i * n + j0;
      T acc = y[(size_t)i * k + c];
      if (bs == kBlk) {
#pragma unroll
        for (int jj = kBlk - 1; jj >= 0; --jj)
          acc = sub(acc, mul(u[jj], yb[jj][c]));
      } else {
        for (int jj = bs - 1; jj >= 0; --jj)
          acc = sub(acc, mul(u[jj], yb[jj][c]));
      }
      y[(size_t)i * k + c] = acc;
    }
    __syncthreads();
  }

  int good = 1;
  for (int i = tid; i < n; i += kThreads)
    good &= a[(size_t)i * n + i] != T(0);
  for (int idx = tid; idx < n * nc; idx += kThreads) {
    const int i = idx / nc;
    good &= isfinite(y[(size_t)i * k + idx - i * nc]) ? 1 : 0;
  }
  good = __syncthreads_and(good);
  if (tid == 0) flags[blockIdx.x] = good;
}

template <typename T>
int launch(const void* lu, const void* perm, const void* b, void* x,
           int* flags, int batch, int n, int k, int kc, cudaStream_t stream) {
  if (batch < 1 || n < 1 || k < 1 || kc < 1 || kc > kMaxCols)
    return cudaErrorInvalidValue;
  const long long ctas = (long long)batch * ((k + kc - 1) / kc);
  if (ctas > 0x7fffffffll) return cudaErrorInvalidValue;
  lu_solve_kernel<T><<<(unsigned)ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(lu), static_cast<const long long*>(perm),
      static_cast<const T*>(b), static_cast<T*>(x), flags, n, k, kc);
  return cudaGetLastError();
}

}  // namespace

// lu: (batch, n, n) packed factors; perm: (batch, n) int64; b: (batch, n,
// k) right-hand sides; x: (batch, n, k) solutions; flags: (batch, tiles)
// int32, tiles = ceil(k / kc), each tile's share of ok; kc: columns a CTA,
// 1 .. 16 (ops/lu.py lu_solve_geometry); fp64 != 0 means double, else
// float. Returns the cudaError_t of the launch.
extern "C" int matinv_lu_solve(const void* lu, const void* perm,
                               const void* b, void* x, int* flags, int batch,
                               int n, int k, int kc, int fp64, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return fp64 ? launch<double>(lu, perm, b, x, flags, batch, n, k, kc, st)
              : launch<float>(lu, perm, b, x, flags, batch, n, k, kc, st);
}
