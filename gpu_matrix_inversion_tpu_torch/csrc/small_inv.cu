// K4: pivoted Gauss-Jordan inverse of small (b, b) blocks, one thread block
// per block.
//
// Replaces gpu_matrix_inversion_tpu/ops/blocked.py:_small_inv_kernel
// (launched by _invert_small), the split path's pivot-block inverse. Same
// mathematics as its gj_eliminate (ops/fused.py:74-137) on [D | I]: per
// step r the full-precision first maximum of |column r| over rows >= r
// (ties to the lowest row; a NaN never wins, and if every candidate is
// NaN row r stays), a swap of rows r and p, the pivot row normalized by an
// IEEE division, every other row eliminated with one fmaf (x - f * v
// rounds once, as XLA's CPU code contracts it), the normalized row
// deposited in row r. ok = every pivot nonzero and the inverse finite.
// This is not K1's packed key: the split path's small inverse pivots on
// exact magnitudes.
//
// What bounds it on an H100: the work is tiny (an inverse needs 2 b^3
// flops, 4.2 MFLOP at b = 128) and the b steps are a serial chain, so one
// launch (the split path inverts one block at a time) is bound by the
// latency of a step and the instructions its warps issue. The earlier
// design kept [D | I] in shared memory and spent three block barriers a
// step, a pivot search in one warp while the others waited, and a serial
// shared-memory chain over all 2b columns per thread. This one keeps the
// block in registers in the in-place layout of gj_regs.cuh (b live
// columns, not 2b: half the updates), with one block barrier a step: each
// warp finds the best of its own rows by two warp reductions and
// publishes that row and its key, and after the barrier every warp takes
// the winner from the keys. Rows stay where they are: the swap becomes a
// position map (each row's place in the swapped order), and the tie-break
// compares those places, as the swaps would have left them. The slots and
// rows are scattered back to their columns and positions at the end.
// Every element sees the parent's operations in the parent's order, so
// the inverse is the shared-memory kernel's bit for bit, up to the sign of
// a zero. b <= 64 runs 8 warps (8 row slots, 2 column slots a thread);
// b <= 128 runs 16 warps (8 row slots, 4 column slots), which measured
// faster for one block at b = 128 than 8 warps of 16 rows or 32 warps of
// 4 (0.103 against 0.104 and 0.124 ms of device time on an H100 80GB HBM3
// at 700 W).
#include <climits>

#include <cuda_runtime.h>

#include "gj_regs.cuh"

namespace {

using matinv::gj::kFull;

// Steps r in [r0, r1), all with column r in slot Q0. phys (lanes < R):
// the position of row slot `lane` in the swapped order, -1 for rows past
// b and for lanes >= R.
template <int W, int R, int C, int Q0, bool PIVOT>
__device__ __forceinline__ void inv_phase(float (&v)[R][C], float* cand,
                                          int2* keys, int* order, int r0,
                                          int r1, int lane, int warp,
                                          int& phys, int& ok) {
  constexpr int N = 32 * C;
  for (int r = r0; r < r1; ++r) {
    const int buf = r & 1;
    float f[R];
    matinv::gj::column<R, C, Q0>(v, r, f);
    int p = r, p_phys = r;  // the pivot row (its slot in storage), its place
    if (PIVOT) {
      // This warp's candidate: the largest |f| among rows at places >= r
      // (a NaN ranks below every number), ties to the lowest place. The
      // key is (|f| bits, place << 8 | storage row).
      const float x = matinv::gj::lane_value(f, lane);
      const bool live = phys >= r;
      const int hi = !live ? INT_MIN
                           : (isnan(x) ? -1 : __float_as_int(fabsf(x)));
      const int whi = __reduce_max_sync(kFull, hi);
      const int lo =
          live && hi == whi ? (phys << 8) | (warp + W * lane) : INT_MAX;
      const int wlo = __reduce_min_sync(kFull, lo);
      matinv::gj::publish(v, (wlo & 255) / W, cand + (buf * W + warp) * N,
                          lane);
      if (lane == 0) keys[buf * W + warp] = make_int2(whi, wlo);
      __syncthreads();
      const int2 k =
          lane < W ? keys[buf * W + lane] : make_int2(INT_MIN, INT_MAX);
      const int best = __reduce_max_sync(kFull, k.x);
      const int win = __reduce_min_sync(kFull, k.x == best ? k.y : INT_MAX);
      p = win & 255;
      p_phys = win >> 8;
    } else {
      if (warp == r % W)
        matinv::gj::publish(v, r / W, cand + (buf * W + warp) * N, lane);
      __syncthreads();
    }
    const int pw = p % W, pslot = p / W;
    const float* u = cand + (buf * W + pw) * N;
    const float piv = u[r];
    ok &= piv != 0.f;
    // The swap: the pivot row takes place r, the row at place r its place.
    if (PIVOT)
      phys = warp == pw && lane == pslot ? r : (phys == r ? p_phys : phys);
    if (threadIdx.x == 0) order[r] = p;
    float mine[C], nv[C];
#pragma unroll
    for (int q = 0; q < C; ++q) mine[q] = u[lane + 32 * q];
    matinv::gj::normalize<C, Q0>(mine, piv == 0.f ? 1.f : piv, r, lane, nv);
    matinv::gj::update<R, C, Q0>(v, f, nv, r, lane, warp == pw ? pslot : -1);
  }
}

template <int W, int R, int C, bool PIVOT>
__global__ void __launch_bounds__(W * 32)
small_inv_kernel(const float* __restrict__ a, float* __restrict__ inv,
                 int* __restrict__ ok_out, int b) {
  constexpr int N = 32 * C;
  __shared__ float cand[2 * W * N];  // each warp's candidate row, by parity
  __shared__ int2 keys[2 * W];       // and its key
  __shared__ int order[N];           // the storage row of each step's pivot
  const size_t item = blockIdx.x;
  const float* A = a + item * b * b;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Rows and columns past b hold zeros; they are never pivot candidates
  // and never stored.
  float v[R][C];
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = warp + W * s, j = lane + 32 * q;
      v[s][q] = i < b && j < b ? A[(size_t)i * b + j] : 0.f;
    }
  const int own = warp + W * lane;
  int phys = lane < R && own < b ? own : -1;

  int ok = 1;
  inv_phase<W, R, C, 0, PIVOT>(v, cand, keys, order, 0, min(b, 32), lane,
                               warp, phys, ok);
  if constexpr (C > 1)
    inv_phase<W, R, C, 1, PIVOT>(v, cand, keys, order, 32, min(b, 64), lane,
                                 warp, phys, ok);
  if constexpr (C > 2) {
    inv_phase<W, R, C, 2, PIVOT>(v, cand, keys, order, 64, min(b, 96), lane,
                                 warp, phys, ok);
    inv_phase<W, R, C, 3, PIVOT>(v, cand, keys, order, 96, b, lane, warp,
                                 phys, ok);
  }
  __syncthreads();  // order[] complete

  // Row slot s goes to row phys (its place), slot j to the column of step
  // j's pivot row.
  int col[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int j = lane + 32 * q;
    col[q] = j < b ? order[j] : 0;
  }
  int finite = 1;
  float* out = inv + item * b * b;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int row = __shfl_sync(kFull, phys, s);
    if (warp + W * s >= b) continue;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (lane + 32 * q >= b) continue;
      finite &= isfinite(v[s][q]) ? 1 : 0;
      out[(size_t)row * b + col[q]] = v[s][q];
    }
  }
  finite = __syncthreads_and(finite);
  if (threadIdx.x == 0) ok_out[item] = ok && finite;
}

template <int W, int R, int C>
void launch(const float* a, float* inv, int* ok, int batch, int b, int pivot,
            cudaStream_t stream) {
  if (pivot)
    small_inv_kernel<W, R, C, true><<<batch, W * 32, 0, stream>>>(a, inv, ok,
                                                                  b);
  else
    small_inv_kernel<W, R, C, false><<<batch, W * 32, 0, stream>>>(a, inv,
                                                                   ok, b);
}

}  // namespace

// a: (batch, b, b) float32; inv: (batch, b, b) float32 out; ok: (batch,)
// int32 out. 1 <= b <= 128. Returns the cudaError_t of the launch.
extern "C" int matinv_small_inv(const float* a, float* inv, int* ok,
                                int batch, int b, int pivot, void* stream) {
  if (batch < 1 || b < 1 || b > 128) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (b <= 64)
    launch<8, 8, 2>(a, inv, ok, batch, b, pivot, st);
  else
    launch<16, 8, 4>(a, inv, ok, batch, b, pivot, st);
  return cudaGetLastError();
}
