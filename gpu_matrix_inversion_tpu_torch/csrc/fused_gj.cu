// K1: fused swap-free Gauss-Jordan inverse, one thread block per matrix.
//
// Replaces gpu_matrix_inversion_tpu/ops/fused.py:_gj_kernel (launched by
// _fused_batched). Same mathematics, step for step: Gauss-Jordan on the
// augmented (m, 2m) [A | I] system, a used-row mask instead of row swaps,
// the packed-key pivot over unused rows (kmask = next_pow2(m) - 1), one
// normalize + eliminate + deposit pass per step, the pivot position vector
// `pos`, and ok = every pivot nonzero and every output finite. The inverse
// leaves the kernel in pivot-row order; the caller gathers rows by `pos`.
// The normalization is an IEEE division (__fdiv_rn), the elimination
// x - f * v one fmaf (a single rounding, as the JAX package's CPU runs
// compute it); the plain PyTorch twin (ops/fused.py gj_twin) rounds the
// same way. The deposit of the normalized pivot row stays a separate
// select, not folded into the elimination (fused.py:11-20 records the
// cancellation the fold causes).
//
// Two branches. m = 128 (the batched headline shape, and every batched
// call with n <= 128) runs fused_gj_regs_kernel. What bounds it on an H100
// is the per-matrix chain of 128 data-dependent steps and the
// instructions each step issues, not the card's rates: the earlier design
// kept [A | I] (128 KiB) in shared memory, so one block (8 warps) fit an
// SM, each thread ran a serial shared-memory chain down its column for all
// 2m columns, and four block barriers a step left those few warps waiting.
// This one keeps the block in registers in the in-place layout of
// gj_regs.cuh (m live columns: half the updates), 8 warps of 16 rows x 4
// column slots (126 registers a thread, under a launch bound of two
// blocks an SM), and 2 KB of shared memory. So two blocks share an SM and
// hide each other's chains (the GPU form of the reference's `pack`), and
// 4096 matrices take 16 waves instead of 32. A step has two barriers:
// after the first every warp takes the maximum of the warps' best packed
// keys; then the warp that owns row p normalizes it (the only warp that
// divides) and publishes it, and after the second every warp updates its
// rows. Measured against 16 warps of 8 rows and one barrier (each warp
// publishing a candidate row) on an H100 80GB HBM3 at 700 W: 2.02 against
// 2.49 ms for 4096 matrices, as fewer warps repeat the per-warp work of a
// step. The values are the
// shared-memory kernel's bit for bit, up to the sign of a zero.
//
// m = 256 .. 640 runs fused_gj_work_kernel: [A | I] (0.5 to 3.2 MB) lives
// in a global workspace that the caller allocates, each thread owns whole
// columns of it, and each of the m steps reads and writes the whole set
// through L2 (a batch that fills the card streams it from HBM), with the
// pivot-column snapshot, the normalized pivot row and the used-row flags
// in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "gj_regs.cuh"

namespace {

using matinv::gj::kFull;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---- m = 128: the block in registers ------------------------------------

constexpr int kM = 128;
constexpr int kKmask = kM - 1;
constexpr int kW = 8;        // warps; warp w owns rows w + 8 s
constexpr int kR = kM / kW;  // row slots a warp owns
constexpr int kC = 4;        // column slots a lane owns: slot l + 32 q

// Steps 32 Q0 .. 32 Q0 + 31 (column r in slot Q0). keys: a packed key per
// warp; nrow: the normalized pivot row and its pivot (kM + 1 floats), by
// the parity of r; used (lanes < kR): whether row slot `lane` of this warp
// has been a pivot row.
template <int Q0, bool PIVOT>
__device__ __forceinline__ void regs_phase(float (&v)[kR][kC], int* keys,
                                           float* nrows, int* order,
                                           int lane, int warp, int& used,
                                           int& ok) {
  for (int r = 32 * Q0; r < 32 * Q0 + 32; ++r) {
    float f[kR];
    matinv::gj::column<kR, kC, Q0>(v, r, f);
    int p = r;
    if (PIVOT) {
      // The best packed key of each warp's unused rows, then of all.
      const int key = lane < kR
                          ? matinv::pivot_key(matinv::gj::lane_value(f, lane),
                                              used, warp + kW * lane, kKmask)
                          : -1;
      const int wkey = __reduce_max_sync(kFull, key);
      if (lane == 0) keys[warp] = wkey;
      __syncthreads();
      const int k = lane < kW ? keys[lane] : -1;
      p = kKmask - (__reduce_max_sync(kFull, k) & kKmask);
    }
    // The warp that owns row p normalizes it and publishes it. Without
    // pivoting the next step's row comes before any barrier of that step,
    // hence the parity.
    const int pw = p % kW, pslot = p / kW;
    float* nrow = nrows + (r & 1) * (kM + 32);
    float nv[kC];
    if (warp == pw) {
      float u[kC];
      matinv::gj::row(v, pslot, u);
      const float piv = __shfl_sync(kFull, u[Q0], r & 31);
      matinv::gj::normalize<kC, Q0>(u, piv == 0.f ? 1.f : piv, r, lane, nv);
#pragma unroll
      for (int q = 0; q < kC; ++q) nrow[lane + 32 * q] = nv[q];
      if (lane == 0) nrow[kM] = piv;
    }
    __syncthreads();
    ok &= nrow[kM] != 0.f;
    if (warp != pw) {
#pragma unroll
      for (int q = 0; q < kC; ++q) nv[q] = nrow[lane + 32 * q];
    }
    if (PIVOT) used |= warp == pw && lane == pslot;
    if (threadIdx.x == 0) order[r] = p;
    matinv::gj::update<kR, kC, Q0>(v, f, nv, r, lane,
                                   warp == pw ? pslot : -1);
  }
}

template <typename T, bool PIVOT>
__global__ void __launch_bounds__(kW * 32, 2)
fused_gj_regs_kernel(const T* __restrict__ a, T* __restrict__ inv,
                     int* __restrict__ pos, int* __restrict__ ok_out) {
  __shared__ int keys[kW];               // each warp's best packed key
  __shared__ float nrows[2 * (kM + 32)];  // the normalized pivot row
  __shared__ int order[kM];              // each step's pivot row
  const size_t item = blockIdx.x;
  const T* A = a + item * kM * kM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float v[kR][kC];
#pragma unroll
  for (int s = 0; s < kR; ++s)
#pragma unroll
    for (int q = 0; q < kC; ++q)
      v[s][q] = to_f32(A[(warp + kW * s) * kM + lane + 32 * q]);

  int used = 0, ok = 1;
  regs_phase<0, PIVOT>(v, keys, nrows, order, lane, warp, used, ok);
  regs_phase<1, PIVOT>(v, keys, nrows, order, lane, warp, used, ok);
  regs_phase<2, PIVOT>(v, keys, nrows, order, lane, warp, used, ok);
  regs_phase<3, PIVOT>(v, keys, nrows, order, lane, warp, used, ok);
  __syncthreads();  // order[] complete

  // getInvertedMatrix (FP32.cpp:216-226): slot j holds the inverse's
  // column order[j]; rows stay in pivot-row order.
  int col[kC];
#pragma unroll
  for (int q = 0; q < kC; ++q) col[q] = order[lane + 32 * q];
  int finite = 1;
  T* out = inv + item * kM * kM;
#pragma unroll
  for (int s = 0; s < kR; ++s)
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      finite &= isfinite(v[s][q]) ? 1 : 0;
      store(out + (warp + kW * s) * kM + col[q], v[s][q]);
    }
  if (threadIdx.x < kM) pos[item * kM + threadIdx.x] = order[threadIdx.x];
  finite = __syncthreads_and(finite);
  if (threadIdx.x == 0) ok_out[item] = ok && finite;
}

// ---- m = 256 .. 640: [A | I] in a global workspace ------------------------

template <typename T>
__global__ void __launch_bounds__(1024)
fused_gj_work_kernel(const T* __restrict__ a, T* __restrict__ inv,
                     int* __restrict__ pos, int* __restrict__ ok_out,
                     float* __restrict__ work, int m, int pivot, int kmask) {
  // Shared: the pivot-column snapshot (m floats), the normalized pivot row
  // (2m floats), the reduction scratch (40 ints), the used-row flags (m).
  extern __shared__ float4 smem4[];
  const int w2 = 2 * m;
  const size_t item = blockIdx.x;
  const size_t mm = (size_t)m * m;
  float* aug = work + item * (size_t)m * w2;
  float* fac = reinterpret_cast<float*>(smem4);                   // (m,)
  float* norm = fac + m;                                          // (2m,)
  int* red = reinterpret_cast<int*>(norm + w2);                   // 40
  unsigned char* used = reinterpret_cast<unsigned char*>(red + 40);  // (m,)

  const T* A = a + item * mm;
  int* P = pos + item * m;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // makeAugmentedMatrix (reference FP32.cpp:198-215): [A | I].
  for (int i = 0; i < m; ++i)
    for (int j = tid; j < w2; j += nt)
      aug[(size_t)i * w2 + j] =
          j < m ? to_f32(A[(size_t)i * m + j]) : (j - m == i ? 1.f : 0.f);
  for (int i = tid; i < m; i += nt) used[i] = 0;
  __syncthreads();

  int ok = 1;
  for (int r = 0; r < m; ++r) {
    // Snapshot pivot column r (the elimination factors) and pick the pivot.
    int best = -1;
    for (int i = tid; i < m; i += nt) {
      const float v = aug[(size_t)i * w2 + r];
      fac[i] = v;
      if (pivot) best = max(best, matinv::pivot_key(v, used[i], i, kmask));
    }
    int p = r;
    if (pivot)
      p = kmask - (matinv::block_max_int(best, red) & kmask);
    else
      __syncthreads();

    // fixRowKernel (FP32.cpp:150-164): normalize pivot row p.
    const float piv = fac[p];
    ok &= (piv != 0.f);
    const float piv_safe = piv == 0.f ? 1.f : piv;
    for (int j = tid; j < w2; j += nt)
      norm[j] = __fdiv_rn(aug[(size_t)p * w2 + j], piv_safe);
    if (tid == 0) {
      used[p] = 1;
      P[r] = p;
    }
    __syncthreads();

    // fixColumnKernel (FP32.cpp:17-63): eliminate every other row, then
    // deposit the normalized pivot row in row p.
    for (int j = tid; j < w2; j += nt) {
      const float nv = norm[j];
      for (int i = 0; i < m; ++i) {
        float* x = aug + (size_t)i * w2 + j;
        *x = i == p ? nv : fmaf(-fac[i], nv, *x);
      }
    }
    __syncthreads();
  }

  // getInvertedMatrix (FP32.cpp:216-226): the right half, in pivot-row
  // order, with the finite check folded into ok.
  int finite = 1;
  T* out = inv + item * mm;
  for (int i = 0; i < m; ++i)
    for (int j = tid; j < m; j += nt) {
      const float v = aug[(size_t)i * w2 + m + j];
      finite &= isfinite(v) ? 1 : 0;
      store(out + (size_t)i * m + j, v);
    }
  finite = __syncthreads_and(finite);
  if (tid == 0) ok_out[item] = ok && finite;
}

template <typename T>
int launch(const void* a, void* inv, int* pos, int* ok, float* work,
           int batch, int m, int pivot, cudaStream_t stream) {
  const T* in = static_cast<const T*>(a);
  T* out = static_cast<T*>(inv);
  if (m == kM) {
    if (pivot)
      fused_gj_regs_kernel<T, true><<<batch, kW * 32, 0, stream>>>(in, out,
                                                                   pos, ok);
    else
      fused_gj_regs_kernel<T, false><<<batch, kW * 32, 0, stream>>>(in, out,
                                                                    pos, ok);
    return cudaGetLastError();
  }
  if (work == nullptr) return cudaErrorInvalidValue;
  int kmask = 1;
  while (kmask < m) kmask *= 2;
  kmask -= 1;
  // One thread per column of [A | I] up to 1024; wider systems give each
  // thread ceil(2m / 1024) columns.
  const int w2 = 2 * m;
  const int per_thread = (w2 + 1023) / 1024;
  const int threads = ((w2 / per_thread) + 31) / 32 * 32;
  const size_t smem = (size_t)3 * m * sizeof(float) + 40 * sizeof(int) + m;
  fused_gj_work_kernel<T><<<batch, threads, smem, stream>>>(
      in, out, pos, ok, work, m, pivot, kmask);
  return cudaGetLastError();
}

}  // namespace

// a: (batch, m, m) input; inv: (batch, m, m) output in the input type, in
// pivot-row order; pos: (batch, m) int32; ok: (batch,) int32; work: null
// at m = 128, else a (batch, m, 2m) float32 workspace (m a multiple of 128
// up to 640). bf16 != 0 means a and inv hold bfloat16, else float32.
// Returns the cudaError_t of the launch.
extern "C" int matinv_fused_gj(const void* a, void* inv, int* pos, int* ok,
                               float* work, int batch, int m, int pivot,
                               int bf16, void* stream) {
  if (batch < 1 || m < 1 || (m & 127) != 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, inv, pos, ok, work, batch, m, pivot,
                                      st)
              : launch<float>(a, inv, pos, ok, work, batch, m, pivot, st);
}

// Blocks of the m = 128 kernel (fp32, pivoting) that one SM holds at once,
// as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it.
extern "C" int matinv_fused_gj_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_gj_regs_kernel<float, true>, kW * 32, 0);
}
