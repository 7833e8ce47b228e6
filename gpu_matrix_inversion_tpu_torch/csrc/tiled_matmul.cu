// K7: the tiled verification GEMM, C = A @ B with an fp32 accumulator.
//
// Replaces gpu_matrix_inversion_tpu/ops/matmul.py:_matmul_kernel, launched by
// _matmul through pallas_matmul: the reference's C8 verification product
// (matrix_multiply.cpp:17-36, one work-item per output element there), which
// the JAX package keeps as a tiled Pallas kernel for parity and to
// cross-check the library GEMM in tests. No inversion path calls it.
//
// Numerics follow the TPU kernel's. fp32 operands: true FP32, one fmaf per
// product (no TF32, which the TPU kernel's HIGHEST precision rules out).
// bf16 operands: widened to fp32, where the product of two bf16 values is
// exact, accumulated in fp32, and the sum rounded once to bf16
// (__float2bfloat16_rn), as one bf16 MXU pass into an fp32 accumulator does.
// The output has A's type.
//
// Design: a plain shared-memory tiled GEMM. Each 256-thread block computes a
// (128, 128) tile of C, walking k through (128, 8) and (8, 128) tiles of A
// and B staged in shared memory (A transposed, so each thread reads its 8
// rows as two float4); each thread accumulates an 8 x 8 sub-tile in
// registers. Loads outside A or B read as zero and stores outside C are
// skipped, so any m, n, k works without host padding. What bounds it: the
// FP32 FMA rate outside the tensor cores (2mnk operations; 67 TFLOP/s on an
// H100 SXM), and for bf16 operands it leaves the tensor cores (989 TFLOP/s)
// unused. wgmma, TMA and a multi-stage pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kTM = 8;
constexpr int kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;  // keeps the transposed A stores off one bank

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* out, float v) { *out = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];  // A tile, transposed
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // Stage the tiles: (kBM, kBK) of A and (kBK, kBN) of B, four values of
    // each per thread, zero outside the operands.
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int i = e / kBK;
      const int kk = e % kBK;
      const int r = row0 + i;
      const int s = k0 + kk;
      as[kk][i] = (r < m && s < k) ? widen(a[(size_t)r * k + s]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBK * kBN / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = e / kBN;
      const int j = e % kBN;
      const int s = k0 + kk;
      const int col = col0 + j;
      bs[kk][j] = (s < k && col < n) ? widen(b[(size_t)s * n + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
      const float4* ap = reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float4* bp = reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 x = ap[h];
        const float4 y = bp[h];
        av[4 * h] = x.x; av[4 * h + 1] = x.y; av[4 * h + 2] = x.z;
        av[4 * h + 3] = x.w;
        bv[4 * h] = y.x; bv[4 * h + 1] = y.y; bv[4 * h + 2] = y.z;
        bv[4 * h + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx * kTN + j;
      if (col < n) narrow(c + (size_t)r * n + col, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  tiled_matmul_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  return cudaGetLastError();
}

}  // namespace

// K7. a: (m, k), b: (k, n), c: (m, n) out, all row-major and of one type:
// float32, or bfloat16 when bf16 != 0. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an empty output or more row tiles than a grid
// holds).
extern "C" int matinv_tiled_matmul(const void* a, const void* b, void* c,
                                   int m, int n, int k, int bf16,
                                   void* stream) {
  if (m < 1 || n < 1 || k < 0 || (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(a, b, c, m, n, k, stream)
              : launch<float>(a, b, c, m, n, k, stream);
}
