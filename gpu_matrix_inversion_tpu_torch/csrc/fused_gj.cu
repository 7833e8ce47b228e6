// K1: fused swap-free Gauss-Jordan inverse, one thread block per matrix.
//
// Replaces gpu_matrix_inversion_tpu/ops/fused.py:_gj_kernel (launched by
// _fused_batched). Same mathematics, step for step: the augmented (m, 2m)
// [A | I] system, a used-row mask instead of row swaps, the packed-key
// pivot over unused rows (kmask = next_pow2(m) - 1), one normalize +
// eliminate + deposit pass per step, the pivot position vector `pos`, and
// ok = every pivot nonzero and every output finite. The inverse leaves the
// kernel in pivot-row order; the caller gathers rows by `pos`.
//
// What bounds it on an H100: each of the m serial steps reads and writes
// the whole (m, 2m) working set once, so the kernel is bound by the
// bandwidth of wherever that set lives, plus two block barriers per step.
// The design keeps the set in shared memory when 8*m^2 bytes fit one
// block's 227 KB (m = 128, the batched headline shape), and otherwise in a
// global workspace that the caller allocates (m = 256 .. 640). That set is
// 0.5 to 3.2 MB per matrix, so the 50 MB L2 holds a few matrices' worth;
// a batch that fills the card streams the workspace from HBM. One kernel
// serves both branches: `work == nullptr` selects shared memory.
//
// Each thread owns whole columns of the working set, so the normalized
// pivot-row value of its column stays in a register across the row loop and
// the pivot-column factor is a shared-memory broadcast. The elimination
// x - f * v is one fmaf (a single rounding, as the JAX package's CPU runs
// compute it) and the normalization an IEEE division (__fdiv_rn); the
// plain PyTorch twin (ops/fused.py gj_twin) rounds the same way. The
// deposit of the normalized pivot row stays a separate select, not folded
// into the elimination (fused.py:11-20 records the cancellation the fold
// causes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Bytes of dynamic shared memory besides the working set: the pivot-column
// snapshot (m floats), the normalized pivot row (2m floats), the reduction
// scratch (40 ints) and the used-row flags (m bytes).
size_t side_bytes(int m) {
  return (size_t)3 * m * sizeof(float) + 40 * sizeof(int) + (size_t)m;
}

template <typename T>
__global__ void __launch_bounds__(1024)
fused_gj_kernel(const T* __restrict__ a, T* __restrict__ inv,
                int* __restrict__ pos, int* __restrict__ ok_out,
                float* __restrict__ work, int m, int pivot, int kmask) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w2 = 2 * m;
  const size_t item = blockIdx.x;
  const size_t mm = (size_t)m * m;
  float* aug = work == nullptr ? smem : work + item * (size_t)m * w2;
  float* fac = work == nullptr ? smem + (size_t)m * w2 : smem;  // (m,)
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
           int batch, int m, int pivot, void* stream) {
  if (batch < 1 || m < 1 || (m & 127) != 0) return cudaErrorInvalidValue;
  int kmask = 1;
  while (kmask < m) kmask *= 2;
  kmask -= 1;
  // One thread per column of [A | I] up to 1024; wider systems give each
  // thread ceil(2m / 1024) columns.
  const int w2 = 2 * m;
  const int per_thread = (w2 + 1023) / 1024;
  const int threads = ((w2 / per_thread) + 31) / 32 * 32;
  size_t smem = side_bytes(m);
  if (work == nullptr) smem += (size_t)m * w2 * sizeof(float);
  auto kernel = fused_gj_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(inv), pos, ok, work, m,
      pivot, kmask);
  return cudaGetLastError();
}

}  // namespace

// a: (batch, m, m) input; inv: (batch, m, m) output in the input type, in
// pivot-row order; pos: (batch, m) int32; ok: (batch,) int32; work: null
// for the shared-memory branch, else a (batch, m, 2m) float32 workspace.
// bf16 != 0 means a and inv hold bfloat16, else float32. Returns the
// cudaError_t of the launch.
extern "C" int matinv_fused_gj(const void* a, void* inv, int* pos, int* ok,
                               float* work, int batch, int m, int pivot,
                               int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(a, inv, pos, ok, work, batch, m, pivot,
                                      stream)
              : launch<float>(a, inv, pos, ok, work, batch, m, pivot, stream);
}
