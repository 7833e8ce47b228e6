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
// bound by latency: two block barriers per step. The design keeps the block
// (b^2 floats, 64 KiB at b = 128) in one block's shared memory for the
// whole chain, one thread per column, so no step touches global memory.
// The grid has one block per matrix of a batch; getrf launches it with one.
#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxShared = 232448;

size_t smem_bytes(int b) { return ((size_t)b * b + b) * sizeof(float); }

__global__ void __launch_bounds__(256)
small_lu_kernel(const float* __restrict__ a, float* __restrict__ out,
                int* __restrict__ ok_out, int b) {
  extern __shared__ float4 smem4[];
  float* lu = reinterpret_cast<float*>(smem4);  // (b, b)
  float* fac = lu + (size_t)b * b;              // (b,) multipliers
  const size_t item = blockIdx.x;
  const float* A = a + item * b * b;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (size_t idx = tid; idx < (size_t)b * b; idx += nt) lu[idx] = A[idx];
  __syncthreads();

  int ok = 1;
  for (int r = 0; r < b; ++r) {
    const float piv = lu[(size_t)r * b + r];
    ok &= (piv != 0.f);
    const float ps = piv == 0.f ? 1.f : piv;
    for (int i = r + 1 + tid; i < b; i += nt)
      fac[i] = __fdiv_rn(lu[(size_t)i * b + r], ps);
    __syncthreads();
    // Eliminate the trailing columns; deposit the multipliers in column r.
    for (int j = r + tid; j < b; j += nt) {
      const float v = lu[(size_t)r * b + j];
      for (int i = r + 1; i < b; ++i) {
        float* x = lu + (size_t)i * b + j;
        *x = j == r ? fac[i] : fmaf(-fac[i], v, *x);
      }
    }
    __syncthreads();
  }

  int finite = 1;
  float* o = out + item * b * b;
  for (size_t idx = tid; idx < (size_t)b * b; idx += nt) {
    finite &= isfinite(lu[idx]) ? 1 : 0;
    o[idx] = lu[idx];
  }
  finite = __syncthreads_and(finite);
  if (tid == 0) ok_out[item] = ok && finite;
}

}  // namespace

// a: (batch, b, b) float32; out: (batch, b, b) float32, the packed factor
// (unit-lower L strictly below the diagonal, U on and above it); ok:
// (batch,) int32 out. Returns the cudaError_t of the launch.
extern "C" int matinv_small_lu(const float* a, float* out, int* ok, int batch,
                               int b, void* stream) {
  if (batch < 1 || b < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(b);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      small_lu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = b >= 256 ? 256 : (b + 31) / 32 * 32;
  small_lu_kernel<<<batch, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(a, out, ok, b);
  return cudaGetLastError();
}
