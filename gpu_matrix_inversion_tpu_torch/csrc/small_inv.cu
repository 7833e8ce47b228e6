// K4: pivoted Gauss-Jordan inverse of small (b, b) blocks, one thread block
// per block.
//
// Replaces gpu_matrix_inversion_tpu/ops/blocked.py:_small_inv_kernel
// (launched by _invert_small), the split path's pivot-block inverse. Same
// mathematics as its gj_eliminate (ops/fused.py:74-137) on [D | I]: per
// step r the full-precision first maximum of |column r| over rows >= r
// (ties to the lowest row), a real swap of rows r and p, the pivot row
// normalized by an IEEE division, every other row eliminated with one fmaf
// (x - f * v rounds once, as XLA's CPU code contracts it), the normalized
// row deposited in row r. ok = every pivot nonzero and the inverse finite.
// This is not K1's packed key: the split path's small inverse pivots on
// exact magnitudes.
//
// What bounds it on an H100: the work is tiny (an inverse needs 2 b^3
// flops, 4.2 MFLOP at b = 128; Gauss-Jordan on [D | I] does twice that)
// and the b steps are a serial chain, so one launch is bound by
// latency: three block barriers per step and the column reduction in one
// warp. The design keeps [D | I] (2 b^2 floats, 128 KiB at b = 128) in one
// block's shared memory for the whole chain, one thread per column of
// [D | I], so no step touches global memory. The grid has one block per
// matrix of a batch; the split path launches it with one.
#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxShared = 232448;

size_t smem_bytes(int b) {
  return ((size_t)2 * b * b + 3 * (size_t)b + 1) * sizeof(float) +
         sizeof(int);
}

__global__ void __launch_bounds__(256)
small_inv_kernel(const float* __restrict__ a, float* __restrict__ inv,
                 int* __restrict__ ok_out, int b, int pivot) {
  extern __shared__ float4 smem4[];
  const int w2 = 2 * b;
  float* aug = reinterpret_cast<float*>(smem4);  // (b, 2b)
  float* fac = aug + (size_t)b * w2;             // (b,) elimination factors
  float* norm = fac + b;                         // (2b,) normalized row
  float* piv_val = norm + w2;                    // the pivot's value
  int* piv_row = reinterpret_cast<int*>(piv_val + 1);
  const size_t item = blockIdx.x;
  const float* A = a + item * b * b;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;

  for (int i = 0; i < b; ++i)
    for (int j = tid; j < w2; j += nt)
      aug[(size_t)i * w2 + j] =
          j < b ? A[(size_t)i * b + j] : (j - b == i ? 1.f : 0.f);
  __syncthreads();

  int ok = 1;
  for (int r = 0; r < b; ++r) {
    if (tid < 32) {
      // First max of |aug[i][r]| over rows i >= r, in one warp. A row with
      // a NaN never wins; if every candidate is NaN, row r stays (ok then
      // fails on the non-finite result, as in the reference).
      float best = -1.f;
      int bi = r;
      for (int i = r + lane; i < b; i += 32) {
        const float v = fabsf(aug[(size_t)i * w2 + r]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        const int pr = pivot ? bi : r;
        *piv_row = pr;
        *piv_val = aug[(size_t)pr * w2 + r];
      }
    }
    __syncthreads();
    // The pivot's value comes from shared memory, not from aug: the swap
    // below overwrites aug[p][r] while other warps may still be reading.
    const int p = *piv_row;
    const float piv = *piv_val;
    ok &= (piv != 0.f);
    const float ps = piv == 0.f ? 1.f : piv;

    // pivotElementsKernel + fixRowKernel: row p takes row r, the normalized
    // old row p goes to `norm`; the factors are column r after the swap,
    // zero at row r. Each thread reads and writes row p only in its own
    // columns, and fac reads column r of rows other than p (row p's factor
    // is row r's value), so the phase needs no barrier inside.
    for (int j = tid; j < w2; j += nt) {
      const float vp = aug[(size_t)p * w2 + j];
      aug[(size_t)p * w2 + j] = aug[(size_t)r * w2 + j];
      norm[j] = __fdiv_rn(vp, ps);
    }
    for (int i = tid; i < b; i += nt)
      fac[i] = i == r ? 0.f
                      : (i == p ? aug[(size_t)r * w2 + r]
                                : aug[(size_t)i * w2 + r]);
    __syncthreads();

    // fixColumnKernel: eliminate every row, deposit the normalized row in r.
    for (int j = tid; j < w2; j += nt) {
      const float nv = norm[j];
      for (int i = 0; i < b; ++i) {
        float* x = aug + (size_t)i * w2 + j;
        *x = i == r ? nv : fmaf(-fac[i], nv, *x);
      }
    }
    __syncthreads();
  }

  int finite = 1;
  float* out = inv + item * b * b;
  for (int i = 0; i < b; ++i)
    for (int j = tid; j < b; j += nt) {
      const float v = aug[(size_t)i * w2 + b + j];
      finite &= isfinite(v) ? 1 : 0;
      out[(size_t)i * b + j] = v;
    }
  finite = __syncthreads_and(finite);
  if (tid == 0) ok_out[item] = ok && finite;
}

}  // namespace

// a: (batch, b, b) float32; inv: (batch, b, b) float32 out; ok: (batch,)
// int32 out. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// when [D | I] does not fit one block's shared memory).
extern "C" int matinv_small_inv(const float* a, float* inv, int* ok,
                                int batch, int b, int pivot, void* stream) {
  if (batch < 1 || b < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(b);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      small_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = 2 * b >= 256 ? 256 : (2 * b + 31) / 32 * 32;
  small_inv_kernel<<<batch, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a, inv, ok, b,
                                                          pivot);
  return cudaGetLastError();
}
