// K2: fused panel factorization of the blocked Gauss-Jordan path.
//
// Replaces gpu_matrix_inversion_tpu/ops/blocked.py:_panel_factor_kernel2
// and its bit-identical twin _panel_factor_kernel with emit_ct=True, called
// through _panel_factor. Given the transposed (b, m) strip of one panel and
// the cross-panel used-row mask, it runs b swap-free packed-key pivot steps
// and emits the pivot rows, the full-panel composite transform C^T (b, m)
// such that X + C @ X[pivrows] applies the whole panel to any columns X,
// and ok (every pivot nonzero, C^T finite). pivot == 0 takes rows kb + r.
//
// Sub-blocked as on the TPU: each step touches a merged (2*sub, m) working
// set (the sub-panel's strip rows and its transform probe rows); later strip
// rows and finished C^T rows get one deferred rank-sub update per sub-panel,
// the two small dots of blocked.py:384-412, computed here with plain FMA
// loops. The first dot (rows @ psel^T) contracts against one-hot rows, so it
// is a gather of each row's values at the sub-panel's pivot lanes; the
// second (g @ C_l^T) is an FMA loop over the sub-panel. `ct` is the output
// and the working buffer at once, as on the TPU.
//
// What bounds it on an H100: one panel's working set does not fit one SM
// (2*sub*m floats: 512 KiB at m = 4096, 2 MiB at m = 16384), and the b
// steps form one serial chain of data-dependent pivot choices. This first
// design is one launch per panel, a single 1024-thread block that runs the b
// steps out of global memory, where L2 holds the working set, with block
// barriers between phases. A step is bound by that one SM's L2 bandwidth
// (one read and one write of the working set) and by its barriers; no host
// round trip or launch sits between steps. Spreading a panel over several
// SMs (a cluster with distributed shared memory, or a cooperative grid) is
// the next step for speed.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxSub = 16;
constexpr int kThreads = 1024;

// Shared memory: the search column (m floats), the gathered pivot-lane
// values g ((b - sub) * sub floats), the normalized pivot column (2*sub
// floats), the sub-panel's pivot lanes (kMaxSub ints), the reduction
// scratch (40 ints) and the used-row flags (m bytes).
size_t smem_bytes(int m, int b, int sub) {
  return ((size_t)m + (size_t)(b - sub) * sub + 2 * sub) * sizeof(float) +
         (kMaxSub + 40) * sizeof(int) + (size_t)m;
}

__global__ void __launch_bounds__(kThreads)
panel_factor_kernel(const float* __restrict__ stripT,
                    const int* __restrict__ used_in, int* __restrict__ pivrows,
                    float* __restrict__ ct, int* __restrict__ ok_out,
                    float* __restrict__ wp, int m, int b, int sub, int kmask,
                    int kb, int pivot) {
  extern __shared__ float4 smem4[];
  float* col = reinterpret_cast<float*>(smem4);   // (m,)
  float* g = col + m;                             // (b - sub, sub)
  float* norm = g + (size_t)(b - sub) * sub;      // (2*sub,)
  int* lanes = reinterpret_cast<int*>(norm + 2 * sub);  // (kMaxSub,)
  int* red = lanes + kMaxSub;                     // 40
  unsigned char* used = reinterpret_cast<unsigned char*>(red + 40);  // (m,)
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int s2 = 2 * sub;

  // The strip enters the C^T buffer, which is the working buffer for the
  // rows not yet eliminated.
  for (size_t idx = tid; idx < (size_t)b * m; idx += nt) ct[idx] = stripT[idx];
  for (int j = tid; j < m; j += nt) used[j] = used_in[j] != 0;
  int ok = 1;  // tracked by thread 0
  __syncthreads();

  for (int r0 = 0; r0 < b; r0 += sub) {
    // Merged working set: rows [0, sub) the sub-panel's strip rows, rows
    // [sub, 2*sub) its transform probe, zero at the start. The first step's
    // search column is strip row r0.
    int best = -1;
    for (int j = tid; j < m; j += nt) {
      for (int k = 0; k < sub; ++k)
        wp[(size_t)k * m + j] = ct[(size_t)(r0 + k) * m + j];
      for (int k = sub; k < s2; ++k) wp[(size_t)k * m + j] = 0.f;
      const float c = ct[(size_t)r0 * m + j];
      col[j] = c;
      if (pivot) best = max(best, matinv::pivot_key(c, used[j], j, kmask));
    }

    for (int r2 = 0; r2 < sub; ++r2) {
      int p = kb + r0 + r2;
      if (pivot)
        p = kmask - (matinv::block_max_int(best, red) & kmask);
      else
        __syncthreads();

      // Pivot column of the working set, with the probe's identity one-hot
      // injected at (sub + r2, p) one step before its own elimination, then
      // normalized by the pivot (strip row r2 at lane p).
      if (tid < s2) {
        float v = wp[(size_t)tid * m + p];
        if (tid == sub + r2) v = __fadd_rn(v, 1.f);
        const float pv = wp[(size_t)r2 * m + p];
        norm[tid] = __fdiv_rn(v, pv == 0.f ? 1.f : pv);
        if (tid == 0) {
          ok &= (pv != 0.f);
          pivrows[r0 + r2] = p;
          lanes[r2] = p;
          used[p] = 1;
        }
      }
      __syncthreads();

      // Rank-1 eliminate every lane but p, deposit the normalized column in
      // lane p, and take the next step's search column (working row r2 + 1)
      // and its keys in the same pass.
      best = -1;
      for (int j = tid; j < m; j += nt) {
        const bool is_p = j == p;
        const float f = col[j];
        float next = 0.f;
        for (int k = 0; k < s2; ++k) {
          float* x = wp + (size_t)k * m + j;
          const float v = is_p ? norm[k] : fmaf(-norm[k], f, *x);
          *x = v;
          if (k == r2 + 1) next = v;
        }
        col[j] = next;
        if (pivot)
          best = max(best, matinv::pivot_key(next, is_p || used[j], j, kmask));
      }
      __syncthreads();
    }

    // Deferred rank-sub update of every C^T-buffer row outside this
    // sub-panel: finished transform rows [0, r0) and later strip rows
    // [r0 + sub, b). First dot: g = rows @ psel^T, the rows' values at the
    // sub-panel's pivot lanes.
    const int nrows = b - sub;
    for (int idx = tid; idx < nrows * sub; idx += nt) {
      const int q = idx / sub;
      const int k = idx - q * sub;
      const int i = q < r0 ? q : q + sub;
      g[idx] = ct[(size_t)i * m + lanes[k]];
    }
    __syncthreads();
    // Second dot: rows += g @ C_l^T with C_l^T = probe - psel; then the
    // sub-panel's own C^T rows land in the rows it just finished.
    for (int j = tid; j < m; j += nt) {
      float ctl[kMaxSub];
#pragma unroll
      for (int k = 0; k < kMaxSub; ++k) {
        if (k < sub) {
          float v = wp[(size_t)(sub + k) * m + j];
          if (j == lanes[k]) v = __fsub_rn(v, 1.f);
          ctl[k] = v;
        }
      }
      for (int q = 0; q < nrows; ++q) {
        const int i = q < r0 ? q : q + sub;
        const float* gq = g + (size_t)q * sub;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxSub; ++k)
          if (k < sub) acc = fmaf(gq[k], ctl[k], acc);
        float* x = ct + (size_t)i * m + j;
        *x = __fadd_rn(*x, acc);
      }
#pragma unroll
      for (int k = 0; k < kMaxSub; ++k)
        if (k < sub) ct[(size_t)(r0 + k) * m + j] = ctl[k];
    }
    __syncthreads();
  }

  int finite = 1;
  for (size_t idx = tid; idx < (size_t)b * m; idx += nt)
    finite &= isfinite(ct[idx]) ? 1 : 0;
  finite = __syncthreads_and(finite);
  if (tid == 0) ok_out[0] = ok && finite;
}

}  // namespace

// stripT: (b, m) float32; used: (m,) int32, nonzero for rows taken by
// earlier panels; pivrows: (b,) int32 out; ct: (b, m) float32 out; ok: (1,)
// int32 out; wp: (2*sub, m) float32 workspace. sub must divide b and be at
// most 16; kmask = next_pow2(m) - 1. Returns the cudaError_t of the launch.
extern "C" int matinv_panel_factor(const float* stripT, const int* used,
                                   int* pivrows, float* ct, int* ok,
                                   float* wp, int m, int b, int sub,
                                   int kmask, int kb, int pivot,
                                   void* stream) {
  if (m < 1 || sub < 1 || sub > kMaxSub || b < sub || b % sub != 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m, b, sub);
  cudaError_t err = cudaFuncSetAttribute(
      panel_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  panel_factor_kernel<<<1, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      stripT, used, pivrows, ct, ok, wp, m, b, sub, kmask, kb, pivot);
  return cudaGetLastError();
}
