// K2, K3 and K6: the panel kernels of the blocked Gauss-Jordan path.
//
// K2 (fused panel factorization) replaces
// gpu_matrix_inversion_tpu/ops/blocked.py:_panel_factor_kernel2 and its
// bit-identical twin _panel_factor_kernel with emit_ct=True, called through
// _panel_factor. Given the transposed (b, m) strip of one panel and the
// cross-panel used-row mask, it runs b swap-free packed-key pivot steps and
// emits the pivot rows, the full-panel composite transform C^T (b, m) such
// that X + C @ X[pivrows] applies the whole panel to any columns X, and ok
// (every pivot nonzero, C^T finite). pivot == 0 takes rows kb + r.
//
// K3 (pivot search) replaces the same bodies with emit_ct=False, called
// through _pivot_search (blocked.py:556-593): the same steps, emitting only
// the pivot rows. It keeps the probe rows (later strip rows still receive
// the deferred update X + C_l @ X[lanes]) and drops the update of finished
// C^T rows, the C^T output and ok. It takes fp32 or bf16 strips. A bf16
// strip computes as the TPU kernel's bf16 code does under XLA's CPU
// backend: every operation in fp32, rounded to bf16 after each one, no
// contraction; the deferred dot accumulates exact bf16 products in fp32 and
// rounds the sum to bf16 before the add. fp32 rounds as K2 does. K3 is a
// template on the strip's type beside K2's own fp32 body: with K2 built
// from the same template, ptxas spilled more of K2's registers (60 bytes of
// spill loads against 32) and K2 took 1.2% longer per panel on an H100.
//
// Sub-blocked as on the TPU: each step touches a merged (2*sub, m) working
// set (the sub-panel's strip rows and its transform probe rows); later strip
// rows (and, for K2, finished C^T rows) get one deferred rank-sub update per
// sub-panel, the two small dots of blocked.py:384-412, computed here with
// plain FMA loops. The first dot (rows @ psel^T) contracts against one-hot
// rows, so it is a gather of each row's values at the sub-panel's pivot
// lanes; the second (g @ C_l^T) is an FMA loop over the sub-panel. `ct`
// (K2) and `w` (K3) are the working buffer for the strip rows not yet
// eliminated; K2's is also its output, as on the TPU.
//
// K6 (lockstep panel factor) replaces
// gpu_matrix_inversion_tpu/ops/lockstep.py:_lockstep_factor_kernel, called
// through _panel_factor_lockstep: K2's outputs for one panel of each of k
// matrices, in one launch. The TPU kernel merged the k matrices into one
// (k, 2*sub, m) working set, since one TensorCore runs one program at a
// time; here K2's kernel runs with a grid of k blocks, one per matrix, so
// the k serial step chains advance on k SMs at once. The contract is the
// reference's (tests/test_lockstep.py): each matrix's outputs equal, bit for
// bit, those of K2 run on that matrix alone.
//
// What bounds it on an H100: one panel's working set does not fit one SM
// (2*sub*m values: 512 KiB at m = 4096 in fp32, 2 MiB at m = 65536 in
// bf16), and the b steps form one serial chain of data-dependent pivot
// choices. This first design is one launch per panel, a single 1024-thread
// block that runs the b steps out of global memory, where L2 holds the
// working set, with block barriers between phases. A step is bound by that
// one SM's L2 bandwidth (one read and one write of the working set) and by
// its barriers; no host round trip or launch sits between steps. Shared
// memory holds the search column and the used flags (m values + m bytes:
// 192 KiB at m = 65536 in bf16, the split path's largest panel), so K3
// serves every m the gates admit. Spreading a panel over several SMs (a
// cluster with distributed shared memory, or a cooperative grid) is the
// next step for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxSub = 16;
constexpr int kThreads = 1024;
constexpr size_t kMaxShared = 232448;  // one block's dynamic shared memory

// Arithmetic on a working-set element type. fp32: x - n*f is one fmaf, as
// XLA's CPU code contracts the TPU kernel's f32 update. bf16: each
// operation rounds to bf16 (the products of two bf16 values are exact in
// fp32; the intrinsics keep the compiler from contracting).
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float elim(float x, float n, float f) {
    return fmaf(-n, f, x);
  }
};

template <>
struct Arith<__nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float elim(float x, float n, float f) {
    return rnd(__fsub_rn(x, rnd(__fmul_rn(n, f))));
  }
};

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared memory: the search column (m values of T), the gathered pivot-lane
// values g ((b - sub) * sub floats), the normalized pivot column (2*sub
// floats), the sub-panel's pivot lanes (kMaxSub ints), the reduction
// scratch (40 ints) and the used-row flags (m bytes).
size_t smem_bytes(int m, int b, int sub, size_t elt) {
  return round16((size_t)m * elt) +
         ((size_t)(b - sub) * sub + 2 * sub) * sizeof(float) +
         (kMaxSub + 40) * sizeof(int) + (size_t)m;
}

// K2: fp32, pivoting or not (pivot == 0 takes rows kb + r); emits C^T
// and ok. kLockstep (K6) runs it on k matrices at once, block i on matrix
// i's strip, mask, outputs and workspace: the same step chain, so each
// matrix gets what K2 gives it alone. The batch offsets exist only in that
// instantiation, so K2's own code is unchanged by it; K2 does not launch
// K6 with one block, because the offsets make ptxas spill more and that
// launch runs slower (PERF.md).
template <bool kLockstep>
__global__ void __launch_bounds__(kThreads)
panel_factor_kernel(const float* __restrict__ stripT,
                    const int* __restrict__ used_in, int* __restrict__ pivrows,
                    float* __restrict__ ct, int* __restrict__ ok_out,
                    float* __restrict__ wp, int m, int b, int sub, int kmask,
                    int kb, int pivot) {
  if constexpr (kLockstep) {
    const size_t item = blockIdx.x;
    stripT += item * b * m;
    used_in += item * m;
    pivrows += item * b;
    ct += item * b * m;
    ok_out += item;
    wp += item * 2 * sub * m;
  }
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

// K3: K2's steps on a strip of T, always pivoting, emitting only the pivot
// rows; the deferred update reaches the later strip rows only.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pivot_search_kernel(const T* __restrict__ stripT,
                    const int* __restrict__ used_in, int* __restrict__ pivrows,
                    T* __restrict__ w, T* __restrict__ wp, int m, int b,
                    int sub, int kmask) {
  using A = Arith<T>;
  extern __shared__ float4 smem4[];
  T* col = reinterpret_cast<T*>(smem4);                              // (m,)
  float* g = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                      round16((size_t)m * sizeof(T)));
  float* norm = g + (size_t)(b - sub) * sub;                     // (2*sub,)
  int* lanes = reinterpret_cast<int*>(norm + 2 * sub);          // (kMaxSub,)
  int* red = lanes + kMaxSub;                                    // 40
  unsigned char* used = reinterpret_cast<unsigned char*>(red + 40);  // (m,)
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int s2 = 2 * sub;
  const T zero = A::put(0.f);

  for (size_t idx = tid; idx < (size_t)b * m; idx += nt) w[idx] = stripT[idx];
  for (int j = tid; j < m; j += nt) used[j] = used_in[j] != 0;
  __syncthreads();

  for (int r0 = 0; r0 < b; r0 += sub) {
    int best = -1;
    for (int j = tid; j < m; j += nt) {
      for (int k = 0; k < sub; ++k)
        wp[(size_t)k * m + j] = w[(size_t)(r0 + k) * m + j];
      for (int k = sub; k < s2; ++k) wp[(size_t)k * m + j] = zero;
      const T c = w[(size_t)r0 * m + j];
      col[j] = c;
      best = max(best, matinv::pivot_key(A::get(c), used[j], j, kmask));
    }

    for (int r2 = 0; r2 < sub; ++r2) {
      const int p = kmask - (matinv::block_max_int(best, red) & kmask);
      if (tid < s2) {
        float v = A::get(wp[(size_t)tid * m + p]);
        if (tid == sub + r2) v = A::rnd(__fadd_rn(v, 1.f));
        const float pv = A::get(wp[(size_t)r2 * m + p]);
        norm[tid] = A::rnd(__fdiv_rn(v, pv == 0.f ? 1.f : pv));
        if (tid == 0) {
          pivrows[r0 + r2] = p;
          lanes[r2] = p;
          used[p] = 1;
        }
      }
      __syncthreads();

      best = -1;
      for (int j = tid; j < m; j += nt) {
        const bool is_p = j == p;
        const float f = A::get(col[j]);
        float next = 0.f;
        for (int k = 0; k < s2; ++k) {
          T* x = wp + (size_t)k * m + j;
          const float v = is_p ? norm[k] : A::elim(A::get(*x), norm[k], f);
          *x = A::put(v);
          if (k == r2 + 1) next = v;
        }
        col[j] = A::put(next);
        best = max(best, matinv::pivot_key(next, is_p || used[j], j, kmask));
      }
      __syncthreads();
    }

    // Deferred rank-sub update of the later strip rows [r0 + sub, b):
    // g = rows @ psel^T (a gather), then rows += g @ C_l^T.
    const int nrows = b - sub - r0;
    for (int idx = tid; idx < nrows * sub; idx += nt) {
      const int q = idx / sub;
      const int k = idx - q * sub;
      g[idx] = A::get(w[(size_t)(r0 + sub + q) * m + lanes[k]]);
    }
    __syncthreads();
    for (int j = tid; j < m; j += nt) {
      float ctl[kMaxSub];
#pragma unroll
      for (int k = 0; k < kMaxSub; ++k) {
        if (k < sub) {
          float v = A::get(wp[(size_t)(sub + k) * m + j]);
          if (j == lanes[k]) v = A::rnd(__fsub_rn(v, 1.f));
          ctl[k] = v;
        }
      }
      for (int q = 0; q < nrows; ++q) {
        const float* gq = g + (size_t)q * sub;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxSub; ++k)
          if (k < sub) acc = fmaf(gq[k], ctl[k], acc);
        T* x = w + (size_t)(r0 + sub + q) * m + j;
        *x = A::put(__fadd_rn(A::get(*x), A::rnd(acc)));
      }
    }
    __syncthreads();
  }
}

// Checks the geometry (sub divides b and is at most kMaxSub) and one
// block's shared memory, and sets the kernel's; returns the bytes in smem.
cudaError_t configure(const void* kernel, int m, int b, int sub, size_t elt,
                      size_t* smem) {
  if (m < 1 || sub < 1 || sub > kMaxSub || b < sub || b % sub != 0)
    return cudaErrorInvalidValue;
  *smem = smem_bytes(m, b, sub, elt);
  if (*smem > kMaxShared) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T>
int launch_search(const void* stripT, const int* used, int* pivrows, void* w,
                  void* wp, int m, int b, int sub, int kmask, void* stream) {
  size_t smem;
  cudaError_t err =
      configure(reinterpret_cast<const void*>(&pivot_search_kernel<T>), m, b,
                sub, sizeof(T), &smem);
  if (err != cudaSuccess) return err;
  pivot_search_kernel<T><<<1, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(stripT), used, pivrows, static_cast<T*>(w),
      static_cast<T*>(wp), m, b, sub, kmask);
  return cudaGetLastError();
}

}  // namespace

// K2. stripT: (b, m) float32; used: (m,) int32, nonzero for rows taken by
// earlier panels; pivrows: (b,) int32 out; ct: (b, m) float32 out; ok: (1,)
// int32 out; wp: (2*sub, m) float32 workspace. sub must divide b and be at
// most 16; kmask = next_pow2(m) - 1. Returns the cudaError_t of the launch.
extern "C" int matinv_panel_factor(const float* stripT, const int* used,
                                   int* pivrows, float* ct, int* ok,
                                   float* wp, int m, int b, int sub,
                                   int kmask, int kb, int pivot,
                                   void* stream) {
  size_t smem;
  cudaError_t err =
      configure(reinterpret_cast<const void*>(&panel_factor_kernel<false>), m,
                b, sub, sizeof(float), &smem);
  if (err != cudaSuccess) return err;
  panel_factor_kernel<false><<<1, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      stripT, used, pivrows, ct, ok, wp, m, b, sub, kmask, kb, pivot);
  return cudaGetLastError();
}

// K6. K2 on k matrices, one block each: stripT (k, b, m) float32, matrix
// i's transposed strip at [i]; used (k, m) int32; pivrows (k, b) int32
// out; ct (k, b, m) float32 out; ok (k,) int32 out; wp (k, 2*sub, m)
// float32 workspace. sub, kmask and kb as for K2 (kb is the same for every
// matrix). Returns the cudaError_t of the launch.
extern "C" int matinv_lockstep_factor(const float* stripT, const int* used,
                                      int* pivrows, float* ct, int* ok,
                                      float* wp, int k, int m, int b, int sub,
                                      int kmask, int kb, int pivot,
                                      void* stream) {
  if (k < 1) return cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err =
      configure(reinterpret_cast<const void*>(&panel_factor_kernel<true>), m,
                b, sub, sizeof(float), &smem);
  if (err != cudaSuccess) return err;
  panel_factor_kernel<true><<<k, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      stripT, used, pivrows, ct, ok, wp, m, b, sub, kmask, kb, pivot);
  return cudaGetLastError();
}

// K3. stripT: (b, m) float32, or bfloat16 when bf16 != 0; used, pivrows,
// sub and kmask as for K2; w: (b, m) and wp: (2*sub, m) workspaces of the
// strip's type. Always pivots. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue when the shared memory for m exceeds one block's).
extern "C" int matinv_pivot_search(const void* stripT, const int* used,
                                   int* pivrows, void* w, void* wp, int m,
                                   int b, int sub, int kmask, int bf16,
                                   void* stream) {
  return bf16 ? launch_search<__nv_bfloat16>(stripT, used, pivrows, w, wp, m,
                                             b, sub, kmask, stream)
              : launch_search<float>(stripT, used, pivrows, w, wp, m, b, sub,
                                     kmask, stream);
}
