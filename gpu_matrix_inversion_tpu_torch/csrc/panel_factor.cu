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
// rounds the sum to bf16 before the add. fp32 rounds as K2 does. K2 and K3
// are one cluster body, a template on the strip's type and on whether it
// emits C^T.
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
// time; here the launch is k clusters of K2's body, cluster i on matrix i
// (a grid of k * C CTAs), so the k serial step chains advance on k * C
// SMs at once; K2 is its k = 1 case. A k past the clusters the card holds
// at once runs in waves. The contract is the reference's
// (tests/test_lockstep.py): each matrix's outputs equal, bit for bit, those
// of K2 run on that matrix alone, which holds by construction.
//
// What bounds them on an H100. A panel's working set does not fit one SM
// (2*sub*m values: 512 KiB at m = 4096 in fp32, 2 MiB at m = 65536 in
// bf16), and the b steps form one serial chain of data-dependent pivot
// choices. One block a panel, running the steps out of L2, takes 37 us a
// step at m = 4096 and 135 us at m = 20032 in bf16 while 131 SMs idle.
//
// K2 and K3 run each panel as one thread-block cluster of C CTAs on C
// SMs (C = 16 where the runtime admits a cluster of 16, else the portable
// 8; fewer for a small m, so that a CTA keeps at least 128 lanes; each CTA
// asks at least 120 KiB of shared memory, so no two share an SM). The m
// lanes (the strip's columns) are cut into C contiguous slices of
// L = ceil(m / C); each CTA keeps its slice of the working set wp
// (2*sub, L), of the strip rows (b, L) -- K2's C^T buffer, K3's later
// rows -- and of the used flags in its own shared memory, where they fit
// (the wrapper's geometry decides; a slice that does not fit stays in
// global memory, a template parameter, same code). A pivot step is:
// eliminate the CTA's own lanes and take the next step's packed keys in
// the same pass; reduce the keys to the CTA's best (one block barrier);
// store that key and the 2*sub values of its lane into slot [rank] of
// every CTA of the cluster (st.async, 16 bytes a store, each completing on
// the receiving CTA's mbarrier; two slot sets and barriers, by step
// parity); then every CTA waits on its own barrier until all C slots have
// landed, and every warp takes the largest key and normalizes the
// winner's column from its own shared memory. That exchange is the step's
// one cluster-wide barrier: no CTA passes it before every CTA has
// published. It is not cooperative_groups' cluster.sync(), which compiles
// to a GPU-scope fence, the cluster barrier and an L1 invalidation
// (MEMBAR.ALL.GPU, UCGABAR, CCTL.IVALL): ~2,400 cycles a step against
// ~900 for the exchange (H100, probes/panel_phases.py, PERF.md). Once per
// sub-panel the CTAs that own its pivot lanes push the rows' values at
// those lanes (the first dot's gather) into every CTA, one cluster.sync()
// follows, and each CTA applies the rank-sub update to its own lanes. So
// a step costs one cluster-wide exchange, one block barrier and a pass
// over 2*sub*L values out of shared memory: the exchange's latency, the
// block reduction and the pass's dependent shared-memory round trips
// bound it now. The bits do not move: a max of packed keys is exact in any
// order, and each element's update chain stays in one thread, in the same
// order, with the same intrinsics, so K2's and K3's outputs are
// byte-identical to the one-block kernels' whatever C is (and equal, bit
// for bit, to the plain twins run on the CPU).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster_sync.cuh"
#include "common.cuh"

namespace {

using matinv::bar_expect;
using matinv::bar_wait;
using matinv::peer_addr;
using matinv::smem_addr;
using matinv::store_to_peer;

constexpr int kMaxSub = 16;
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

// ---------------------------------------------------------------------------
// K2 and K3: one thread-block cluster per panel.
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;
constexpr int kMaxCluster = 16;

// What a CTA publishes at the end of a step: its best packed key and the
// 2*sub working-set values of that lane (the next pivot column if it wins).
// Every CTA holds one slot per CTA of the cluster, by step parity; a slot
// travels as nine 16-byte stores.
struct alignas(16) Slot {
  float col[2 * kMaxSub];
  int key;
  int pad[3];
};
constexpr int kSlotChunks = sizeof(Slot) / 16;
constexpr int kMaxWarps = kClusterThreads / 32;

// Row stride of the gathered pivot-lane values g, in floats: sub padded to
// a whole float4.
__host__ __device__ inline int g_stride(int sub) { return (sub + 3) / 4 * 4; }

// Per-CTA shared memory of the cluster body, for L lanes a CTA: the strip
// rows (b, L) and the working set (2*sub, L) of T where the wrapper keeps
// them there, the gathered pivot-lane values g ((b - sub) rows of
// g_stride(sub) floats), 2 * kMaxCluster slots, two mbarriers, each warp's
// normalized column (kMaxWarps * 32 floats), the sub-panel's pivot lanes
// (kMaxSub ints), the reduction scratch (32 ints), a flag (4 ints) and the
// used flags (L bytes). The wrapper's count (ops/blocked.py,
// cluster_geometry) is the same sum.
size_t cluster_smem_bytes(int lanes, int b, int sub, size_t elt,
                          bool wp_shared, bool rows_shared) {
  size_t s = round16((size_t)(b - sub) * g_stride(sub) * sizeof(float)) +
             2 * kMaxCluster * sizeof(Slot) + 2 * sizeof(uint64_t) +
             kMaxWarps * 32 * sizeof(float) +
             (kMaxSub + 32 + 4) * sizeof(int) + (size_t)lanes;
  if (wp_shared) s += round16((size_t)2 * sub * lanes * elt);
  if (rows_shared) s += round16((size_t)b * lanes * elt);
  return s;
}

// Max of v over the CTA, with one barrier: every warp reduces the per-warp
// maxima itself. red (32 ints) is rewritten by the next call, which comes
// after every thread has waited for the slots this call's step publishes,
// so no warp still reads it then.
__device__ __forceinline__ int cta_max(int v, int* red) {
  const int lane = threadIdx.x & 31;
  v = __reduce_max_sync(0xffffffffu, v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int w = lane < (int)(blockDim.x >> 5) ? red[lane] : -2147483647 - 1;
  return __reduce_max_sync(0xffffffffu, w);
}

// The panel's steps on the cluster. CTA r owns lanes [r*L, r*L + len) of
// the strip. kEmitCt: K2 (C^T, ok and the update of finished C^T rows);
// else K3 (pivot rows only; the deferred update reaches the later strip
// rows). kWpShared / kRowsShared: the CTA's slice of wp / of the strip rows
// lives in its shared memory; else in wp_g / rows_g at column r*L, row
// stride m. rows_g is K2's C^T output (written at the end when the rows
// live in shared memory) and K3's workspace. A grid of k clusters (K6)
// runs k panels, cluster i on item i of each argument: the strip, mask,
// pivot rows, C^T, ok and workspace of matrix i.
template <typename T, bool kEmitCt, bool kWpShared, bool kRowsShared>
__device__ __forceinline__ void cluster_body(
    const T* __restrict__ stripT, const int* __restrict__ used_in,
    int* __restrict__ pivrows, T* __restrict__ rows_g,
    int* __restrict__ ok_out, T* __restrict__ wp_g, int m, int b, int sub,
    int kmask, int kb, int pivot) {
  using A = Arith<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t item = blockIdx.x / nc;
  if (item != 0) {
    stripT += item * b * m;
    used_in += item * m;
    pivrows += item * b;
    rows_g += item * b * m;
    ok_out += item;
    if constexpr (!kWpShared) wp_g += item * 2 * sub * m;
  }
  const int L = (m + nc - 1) / nc;
  const int base = rank * L;
  const int len = min(L, m - base);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int s2 = 2 * sub;
  const T zero = A::put(0.f);

  extern __shared__ float4 smem4[];
  char* sp = reinterpret_cast<char*>(smem4);
  T* rows;
  size_t rs;
  if constexpr (kRowsShared) {
    rows = reinterpret_cast<T*>(sp);
    rs = L;
    sp += round16((size_t)b * L * sizeof(T));
  } else {
    rows = rows_g + base;
    rs = m;
  }
  T* wp;
  size_t ws;
  if constexpr (kWpShared) {
    wp = reinterpret_cast<T*>(sp);
    ws = L;
    sp += round16((size_t)s2 * L * sizeof(T));
  } else {
    wp = wp_g + base;
    ws = m;
  }
  const int gs = g_stride(sub);
  float* g = reinterpret_cast<float*>(sp);   // (b - sub, gs)
  sp += round16((size_t)(b - sub) * gs * sizeof(float));
  Slot* slots = reinterpret_cast<Slot*>(sp);  // (2, kMaxCluster)
  sp += 2 * kMaxCluster * sizeof(Slot);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sp);  // (2,): by parity
  sp += 2 * sizeof(uint64_t);
  float* wnorm = reinterpret_cast<float*>(sp) + (tid >> 5) * 32;  // a warp's
  sp += kMaxWarps * 32 * sizeof(float);
  int* lanes = reinterpret_cast<int*>(sp);   // (kMaxSub,)
  int* red = lanes + kMaxSub;                // 32
  int* flag = red + 32;                      // 4
  unsigned char* used = reinterpret_cast<unsigned char*>(flag + 4);  // (L,)

  for (int jl = tid; jl < len; jl += nt) {
    used[jl] = used_in[base + jl] != 0;
    for (int i = 0; i < b; ++i)
      rows[i * rs + jl] = stripT[(size_t)i * m + base + jl];
  }
  int ok = 1;  // tracked by thread 0; every CTA sees every pivot
  // Steps publish in turn into the slots and barrier of parity t & 1; the
  // barrier of a parity completes its phase (t >> 1) & 1 when all C slots
  // of step t have landed. Both start armed; each wait re-arms its barrier
  // for step t + 2, whose stores no peer can send before this CTA has
  // published step t + 1, after every thread here read step t's slots.
  const uint32_t slot_bytes = nc * sizeof(Slot);
  if (tid == 0) matinv::bars_start(bars, slot_bytes);
  cluster.sync();  // every peer's barriers exist before the first store
  int t = 0;       // the step being published next

  // Ends a step: the CTA's best key (or, without pivoting, the lane given)
  // and that lane's column, stored into slot [t & 1][rank] of every CTA of
  // the cluster, each store completing on that CTA's barrier. The block
  // barrier inside makes the lane's values, written by another thread,
  // visible here.
  auto publish = [&](int best, int given) {
    int jb = given;
    if (pivot) {
      best = cta_max(best, red);
      jb = kmask - (best & kmask);
    } else {
      __syncthreads();
    }
    const int jbl = jb - base;
    const bool mine = jbl >= 0 && jbl < len;
    const int par = t & 1;
    const uint32_t slot = smem_addr(&slots[par * kMaxCluster + rank]);
    const uint32_t bar = smem_addr(&bars[par]);
    for (int idx = tid; idx < kSlotChunks * nc; idx += nt) {
      const int d = idx / kSlotChunks;
      const int c = idx - d * kSlotChunks;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (c == kSlotChunks - 1) {
        v[0] = __int_as_float(best);
      } else if (mine) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * c + e < s2) v[e] = A::get(wp[(4 * c + e) * ws + jbl]);
      }
      store_to_peer(peer_addr(slot + 16 * c, d), peer_addr(bar, d),
                    make_float4(v[0], v[1], v[2], v[3]));
    }
    ++t;
  };

  for (int r0 = 0; r0 < b; r0 += sub) {
    // Merged working set: rows [0, sub) the sub-panel's strip rows, rows
    // [sub, 2*sub) its transform probe, zero at the start. The first
    // step's search column is strip row r0.
    int best = -1;
    for (int jl = tid; jl < len; jl += nt) {
      for (int k = 0; k < sub; ++k) wp[k * ws + jl] = rows[(r0 + k) * rs + jl];
      for (int k = sub; k < s2; ++k) wp[k * ws + jl] = zero;
      if (pivot)
        best = max(best, matinv::pivot_key(A::get(rows[r0 * rs + jl]),
                                           used[jl], base + jl, kmask));
    }
    publish(best, kb + r0);

    for (int r2 = 0; r2 < sub; ++r2) {
      // The pivot: the largest of the C published keys, and its owner's
      // column, with the probe's identity one-hot injected at (sub + r2, p),
      // normalized by the pivot (strip row r2 at lane p). Every warp waits
      // for the slots and reads them itself; lane k divides value k into
      // the warp's row of wnorm, from which each thread reads all 2*sub.
      const int par = (t - 1) & 1;
      bar_wait(&bars[par], ((t - 1) >> 1) & 1);
      if (tid == 0) bar_expect(&bars[par], slot_bytes);  // for step t + 1
      const Slot* slot = slots + par * kMaxCluster;
      int p = kb + r0 + r2;
      if (pivot) {
        const int key = __reduce_max_sync(0xffffffffu,
                                          lane < nc ? slot[lane].key : -1);
        p = kmask - (key & kmask);
      }
      const int owner = p / L;
      float v = 0.f;
      if (lane < s2) v = slot[owner].col[lane];
      const float pv = __shfl_sync(0xffffffffu, v, r2);
      if (lane == sub + r2) v = A::rnd(__fadd_rn(v, 1.f));
      const float nv = A::rnd(__fdiv_rn(v, pv == 0.f ? 1.f : pv));
      __syncwarp();  // the warp's reads of the last step's column are done
      wnorm[lane] = nv;
      __syncwarp();
      float norm[2 * kMaxSub];
#pragma unroll
      for (int k4 = 0; k4 < kMaxSub / 2; ++k4) {
        const float4 n4 = reinterpret_cast<const float4*>(wnorm)[k4];
        norm[4 * k4] = n4.x;
        norm[4 * k4 + 1] = n4.y;
        norm[4 * k4 + 2] = n4.z;
        norm[4 * k4 + 3] = n4.w;
      }
      if (tid == 0) {
        ok &= (pv != 0.f);
        lanes[r2] = p;
        if (rank == owner) pivrows[r0 + r2] = p;
      }

      // Rank-1 eliminate every own lane but p, deposit the normalized
      // column in lane p, and take the next step's keys (working row
      // r2 + 1) in the same pass.
      const bool more = r2 + 1 < sub;
      best = -1;
      for (int jl = tid; jl < len; jl += nt) {
        const int j = base + jl;
        const bool is_p = j == p;
        // The lane's column into registers first, all loads in flight at
        // once (a store between them would serialize the chain).
        float x[2 * kMaxSub];
#pragma unroll
        for (int k = 0; k < 2 * kMaxSub; ++k)
          if (k < s2) x[k] = A::get(wp[k * ws + jl]);
        const float f = A::get(wp[r2 * ws + jl]);
        float next = 0.f;
#pragma unroll
        for (int k = 0; k < 2 * kMaxSub; ++k) {
          if (k < s2) {
            const float e = is_p ? norm[k] : A::elim(x[k], norm[k], f);
            wp[k * ws + jl] = A::put(e);
            if (k == r2 + 1) next = e;
          }
        }
        if (is_p) used[jl] = 1;
        if (pivot && more)
          best = max(best, matinv::pivot_key(next, is_p || used[jl], j, kmask));
      }
      if (more) publish(best, p + 1);
    }

    // Deferred rank-sub update of the rows outside this sub-panel: for K2
    // every other C^T-buffer row (finished transform rows [0, r0), later
    // strip rows [r0 + sub, b)), for K3 the later strip rows. First dot:
    // g = rows @ psel^T, the rows' values at the sub-panel's pivot lanes,
    // pushed by the lanes' owners into every CTA. No CTA pushes the next
    // sub-panel's g before every CTA has published that sub-panel's first
    // step, after its update read this g; and no CTA exits before the last
    // cluster barrier, by which every slot store has landed.
    __syncthreads();  // lanes[] from thread 0
    const int nrows = kEmitCt ? b - sub : b - sub - r0;
    for (int idx = tid; idx < nrows * sub; idx += nt) {
      const int q = idx / sub;
      const int k = idx - q * sub;
      const int lk = lanes[k] - base;
      if (lk >= 0 && lk < len) {
        const int i = kEmitCt ? (q < r0 ? q : q + sub) : r0 + sub + q;
        const float gv = A::get(rows[i * rs + lk]);
        for (int d = 0; d < nc; ++d)
          cluster.map_shared_rank(g, d)[q * gs + k] = gv;
      }
    }
    cluster.sync();
    // Second dot: rows += g @ C_l^T with C_l^T = probe - psel, each
    // element's sum in one thread from +0 in k order; then, for K2, the
    // sub-panel's own C^T rows land in the rows it just finished.
    for (int jl = tid; jl < len; jl += nt) {
      const int j = base + jl;
      float ctl[kMaxSub];
#pragma unroll
      for (int k = 0; k < kMaxSub; ++k) {
        if (k < sub) {
          float c = A::get(wp[(sub + k) * ws + jl]);
          if (j == lanes[k]) c = A::rnd(__fsub_rn(c, 1.f));
          ctl[k] = c;
        }
      }
      // Four rows at a time, their loads ahead of their stores, so four
      // independent FMA chains are in flight.
      for (int q0 = 0; q0 < nrows; q0 += 4) {
        float acc[4], xr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u;
          const int i = kEmitCt ? (q < r0 ? q : q + sub) : r0 + sub + q;
          acc[u] = 0.f;
          xr[u] = q < nrows ? A::get(rows[i * rs + jl]) : 0.f;
        }
#pragma unroll
        for (int k4 = 0; k4 < kMaxSub / 4; ++k4) {
          if (4 * k4 < sub) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int q = min(q0 + u, nrows - 1);
              const float4 g4 =
                  reinterpret_cast<const float4*>(g + q * gs)[k4];
              const float gk[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (4 * k4 + c < sub)
                  acc[u] = fmaf(gk[c], ctl[4 * k4 + c], acc[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u;
          const int i = kEmitCt ? (q < r0 ? q : q + sub) : r0 + sub + q;
          if (q < nrows)
            rows[i * rs + jl] = A::put(__fadd_rn(xr[u], A::rnd(acc[u])));
        }
      }
      if constexpr (kEmitCt) {
#pragma unroll
        for (int k = 0; k < kMaxSub; ++k)
          if (k < sub) rows[(r0 + k) * rs + jl] = A::put(ctl[k]);
      }
    }
    // The next load pass reads, lane by lane, what this thread wrote.
  }

  if constexpr (kEmitCt) {
    // C^T out (from shared memory), ok = every pivot nonzero and C^T
    // finite, reduced over the cluster by rank 0.
    int finite = 1;
    for (int jl = tid; jl < len; jl += nt) {
      for (int i = 0; i < b; ++i) {
        const float c = A::get(rows[i * rs + jl]);
        if constexpr (kRowsShared) rows_g[(size_t)i * m + base + jl] = A::put(c);
        finite &= isfinite(c) ? 1 : 0;
      }
    }
    finite = __syncthreads_and(finite);
    if (tid == 0) flag[0] = ok && finite;
    cluster.sync();
    if (rank == 0 && tid == 0) {
      int all = 1;
      for (int d = 0; d < nc; ++d) all &= *cluster.map_shared_rank(flag, d);
      ok_out[0] = all;
    }
    cluster.sync();  // rank 0 reads every flag before any CTA exits
  }
}

// K2: fp32, pivoting or not.
template <bool kWpShared, bool kRowsShared>
__global__ void __launch_bounds__(kClusterThreads)
panel_factor_cluster_kernel(const float* __restrict__ stripT,
                            const int* __restrict__ used_in,
                            int* __restrict__ pivrows, float* __restrict__ ct,
                            int* __restrict__ ok_out, float* __restrict__ wp,
                            int m, int b, int sub, int kmask, int kb,
                            int pivot) {
  cluster_body<float, true, kWpShared, kRowsShared>(
      stripT, used_in, pivrows, ct, ok_out, wp, m, b, sub, kmask, kb, pivot);
}

// K3: an fp32 or bf16 strip, always pivoting.
template <typename T, bool kWpShared, bool kRowsShared>
__global__ void __launch_bounds__(kClusterThreads)
pivot_search_cluster_kernel(const T* __restrict__ stripT,
                            const int* __restrict__ used_in,
                            int* __restrict__ pivrows, T* __restrict__ w,
                            int* __restrict__ ok_out, T* __restrict__ wp,
                            int m, int b, int sub, int kmask, int kb,
                            int pivot) {
  cluster_body<T, false, kWpShared, kRowsShared>(
      stripT, used_in, pivrows, w, ok_out, wp, m, b, sub, kmask, kb, pivot);
}

// The instantiation for a placement: the rows live in shared memory only
// beside the working set.
template <typename T, bool kEmitCt>
const void* cluster_kernel(int wp_shared, int rows_shared) {
  if (rows_shared && !wp_shared) return nullptr;
  if constexpr (kEmitCt) {
    if (rows_shared)
      return reinterpret_cast<const void*>(
          &panel_factor_cluster_kernel<true, true>);
    return wp_shared ? reinterpret_cast<const void*>(
                           &panel_factor_cluster_kernel<true, false>)
                     : reinterpret_cast<const void*>(
                           &panel_factor_cluster_kernel<false, false>);
  } else {
    if (rows_shared)
      return reinterpret_cast<const void*>(
          &pivot_search_cluster_kernel<T, true, true>);
    return wp_shared ? reinterpret_cast<const void*>(
                           &pivot_search_cluster_kernel<T, true, false>)
                     : reinterpret_cast<const void*>(
                           &pivot_search_cluster_kernel<T, false, false>);
  }
}

// kind: 0 K2, 1 K3 on fp32, 2 K3 on bf16.
const void* cluster_kernel_of(int kind, int wp_shared, int rows_shared) {
  switch (kind) {
    case 0: return cluster_kernel<float, true>(wp_shared, rows_shared);
    case 1: return cluster_kernel<float, false>(wp_shared, rows_shared);
    case 2:
      return cluster_kernel<__nv_bfloat16, false>(wp_shared, rows_shared);
    default: return nullptr;
  }
}

// Checks the geometry the wrapper chose (sub divides b and is at most
// kMaxSub; 1 to kMaxCluster CTAs, none without lanes; a warp multiple of
// threads; smem at least the placement's count and at most one block's),
// sets the kernel's attributes and fills the launch of `items` clusters.
cudaError_t cluster_launch_config(const void* kernel, int items, int m,
                                  int b, int sub, size_t elt, int cluster,
                                  int threads, int wp_shared, int rows_shared,
                                  int smem, void* stream,
                                  cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr) {
  if (kernel == nullptr || items < 1 || m < 1 || sub < 1 || sub > kMaxSub ||
      b < sub ||
      b % sub != 0 || cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kClusterThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int lanes = (m + cluster - 1) / cluster;
  if ((cluster - 1) * lanes >= m) return cudaErrorInvalidValue;
  if (smem < 0 || (size_t)smem > kMaxShared ||
      (size_t)smem < cluster_smem_bytes(lanes, b, sub, elt, wp_shared,
                                        rows_shared))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * items, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

int launch_cluster(int kind, int items, const void* stripT, const int* used,
                   int* pivrows, void* rows, int* ok, void* wp, int m, int b,
                   int sub, int kmask, int kb, int pivot, int cluster,
                   int threads, int wp_shared, int rows_shared, int smem,
                   void* stream) {
  const void* kernel = cluster_kernel_of(kind, wp_shared, rows_shared);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_launch_config(
      kernel, items, m, b, sub, kind == 2 ? 2 : 4, cluster, threads,
      wp_shared, rows_shared, smem, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  void* args[] = {&stripT, &used,  &pivrows, &rows, &ok,   &wp,
                  &m,      &b,     &sub,     &kmask, &kb,  &pivot};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Clusters of the given geometry the card can hold at once
// (cudaOccupancyMaxActiveClusters) for kind 0 (K2), 1 (K3 fp32) or 2 (K3
// bf16); 0 means the launch would be refused. Returns the cudaError_t of
// the query.
extern "C" int matinv_panel_clusters(int kind, int m, int b, int sub,
                                     int cluster, int threads, int wp_shared,
                                     int rows_shared, int smem,
                                     int* clusters) {
  const void* kernel = cluster_kernel_of(kind, wp_shared, rows_shared);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_launch_config(
      kernel, 1, m, b, sub, kind == 2 ? 2 : 4, cluster, threads, wp_shared,
      rows_shared, smem, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  cudaGetLastError();  // a refused size must not fail the next launch check
  return err;
}

// K2. stripT: (b, m) float32; used: (m,) int32, nonzero for rows taken by
// earlier panels; pivrows: (b,) int32 out; ct: (b, m) float32 out; ok: (1,)
// int32 out; wp: (2*sub, m) float32 workspace, read only when wp_shared is
// 0. sub must divide b and be at most 16; kmask = next_pow2(m) - 1. The
// cluster geometry (cluster CTAs of threads threads and smem bytes, the
// placement flags) is the wrapper's (ops/blocked.py, cluster_geometry).
// Returns the cudaError_t of the launch.
extern "C" int matinv_panel_factor(const float* stripT, const int* used,
                                   int* pivrows, float* ct, int* ok,
                                   float* wp, int m, int b, int sub,
                                   int kmask, int kb, int pivot, int cluster,
                                   int threads, int wp_shared,
                                   int rows_shared, int smem, void* stream) {
  return launch_cluster(0, 1, stripT, used, pivrows, ct, ok, wp, m, b, sub,
                        kmask, kb, pivot, cluster, threads, wp_shared,
                        rows_shared, smem, stream);
}

// K6. K2's cluster body on k matrices, one cluster each, in one launch:
// stripT (k, b, m) float32, matrix i's transposed strip at [i]; used (k, m)
// int32; pivrows (k, b) int32 out; ct (k, b, m) float32 out; ok (k,) int32
// out; wp (k, 2*sub, m) float32 workspace, read only when wp_shared is 0.
// sub, kmask, kb (the same for every matrix) and the cluster geometry as
// for K2. Returns the cudaError_t of the launch.
extern "C" int matinv_lockstep_factor(const float* stripT, const int* used,
                                      int* pivrows, float* ct, int* ok,
                                      float* wp, int k, int m, int b, int sub,
                                      int kmask, int kb, int pivot,
                                      int cluster, int threads, int wp_shared,
                                      int rows_shared, int smem,
                                      void* stream) {
  return launch_cluster(0, k, stripT, used, pivrows, ct, ok, wp, m, b, sub,
                        kmask, kb, pivot, cluster, threads, wp_shared,
                        rows_shared, smem, stream);
}

// K3. stripT: (b, m) float32, or bfloat16 when bf16 != 0; used, pivrows,
// sub, kmask and the cluster geometry as for K2; w: (b, m) and wp:
// (2*sub, m) workspaces of the strip's type, read only when rows_shared /
// wp_shared is 0. Always pivots. Returns the cudaError_t of the launch.
extern "C" int matinv_pivot_search(const void* stripT, const int* used,
                                   int* pivrows, void* w, void* wp, int m,
                                   int b, int sub, int kmask, int bf16,
                                   int cluster, int threads, int wp_shared,
                                   int rows_shared, int smem, void* stream) {
  return launch_cluster(bf16 ? 2 : 1, 1, stripT, used, pivrows, w, nullptr,
                        wp, m, b, sub, kmask, 0, 1, cluster, threads,
                        wp_shared, rows_shared, smem, stream);
}
