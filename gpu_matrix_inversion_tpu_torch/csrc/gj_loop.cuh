// The Gauss-Jordan step loop shared by L1 and L4 (gauss_jordan.cu, the
// pivot-block and spec inverse and the spec getrf), L2 (logical_panel.cu,
// the logical panel's pivot search) and L3 (lu_panel.cu, the blocked
// getrf's panel): device-side loops of the JAX package that reach no
// Pallas kernel.
//
// A job is a working matrix of `rows` rows and `w` columns, cut by rows
// over the members of a group of CTAs: a thread-block cluster (members
// read each other's shared memory) or a persistent grid (members meet in
// global memory, L2-resident at these sizes). Member k owns rows
// [k * rows_per, k * rows_per + rows_per), in its shared memory or in a
// device workspace (the caller's choice, through a generic pointer). A
// step r:
//   every member has published, for step r, its best eligible row (the
//   largest |column r|, ties to the lowest order) with its key, and a copy
//   of that row's values (its proposal; without pivoting the owner of the
//   step's fixed row publishes that row);
//   one group barrier;
//   every member reduces the proposals' keys to the same winner, reads the
//   winner's row from its proposal and normalizes it (an IEEE division);
//   every member updates its rows, x - f * v with two roundings
//   (__dmul_rn then __dsub_rn; nvcc would contract them into one FMA by
//   default), as the plain PyTorch loops compute `aug -= col * norm`;
//   in the LU mode (L3, L4) the row stays unnormalized, the multiplier is
//   f = x_r / pivot (an IEEE division) on the rows the step eliminates and
//   0 on every other row, every row takes x - f * v on the columns right
//   of the step (0 * inf makes NaN there, as in the plain loops, which
//   subtract from the whole matrix), and f is deposited in column r;
//   every member publishes its proposal for step r + 1 into the other
//   parity of its two proposal buffers.
// One barrier a step suffices: a member writes the buffers of step r's
// parity again only in step r + 1, after the barrier of step r + 1, by
// which every member has finished reading them.
//
// The pivot key is the bit pattern of |v| as a 64-bit integer (monotone
// for a nonnegative float), every NaN mapped to the largest key: so the
// winner is the first maximum of |v| with NaN counted as the maximum, as
// torch.argmax picks it. Ineligible rows take key -1, an empty member
// LLONG_MIN.
#pragma once

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace matinv::loop {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxShared = 232448;  // one block's dynamic shared memory
constexpr int kHeader = 16;            // a proposal's key, order and row
constexpr int kU = 8;                  // columns a lane updates at once

// IEEE operations, each rounded once.
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}

__device__ __forceinline__ long long abs_key(double v) {
  return isnan(v) ? LLONG_MAX : __double_as_longlong(fabs(v));
}
__device__ __forceinline__ long long abs_key(float v) {
  return isnan(v) ? LLONG_MAX : (long long)__float_as_int(fabsf(v));
}

struct Cand {
  long long key;
  int ord;  // the tie-break: the row's position (L1) or index (L2)
  int row;
};

__device__ __forceinline__ Cand empty_cand() {
  return Cand{LLONG_MIN, INT_MAX, -1};
}

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.key > b.key || (a.key == b.key && a.ord < b.ord);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Cand d;
    d.key = __shfl_xor_sync(kFull, c.key, o);
    d.ord = __shfl_xor_sync(kFull, c.ord, o);
    d.row = __shfl_xor_sync(kFull, c.row, o);
    if (better(d, c)) c = d;
  }
  return c;
}

// The best of every thread's candidate, in every thread; red holds kWarps
// candidates. One block barrier; the caller's next barrier comes before
// red is written again.
__device__ __forceinline__ Cand block_best(Cand c, Cand* red) {
  c = warp_best(c);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  Cand b = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k)
    if (better(red[k], b)) b = red[k];
  return b;
}

// Loads of another member's proposal: from global memory past L1 (a line
// cached two steps ago would be stale), or from a peer's shared memory.
template <bool GLOBAL, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  else return *p;
}

// A proposal's header (key; order in the low, row in the high 32 bits).
template <bool GLOBAL>
__device__ __forceinline__ Cand ld_header(const char* h) {
  const longlong2 v = ld<GLOBAL>(reinterpret_cast<const longlong2*>(h));
  return Cand{v.x, (int)(unsigned)(v.y & 0xffffffffll),
              (int)(unsigned)((unsigned long long)v.y >> 32)};
}

// The most members a group has (a grid of at most one CTA an SM), and the
// headers a lane loads to read them all.
constexpr int kMaxMembers = 160;
constexpr int kLaneLoads = kMaxMembers / 32;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A barrier over the g CTAs of a grid that are all resident (a
// cooperative launch guarantees it, or refuses the launch), as cooperative
// groups' grid sync builds it: one atomic a CTA on *bar (0 at launch). CTA
// 0 adds 2^31 - (g - 1), the others 1, so the g arrivals add 2^31: the top
// bit flips when the last CTA arrives, and not before, whichever barrier
// the early CTAs have reached. A wait past 10 s means the grid is not
// co-resident: the kernel traps, so the launch fails instead of hanging
// the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned g) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (g - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    volatile unsigned* now = bar;
    const unsigned long long t0 = global_ns();
    while (((old ^ *now) & 0x80000000u) == 0)
      if (global_ns() - t0 > 10000000000ull) __trap();
    __threadfence();
  }
  __syncthreads();
}

// The members of a thread-block cluster: proposals in each CTA's shared
// memory, read through the cluster's shared-memory window.
struct ClusterComm {
  static constexpr bool kGlobal = false;
  cg::cluster_group cl;
  char* props;        // this CTA's two proposals
  size_t pbytes;      // one proposal's bytes
  int* flag;          // this CTA's share of the final ok
  __device__ int members() { return (int)cl.num_blocks(); }
  __device__ int rank() { return (int)cl.block_rank(); }
  __device__ char* mine(int par) { return props + par * pbytes; }
  __device__ const char* of(int member, int par) {
    return cl.map_shared_rank(mine(par), member);
  }
  __device__ void sync() { cl.sync(); }
  // The AND of every member's f, in member 0's thread 0 (the value
  // elsewhere is meaningless). Two cluster barriers: no CTA exits while
  // member 0 reads its flag.
  __device__ int all(int f) {
    if (threadIdx.x == 0) *flag = f;
    cl.sync();
    int out = 1;
    if (rank() == 0 && threadIdx.x == 0)
      for (int d = 0; d < members(); ++d) out &= *cl.map_shared_rank(flag, d);
    cl.sync();
    return out;
  }
};

// The members of a persistent grid: proposals in a device workspace of
// (2, g) proposals, the grid barrier on bar (one unsigned, 0 at launch).
struct GridComm {
  static constexpr bool kGlobal = true;
  char* props;
  size_t pbytes;      // one proposal's bytes
  unsigned* bar;
  int* flags;         // (g,) ints, each member's share of the final ok
  int g, r;
  __device__ int members() { return g; }
  __device__ int rank() { return r; }
  __device__ char* mine(int par) {
    return props + ((size_t)par * g + r) * pbytes;
  }
  __device__ const char* of(int member, int par) {
    return props + ((size_t)par * g + member) * pbytes;
  }
  __device__ void sync() { grid_sync(bar, g); }
  __device__ int all(int f) {
    if (threadIdx.x == 0) flags[r] = f;
    sync();
    int out = 1;
    if (r == 0 && threadIdx.x == 0)
      for (int d = 0; d < g; ++d) out &= __ldcg(flags + d);
    return out;
  }
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// A proposal: the header (key, order, row), then w values.
__host__ __device__ inline size_t prop_bytes(int w, int tsize) {
  return align16(kHeader + (size_t)w * tsize);
}

// Shared memory of a member, in this order: its rows (when they live
// there), the normalized pivot row (w values), its two proposals (a
// cluster's), `ints` ints (L1's three position maps, L2's row states),
// the reduction scratch (kWarps candidates) and a flag. The wrappers'
// count (ops/gauss_jordan.py loop_smem) is the same sum.
__host__ __device__ inline size_t smem_bytes(int rows_per, int w, int ints,
                                             int tsize, bool rows_shared,
                                             bool props_shared) {
  return (rows_shared ? align16((size_t)rows_per * w * tsize) : 0) +
         align16((size_t)w * tsize) +
         (props_shared ? 2 * prop_bytes(w, tsize) : 0) +
         align16((size_t)ints * sizeof(int)) + kWarps * sizeof(Cand) +
         16;
}

// Launches a persistent grid of g CTAs that meet at grid_sync, as a
// cooperative launch: the runtime guarantees every CTA is resident at
// once, or refuses the launch. Such a launch records in a CUDA graph.
inline cudaError_t launch_grid(const void* kernel, int g, int smem,
                               cudaStream_t stream, void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

template <typename T>
struct Job {
  T* v;          // the member's rows, row stride w
  int lo, hi;    // its rows [lo, hi) of the working matrix
  int rows_per;  // rows a member owns: row g's owner is g / rows_per
  int w, steps;
  int pivot;
  T* nr;         // shared: the normalized pivot row (w)
  Cand* red;     // shared: kWarps candidates
  // L1, L4: shared position maps of all rows (the swaps the plain loop
  // makes): pos_of[g] the place of row g, phys_at[p] the row at place p,
  // order[r] the pivot row of step r. L2, L3: state[i] of the member's row
  // lo + i: bit 0 used before the panel, bit 1 pivot row of an earlier
  // step; kb.
  int* pos_of;
  int* phys_at;
  int* order;
  int* state;
  int kb;
};

// Publishes the member's proposal for step s (column s), in every thread.
// L1 (INV without LU) offers every slot of the row, L2, L3 and L4 its
// columns s .. w - 1. Every row of the member is a candidate: the eligible
// ones (INV: place >= s; else unused) by their key, the others with key
// -1. With `warps` the caller has left each warp's best candidate in red[]
// (and a block barrier since); else the keys are taken here.
template <typename T, bool INV, bool LU, class Comm>
__device__ void propose(Comm& comm, const Job<T>& jb, int s, bool warps) {
  const int tid = threadIdx.x;
  const int nrow = jb.hi - jb.lo;
  Cand c = empty_cand();
  if (jb.pivot && warps) {
    c = jb.red[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k)
      if (better(jb.red[k], c)) c = jb.red[k];
  } else if (jb.pivot) {
    for (int i = tid; i < nrow; i += kThreads) {
      const int g = jb.lo + i;
      const bool elig = INV ? jb.pos_of[g] >= s : jb.state[i] == 0;
      const Cand d{elig ? abs_key(jb.v[(size_t)i * jb.w + s]) : -1LL,
                   INV ? jb.pos_of[g] : g, g};
      if (better(d, c)) c = d;
    }
    c = block_best(c, jb.red);
  } else {
    const int d = INV ? s : jb.kb + s;
    if (d >= jb.lo && d < jb.hi) c = Cand{0, d, d};
  }
  char* h = comm.mine(s & 1);
  if (tid == 0) {
    *reinterpret_cast<long long*>(h) = c.key;
    reinterpret_cast<int*>(h)[2] = c.ord;
    reinterpret_cast<int*>(h)[3] = c.row;
  }
  if (c.row >= 0) {
    T* vals = reinterpret_cast<T*>(h + kHeader);
    const T* src = jb.v + (size_t)(c.row - jb.lo) * jb.w;
    for (int j = (INV && !LU ? 0 : s) + tid; j < jb.w; j += kThreads)
      vals[j] = src[j];
  }
}

// The job's steps; returns ok of the pivots (every pivot nonzero), the
// same in every thread of every member. L2 writes its pivot rows to
// pivrows (member 0). Ends with a block barrier, not a group barrier.
//
// L1 (INV) keeps the in-place layout of gj_regs.cuh: slot j of a row holds
// column j of [A | I] until step j, then the right-half column of step j's
// pivot row (the plain loop's other columns are unit or zero columns that
// nothing reads). A step updates every slot of every row: slot r starts
// from the right-half column's 0, the pivot row takes the normalized row
// (the deposit), whose slot r is 1 / pivot. Rows never move: pos_of and
// phys_at replay the plain loop's swaps, and the tie-break compares places.
//
// L2 keeps only what later steps read current: columns > r of the rows
// that can still be pivot rows (with pivoting the unused rows, without it
// every row not yet a pivot row). The plain loop updates the whole strip,
// a scratch copy it never returns.
//
// LU (L3 without INV, L4 with it) updates columns > r of every row, as the
// plain loops do, and deposits the multiplier in column r of the rows the
// step eliminates: INV those at places > r (the rows below the pivot after
// the swap), else the unused rows other than the pivot row.
template <typename T, bool INV, bool LU, class Comm>
__device__ int run_steps(Comm& comm, const Job<T>& jb, int* pivrows) {
  constexpr bool G = Comm::kGlobal;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nrow = jb.hi - jb.lo;
  const int members = comm.members();
  int ok = 1;
  propose<T, INV, LU>(comm, jb, 0, false);
  for (int r = 0; r < jb.steps; ++r) {
    const int par = r & 1;
    comm.sync();
    // Every warp takes the winner from the headers itself (all loads in
    // flight at once), so no block barrier passes it on.
    int prow_id = INV ? r : jb.kb + r;
    if (jb.pivot) {
      Cand h[kLaneLoads];
#pragma unroll
      for (int k = 0; k < kLaneLoads; ++k)
        h[k] = lane + 32 * k < members
                   ? ld_header<G>(comm.of(lane + 32 * k, par))
                   : empty_cand();
      Cand best = h[0];
#pragma unroll
      for (int k = 1; k < kLaneLoads; ++k)
        if (better(h[k], best)) best = h[k];
      prow_id = warp_best(best).row;
    }
    const T* prow = reinterpret_cast<const T*>(
        comm.of(prow_id / jb.rows_per, par) + kHeader);
    const T piv = ld<G>(prow + r);
    ok &= piv != T(0);
    const T pd = piv == T(0) ? T(1) : piv;
    for (int j = (INV && !LU ? 0 : r + 1) + tid; j < jb.w; j += kThreads)
      jb.nr[j] = LU ? ld<G>(prow + j)
                    : div((INV && j == r) ? T(1) : ld<G>(prow + j), pd);
    if (tid == 0) {
      if (INV) {
        const int p = jb.pos_of[prow_id];
        const int q = jb.phys_at[r];
        jb.phys_at[r] = prow_id;
        jb.phys_at[p] = q;
        jb.pos_of[prow_id] = r;
        jb.pos_of[q] = p;
        jb.order[r] = prow_id;
      } else {
        if (prow_id >= jb.lo && prow_id < jb.hi)
          jb.state[prow_id - jb.lo] |= 2;
        if (pivrows != nullptr && comm.rank() == 0) pivrows[r] = prow_id;
      }
    }
    __syncthreads();
    // Each warp updates its rows, kU columns a lane at a time with all
    // their loads issued first, and keeps the best candidate of its rows
    // for step r + 1 (the row's column r + 1 as it leaves the update).
    const int tn = r + 1;
    const bool keys = jb.pivot && tn < jb.steps;
    const int j0 = INV && !LU ? 0 : r + 1;
    Cand wbest = empty_cand();
    for (int i = warp; i < nrow; i += kWarps) {
      T* x = jb.v + (size_t)i * jb.w;
      const int g = jb.lo + i;
      // LU: whether the step eliminates the row (and deposits f).
      const bool elim = LU && (INV ? jb.pos_of[g] > r : jb.state[i] == 0);
      if (INV && !LU && g == prow_id) {  // the deposit
        for (int j = lane; j < jb.w; j += 32) x[j] = jb.nr[j];
      } else if (LU || INV ||
                 !((jb.state[i] & 2) || (jb.pivot && (jb.state[i] & 1)))) {
        const T f = !LU ? x[r] : elim ? div(x[r], pd) : T(0);
        __syncwarp();  // every lane has f before the lane of slot r writes
        for (int jc = j0 + lane; jc < jb.w; jc += 32 * kU) {
          T xs[kU], ns[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int j = jc + 32 * u;
            if (j < jb.w) {
              xs[u] = x[j];
              ns[u] = jb.nr[j];
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int j = jc + 32 * u;
            if (j < jb.w)
              x[j] = sub((INV && !LU && j == r) ? T(0) : xs[u],
                         mul(f, ns[u]));
          }
        }
        if (elim && lane == 0) x[r] = f;
      }
      if (keys) {
        const bool elig = INV ? jb.pos_of[g] >= tn : jb.state[i] == 0;
        long long key = -1;
        if (elig) {
          __syncwarp();  // the lane that wrote column tn has stored it
          key = abs_key(x[tn]);
        }
        const Cand d{key, INV ? jb.pos_of[g] : g, g};
        if (better(d, wbest)) wbest = d;
      }
    }
    if (keys && lane == 0) jb.red[warp] = wbest;
    __syncthreads();
    if (tn < jb.steps) propose<T, INV, LU>(comm, jb, tn, keys);
  }
  __syncthreads();
  return ok;
}

}  // namespace matinv::loop
