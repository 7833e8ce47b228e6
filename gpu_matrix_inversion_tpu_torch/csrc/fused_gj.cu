// K1: fused swap-free Gauss-Jordan inverse: one thread block per matrix at
// m = 128, one thread-block cluster per matrix at m = 256 .. 640.
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
// m = 256 .. 640 runs fused_gj_cluster_kernel, one thread-block cluster
// of C CTAs per matrix. The earlier design kept [A | I] (0.5 to 3.2 MB) in
// a global workspace that every step read and wrote whole, so a batch that
// filled the card ran at HBM speed (60 ms for 512 matrices at m = 256 on
// an H100 80GB HBM3 at 700 W, 235x its bound; 5.8 ms now), and a single
// matrix had one SM. Here the matrix stays on chip in the in-place layout
// (m live columns, as gj_regs.cuh), cut by rows over the cluster (C = 2 to
// 16; the wrapper's geometry, ops/fused.py
// cluster_geometry), each CTA's rows in its shared memory. A step's pivot
// is a max of packed keys, so each CTA offers its best row and the
// cluster's exchange carries the rows themselves: every CTA stores its
// candidate row, updated through the last step, with its key into every
// CTA (st.async onto mbarriers, as K2's exchange, cluster_sync.cuh), and
// every CTA normalizes the winner from its own copy. Each element's update
// chain stays in one thread with the same intrinsics, so the values do
// not depend on C, and equal the workspace kernel's up to the sign of a
// zero. No workspace is allocated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "cluster_sync.cuh"
#include "common.cuh"
#include "gj_regs.cuh"

namespace {

namespace cg = cooperative_groups;
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

// ---- m = 256 .. 640: one thread-block cluster per matrix ---------------

constexpr int kCThreads = 512;
constexpr int kCWarps = kCThreads / 32;  // warp w owns local rows w + 16 s
constexpr int kMaxRS = 8;                // row slots a warp owns (rows <= 128)
constexpr int kMaxCluster = 16;
constexpr size_t kMaxShared = 232448;    // one block's dynamic shared memory

// Per-CTA shared memory of the cluster branch for an (m, m) matrix on c
// CTAs: the CTA's rows of the matrix (m / c rows of m floats), two step
// parities of c slots (a candidate row of m floats and a 16-byte key) and
// of the normalized pivot row (m floats), two mbarriers, the pivot order
// (m ints), two parities of the reduction scratch (2 x 16 ints) and a flag
// (4 ints). The wrapper's count (ops/fused.py, cluster_smem_bytes) is the
// same sum.
size_t cluster_smem_bytes(int m, int c) {
  const size_t rows = m / c;
  return rows * m * sizeof(float) + 2 * (size_t)c * (4 * (size_t)m + 16) +
         2 * (size_t)m * sizeof(float) + 2 * sizeof(uint64_t) +
         (size_t)m * sizeof(int) + (2 * kCWarps + 4) * sizeof(int);
}

// Step t's update of four columns j0 .. j0 + 3 of a row whose factor is f,
// with n the normalized pivot row there: the deposit in the pivot row
// (dep), else x - f n as one fmaf, column t starting from its identity
// entry (0); column tn (updated first) is left as it is.
__device__ __forceinline__ float4 gj_update(float4 x4, float4 n4, float f,
                                           bool dep, int j0, int t, int tn) {
  if (!dep && j0 != (t & ~3) && j0 != (tn & ~3))  // the common case
    return make_float4(fmaf(-f, n4.x, x4.x), fmaf(-f, n4.y, x4.y),
                       fmaf(-f, n4.z, x4.z), fmaf(-f, n4.w, x4.w));
  float x[4] = {x4.x, x4.y, x4.z, x4.w};
  const float n[4] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    if (j != tn) x[e] = dep ? n[e] : fmaf(-f, n[e], j == t ? 0.f : x[e]);
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

// The matrix's steps on a cluster of C CTAs; CTA `rank` owns rows
// [rank * R, rank * R + R), R = m / C, in the in-place layout of
// gj_regs.cuh (slot j of a row holds column j until step j, then the
// right column of step j's pivot row), in its shared memory. Warp w owns
// local rows w + 16 s, lane l the float4 column groups l + 32 q. A step t:
//   wait for the C slots of step t (each CTA's best unused row, updated
//     through step t - 1, and its packed key); take the largest key: p;
//     the CTA's threads divide the owner's row by its pivot (__fdiv_rn),
//     a column each, into the normalized row;
//   lane s of each warp updates column t + 1 of the warp's row s first
//     and takes its packed key; one block barrier reduces them to the
//     CTA's best row c, and publishes the normalized row;
//   the warp owning row c updates it and stores it with its key into slot
//     [rank] of every CTA of the cluster (st.async onto that CTA's
//     mbarrier, by the parity of step t + 1);
//   every warp updates the rest of its rows while the slots travel, a
//     chunk of rows at a time with all of the chunk's values loaded at
//     once.
// Every CTA publishes every step, after its block barrier, by which all
// its threads have read step t's slots: so no CTA can send step t + 2
// (into step t's slots) before every CTA is done with them.
// Without pivoting the CTA that owns row t + 1 publishes it; the others
// publish a row with key -1 that nobody reads.
template <typename T, bool PIVOT, int Q4>
__global__ void __launch_bounds__(kCThreads)
fused_gj_cluster_kernel(const T* __restrict__ a, T* __restrict__ inv,
                        int* __restrict__ pos, int* __restrict__ ok_out,
                        int m, int kmask) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t item = blockIdx.x / nc;
  const int rows = m / nc;
  const int base = rank * rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rs = (rows + kCWarps - 1) / kCWarps;
  const int m4 = m >> 2;
  const int ss = m + 4;                       // slot stride in floats

  extern __shared__ float4 smem4[];
  float* v = reinterpret_cast<float*>(smem4);  // (rows, m)
  float4* v4 = smem4;
  float* slots = v + (size_t)rows * m;         // (2, nc, m + 4)
  float* nrow = slots + 2 * nc * ss;           // (2, m)
  uint64_t* bars = reinterpret_cast<uint64_t*>(nrow + 2 * m);
  int* order = reinterpret_cast<int*>(bars + 2);  // (m,)
  int* red = order + m;                        // (2, kCWarps)
  int* flag = red + 2 * kCWarps;               // 4

  const T* A = a + item * m * m + (size_t)base * m;
  for (int idx = tid; idx < rows * m; idx += kCThreads)
    v[idx] = to_f32(A[idx]);
  const uint32_t slot_bytes = nc * ss * sizeof(float);
  if (tid == 0) matinv::bars_start(bars, slot_bytes);
  cluster.sync();  // the rows loaded, every peer's barriers armed

  // Bit s: whether the warp's row s has been a pivot row (the same in
  // every lane of the warp).
  unsigned used = 0;
  // Lane s's row slot, -1 past the CTA's rows.
  const int my_row =
      lane < rs && warp + kCWarps * lane < rows ? warp + kCWarps * lane : -1;

  // Reduces each lane's key (its row's, -1 if none) to the CTA's best row
  // c (local; 0 when every row is used or, without pivoting, when row tn
  // is another CTA's) and the key it publishes with. One block barrier.
  auto choose = [&](int key, int tn, int& best) {
    int* r = red + (tn & 1) * kCWarps;
    key = __reduce_max_sync(kFull, key);
    if (lane == 0) r[warp] = key;
    __syncthreads();
    best = __reduce_max_sync(kFull, lane < kCWarps ? r[lane] : -1);
    int c;
    if (PIVOT) {
      c = best < 0 ? 0 : kmask - (best & kmask) - base;
    } else {
      c = tn - base;
      if (c < 0 || c >= rows) c = 0;
      best = -1;
    }
    return c;
  };
  // Row c (already updated) and its key into slot [rank] of step tn of
  // every CTA; by the warp that owns c, each lane sending the groups it
  // owns (and wrote).
  auto publish = [&](int c, int tn, int best) {
    const uint32_t slot =
        matinv::smem_addr(slots + ((tn & 1) * nc + rank) * ss);
    const uint32_t bar = matinv::smem_addr(&bars[tn & 1]);
    const float4* src = v4 + (size_t)c * m4;
    for (int d = 0; d < nc; ++d) {
      const uint32_t ps = matinv::peer_addr(slot, d);
      const uint32_t pb = matinv::peer_addr(bar, d);
#pragma unroll
      for (int q = 0; q < Q4; ++q)
            matinv::store_to_peer(ps + 16 * (lane + 32 * q), pb,
                                src[lane + 32 * q]);
      if (lane == 0)
        matinv::store_to_peer(
            ps + 4 * m, pb,
            make_float4(__int_as_float(best), 0.f, 0.f, 0.f));
    }
  };

  {  // Step 0's candidates: the keys of column 0, nothing to update.
    int best;
    const int c = choose(
        PIVOT && my_row >= 0
            ? matinv::pivot_key(v[(size_t)my_row * m], false, base + my_row,
                                kmask)
            : -1,
        0, best);
    if (warp == c % kCWarps) publish(c, 0, best);
  }

  int ok = 1;
  for (int t = 0; t < m; ++t) {
    const int par = t & 1;
    matinv::bar_wait(&bars[par], (t >> 1) & 1);
    if (tid == 0) matinv::bar_expect(&bars[par], slot_bytes);  // step t + 2
    const float* sl = slots + (size_t)par * nc * ss;
    int p = t;
    if (PIVOT) {
      const int key = __reduce_max_sync(
          kFull, lane < nc ? __float_as_int(sl[lane * ss + m]) : -1);
      p = kmask - (key & kmask);
    }
    const float* prow = sl + (p / rows) * ss;
    const float piv = prow[t];
    ok &= piv != 0.f;
    const float pd = piv == 0.f ? 1.f : piv;
    const int pl = p - base;  // the pivot row, if it is this CTA's
    // The normalized pivot row, a column a thread; column t takes the
    // pivot row's identity entry (1). Read after the step's barrier.
    float* nr = nrow + par * m;
    for (int j = tid; j < m; j += kCThreads)
      nr[j] = __fdiv_rn(j == t ? 1.f : prow[j], pd);
    if (tid == 0) order[t] = p;
    // The elimination factors: column t of the warp's rows.
    float f[kMaxRS];
#pragma unroll
    for (int s = 0; s < kMaxRS; ++s) {
      const int i = warp + kCWarps * s;
      f[s] = s < rs && i < rows ? v[(size_t)i * m + t] : 0.f;
    }
    __syncwarp();  // read before the lane owning column t rewrites it
    if (pl >= 0 && pl < rows && pl % kCWarps == warp)
      used |= 1u << (pl / kCWarps);
    const int tn = t + 1;
    int c = -1;  // the row this CTA publishes for step tn, updated first
    int best = -1;
    if (tn < m) {
      // Column tn first: lane s takes row slot s, with its next key.
      int key = -1;
      if (my_row >= 0) {
        const float fs = matinv::gj::lane_value(f, lane);
        float* x = v + (size_t)my_row * m + tn;
        const float n = __fdiv_rn(prow[tn], pd);
        const float e = my_row == pl ? n : fmaf(-fs, n, *x);
        *x = e;
        if (PIVOT)
          key = matinv::pivot_key(e, (used >> lane) & 1, base + my_row,
                                  kmask);
      }
      c = choose(key, tn, best);
    } else {
      __syncthreads();  // the last step: the normalized row complete
    }
    // The normalized row at this lane's column groups.
    float4 nv[Q4];
#pragma unroll
    for (int q = 0; q < Q4; ++q)
      nv[q] = reinterpret_cast<const float4*>(nr)[lane + 32 * q];
    if (c >= 0 && warp == c % kCWarps) {
      const int sc = c / kCWarps;
      float fc = f[0];
#pragma unroll
      for (int s = 1; s < kMaxRS; ++s) fc = s == sc ? f[s] : fc;
      float4 xr[Q4];
      float4* row = v4 + (size_t)c * m4 + lane;
#pragma unroll
      for (int q = 0; q < Q4; ++q)
        xr[q] = row[32 * q];
#pragma unroll
      for (int q = 0; q < Q4; ++q)
        row[32 * q] = gj_update(xr[q], nv[q], fc, c == pl,
                                4 * (lane + 32 * q), t, tn);
      publish(c, tn, best);
    }
    // The rest: every row but the published one, every column but tn, in
    // chunks of 16 / Q4 row slots, all of a chunk's float4 loaded at once,
    // so no load waits behind a store it could pass (at m = 384 .. 640
    // 5-25% faster than a column group at a time, H100).
    constexpr int kRB = 16 / Q4;
#pragma unroll
    for (int s0 = 0; s0 < kMaxRS; s0 += kRB) {
      float4 xr[kRB][Q4];
#pragma unroll
      for (int sb = 0; sb < kRB; ++sb) {
        const int s = s0 + sb;
        const int i = warp + kCWarps * s;
        if (s < kMaxRS && s < rs && i < rows && i != c) {
#pragma unroll
          for (int q = 0; q < Q4; ++q)
            xr[sb][q] = v4[(size_t)i * m4 + lane + 32 * q];
        }
      }
#pragma unroll
      for (int sb = 0; sb < kRB; ++sb) {
        const int s = s0 + sb;
        const int i = warp + kCWarps * s;
        if (s < kMaxRS && s < rs && i < rows && i != c) {
#pragma unroll
          for (int q = 0; q < Q4; ++q)
            v4[(size_t)i * m4 + lane + 32 * q] = gj_update(
                xr[sb][q], nv[q], f[s < kMaxRS ? s : 0], i == pl,
                4 * (lane + 32 * q), t, tn);
        }
      }
    }
  }
  __syncthreads();  // order[] complete, every row final

  // getInvertedMatrix (FP32.cpp:216-226): slot j holds the inverse's
  // column order[j]; rows stay in pivot-row order. ok: every pivot
  // nonzero and every output finite, over the cluster.
  int finite = 1;
  T* out = inv + item * m * m + (size_t)base * m;
  for (int idx = tid; idx < rows * m; idx += kCThreads) {
    const float x = v[idx];
    finite &= isfinite(x) ? 1 : 0;
    const int i = idx / m;
    store(out + (size_t)i * m + order[idx - i * m], x);
  }
  if (rank == 0)
    for (int j = tid; j < m; j += kCThreads) pos[item * m + j] = order[j];
  finite = __syncthreads_and(finite);
  if (tid == 0) flag[0] = ok && finite;
  cluster.sync();
  if (rank == 0 && tid == 0) {
    int all = 1;
    for (int d = 0; d < nc; ++d) all &= *cluster.map_shared_rank(flag, d);
    ok_out[item] = all;
  }
  cluster.sync();  // rank 0 reads every flag before any CTA exits
}

template <typename T, int Q4>
const void* cluster_kernel_q(int pivot) {
  return pivot ? reinterpret_cast<const void*>(
                     &fused_gj_cluster_kernel<T, true, Q4>)
               : reinterpret_cast<const void*>(
                     &fused_gj_cluster_kernel<T, false, Q4>);
}

// The instantiation for m = 128 Q4 (Q4 = 2 .. 5); null for another m.
template <typename T>
const void* cluster_kernel(int m, int pivot) {
  switch (m) {
    case 2 * kM: return cluster_kernel_q<T, 2>(pivot);
    case 3 * kM: return cluster_kernel_q<T, 3>(pivot);
    case 4 * kM: return cluster_kernel_q<T, 4>(pivot);
    case 5 * kM: return cluster_kernel_q<T, 5>(pivot);
    default: return nullptr;
  }
}

// Checks the geometry the wrapper chose (m a multiple of 128 from 256 to
// 640; 1 to kMaxCluster CTAs dividing m into at most kCWarps * kMaxRS rows
// each; smem at least the count and at most one block's), sets the
// kernel's attributes and fills the launch of `batch` clusters.
cudaError_t cluster_config(const void* kernel, int batch, int m, int cluster,
                           int smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  if (kernel == nullptr || batch < 1 ||
      cluster < 1 || cluster > kMaxCluster || m % cluster != 0 ||
      m / cluster > kCWarps * kMaxRS || smem < 0 ||
      (size_t)smem > kMaxShared ||
      (size_t)smem < cluster_smem_bytes(m, cluster))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * batch, 1, 1);
  cfg->blockDim = dim3(kCThreads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch(const void* a, void* inv, int* pos, int* ok, int batch, int m,
           int pivot, int cluster, int smem, cudaStream_t stream) {
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
  const void* kernel = cluster_kernel<T>(m, pivot);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(kernel, batch, m, cluster, smem, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  int kmask = 1;
  while (kmask < m) kmask *= 2;
  kmask -= 1;
  void* args[] = {&in, &out, &pos, &ok, &m, &kmask};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// a: (batch, m, m) input; inv: (batch, m, m) output in the input type, in
// pivot-row order; pos: (batch, m) int32; ok: (batch,) int32 (m a
// multiple of 128 up to 640). bf16 != 0 means a and inv hold bfloat16,
// else float32. At m = 256 .. 640 each matrix runs on a cluster of
// `cluster` CTAs of `smem` bytes of shared memory (the wrapper's geometry,
// ops/fused.py cluster_geometry); at m = 128 both are ignored. Returns the
// cudaError_t of the launch.
extern "C" int matinv_fused_gj(const void* a, void* inv, int* pos, int* ok,
                               int batch, int m, int pivot, int bf16,
                               int cluster, int smem, void* stream) {
  if (batch < 1 || m < 1 || (m & 127) != 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, inv, pos, ok, batch, m, pivot,
                                      cluster, smem, st)
              : launch<float>(a, inv, pos, ok, batch, m, pivot, cluster, smem,
                              st);
}

// Clusters of the m = 256 .. 640 branch with the given geometry that the
// card can hold at once (cudaOccupancyMaxActiveClusters; 0 means the launch
// would be refused). Returns the cudaError_t of the query.
extern "C" int matinv_fused_clusters(int m, int cluster, int smem,
                                     int* clusters) {
  const void* kernel = cluster_kernel<float>(m, 1);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(kernel, 1, m, cluster, smem, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  cudaGetLastError();  // a refused size must not fail the next launch check
  return err;
}

// Blocks of the m = 128 kernel (fp32, pivoting) that one SM holds at once,
// as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it.
extern "C" int matinv_fused_gj_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_gj_regs_kernel<float, true>, kW * 32, 0);
}
