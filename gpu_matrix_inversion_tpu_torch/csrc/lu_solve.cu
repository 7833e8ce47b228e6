// L5: the spec getrs, x = U^-1 L^-1 P b for (B, n, n) packed factors and
// (B, n, k) right-hand sides, fp64 or fp32.
//
// Replaces the device-side loops of gpu_matrix_inversion_tpu/ops/lu.py:
// _lu_solve_2d (its two lax.fori_loops), which reach no Pallas kernel. The
// port's plain twin (ops/lu.py lu_solve_twin) issues each of its 2 n steps
// as a few tensor operations from the host. L5 serves lu_solve,
// lu_inverse, lu_solve_matrix, refine_solve (every correction of
// solve(..., refine_iters=k) on the LU route) and lu_inverse_refined.
//
// Same operations as the twin in each element's order, so x equals it bit
// for bit: y = P b; forward, y_i = y_i - L_ij * y_j for j = 0 .. i - 1 in
// that order; back, for j = n - 1 .. 0, x_j = y_j / u_jj (IEEE division; a
// zero u_jj divides by 1 and clears ok), then y_i = y_i - U_ij * x_j for
// i < j; each x - f * v rounded twice (__dmul_rn, __dsub_rn; __fmul_rn,
// __fsub_rn in fp32). ok = every u_jj nonzero and x finite. Right-hand
// side columns are independent, and any schedule that keeps each element's
// chain in this order gives the twin's bits: so the steps go in blocks of
// 32; a block's own rows are finished by a chain of 32 steps, then the
// block's 32 updates go, in order, to every row below (forward) or above
// (back).
//
// What bounds it on an H100: 2 n^2 k operations (137 G at n = k = 4096,
// 2.05 ms at the FP32 peak counting a multiply-subtract as two), but kept
// bit-exact nothing fuses into an FMA, so 2 n^2 k lane instructions: 4.1
// ms at 132 SMs x 128 lanes x 1.98 GHz (fp64 half that rate); the
// factor's reads (n^2 values a tile of columns); and the chain of 2 n / 32
// blocks of a tile, each waiting for the one before. Two paths, one
// algorithm, chosen by shape alone (ops/lu.py lu_solve_plan):
//
// The cluster path (lu_solve_kernel_cluster), which replaced the
// per-column kernel at every shape where it was faster on the card: one
// thread-block cluster of C <= 16 CTAs a (matrix, tile of 256 bytes of
// columns: 64 fp32, 32 fp64). The tile's y stays in the cluster's shared
// memory from the gather of P b to the store of x; rows go to the CTAs by
// blocks of 32, cyclically, so the shrinking triangle stays balanced. A
// block step: its owner finishes the block (one thread a column, the 32
// values in registers, the diagonal block's columns read from shared
// memory a step ahead, so a back step's division is done by every column
// at once) and sends the 32 finished rows to every CTA of the cluster (a
// store to the cluster's slot in device memory and one bulk copy
// multicast into each CTA's buffer, completing on its mbarrier); every CTA
// then applies the block's 32 updates to its own rows, a thread holding
// two rows and 16 bytes of columns, the factor's 8-column segments
// prefetched into registers, so a factor value serves 16 bytes of columns
// and a finished value two rows. The owner of the next block first
// updates that block (its factor block staged in shared memory by
// cp.async at the step's start), finishes and sends it, then updates the
// rest of its rows: a lookahead of one. A send into a buffer waits until
// every CTA has applied the buffer's previous block (an arrival on the
// sender's barrier). Each tile reads the factor once (64 MB at n = 4096
// fp32, 4.3 GB over the 64 tiles of k = 4096, mostly from L2).
//
// Measured on an H100 80GB HBM3 at 700 W (probes/l5_paths.py, CUDA
// events, the per-column kernel in the same call): (1, 4096^2, k = 4096)
// fp32 13.45 ms against 35.85 (bound 2.05, bit-exact floor 4.1), fp64
// 46.8 against 54.7; (1, 4096^2, k = 16) 2.29 against 10.39; (64, 128^2,
// k = 128) 0.127 against 0.229 (C = 2). A block step of one tile takes
// ~18,000 cycles (clock64 at k = 16): the lookahead update 2,500, the
// forward chain 2,800 or the back chain 7,900 (32 dependent divisions),
// the multicast ~6,800 (the same for 16 st.async stores of every chunk,
// or the consumers' reads from L2 after a release); so the chain of
// 2 n / 32 steps, not the 4.1 ms of updates, bounds both k = 16 and,
// with 16 tiles in flight, k = 4096.
//
// The per-column path (lu_solve_kernel), kept where it wins or the
// cluster's shared memory cannot hold a tile: n under 512 with few CTAs
// (a lone (1, 256^2) solve: 0.100 ms against 0.140; its 2 n steps are
// short there), and n past 11,776 in fp32. One CTA a (matrix, tile of
// kc <= 16 columns, ops/lu.py lu_solve_geometry); y lives in the output
// in device memory, each CTA reading the whole factor once; each block's
// 32 rows finished by one warp a column (lane = row, the step's value
// passed by a shuffle), then every thread applies the block's updates.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_sync.cuh"
#include "gj_loop.cuh"

namespace {

namespace cg = cooperative_groups;
using matinv::loop::div;
using matinv::loop::kFull;
using matinv::loop::kThreads;
using matinv::loop::kWarps;
using matinv::loop::mul;
using matinv::loop::sub;

constexpr int kBlk = 32;      // steps a block
constexpr int kMaxCols = 16;  // columns a CTA, the per-column path

// ---- The per-column path -------------------------------------------------

// lu: (B, n, n); perm: (B, n) int64; b and x: (B, n, k); flags: (B, tiles)
// int32, each CTA's share of ok. CTA item * tiles + t solves columns
// [t kc, t kc + kc) of matrix item.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_solve_kernel(const T* __restrict__ lu, const long long* __restrict__ perm,
                const T* __restrict__ b, T* __restrict__ x,
                int* __restrict__ flags, int n, int k, int kc) {
  __shared__ T yb[kBlk][kMaxCols];  // the block's finished values
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = (k + kc - 1) / kc;
  const size_t item = blockIdx.x / tiles;
  const int col0 = (int)(blockIdx.x - item * tiles) * kc;
  const int nc = min(kc, k - col0);
  const T* a = lu + item * n * n;
  T* y = x + item * n * k + col0;
  const T* rhs = b + item * n * k + col0;
  const long long* pm = perm + item * n;

  for (int idx = tid; idx < n * nc; idx += kThreads) {
    const int i = idx / nc;
    const int c = idx - i * nc;
    y[(size_t)i * k + c] = rhs[(size_t)pm[i] * k + c];
  }
  __syncthreads();

  // Forward: L unit lower.
  for (int j0 = 0; j0 < n; j0 += kBlk) {
    const int bs = min(kBlk, n - j0);
    for (int c = warp; c < nc; c += kWarps) {
      const int i = j0 + lane;
      T v = lane < bs ? y[(size_t)i * k + c] : T(0);
      for (int jj = 0; jj < bs; ++jj) {
        const T vj = __shfl_sync(kFull, v, jj);
        if (lane > jj && lane < bs)
          v = sub(v, mul(a[(size_t)i * n + j0 + jj], vj));
      }
      if (lane < bs) {
        y[(size_t)i * k + c] = v;
        yb[lane][c] = v;
      }
    }
    __syncthreads();
    const int below = n - j0 - bs;
    for (int idx = tid; idx < below * nc; idx += kThreads) {
      const int i = j0 + bs + idx / nc;
      const int c = idx % nc;
      const T* l = a + (size_t)i * n + j0;
      T acc = y[(size_t)i * k + c];
      if (bs == kBlk) {
#pragma unroll
        for (int jj = 0; jj < kBlk; ++jj)
          acc = sub(acc, mul(l[jj], yb[jj][c]));
      } else {
        for (int jj = 0; jj < bs; ++jj)
          acc = sub(acc, mul(l[jj], yb[jj][c]));
      }
      y[(size_t)i * k + c] = acc;
    }
    __syncthreads();
  }

  // Back substitution: U x = y, the blocks from the last.
  for (int j0 = ((n - 1) / kBlk) * kBlk; j0 >= 0; j0 -= kBlk) {
    const int bs = min(kBlk, n - j0);
    for (int c = warp; c < nc; c += kWarps) {
      const int i = j0 + lane;
      T v = lane < bs ? y[(size_t)i * k + c] : T(0);
      for (int jj = bs - 1; jj >= 0; --jj) {
        if (lane == jj) {
          const T u = a[(size_t)i * n + i];
          v = div(v, u == T(0) ? T(1) : u);
        }
        const T xj = __shfl_sync(kFull, v, jj);
        if (lane < jj) v = sub(v, mul(a[(size_t)i * n + j0 + jj], xj));
      }
      if (lane < bs) {
        y[(size_t)i * k + c] = v;
        yb[lane][c] = v;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < j0 * nc; idx += kThreads) {
      const int i = idx / nc;
      const int c = idx % nc;
      const T* u = a + (size_t)i * n + j0;
      T acc = y[(size_t)i * k + c];
      if (bs == kBlk) {
#pragma unroll
        for (int jj = kBlk - 1; jj >= 0; --jj)
          acc = sub(acc, mul(u[jj], yb[jj][c]));
      } else {
        for (int jj = bs - 1; jj >= 0; --jj)
          acc = sub(acc, mul(u[jj], yb[jj][c]));
      }
      y[(size_t)i * k + c] = acc;
    }
    __syncthreads();
  }

  int good = 1;
  for (int i = tid; i < n; i += kThreads)
    good &= a[(size_t)i * n + i] != T(0);
  for (int idx = tid; idx < n * nc; idx += kThreads) {
    const int i = idx / nc;
    good &= isfinite(y[(size_t)i * k + idx - i * nc]) ? 1 : 0;
  }
  good = __syncthreads_and(good);
  if (tid == 0) flags[blockIdx.x] = good;
}

// ---- The cluster path ----------------------------------------------------

// A tile's row: 256 bytes, 64 fp32 or 32 fp64 right-hand-side columns.
constexpr int kRowBytes = 256;
constexpr int kMaxCluster = 16;

template <typename T>
struct Vec16;  // 16 bytes of T: one load or store a lane
template <>
struct Vec16<float> {
  using type = float4;
  __device__ static void unpack(float4 t, float (&v)[4]) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static float4 pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  __device__ static void unpack(double2 t, double (&v)[2]) {
    v[0] = t.x; v[1] = t.y;
  }
  __device__ static double2 pack(const double (&v)[2]) {
    return make_double2(v[0], v[1]);
  }
};

template <typename T>
struct Tile {
  static constexpr int kV = 16 / sizeof(T);          // values a 16-byte op
  static constexpr int kCols = kRowBytes / sizeof(T);  // columns a tile
  static constexpr int kLd = kCols + kV;  // a row's stride in shared memory
};

// Dynamic shared memory of a CTA of a cluster of `cl` at order n: two
// barriers of each kind, the two buffers of finished values (32 rows of a
// tile each), the owner's two blocks of the factor (fetch_block) and the
// CTA's rows of y (padded rows). ops/lu.py lu_solve_smem computes the
// same.
inline size_t cluster_smem_bytes(int n, int cl, int tsize) {
  const size_t blocks = ((size_t)(n + kBlk - 1) / kBlk + cl - 1) / cl;
  return 32 + 2 * kBlk * kRowBytes + 2 * kBlk * (kBlk * tsize + 16) +
         blocks * kBlk * (kRowBytes + 16);
}

// Row g's values at columns j .. j + kSeg - 1 of the factor into f; zero
// past the matrix (g >= n or a column >= n). kVec: rows start on 16 bytes
// (n * sizeof(T) a multiple of 16), so whole 16-byte loads.
constexpr int kSeg = 8;
template <typename T, bool kVec>
__device__ __forceinline__ void load_seg(const T* a, int n, int g, int j,
                                         T (&f)[kSeg]) {
  constexpr int V = Tile<T>::kV;
  using VT = typename Vec16<T>::type;
  const T* row = a + (size_t)g * n + j;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kSeg; q += V) {
      T t[V];
      if (g < n && j + q < n) {
        Vec16<T>::unpack(__ldg(reinterpret_cast<const VT*>(row + q)), t);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) t[e] = T(0);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) f[q + e] = t[e];
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSeg; ++q)
      f[q] = g < n && j + q < n ? __ldg(row + q) : T(0);
  }
}

// Local blocks [lb0, lb1) of this CTA's rows take block J's 32 updates
// (columns j0 .. j0 + 31) from the finished values `fin` (32 rows of the
// tile), each element in the twin's order: j ascending forward,
// descending back. A thread holds rows rl and rl + 16 of a block and 16
// bytes of columns, so a factor value serves 16 bytes of columns out of a
// register and a finished value two rows; the factor comes in segments of
// kSeg columns, the next segment (or the next block's first) loaded while
// this one is applied. Past the matrix the factor reads zero and the
// finished rows are zero, so x - 0 * 0 leaves x's bits as they are.
template <typename T, bool kVec, bool kFwd>
__device__ __noinline__ void update_blocks(T* ys, const T* fin,
                                           const T* a, int n, int j0,
                                           int lb0, int lb1, int rank,
                                           int cl) {
  constexpr int V = Tile<T>::kV;
  constexpr int KC = Tile<T>::kCols;
  constexpr int LD = Tile<T>::kLd;
  constexpr int kSegs = kBlk / kSeg;
  using VT = typename Vec16<T>::type;
  const int cgp = threadIdx.x & 15;
  const int rl = threadIdx.x >> 4;
  if (lb0 >= lb1) return;
  // Segment i of a block in the chain's order: columns from j0.
  auto seg_col = [&](int i) {
    return j0 + (kFwd ? i : kSegs - 1 - i) * kSeg;
  };
  auto row_of = [&](int lb) { return (rank + lb * cl) * kBlk + rl; };
  T f[2][kSeg];
  load_seg<T, kVec>(a, n, row_of(lb0), seg_col(0), f[0]);
  load_seg<T, kVec>(a, n, row_of(lb0) + 16, seg_col(0), f[1]);
  for (int lb = lb0; lb < lb1; ++lb) {
    T* y0 = ys + (size_t)(lb * kBlk + rl) * LD + cgp * V;
    T* y1 = y0 + 16 * LD;
    T acc[2][V];
    Vec16<T>::unpack(*reinterpret_cast<const VT*>(y0), acc[0]);
    Vec16<T>::unpack(*reinterpret_cast<const VT*>(y1), acc[1]);
#pragma unroll
    for (int i = 0; i < kSegs; ++i) {
      T fn[2][kSeg];
      if (i + 1 < kSegs) {
        load_seg<T, kVec>(a, n, row_of(lb), seg_col(i + 1), fn[0]);
        load_seg<T, kVec>(a, n, row_of(lb) + 16, seg_col(i + 1), fn[1]);
      } else if (lb + 1 < lb1) {
        load_seg<T, kVec>(a, n, row_of(lb + 1), seg_col(0), fn[0]);
        load_seg<T, kVec>(a, n, row_of(lb + 1) + 16, seg_col(0), fn[1]);
      }
      const int jb = (kFwd ? i : kSegs - 1 - i) * kSeg;
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        const int q = kFwd ? t : kSeg - 1 - t;
        T yv[V];
        Vec16<T>::unpack(
            *reinterpret_cast<const VT*>(fin + (jb + q) * KC + cgp * V), yv);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[r][e] = sub(acc[r][e], mul(f[r][q], yv[e]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < kSeg; ++q) f[r][q] = fn[r][q];
    }
    *reinterpret_cast<VT*>(y0) = Vec16<T>::pack(acc[0]);
    *reinterpret_cast<VT*>(y1) = Vec16<T>::pack(acc[1]);
  }
}

// A 32 x 32 block of the factor (rows from r0, columns from c0) into
// shared memory by cp.async, zero past the matrix: row-major in `lf` (a
// row of kBlkLd values) or, where kT, transposed in `dg` (dg[j * kBlkLd +
// i] = A[r0 + i][c0 + j]). Issued ahead; cp.async.wait_all before use.
template <typename T>
struct Blk {
  static constexpr int kLd = kBlk + 16 / sizeof(T);  // rows on 16 bytes
};

template <typename T, bool kT>
__device__ __noinline__ void fetch_block(T* dst, const T* a, int n, int r0,
                                         int c0) {
  for (int idx = threadIdx.x; idx < kBlk * kBlk; idx += kThreads) {
    const int i = idx / kBlk;
    const int j = idx % kBlk;
    const bool in = r0 + i < n && c0 + j < n;
    const T* src = in ? a + (size_t)(r0 + i) * n + c0 + j : a;
    T* d = dst + (kT ? j * Blk<T>::kLd + i : i * Blk<T>::kLd + j);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                     matinv::smem_addr(d)),
                 "l"(src), "n"((int)sizeof(T)), "r"(in ? (int)sizeof(T) : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The lookahead: local block lb's 32 rows take block J's 32 updates from
// `fin` in the twin's order, as update_blocks does, with the factor's
// 32 x 32 block for these rows already in shared memory (`lf`, from
// fetch_block): each thread's 2 x 32 factor values read at once.
template <typename T, bool kFwd>
__device__ __noinline__ void update_staged(T* ys, const T* fin, const T* lf,
                                           int lb) {
  constexpr int V = Tile<T>::kV;
  constexpr int KC = Tile<T>::kCols;
  constexpr int LD = Tile<T>::kLd;
  using VT = typename Vec16<T>::type;
  const int cgp = threadIdx.x & 15;
  const int rl = threadIdx.x >> 4;
  T f[2][kBlk];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < kBlk; q += V) {
      T e[V];
      Vec16<T>::unpack(*reinterpret_cast<const VT*>(
                           lf + (rl + 16 * r) * Blk<T>::kLd + q),
                       e);
#pragma unroll
      for (int t = 0; t < V; ++t) f[r][q + t] = e[t];
    }
  T* y0 = ys + (size_t)(lb * kBlk + rl) * LD + cgp * V;
  T* y1 = y0 + 16 * LD;
  T acc[2][V];
  Vec16<T>::unpack(*reinterpret_cast<const VT*>(y0), acc[0]);
  Vec16<T>::unpack(*reinterpret_cast<const VT*>(y1), acc[1]);
#pragma unroll
  for (int t = 0; t < kBlk; ++t) {
    const int jj = kFwd ? t : kBlk - 1 - t;
    T yv[V];
    Vec16<T>::unpack(*reinterpret_cast<const VT*>(fin + jj * KC + cgp * V),
                     yv);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[r][e] = sub(acc[r][e], mul(f[r][jj], yv[e]));
  }
  *reinterpret_cast<VT*>(y0) = Vec16<T>::pack(acc[0]);
  *reinterpret_cast<VT*>(y1) = Vec16<T>::pack(acc[1]);
}

// Column j of the diagonal block, rows [q0, q1) (multiples of 16 bytes'
// worth), from `dg` into d.
template <typename T>
__device__ __forceinline__ void load_col(const T* dg, int j, int q0, int q1,
                                         T (&d)[kBlk]) {
  constexpr int V = Tile<T>::kV;
  using VT = typename Vec16<T>::type;
#pragma unroll
  for (int q = q0; q < q1; q += V) {
    T e[V];
    Vec16<T>::unpack(*reinterpret_cast<const VT*>(dg + j * Blk<T>::kLd + q),
                     e);
#pragma unroll
    for (int r = 0; r < V; ++r) d[q + r] = e[r];
  }
}

// The owner's chain over block J (its local block lb): one thread a
// column of the tile, the block's 32 values in its registers, the
// diagonal block's column j read from `dg` (every lane the same address)
// a step ahead. Forward: for j ascending, y_i -= L_ij y_j for the rows
// i > j of the block; back: for j descending, x_j = y_j / u_jj (1 for a
// zero u_jj), then y_i -= U_ij x_j for i < j: each element's chain in the
// twin's order, and a step's division done by every column at once. Rows
// past the matrix end as zero.
template <typename T, bool kFwd>
__device__ __noinline__ void finalize_block(T* ys, const T* dg, int n,
                                            int J, int lb) {
  constexpr int V = Tile<T>::kV;
  constexpr int KC = Tile<T>::kCols;
  constexpr int LD = Tile<T>::kLd;
  const int c = threadIdx.x;
  if (c >= KC) return;  // whole warps
  const int bs = min(kBlk, n - J * kBlk);
  T* yc = ys + (size_t)lb * kBlk * LD + c;
  T v[kBlk];
#pragma unroll
  for (int i = 0; i < kBlk; ++i) v[i] = yc[i * LD];
  // Rows of column j a step reads: below j forward, j and above back.
  auto lo_of = [](int j) { return kFwd ? (j + 1) / V * V : 0; };
  auto hi_of = [](int j) { return kFwd ? kBlk : (j / V + 1) * V; };
  T d[kBlk];
  load_col(dg, kFwd ? 0 : kBlk - 1, lo_of(kFwd ? 0 : kBlk - 1),
           hi_of(kFwd ? 0 : kBlk - 1), d);
#pragma unroll
  for (int t = 0; t < kBlk; ++t) {
    const int j = kFwd ? t : kBlk - 1 - t;
    T dn[kBlk];
    if (t + 1 < kBlk) {
      const int jn = kFwd ? j + 1 : j - 1;
      load_col(dg, jn, lo_of(jn), hi_of(jn), dn);
    }
    if (j < bs) {
      if (!kFwd) {
        const T u = d[j];
        v[j] = div(v[j], u == T(0) ? T(1) : u);
      }
#pragma unroll
      for (int i = kFwd ? j + 1 : 0; i < (kFwd ? kBlk : j); ++i)
        if (!kFwd || i < bs) v[i] = sub(v[i], mul(d[i], v[j]));
    }
#pragma unroll
    for (int i = 0; i < kBlk; ++i) d[i] = dn[i];
  }
#pragma unroll
  for (int i = 0; i < kBlk; ++i) yc[i * LD] = i < bs ? v[i] : T(0);
}

// Local block lb's 32 finished rows into buffer `fin` of every CTA of the
// cluster: stored to the cluster's slot `slot` in device memory, then one
// bulk copy multicast to every CTA's `fin` (the same offset in each),
// completing on each CTA's barrier `full`. Every thread's stores are
// ordered before the copy's reads by the proxy fence and the block
// barrier.
template <typename T>
__device__ __noinline__ void push_block(const T* ys, T* slot, T* fin,
                                        uint64_t* full, int lb, int cl) {
  constexpr int V = Tile<T>::kV;
  constexpr int KC = Tile<T>::kCols;
  constexpr int LD = Tile<T>::kLd;
  constexpr int kChunks = kBlk * kRowBytes / 16;
  for (int idx = threadIdx.x; idx < kChunks; idx += kThreads) {
    const int row = idx / (kRowBytes / 16);
    const int q = idx % (kRowBytes / 16);
    *reinterpret_cast<uint4*>(slot + row * KC + q * V) =
        *reinterpret_cast<const uint4*>(ys + (size_t)(lb * kBlk + row) * LD +
                                        q * V);
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint16_t mask = (uint16_t)((1u << cl) - 1);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
            matinv::smem_addr(fin)),
        "l"(slot), "r"((uint32_t)(kBlk * kRowBytes)),
        "r"(matinv::smem_addr(full)), "h"(mask)
        : "memory");
  }
}

// One cluster of cl CTAs a (matrix, tile of kCols columns): cluster
// `tile` = blockIdx.x / cl solves columns [t kCols, t kCols + kCols) of
// matrix item. Rows go to CTAs by blocks of 32, block J to rank J % cl,
// and stay in that CTA's shared memory (ys, local block J / cl) from the
// gather of P b to the store of x. Step s of 2 nb: block J = s forward,
// then J = 2 nb - 1 - s back. At step s every CTA waits for block J's
// finished rows (buffer s % 2, pushed by J's owner) and applies them; the
// owner of step s + 1's block first applies them to that block, finishes
// it and pushes it, then updates the rest of its rows: a lookahead of one
// step. A push into buffer p waits until every CTA has applied that
// buffer's previous block (each CTA arrives on the pusher's barrier
// empty[p] when it starts the next step). flags: (B, tiles * cl), each
// CTA's share of ok. Two CTAs an SM in fp32 (128 registers a thread); fp64's 64
// factor values take twice the registers.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
lu_solve_kernel_cluster(const T* __restrict__ lu,
                        const long long* __restrict__ perm,
                        const T* __restrict__ b, T* __restrict__ x,
                        int* __restrict__ flags, T* __restrict__ work, int n,
                        int k) {
  constexpr int KC = Tile<T>::kCols;
  constexpr int LD = Tile<T>::kLd;
  constexpr uint32_t kBytes = kBlk * kRowBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nb = (n + kBlk - 1) / kBlk;
  const int nbl_max = (nb + cl - 1) / cl;
  const int nbl = rank < nb ? (nb - 1 - rank) / cl + 1 : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // (2,)
  uint64_t* empty = full + 2;                          // (2,)
  T* fin = reinterpret_cast<T*>(smem + 32);            // (2, 32, KC)
  T* dg = fin + 2 * kBlk * KC;   // (32, Blk<T>::kLd), transposed
  T* lf = dg + kBlk * Blk<T>::kLd;  // (32, Blk<T>::kLd)
  T* ys = lf + kBlk * Blk<T>::kLd;  // (nbl_max * 32, LD)

  const int tiles = (k + KC - 1) / KC;
  const size_t tile = blockIdx.x / cl;
  const size_t item = tile / tiles;
  const int col0 = (int)(tile - item * tiles) * KC;
  const int nc = min(KC, k - col0);
  const T* a = lu + item * n * n;
  const T* rhs = b + item * n * k + col0;
  const long long* pm = perm + item * n;
  T* slots = work + tile * 2 * kBlk * KC;  // the cluster's two slots

  for (int idx = tid; idx < nbl_max * kBlk * KC; idx += kThreads) {
    const int lr = idx / KC;
    const int c = idx % KC;
    const int g = (rank + (lr / kBlk) * cl) * kBlk + lr % kBlk;
    ys[(size_t)lr * LD + c] =
        g < n && c < nc ? rhs[(size_t)pm[g] * k + c] : T(0);
  }
  if (tid == 0) {
    matinv::bars_start(full, kBytes);
    matinv::bar_init_count(&empty[0], cl);
    matinv::bar_init_count(&empty[1], cl);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // the rows gathered, every peer's barriers armed

  if (rank == 0) {  // block 0 needs no update before its chain
    fetch_block<T, true>(dg, a, n, 0, 0);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    finalize_block<T, true>(ys, dg, n, 0, 0);
    __syncthreads();
    push_block(ys, slots, fin, &full[0], 0, cl);
  }
  const int steps = 2 * nb;
  uint32_t empty_uses[2] = {0, 0};
  for (int s = 0; s < steps; ++s) {
    const int p = s & 1;
    // This CTA's reads of buffer p ^ 1 (step s - 1) are done: tell the
    // owner of step s + 1, which pushes into it next.
    __syncthreads();
    const int s1 = s + 1;
    const int J1 = s1 < nb ? s1 : steps - 1 - s1;
    if (tid == 0 && s >= 1 && s1 < steps)
      matinv::bar_arrive_peer(matinv::peer_addr(
          matinv::smem_addr(&empty[p ^ 1]), J1 % cl));
    const bool own1 = s1 < steps && J1 % cl == rank;
    const bool fwd = s < nb;
    const int J = fwd ? s : steps - 1 - s;
    if (own1) {  // the next block's diagonal and its rows' block J, ahead
      fetch_block<T, true>(dg, a, n, J1 * kBlk, J1 * kBlk);
      fetch_block<T, false>(lf, a, n, J1 * kBlk, J * kBlk);
    }

    const T* fs = fin + p * kBlk * KC;
    matinv::bar_wait(&full[p], (s >> 1) & 1);
    if (tid == 0 && s + 2 < steps) matinv::bar_expect(&full[p], kBytes);
    // Local blocks [b0, b1) take block J's updates.
    auto update = [&](int b0, int b1) {
      if (fwd)
        update_blocks<T, kVec, true>(ys, fs, a, n, J * kBlk, b0, b1, rank,
                                     cl);
      else
        update_blocks<T, kVec, false>(ys, fs, a, n, J * kBlk, b0, b1, rank,
                                      cl);
    };
    // This CTA's local blocks that take block J's updates: below J
    // forward, above J back.
    int lo = 0;
    int hi = 0;
    if (fwd) {
      lo = J >= rank ? (J - rank) / cl + 1 : 0;
      hi = nbl;
    } else {
      hi = J > rank ? (J - rank - 1) / cl + 1 : 0;
    }
    if (own1) {
      const int lb1 = J1 / cl;
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
      if (lb1 >= lo && lb1 < hi) {  // block J1 first: the lookahead
        if (fwd) {
          update_staged<T, true>(ys, fs, lf, lb1);
          lo = lb1 + 1;
        } else {
          update_staged<T, false>(ys, fs, lf, lb1);
          hi = lb1;
        }
        __syncthreads();
      }
      if (s1 < nb)
        finalize_block<T, true>(ys, dg, n, J1, lb1);
      else
        finalize_block<T, false>(ys, dg, n, J1, lb1);
      if (s1 >= 2) {
        matinv::bar_wait(&empty[p ^ 1], empty_uses[p ^ 1] & 1);
        ++empty_uses[p ^ 1];
      }
      __syncthreads();
      push_block(ys, slots + (p ^ 1) * kBlk * KC, fin + (p ^ 1) * kBlk * KC,
                 &full[p ^ 1], lb1, cl);
    }
    update(lo, hi);
  }
  __syncthreads();

  T* y = x + item * n * k + col0;
  int good = 1;
  for (int idx = tid; idx < nbl * kBlk * KC; idx += kThreads) {
    const int lr = idx / KC;
    const int c = idx % KC;
    const int g = (rank + (lr / kBlk) * cl) * kBlk + lr % kBlk;
    if (g < n && c < nc) {
      const T v = ys[(size_t)lr * LD + c];
      y[(size_t)g * k + c] = v;
      good &= isfinite(v) ? 1 : 0;
    }
  }
  for (int lr = tid; lr < nbl * kBlk; lr += kThreads) {
    const int g = (rank + (lr / kBlk) * cl) * kBlk + lr % kBlk;
    if (g < n) good &= a[(size_t)g * n + g] != T(0);
  }
  good = __syncthreads_and(good);
  if (tid == 0) flags[blockIdx.x] = good;
  cluster.sync();  // no CTA leaves while a peer may still reach it
}

template <typename T>
int launch_columns(const void* lu, const void* perm, const void* b, void* x,
                   int* flags, int batch, int n, int k, int kc,
                   cudaStream_t stream) {
  if (batch < 1 || n < 1 || k < 1 || kc < 1 || kc > kMaxCols)
    return cudaErrorInvalidValue;
  const long long ctas = (long long)batch * ((k + kc - 1) / kc);
  if (ctas > 0x7fffffffll) return cudaErrorInvalidValue;
  lu_solve_kernel<T><<<(unsigned)ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(lu), static_cast<const long long*>(perm),
      static_cast<const T*>(b), static_cast<T*>(x), flags, n, k, kc);
  return cudaGetLastError();
}

template <typename T>
int launch_cluster(const void* lu, const void* perm, const void* b, void* x,
                   int* flags, void* work, int batch, int n, int k, int cl,
                   cudaStream_t stream) {
  if (batch < 1 || n < 1 || k < 1 || cl < 1 || cl > kMaxCluster ||
      work == nullptr || reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = cluster_smem_bytes(n, cl, sizeof(T));
  const long long ctas =
      (long long)batch * ((k + Tile<T>::kCols - 1) / Tile<T>::kCols) * cl;
  if (smem > matinv::loop::kMaxShared || ctas > 0x7fffffffll)
    return cudaErrorInvalidValue;
  // Whole 16-byte loads of the factor where its rows start on 16 bytes.
  const bool vec = (n * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(lu) % 16 == 0;
  const void* kernel =
      vec ? reinterpret_cast<const void*>(&lu_solve_kernel_cluster<T, true>)
          : reinterpret_cast<const void*>(&lu_solve_kernel_cluster<T, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const T* lu_t = static_cast<const T*>(lu);
  const long long* perm_t = static_cast<const long long*>(perm);
  const T* b_t = static_cast<const T*>(b);
  T* x_t = static_cast<T*>(x);
  T* work_t = static_cast<T*>(work);
  void* args[] = {&lu_t, &perm_t, &b_t, &x_t, &flags, &work_t, &n, &k};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(const void* lu, const void* perm, const void* b, void* x,
           int* flags, void* work, int batch, int n, int k, int kc,
           int cluster, cudaStream_t stream) {
  if (cluster == 0)
    return launch_columns<T>(lu, perm, b, x, flags, batch, n, k, kc, stream);
  if (kc != Tile<T>::kCols) return cudaErrorInvalidValue;
  return launch_cluster<T>(lu, perm, b, x, flags, work, batch, n, k,
                           cluster, stream);
}

}  // namespace

// lu: (batch, n, n) packed factors; perm: (batch, n) int64; b: (batch, n,
// k) right-hand sides; x: (batch, n, k) solutions; fp64 != 0 means double,
// else float. cluster 0, the per-column path: kc columns a CTA, 1 .. 16,
// flags (batch, ceil(k / kc)) int32, work unused; cluster 1 .. 16, the
// cluster path: kc the tile's columns (64 fp32, 32 fp64), flags (batch,
// ceil(k / kc) * cluster), each CTA's share of ok, work (batch, ceil(k /
// kc), 2, 32, kc) values, each cluster's two slots of finished rows
// (ops/lu.py lu_solve_plan chooses). Returns the cudaError_t of the launch.
extern "C" int matinv_lu_solve(const void* lu, const void* perm,
                               const void* b, void* x, int* flags, void* work,
                               int batch, int n, int k, int kc, int cluster,
                               int fp64, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return fp64 ? launch<double>(lu, perm, b, x, flags, work, batch, n, k, kc,
                               cluster, st)
              : launch<float>(lu, perm, b, x, flags, work, batch, n, k, kc,
                              cluster, st);
}
