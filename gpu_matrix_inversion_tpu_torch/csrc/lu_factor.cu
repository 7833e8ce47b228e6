// L4's grid path: the spec getrf of one (n, n) fp64 or fp32 matrix at a
// time as a blocked right-looking factorization on a persistent grid, for
// n > 511 (ops/lu.py lu_factor_plan; the cluster branch of
// gauss_jordan.cu takes n <= 511; past n ~ 16,700 in fp64 and ~24,900 in
// fp32 a CTA's places outgrow its shared memory and the plan refuses).
//
// Replaces, with gauss_jordan.cu's LU mode, the device-side loop of
// gpu_matrix_inversion_tpu/ops/lu.py:_lu_factor_2d (its lax.fori_loop),
// which reaches no Pallas kernel. Same (lu, perm, ok) as the plain twin
// (ops/lu.py lu_factor_twin) bit for bit: every element takes the twin's
// operations in the twin's order, only grouped otherwise.
//
// The twin, step r: the pivot is the first maximum of |column r| over the
// places >= r (NaN counted as the largest, ties to the lowest place), the
// rows swap, f = x_r / pivot (IEEE division; a zero pivot divides by 1
// and clears ok) on the places > r and +0 on every other row, every row
// takes x - f * v on the columns > r (two roundings: mul, then sub), and
// f is deposited in column r. So an element below the diagonal takes
// x - f_s * u_s for s ascending, u_s the pivot row of step s as it stood
// then; and a U entry (place i, column j > i) takes, after its own real
// updates, x - 0 * u_s for s = i .. j - 1, itself first. Those make NaN
// where any u_s there is not finite, turn a -0 into +0 (its own step:
// -0 - (0 * -0)), and leave every other value as it is.
//
// Per panel of B = 64 columns [k0, k0 + B):
//   the chain: each CTA holds its rows' panel columns in shared memory. A
//     step's proposals (each CTA's best eligible row) go through device
//     memory as 16-byte words that carry 8 bytes of data and the step's
//     stamp twice (a reader spins until both stamps are the step's), so a
//     step needs no grid barrier and no fence. A proposal's header carries
//     what the next step needs of the winner (Prop below), so warp 0 runs
//     the chain from the headers alone: the winner, the rows' multipliers
//     and next two columns (held in registers), the next header; the
//     winner's panel values arrive meanwhile, and warps 1-7 update the
//     rest of the panel and publish the CTA's values, off the chain;
//   the U rows right of the panel (u_rows): each CTA a slice of the
//     columns, a lane a column, the pivot rows in registers across the
//     warps, each taking the panel's earlier steps' updates in step order;
//   the trailing pass (trailing): each CTA its rows below the panel, on
//     every column right of it, the panel's B updates in step order with
//     the rows' multipliers in shared memory and the U rows staged there
//     by cp.async a chunk ahead, each thread holding 16 bytes of columns
//     of as few rows as the CTA's rows below the panel need (4 at most a
//     pass): the trailing matrix read and written once a panel, not B
//     times.
// Rows never move: the places (phys, the row at each place; posl, the
// place of each of the CTA's rows) replay the twin's swaps, and the store
// writes each row to its place. The zero updates of the U entries are
// applied there: marks[j], the largest place < j whose U value in column
// j is not finite (or -1), noted as each U value is made, makes NaN of
// every U entry of column j at a place <= marks[j], and every other -0
// above the diagonal +0.
//
// What bounds it on an H100: 2 n^3 / 3 operations (45.8 GFLOP at
// n = 4096: 0.68 ms at the FP32 peak; bit-exact, nothing fuses into an
// FMA), the trailing passes' traffic, and the chain of n steps. Measured
// on an H100 80GB HBM3 at 700 W (CUDA events; clock64 laps of CTA 0): at
// (1, 4096^2) fp32 ~14.9 ms, of which the chain ~8 ms (a step ~2 us: the
// headers' trip through L2 and the wait for the last CTA's, then the
// division, two updates and the warp's pick, ~0.6 us), the trailing
// passes ~4 ms and the U rows ~1.1 ms; (1, 2048^2) fp64 ~7.1 ms. A
// look-ahead that spread each trailing pass over the next panel's chain in
// warps 1-7 slowed the chain about as much as it hid (PERF.md).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_sync.cuh"
#include "gj_loop.cuh"

namespace {

using namespace matinv::loop;

// Rows a lane of warp 0 holds in the chain: a CTA has at most 32 times as
// many (ops/lu.py lu_factor_plan keeps the places within shared memory,
// which bounds them first).
template <typename T>
constexpr int kRowsW = sizeof(T) == 4 ? 6 : 4;
constexpr int kChunkBytes = 512;     // a staged U row's bytes (32 lanes x 16)
constexpr unsigned long long kWaitNs = 10000000000ull;  // a 10 s wait traps

// Values a 16-byte word of a proposal carries: 8 bytes, two fp32 or one
// fp64, beside the stamp twice.
template <typename T>
struct Words;
template <>
struct Words<float> {
  static constexpr int kPer = 2;
  __device__ static void pack(const float* v, uint32_t& d0, uint32_t& d1) {
    d0 = __float_as_uint(v[0]);
    d1 = __float_as_uint(v[1]);
  }
  __device__ static void unpack(uint32_t d0, uint32_t d1, float* v) {
    v[0] = __uint_as_float(d0);
    v[1] = __uint_as_float(d1);
  }
  __device__ static float nan() { return __uint_as_float(0x7fc00000u); }
};
template <>
struct Words<double> {
  static constexpr int kPer = 1;
  __device__ static void pack(const double* v, uint32_t& d0, uint32_t& d1) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(*v);
    d0 = (uint32_t)b;
    d1 = (uint32_t)(b >> 32);
  }
  __device__ static void unpack(uint32_t d0, uint32_t d1, double* v) {
    *v = __longlong_as_double(
        (long long)(((unsigned long long)d1 << 32) | d0));
  }
  __device__ static double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
};

// A proposal for step s (local column t): the header, then the row's B
// panel values. The header holds the row, its place and four values: the
// row's columns t and t + 1 as step s - 1 left them (the pivot if it
// wins, whose |value| is the key, and the next column's), its column
// t + 2 as step s - 2 left it, and its multiplier of step s - 1; a reader
// applies that last update itself, with the winner of step s - 1's value
// at column t + 2. So the rows' columns t + 1 and t + 2, and the next
// proposal, need nothing more of the winner than its header: its panel
// values are read off the chain. fp32 two values a word, fp64 one.
template <typename T, int B>
struct Prop {
  static constexpr int kHead = sizeof(T) == 4 ? 3 : 5;
  static constexpr int kData = B * (int)sizeof(T) / 8;
  static constexpr int kWords = kHead + kData;
};

__device__ __forceinline__ void put(uint4* p, uint32_t d0, uint32_t d1,
                                    uint32_t stamp) {
  asm volatile("st.relaxed.gpu.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(d0), "r"(stamp), "r"(d1), "r"(stamp)
               : "memory");
}

__device__ __forceinline__ uint4 peek(const uint4* p) {
  uint4 v;
  asm volatile("ld.relaxed.gpu.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ bool stamped(uint4 v, uint32_t stamp) {
  return v.y == stamp && v.w == stamp;
}

__device__ __forceinline__ void check_wait(unsigned long long t0) {
  if (global_ns() - t0 > kWaitNs) __trap();
}

// One word of step `stamp`, spinning until it has come.
__device__ __forceinline__ uint4 get(const uint4* p, uint32_t stamp) {
  uint4 v = peek(p);
  if (stamped(v, stamp)) return v;
  const unsigned long long t0 = global_ns();
  for (;;) {
    v = peek(p);
    if (stamped(v, stamp)) return v;
    check_wait(t0);
  }
}

// Named barriers of `count` threads: a wait, and an arrival that does not
// wait (the threads that wait see the memory the arriving ones wrote).
// Each thread counts on its own (no .aligned), after its warp has
// reconverged.
__device__ __forceinline__ void named_sync(int id, int count) {
  __syncwarp();
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  __syncwarp();
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// A slot holds one step's proposals of the g CTAs: their headers' words
// first, word e of CTA r at e * g + r (so a warp's reads of the headers
// are contiguous), then their panel values, CTA r's at H g + r kData.
//
// The header of CTA r's proposal: row (< 0: none), place and the four
// values.
template <typename T>
__device__ __forceinline__ void put_head(uint4* slot, int g, int r, int row,
                                         int place, const T (&v)[4],
                                         uint32_t stamp) {
  uint32_t d0, d1;
  if constexpr (sizeof(T) == 4) {
    Words<T>::pack(v, d0, d1);
    put(slot + r, d0, d1, stamp);
    Words<T>::pack(v + 2, d0, d1);
    put(slot + 2 * g + r, d0, d1, stamp);
  } else {
    Words<T>::pack(v, d0, d1);
    put(slot + r, d0, d1, stamp);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      Words<T>::pack(v + k, d0, d1);
      put(slot + (1 + k) * g + r, d0, d1, stamp);
    }
  }
  put(slot + g + r, (uint32_t)row, (uint32_t)place, stamp);
}

template <typename T, int H>
__device__ __forceinline__ void get_head(const uint4 (&h)[H], T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    Words<T>::unpack(h[0].x, h[0].z, v);
    Words<T>::unpack(h[2].x, h[2].z, v + 2);
  } else {
    Words<T>::unpack(h[0].x, h[0].z, v);
#pragma unroll
    for (int k = 1; k < 4; ++k) Words<T>::unpack(h[1 + k].x, h[1 + k].z, v + k);
  }
}

// The row's panel values of CTA r's proposal, from P, by threads
// first .. first + kData - 1.
template <typename T, int B>
__device__ __forceinline__ void put_data(uint4* slot, int g, int r, int row,
                                         const T* P, int lo, uint32_t stamp,
                                         int first) {
  constexpr int D = Prop<T, B>::kData;
  const int q = (int)threadIdx.x - first;
  if (row >= 0 && q >= 0 && q < D) {
    uint32_t d0, d1;
    Words<T>::pack(P + (size_t)(row - lo) * (B + 1) + q * Words<T>::kPer, d0,
                   d1);
    put(slot + (size_t)Prop<T, B>::kHead * g + (size_t)r * D + q, d0, d1,
        stamp);
  }
}

// A candidate's key as an unsigned integer: |v| + 1 (NaN the largest), 0
// for none.
__device__ __forceinline__ unsigned long long ukey(float v) {
  return isnan(v) ? 0xffffffffull : (unsigned long long)__float_as_uint(
                                        fabsf(v)) + 1;
}
__device__ __forceinline__ unsigned long long ukey(double v) {
  return isnan(v) ? ~0ull
                  : (unsigned long long)__double_as_longlong(fabs(v)) + 1;
}

// A candidate: its key, place, row and header values.
template <typename T>
struct Pick {
  unsigned long long key;
  int place, row;
  T v[4];
  __device__ bool over(const Pick& o) const {
    return key > o.key || (key == o.key && place < o.place);
  }
};

template <typename T>
__device__ __forceinline__ Pick<T> no_pick() {
  return Pick<T>{0ull, INT_MAX, -1, {T(0), T(0), T(0), T(0)}};
}

// The warp's best candidate (largest key, then lowest place), in every
// lane: the warp's reductions pick the lane, which passes its values on.
template <typename T>
__device__ Pick<T> warp_pick(const Pick<T>& p) {
  bool top;
  if constexpr (sizeof(T) == 4) {
    const unsigned k = (unsigned)p.key;
    top = k == __reduce_max_sync(kFull, k);
  } else {
    const unsigned hi = (unsigned)(p.key >> 32);
    const unsigned lo = (unsigned)p.key;
    const bool high = hi == __reduce_max_sync(kFull, hi);
    const unsigned lo_max = __reduce_max_sync(kFull, high ? lo : 0u);
    top = high && lo == lo_max;
  }
  const unsigned first =
      __reduce_min_sync(kFull, top ? (unsigned)p.place : 0xffffffffu);
  const int src =
      __ffs(__ballot_sync(kFull, top && (unsigned)p.place == first)) - 1;
  Pick<T> out;
  out.key = __shfl_sync(kFull, p.key, src);
  out.place = __shfl_sync(kFull, p.place, src);
  out.row = __shfl_sync(kFull, p.row, src);
#pragma unroll
  for (int k = 0; k < 4; ++k) out.v[k] = __shfl_sync(kFull, p.v[k], src);
  return out;
}

// The step's winner over the g proposals in `slot`, in every
// lane of the calling warp: each lane waits for its members' headers, all
// of their loads in flight at once. The key is |v[0]| (NaN the largest),
// or 1 without pivoting, where only the row at the step's place is
// proposed.
template <typename T, int H>
__device__ Pick<T> winner(const uint4* slot, int g, uint32_t stamp,
                          int pivot) {
  constexpr int K = (kMaxMembers + 31) / 32;
  const int lane = threadIdx.x & 31;
  bool need[K];
#pragma unroll
  for (int k = 0; k < K; ++k) need[k] = lane + 32 * k < g;
  Pick<T> best = no_pick<T>();
  unsigned long long t0 = 0;
  for (;;) {
    uint4 h[K][H];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (need[k])
#pragma unroll
        for (int e = 0; e < H; ++e)
          h[k][e] = peek(slot + (size_t)e * g + lane + 32 * k);
    bool done = true;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (need[k]) {
        bool in = true;
#pragma unroll
        for (int e = 0; e < H; ++e) in = in && stamped(h[k][e], stamp);
        if (in) {
          need[k] = false;
          Pick<T> d;
          get_head<T, H>(h[k], d.v);
          d.row = (int)h[k][1].x;
          d.place = (int)h[k][1].z;
          d.key = d.row < 0 ? 0ull : pivot ? ukey(d.v[0]) : 1ull;
          if (d.over(best)) best = d;
        } else {
          done = false;
        }
      }
    if (__all_sync(kFull, done)) break;
    if (t0 == 0) t0 = global_ns();
    check_wait(t0);
  }
  return warp_pick(best);
}

// Shared memory of a CTA with rp rows, panel B, at order n, in this order:
// the places (n ints; the marks at the store), the CTA's rows' places and
// its list of active rows (rp ints each), its rows' panel columns P (rp
// rows of B + 1 values), the pivot rows' panel values Pb (B x B), two
// staged U chunks (B rows of kChunkBytes), the reduction scratch and 16
// ints. ops/lu.py lu_factor_smem computes the same.
__host__ __device__ inline size_t blocked_smem_bytes(int n, int rp, int b,
                                                     int tsize) {
  return align16((size_t)n * 4) + 2 * align16((size_t)rp * 4) +
         align16((size_t)rp * (b + 1) * tsize) +
         align16((size_t)b * b * tsize) +
         2 * (size_t)b * kChunkBytes + kWarps * sizeof(Cand) + 64;
}

// The U rows right of the panel: columns j >= j0 of the pivot rows of
// places k0 .. k0 + bk - 1 (rows ord[0 .. bk)), each taking the panel's
// earlier steps' updates in step order from the multipliers in Pb's
// lower triangle. This CTA takes a slice of the columns, 32 at a time: a
// lane a column, a warp the rows t = warp + 8 r in registers; at step s
// the warp holding row s, final now, puts it in xs, and every warp applies
// it to its rows below. marks[j] notes the last of the column's new U
// values that is not finite.
template <typename T, int B>
__device__ __noinline__ void u_rows(T* __restrict__ w, const T* pb,
                                    const int* ord, int* marks, T* xs,
                                    int n, int k0, int bk, int j0, int rank,
                                    int g) {
  constexpr int R = B / kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n - j0 + g - 1) / g;
  const int c0 = j0 + rank * per;
  const int c1 = min(n, c0 + per);
  for (int cb = c0; cb < c1; cb += 32) {
    const int j = cb + lane;
    const bool on = j < c1;
    T x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = warp + kWarps * r;
      x[r] = on && t < bk ? __ldcg(w + (size_t)ord[t] * n + j) : T(0);
    }
#pragma unroll
    for (int s = 0; s < B; ++s) {
      if (s < bk) {
        if (warp == s % kWarps) xs[s * 32 + lane] = x[s / kWarps];
        __syncthreads();
        const T v = xs[s * 32 + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int t = warp + kWarps * r;
          if (t > s && t < bk) x[r] = sub(x[r], mul(pb[t * B + s], v));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = warp + kWarps * r;
      if (on && t < bk) w[(size_t)ord[t] * n + j] = x[r];
    }
    if (warp == 0 && on)
      for (int t = bk - 1; t >= 0; --t)
        if (!isfinite(xs[t * 32 + lane])) {
          marks[j] = k0 + t;
          break;
        }
    __syncthreads();  // xs is read no more
  }
}

// A chunk of the U rows into shared memory by cp.async: row t of `dst`
// (CC values) from columns c0 .. c0 + CC - 1 of row ord[t] of w, zero past
// the matrix. vec: rows start on 16 bytes (n * sizeof(T) a multiple of
// 16), so whole 16-byte copies. Committed as one group.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* w, const int* ord,
                                      int n, int bk, int c0, bool vec) {
  constexpr int CV = 16 / (int)sizeof(T);
  constexpr int CC = 32 * CV;
  for (int idx = threadIdx.x; idx < bk * 32; idx += kThreads) {
    const int t = idx >> 5;
    const int col = c0 + (idx & 31) * CV;
    T* d = dst + t * CC + (idx & 31) * CV;
    const T* src = w + (size_t)ord[t] * n + col;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                       matinv::smem_addr(d)),
                   "l"(col < n ? src : w), "r"(col < n ? 16 : 0)
                   : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < CV; ++e)
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                         matinv::smem_addr(d + e)),
                     "l"(col + e < n ? src + e : w), "n"((int)sizeof(T)),
                     "r"(col + e < n ? (int)sizeof(T) : 0)
                     : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The trailing pass: the CTA's active rows act[0 .. na) (local indices,
// their multipliers in P) take the panel's bk updates on columns
// j0 .. n - 1, from the U rows (rows ord[0 .. bk) of w) staged a chunk of
// CC columns at a time, two buffers in us, the next chunk's copy in
// flight while this one is applied; a warp takes rows, a lane columns
// lane + 32 e, RT rows x CV columns a thread, the next (chunk, rows)
// pair's values loaded while this pair's are computed.
template <typename T, int B, int RT>
__device__ __noinline__ void trailing(T* __restrict__ w, const T* P,
                                      const int* act, int na, const int* ord,
                                      T* us, int n, int bk, int j0, int lo) {
  constexpr int CV = 16 / (int)sizeof(T);
  constexpr int CC = 32 * CV;
  constexpr int RB = kWarps * RT;  // rows a pass of the CTA
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = ((size_t)n * sizeof(T)) % 16 == 0;
  if (na == 0) return;
  const int chunks = (n - j0 + CC - 1) / CC;
  const int batches = (na + RB - 1) / RB;
  // The rows and values of pass (chunk, batch) = (q / batches, q % batches).
  auto load = [&](int q, int (&rows)[RT], T (&v)[RT][CV]) {
    const int c0 = j0 + (q / batches) * CC;
    const int rb = (q % batches) * RB;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int ri = rb + warp + kWarps * r;
      rows[r] = ri < na ? act[ri] : -1;
#pragma unroll
      for (int e = 0; e < CV; ++e) {
        const int col = c0 + lane + 32 * e;
        v[r][e] = rows[r] >= 0 && col < n
                      ? w[(size_t)(lo + rows[r]) * n + col]
                      : T(0);
      }
    }
  };
  int rows[RT];
  T acc[RT][CV];
  load(0, rows, acc);
  stage(us, w, ord, n, bk, j0, vec);
  for (int c = 0; c < chunks; ++c) {
    const int c0 = j0 + c * CC;
    T* cur = us + (c & 1) * B * CC;
    if (c + 1 < chunks)
      stage(us + ((c + 1) & 1) * B * CC, w, ord, n, bk, c0 + CC, vec);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    for (int b = 0; b < batches; ++b) {
      const int q = c * batches + b;
      int nrows[RT];
      T nacc[RT][CV];
      if (q + 1 < chunks * batches) load(q + 1, nrows, nacc);
#pragma unroll 4
      for (int t = 0; t < bk; ++t) {
        T f[RT], u[CV];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          f[r] = rows[r] >= 0 ? P[rows[r] * (B + 1) + t] : T(0);
#pragma unroll
        for (int e = 0; e < CV; ++e) u[e] = cur[t * CC + lane + 32 * e];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < CV; ++e)
            acc[r][e] = sub(acc[r][e], mul(f[r], u[e]));
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < CV; ++e) {
          const int col = c0 + lane + 32 * e;
          if (rows[r] >= 0 && col < n)
            w[(size_t)(lo + rows[r]) * n + col] = acc[r][e];
        }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        rows[r] = nrows[r];
#pragma unroll
        for (int e = 0; e < CV; ++e) acc[r][e] = nacc[r][e];
      }
    }
    __syncthreads();  // cur is read no more: the next stage may fill it
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One matrix at a time on a persistent grid of g CTAs (a cooperative
// launch); CTA k owns rows [k rp, k rp + rp) of the workspace w, in the
// input's order. props: 3 slots of g proposals of Prop<T, B>::kWords
// words, step s's in slot s % 3 (a CTA writes the slot of step s + 1 once it
// has every header of step s, so every reader of step s - 2's values is
// done: each publishes its header of step s after reading them);
// bar: one unsigned, zero; flags: g ints; marks: n ints.
template <typename T, int B>
__global__ void __launch_bounds__(kThreads, 1)
lu_factor_grid_kernel_blocked(const T* __restrict__ a, T* __restrict__ out,
                              long long* __restrict__ perm,
                              int* __restrict__ ok_out, T* __restrict__ w,
                              uint4* props, unsigned* bar, int* flags,
                              int* marks, int batch, int n, int pivot) {
  constexpr int W = Prop<T, B>::kWords;
  constexpr int H = Prop<T, B>::kHead;
  constexpr int LP = B + 1;  // P's row stride: a lane a row, no bank conflict
  constexpr int RW = kRowsW<T>;
  extern __shared__ __align__(16) char smem[];
  const int g = (int)gridDim.x;
  const int rank = (int)blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rp = (n + g - 1) / g;
  const int lo = min(n, rank * rp);
  const int hi = min(n, lo + rp);
  const int nr = hi - lo;

  size_t off = 0;
  int* phys = reinterpret_cast<int*>(smem);
  off += align16((size_t)n * 4);
  int* posl = reinterpret_cast<int*>(smem + off);
  off += align16((size_t)rp * 4);
  int* act = reinterpret_cast<int*>(smem + off);
  off += align16((size_t)rp * 4);
  T* P = reinterpret_cast<T*>(smem + off);
  off += align16((size_t)rp * LP * sizeof(T));
  T* pb = reinterpret_cast<T*>(smem + off);
  off += align16((size_t)B * B * sizeof(T));
  T* us = reinterpret_cast<T*>(smem + off);
  off += 2 * (size_t)B * kChunkBytes;
  Cand* red = reinterpret_cast<Cand*>(smem + off);
  off += kWarps * sizeof(Cand);
  int* misc = reinterpret_cast<int*>(smem + off);

  // Slot k (step s takes slot s % 3); this CTA's words in each zeroed.
  auto slot_of = [&](int k) { return props + (size_t)k * g * W; };
  for (int k = tid; k < 3 * W; k += kThreads) {
    const int e = k % W;
    slot_of(k / W)[e < H ? (size_t)e * g + rank
                         : (size_t)H * g + (size_t)rank * (W - H) + e - H] =
        make_uint4(0, 0, 0, 0);
  }
  grid_sync(bar, g);  // no stale stamp is left to read

  for (int item = 0; item < batch; ++item) {
    const T* src = a + (size_t)item * n * n;
    for (size_t idx = tid; idx < (size_t)nr * n; idx += kThreads)
      w[(size_t)lo * n + idx] = src[(size_t)lo * n + idx];
    for (int p = tid; p < n; p += kThreads) phys[p] = p;
    for (int i = tid; i < nr; i += kThreads) posl[i] = lo + i;
    for (int j = rank * kThreads + tid; j < n; j += g * kThreads)
      marks[j] = -1;
    __syncthreads();
    const uint32_t stamp0 = (uint32_t)item * (uint32_t)n + 1u;
    int ok = 1;

    for (int k0 = 0; k0 < n; k0 += B) {
      const int bk = min(B, n - k0);
      // The panel's columns of the CTA's rows not yet pivot rows.
      for (int idx = tid; idx < nr * B; idx += kThreads) {
        const int i = idx / B;
        const int c = idx - i * B;
        if (c < bk && posl[i] >= k0)
          P[i * LP + c] = w[(size_t)(lo + i) * n + k0 + c];
      }
      __syncthreads();
      {  // the proposal for the panel's first step
        Cand c = empty_cand();
        if (pivot) {
          for (int i = tid; i < nr; i += kThreads)
            if (posl[i] >= k0) {
              const Cand d{abs_key(P[(size_t)i * LP]), posl[i], lo + i};
              if (better(d, c)) c = d;
            }
          c = block_best(c, red);
        } else if (k0 >= lo && k0 < hi) {
          c = Cand{0, k0, k0};
        }
        uint4* to = slot_of(k0 % 3);
        if (tid == 0) {
          T v[4] = {T(0), T(0), T(0), T(0)};
          for (int k = 0; k < 3 && c.row >= 0; ++k)
            if (k < bk) v[k] = P[(size_t)(c.row - lo) * LP + k];
          put_head<T>(to, g, rank, c.row, c.ord, v, stamp0 + k0);
        }
        put_data<T, B>(to, g, rank, c.row, P, lo, stamp0 + k0, 1);
      }

      // The chain. Warp 0: the winner, the multipliers and columns t + 1
      // and t + 2 of the rows below the pivot and the next step's header,
      // all from the headers and registers (a lane's rows lane + 32 k, their
      // columns t .. t + 3 held); then, off the chain, the winner's panel
      // values, columns t + 3 and t + 4, the places and the rows' new
      // values in shared memory. Warps 1-7, meanwhile: columns t + 5 on,
      // then the next step's panel values. Named barriers: 1, warp 0's
      // step is done (its columns, the places, the winner's values in pb);
      // 2, warps 1-7's columns are done; 3, warps 1-7 are done with the
      // step, so warp 0 may read and write the rows and places again.
      int pl[RW];
      T r0[RW], r1[RW], r2[RW], r3[RW];
      T pbn = T(0);  // the last winner's column t + 2
      if (warp == 0)
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          const int i = lane + 32 * k;
          const bool on = i < nr;
          pl[k] = on ? posl[i] : -1;
          r0[k] = on ? P[i * LP] : T(0);
          r1[k] = on && bk > 1 ? P[i * LP + 1] : T(0);
          r2[k] = on && bk > 2 ? P[i * LP + 2] : T(0);
          r3[k] = on && bk > 3 ? P[i * LP + 3] : T(0);
        }
      for (int t = 0; t < bk; ++t) {
        const int s = k0 + t;
        const uint32_t stamp = stamp0 + s;
        const uint4* pp = slot_of(s % 3);
        T* pbt = pb + t * B;
        const bool next = t + 1 < bk;
        if (warp == 0) {
          const Pick<T> win = winner<T, H>(pp, g, stamp, pivot);
          const uint4* src = pp + (size_t)H * g +
                             (size_t)(win.row / rp) * Prop<T, B>::kData;
          constexpr int DL = (Prop<T, B>::kData + 31) / 32;
          uint4 dv[DL];
#pragma unroll
          for (int d = 0; d < DL; ++d)
            if (lane + 32 * d < Prop<T, B>::kData)
              dv[d] = peek(src + lane + 32 * d);
          ok &= win.v[0] != T(0);
          const T pd = win.v[0] == T(0) ? T(1) : win.v[0];
          // The winner's column t + 2 as step s - 1 left it.
          const T p2 = t > 0 && t + 2 < bk ? sub(win.v[2], mul(win.v[3], pbn))
                                           : win.v[2];
          Pick<T> best = no_pick<T>();
          T fk[RW];
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            const int i = lane + 32 * k;
            if (lo + i == win.row)  // the swap of places s and the winner's
              pl[k] = s;
            else if (pl[k] == s)
              pl[k] = win.place;
            fk[k] = T(0);
            if (i < nr && pl[k] > s) {
              const T f = div(r0[k], pd);
              fk[k] = f;
              r1[k] = sub(r1[k], mul(f, win.v[1]));
              r2[k] = sub(r2[k], mul(f, p2));
              const Pick<T> d{pivot ? ukey(r1[k]) : lo + i == s + 1 ? 1ull
                                                                    : 0ull,
                              pl[k], lo + i,
                              {r1[k], t + 2 < bk ? r2[k] : T(0), r3[k], f}};
              if (next && d.over(best)) best = d;
            }
          }
          int crow = -1;
          if (next) {
            const Pick<T> c = warp_pick(best);
            crow = c.key ? c.row : -1;
            if (lane == 0)
              put_head<T>(slot_of((s + 1) % 3), g, rank, crow, c.place, c.v,
                          stamp + 1);
          }
          // Off the chain: the winner's panel values, columns t + 3 and
          // t + 4, the places and the rows in shared memory.
#pragma unroll
          for (int d = 0; d < DL; ++d) {
            const int q = lane + 32 * d;
            if (q < Prop<T, B>::kData) {
              if (!stamped(dv[d], stamp)) dv[d] = get(src + q, stamp);
              Words<T>::unpack(dv[d].x, dv[d].z,
                               pbt + q * Words<T>::kPer);
            }
          }
          __syncwarp();
          if (t > 0) named_sync(3, kThreads);
          pbn = t + 3 < bk ? pbt[t + 3] : T(0);
          const T u4 = t + 4 < bk ? pbt[t + 4] : T(0);
          if (lane == 0) {
            misc[0] = crow;
            const int q = phys[s];
            phys[s] = win.row;
            phys[win.place] = q;
            if (q >= lo && q < hi) posl[q - lo] = win.place;
            if (win.row >= lo && win.row < hi) posl[win.row - lo] = s;
          }
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            const int i = lane + 32 * k;
            T x4 = T(0);
            if (i < nr && pl[k] > s) {
              T* x = P + (size_t)i * LP;
              x[t] = fk[k];
              if (t + 1 < bk) x[t + 1] = r1[k];
              if (t + 2 < bk) x[t + 2] = r2[k];
              if (t + 3 < bk) {
                r3[k] = sub(r3[k], mul(fk[k], pbn));
                x[t + 3] = r3[k];
              }
              if (t + 4 < bk) {
                x4 = sub(x[t + 4], mul(fk[k], u4));
                x[t + 4] = x4;
              }
            }
            r0[k] = r1[k];  // the window moves on a column
            r1[k] = r2[k];
            r2[k] = r3[k];
            r3[k] = x4;
          }
          named_arrive(1, kThreads);
        } else {
          named_sync(1, kThreads);
          const int tw = tid - 32;
          constexpr int kRowsA = (kThreads - 32) / 8;
          if (t + 5 < bk)
            for (int base = 0; base < nr; base += kRowsA) {
              const int i = base + (tw >> 3);
              if (i < nr && posl[i] > s) {
                T* x = P + (size_t)i * LP;
                const T f = x[t];
                for (int j = t + 5 + (tw & 7); j < bk; j += 8)
                  x[j] = sub(x[j], mul(f, pbt[j]));
              }
            }
          if (next) {
            named_sync(2, kThreads - 32);
            put_data<T, B>(slot_of((s + 1) % 3), g, rank, misc[0], P, lo,
                           stamp + 1, 32);
            named_arrive(3, kThreads);
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < nr * B; idx += kThreads) {
        const int i = idx / B;
        const int c = idx - i * B;
        if (c < bk && posl[i] >= k0)
          w[(size_t)(lo + i) * n + k0 + c] = P[i * LP + c];
      }
      grid_sync(bar, g);
      // The panel's own U values: column k0 + t2's last one not finite.
      if (rank == 0)
        for (int t2 = 1 + tid; t2 < bk; t2 += kThreads)
          for (int t = t2 - 1; t >= 0; --t)
            if (!isfinite(pb[t * B + t2])) {
              marks[k0 + t2] = k0 + t;
              break;
            }
      const int j0 = k0 + bk;
      if (j0 < n) {
        u_rows<T, B>(w, pb, phys + k0, marks, us, n, k0, bk, j0, rank, g);
        if (warp == 0) {  // the CTA's rows below the panel
          int cnt = 0;
          for (int base = 0; base < nr; base += 32) {
            const int i = base + lane;
            const bool on = i < nr && posl[i] >= j0;
            const unsigned m = __ballot_sync(kFull, on);
            if (on) act[cnt + __popc(m & ((1u << lane) - 1))] = i;
            cnt += __popc(m);
          }
          if (lane == 0) misc[2] = cnt;
        }
        grid_sync(bar, g);
        // Rows a thread: as few as the CTA's rows below the panel take.
        switch ((min(misc[2], 4 * kWarps) + kWarps - 1) / kWarps) {
          case 1:
            trailing<T, B, 1>(w, P, act, misc[2], phys + k0, us, n, bk, j0,
                              lo);
            break;
          case 2:
            trailing<T, B, 2>(w, P, act, misc[2], phys + k0, us, n, bk, j0,
                              lo);
            break;
          case 3:
            trailing<T, B, 3>(w, P, act, misc[2], phys + k0, us, n, bk, j0,
                              lo);
            break;
          default:
            trailing<T, B, 4>(w, P, act, misc[2], phys + k0, us, n, bk, j0,
                              lo);
        }
        __syncthreads();  // P and the places are read no more this panel
      }
    }
    grid_sync(bar, g);

    // The store: each row to its place, the U entries' zero updates
    // applied (the marks, loaded over the places).
    for (int j = tid; j < n; j += kThreads) phys[j] = __ldcg(marks + j);
    __syncthreads();
    int finite = 1;
    T* dst = out + (size_t)item * n * n;
    for (int i = 0; i < nr; ++i) {
      const int p = posl[i];
      for (int j = tid; j < n; j += kThreads) {
        T x = __ldcg(w + (size_t)(lo + i) * n + j);
        if (j > p) {
          if (p <= phys[j]) {
            if (!isnan(x)) x = Words<T>::nan();
          } else if (x == T(0)) {
            x = T(0);
          }
        }
        finite &= isfinite(x) ? 1 : 0;
        dst[(size_t)p * n + j] = x;
      }
    }
    for (int i = tid; i < nr; i += kThreads)
      perm[(size_t)item * n + posl[i]] = lo + i;
    finite = __syncthreads_and(finite);
    if (tid == 0) flags[rank] = ok && finite;
    grid_sync(bar, g);
    if (rank == 0 && tid == 0) {
      int all = 1;
      for (int d = 0; d < g; ++d) all &= __ldcg(flags + d);
      ok_out[item] = all;
    }
  }
}

template <typename T, int B>
int launch(const void* a, void* out, void* perm, int* ok, void* work,
           void* props, void* bar, void* flags, void* marks, int batch,
           int n, int pivot, int ctas, int smem, cudaStream_t stream) {
  if (batch < 1 || n < 1 || ctas < 1 || ctas > kMaxMembers ||
      (long long)batch * n >= 0x7fffffffll || out == nullptr ||
      perm == nullptr || ok == nullptr || work == nullptr ||
      props == nullptr || bar == nullptr || flags == nullptr ||
      marks == nullptr || reinterpret_cast<uintptr_t>(props) % 16 != 0)
    return cudaErrorInvalidValue;
  const int rp = (n + ctas - 1) / ctas;
  if ((long long)(ctas - 1) * rp >= n || rp > 32 * kRowsW<T> || smem < 0 ||
      (size_t)smem > kMaxShared ||
      (size_t)smem < blocked_smem_bytes(n, rp, B, sizeof(T)))
    return cudaErrorInvalidValue;
  const void* kernel =
      reinterpret_cast<const void*>(&lu_factor_grid_kernel_blocked<T, B>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const T* in = static_cast<const T*>(a);
  T* dst = static_cast<T*>(out);
  long long* pm = static_cast<long long*>(perm);
  T* wk = static_cast<T*>(work);
  uint4* pr = static_cast<uint4*>(props);
  unsigned* br = static_cast<unsigned*>(bar);
  int* fl = static_cast<int*>(flags);
  int* mk = static_cast<int*>(marks);
  void* args[] = {&in, &dst, &pm, &ok, &wk, &pr, &br, &fl, &mk, &batch, &n,
                  &pivot};
  err = launch_grid(kernel, ctas, smem, stream, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// a: (batch, n, n) input; out: (batch, n, n) packed factors; perm: (batch,
// n) int64; ok: (batch,) int32; work: (n, n) values; props: (3, ctas,
// h + panel * itemsize / 8) 16-byte words, h = 3 (fp32) or 5 (fp64); bar:
// one unsigned, zero;
// flags: ctas ints; marks: n ints; fp64 != 0 means double, else float;
// panel: 64 (the columns a panel); smem: the bytes of shared memory a CTA
// gets (ops/lu.py lu_factor_plan). Launched cooperatively. Returns the
// cudaError_t of the launch.
extern "C" int matinv_lu_factor_blocked(const void* a, void* out, void* perm,
                                        int* ok, void* work, void* props,
                                        void* bar, void* flags, void* marks,
                                        int batch, int n, int fp64, int pivot,
                                        int ctas, int panel, int smem,
                                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (panel != 64) return cudaErrorInvalidValue;
  return fp64 ? launch<double, 64>(a, out, perm, ok, work, props, bar, flags,
                                   marks, batch, n, pivot, ctas, smem, st)
              : launch<float, 64>(a, out, perm, ok, work, props, bar, flags,
                                  marks, batch, n, pivot, ctas, smem, st);
}
