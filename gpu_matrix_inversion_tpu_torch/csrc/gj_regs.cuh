// The register-resident Gauss-Jordan block shared by K1 (fused_gj.cu, its
// m = 128 branch) and K4 (small_inv.cu).
//
// Both kernels invert one small matrix per thread block by Gauss-Jordan on
// [X | I], one pivot step at a time. At step r only about half of the 2m
// columns of [X | I] carry values that change: a left column j < r has
// become a unit vector that no later step reads, and a right column whose
// identity row has not been the pivot yet still holds its identity column.
// So the block keeps m live columns in place, one "slot" per column: slot
// j holds left column j until step j, and from step j on the right column
// of step j's pivot row (the in-place Gauss-Jordan inverse). The caller
// scatters slot j to that column at the end.
//
// Layout: W warps, warp w owning rows w + W s (s < R, cyclic), lane l
// owning slots l + 32 q (q < C); each thread keeps R x C values in
// registers. A step starts with every lane taking column r of its warp's
// rows by shuffles (the elimination factors and the pivot candidates);
// the kernels differ in how the pivot row reaches every warp through
// shared memory (K4: each warp publishes its candidate row, one barrier;
// K1: the owner of the winning row, two barriers); then every warp
// updates its rows. Slot indices are compile-time within a phase of 32
// steps (Q0 = r / 32), and a row chosen by data is taken by selects over
// the slots, so no register is indexed by data.
//
// Arithmetic, element for element as the shared-memory kernels on [X | I]
// did it: the pivot row divided by an IEEE division (__fdiv_rn), every
// other row x - f * v as one fmaf, the normalized row deposited by a
// separate select. The slot that turns from column r into a right column
// starts from its identity entries: 1 in the pivot row (so its normalized
// value is 1 / pivot) and 0 elsewhere (fmaf(-f, v, 0)). On finite input
// every value is the one [X | I] computes, except that a zero may carry the
// other sign (there the dead entry it started from was -0).
#pragma once

#include <cuda_runtime.h>

namespace matinv {
namespace gj {

constexpr unsigned kFull = 0xffffffffu;

// Column r (slot Q0 of lane r mod 32) of each of the warp's R rows, in
// every lane: the rows' elimination factors and pivot candidates.
template <int R, int C, int Q0>
__device__ __forceinline__ void column(const float (&v)[R][C], int r,
                                       float (&f)[R]) {
#pragma unroll
  for (int s = 0; s < R; ++s) f[s] = __shfl_sync(kFull, v[s][Q0], r & 31);
}

// f[lane] for lanes below R (lane s speaks for row slot s in the pivot
// search), by selects rather than a register indexed by the lane.
template <int R>
__device__ __forceinline__ float lane_value(const float (&f)[R], int lane) {
  float x = f[0];
#pragma unroll
  for (int s = 1; s < R; ++s) x = lane == s ? f[s] : x;
  return x;
}

// This lane's slots of row slot s (the same in every lane of the warp;
// none if s >= R, and then row slot 0's), by selects over the slots.
template <int R, int C>
__device__ __forceinline__ void row(const float (&v)[R][C], int s,
                                    float (&u)[C]) {
#pragma unroll
  for (int q = 0; q < C; ++q) {
    float x = v[0][q];
#pragma unroll
    for (int t = 1; t < R; ++t) x = t == s ? v[t][q] : x;
    u[q] = x;
  }
}

// Row slot s to dst[lane + 32 q].
template <int R, int C>
__device__ __forceinline__ void publish(const float (&v)[R][C], int s,
                                        float* dst, int lane) {
  float u[C];
  row(v, s, u);
#pragma unroll
  for (int q = 0; q < C; ++q) dst[lane + 32 * q] = u[q];
}

// The normalized pivot row for this lane's slots: u (the pivot row's
// values in them, before step r) over ps (its pivot, 1 if the pivot is
// 0). Slot r takes the right column of the pivot row, whose identity
// entry (1) stands in for the pivot row's value.
template <int C, int Q0>
__device__ __forceinline__ void normalize(const float (&u)[C], float ps,
                                          int r, int lane, float (&nv)[C]) {
  const bool at_r = lane == (r & 31);
#pragma unroll
  for (int q = 0; q < C; ++q)
    nv[q] = __fdiv_rn(q == Q0 && at_r ? 1.f : u[q], ps);
}

// Step r's update with the normalized pivot row nv: every row eliminated
// by its factor f, slot r's other rows starting from their identity
// entries (0), and row slot dep of this warp (the pivot row; -1 if none)
// taking nv.
template <int R, int C, int Q0>
__device__ __forceinline__ void update(float (&v)[R][C], const float (&f)[R],
                                       const float (&nv)[C], int r, int lane,
                                       int dep) {
  const bool at_r = lane == (r & 31);
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int q = 0; q < C; ++q)
      v[s][q] = fmaf(-f[s], nv[q], q == Q0 && at_r ? 0.f : v[s][q]);
  if (dep >= 0) {
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int q = 0; q < C; ++q) v[s][q] = s == dep ? nv[q] : v[s][q];
  }
}

}  // namespace gj
}  // namespace matinv
