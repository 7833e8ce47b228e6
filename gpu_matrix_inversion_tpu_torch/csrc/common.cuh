// Device helpers shared by the hand-written kernels (fused_gj.cu,
// panel_factor.cu). Every kernel here is launched with a block size that is
// a multiple of 32, which the full-mask warp reductions rely on.
#pragma once

#include <cuda_runtime.h>

namespace matinv {

// Packed pivot key of the TPU kernels (gpu_matrix_inversion_tpu/ops/fused.py
// _gj_kernel, ops/blocked.py _panel_factor_kernel2): the int32 bits of |v|
// (value-monotonic for a nonnegative float) with the low log2(kmask+1) bits
// replaced by (kmask - row), so the max over unused rows picks the largest
// |v| and, among values equal in the kept bits, the lowest row. Used rows
// get -1, below every unused key.
__device__ __forceinline__ int pivot_key(float v, bool used, int row,
                                         int kmask) {
  const int bits = __float_as_int(fabsf(v));
  return used ? -1 : ((bits & ~kmask) | (kmask - row));
}

// Max of v over the block; every thread gets the result. red must hold 33
// ints of shared memory. Ends with a __syncthreads, so shared writes made
// before the call are visible to every thread after it.
__device__ __forceinline__ int block_max_int(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = __reduce_max_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? red[lane] : -2147483647 - 1;
    w = __reduce_max_sync(0xffffffffu, w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
}

}  // namespace matinv
