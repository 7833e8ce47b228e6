// The packed pivot key, shared by the hand-written kernels that choose
// pivots by it (fused_gj.cu, panel_factor.cu).
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

}  // namespace matinv
