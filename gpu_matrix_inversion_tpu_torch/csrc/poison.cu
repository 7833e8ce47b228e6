// Shared-memory poison for the determinism check (utils/determinism.py).
//
// Not a port of a TPU kernel: the JAX package's check_deterministic
// (gpu_matrix_inversion_tpu/utils/determinism.py) runs a dummy computation
// between runs so that reused scratch holds garbage. On Hopper the scratch
// that K1, K2, K3 and K6 keep on chip is the SMs' shared memory, which a
// kernel inherits from whatever ran on that SM before it. This kernel fills
// every byte of it with 0xFF (NaN in fp32, bf16 and fp64): one block per SM
// at the largest dynamic shared memory a block may take, so no two blocks
// share an SM. Each block records the SM it ran on, so the caller can check
// that every SM was reached. Bound by nothing of interest: ~227 KiB of
// stores an SM, microseconds.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    poison_shared_kernel(int words, int* smids) {
  extern __shared__ unsigned int smem[];
  // volatile: the stores are the point, though nothing here reads them.
  volatile unsigned int* out = smem;
  for (int i = threadIdx.x; i < words; i += kThreads) out[i] = 0xFFFFFFFFu;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    smids[blockIdx.x] = static_cast<int>(smid);
  }
}

}  // namespace

// Launch `blocks` blocks, each with the device's opt-in maximum of dynamic
// shared memory (written to *smem_bytes), filling it with 0xFF; smids[i]
// receives the SM that block i ran on.
extern "C" int matinv_poison_shared(int blocks, int* smids, int* smem_bytes,
                                    void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int smem = 0;
  err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(poison_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = smem;
  poison_shared_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      smem / static_cast<int>(sizeof(unsigned int)), smids);
  return cudaGetLastError();
}
