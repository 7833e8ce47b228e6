// The step exchange of the cluster kernels (K1's m = 256 .. 640 branch in
// fused_gj.cu; K2, K3 and K6 in panel_factor.cu): 16-byte st.async stores
// into another CTA's shared memory, each completing on that CTA's
// mbarrier, and the waits on those barriers. L5's cluster path
// (lu_solve.cu) uses the barriers, and arrivals on another CTA's.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace matinv {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in CTA `rank` of the
// cluster (shared::cluster space).
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// The local arrival of the barrier's next phase, which then waits for
// `bytes` of stores from the cluster.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed. A
// wait never lasts longer than one step of the slowest CTA; past ~2^26
// tries (seconds) the cluster is deadlocked, and the kernel traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 16 bytes into another CTA's shared memory; completes on its barrier.
__device__ __forceinline__ void store_to_peer(uint32_t addr, uint32_t bar,
                                              float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// A barrier whose phase completes after `count` arrivals, with no bytes
// expected. Thread 0 only, before the
// cluster's first sync.
__device__ __forceinline__ void bar_init_count(uint64_t* bar,
                                               uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival on a barrier of another CTA (`peer` from peer_addr), after
// this thread's earlier reads and writes (release at cluster scope).
__device__ __forceinline__ void bar_arrive_peer(uint32_t peer) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          peer)
      : "memory");
}

// Initializes a CTA's two step barriers (one per step parity), each armed
// for the first step of its parity; the caller's cluster.sync() then makes
// them visible before any peer stores into them. Thread 0 only.
__device__ __forceinline__ void bars_start(uint64_t* bars, uint32_t bytes) {
  bar_init(&bars[0]);
  bar_init(&bars[1]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  bar_expect(&bars[0], bytes);
  bar_expect(&bars[1], bytes);
}

}  // namespace matinv
