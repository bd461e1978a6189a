// The mbarrier helpers of the kernels fed by the copy engines
// (block_jacobi_apply_batched.cu's cp.async.bulk ring, grouped_mm_sm90.cu's
// TMA ring).  A wrong phase parity would hang rather than fail: every wait
// gives up with a trap, which the next synchronize reports, once it has
// spun for kMaxWaitNs on the global timer (a bound on tries alone would
// not bound the time: each try_wait may suspend for a while).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kMaxWaitNs = 2000000000ull;   // 2 s

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// arrive and raise the transaction count by `bytes`, which the copies that
// complete on this barrier bring back to 0
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > kMaxWaitNs) __trap();
    }
  }
}

}  // namespace
