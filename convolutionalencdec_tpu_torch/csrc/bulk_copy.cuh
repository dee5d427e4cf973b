// Bulk copies into shared memory on an mbarrier (Hopper's cp.async.bulk),
// shared by the staged walks of acs_generic.cu and traceback_k1.cu, and the
// shared-memory address of turbo_rsc.cu's copies.  kernels/_build.py
// rebuilds the library when this header is newer than it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// that completes on the mbarrier at `bar`, whose phase this lane's arrival
// also expects them.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the mbarrier's phase of parity `parity` to complete; a copy that
// never lands stops the kernel with an error rather than spinning forever.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  for (long long tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1ll << 28)) __trap();
  }
}

}  // namespace
