// Shared-memory mbarriers and 1-D bulk asynchronous copies (sm_90), shared by
// the kernels that feed a shared-memory ring from device memory: one thread
// arms a barrier with the bytes it expects and starts copies that complete
// those bytes on it; consumers wait on the barrier's phase parity.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Makes the barriers initialised by this thread visible to the async proxy
// (the copies that complete on them); a __syncthreads follows it.
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
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
    return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait of about ten
// seconds means a lost arrival: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - start > 20000000000ll) __trap();
}

// Copy `bytes` contiguous bytes from device memory to shared memory; the copy
// completes `bytes` of transaction count on barrier `bar`. Addresses and size
// are multiples of 16 bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
        : "memory");
}
