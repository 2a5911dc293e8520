// Asynchronous copies into shared memory, and a block's arrival at a counter
// that its launch's blocks share: the helpers of the kernels that stage
// tiles with cp.async and let the last block (or warp) of a group add the
// group's splits in the same launch (attention_decode.cuh, exl3_gemm.cu,
// intb_matmul.cu). Those kernels share one per-device counter tensor
// (util/device.py), so they share the protocol that leaves every counter at
// 0 after a launch.
#pragma once

#include <cuda_runtime.h>

namespace {

// N bytes (4, 8 or 16) from global to shared memory; 16-byte copies bypass L1
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A block's arrival at a counter that its launch's blocks share, made by
// one thread after a block barrier (a warp's, after a warp barrier, where
// each warp arrives for itself): a release of the block's writes before
// the increment (fence.acq_rel at gpu scope, cumulative over what the
// barrier ordered) and, for the last to arrive (the count it read was the
// others'), an acquire after it, so that its block reads every other
// block's writes from L2 (__ldcg). Returns the count before the increment;
// the last block resets the counter to 0 for the next launch.
__device__ __forceinline__ int arrive(int* counter) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const int old = atomicAdd(counter, 1);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    return old;
}

}  // namespace
