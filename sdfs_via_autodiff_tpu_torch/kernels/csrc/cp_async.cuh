// cp.async copies from global to shared memory (sm_80 and later), shared
// by the port's kernels.
#pragma once

namespace {

// 16 bytes from src to dst (both 16-byte aligned); with valid false, 16
// zero bytes (src is not read).  Bypasses L1 (.cg).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes, the same way (.ca: a 4-byte copy cannot bypass L1).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
