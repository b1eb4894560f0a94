// Asynchronous copies from device memory into shared memory (cp.async, sm_80
// and later), shared by the kernels that copy a span of point rows once.
#pragma once

#include <stdint.h>

namespace repro {

// 16 bytes, cached in L2 only; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// one float: the head and tail of a span that does not start or end on a
// 16-byte boundary
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// floats from the last 16-byte boundary at or below p
__device__ __forceinline__ int misalignment(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

}  // namespace repro
