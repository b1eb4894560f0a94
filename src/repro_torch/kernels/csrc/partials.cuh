// The second pass of the fused statistics kernels (lloyd_stats,
// weiszfeld_stats): each block of the first pass wrote one partial of E
// floats over a fixed slice of rows; this sums a site's G partials in block
// order. No float atomics, so results are bit-identical from run to run and
// a site's result does not depend on how many sites share the launch.
#pragma once

#include "argmin_tile.cuh"

namespace repro {

// out[b][e] = sum over the site's blocks g, in order, of partials[b][g][e]
__global__ void __launch_bounds__(kThreads)
    partials_reduce_kernel(const float* __restrict__ partials,
                           float* __restrict__ out, int G, int E) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const float* p = partials + (size_t)b * G * E + e;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += p[(size_t)g * E];
  out[(size_t)b * E + e] = s;
}

inline cudaError_t launch_partials_reduce(const float* partials, float* out,
                                          int S, int G, int E,
                                          cudaStream_t stream) {
  partials_reduce_kernel<<<dim3((E + kThreads - 1) / kThreads, S), kThreads,
                           0, stream>>>(partials, out, G, E);
  return cudaGetLastError();
}

}  // namespace repro
