// distance_argmin: per point, the min squared distance to k centres and its
// argmin, for S independent (points, centres) pairs in one launch.
//
// Replaces src/repro/kernels/distance_argmin.py:distance_argmin (the Pallas
// TPU kernel _kernel; under jax.vmap over sites it ran as one launch with a
// batch grid axis, and blockIdx.y is that axis here).
//
// Bound on an H100: at the main path's shapes (k = 50, d = 90) the work is
// 2 k d flops per point against 4 d bytes read, ~25 flops per byte: above
// the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, ~20), so it is bound
// by operations. With one centre (D^2 seeding) it reads 4 d bytes for 2 d
// flops and is bound by bytes.
// Design: each block owns a tile of points and sweeps every centre tile
// through shared memory, keeping the running min/argmin in registers
// (argmin_tile.cuh); the (n, k) matrix is never written. Wide and one-centre
// tile shapes keep both regimes busy. fp32 FMAs on the CUDA cores, not the
// tensor cores: TF32 would flip argmins, and exact-fp32 tensor-core
// emulation is later work.
#include "argmin_tile.cuh"

namespace {

using namespace repro;

template <int TX, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    distance_argmin_kernel(const float* __restrict__ P,
                           const float* __restrict__ C,
                           float* __restrict__ out_min,
                           int* __restrict__ out_arg, int M, int k_pad, int d) {
  using T = Tile<TX, TM, TN>;
  __shared__ float smem[T::kSmemFloats];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * T::BN;
  const int rows = min(T::BN, M - row0);
  float best[TM];
  int arg[TM];
  tile_argmin<TX, TM, TN>(P + ((size_t)b * M + row0) * d,
                          C + (size_t)b * k_pad * d, rows, k_pad, d, smem,
                          best, arg);
  if (threadIdx.x % TX == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = threadIdx.x / TX + i * T::TY;
      if (r < rows) {
        out_min[(size_t)b * M + row0 + r] = best[i];
        out_arg[(size_t)b * M + row0 + r] = arg[i];
      }
    }
  }
}

template <typename T, typename K>
int launch(K kernel, const float* P, const float* C, float* out_min,
           int* out_arg, int S, int M, int k_pad, int d,
           cudaStream_t stream) {
  if (k_pad % T::BK != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((M + T::BN - 1) / T::BN, S);
  kernel<<<grid, kThreads, 0, stream>>>(P, C, out_min, out_arg, M, k_pad, d);
  return (int)cudaGetLastError();
}

}  // namespace

// points (S, M, d), centres (S, k_pad, d), outputs (S, M); all contiguous.
// Returns the CUDA error of the launch (0 on success).
extern "C" int distance_argmin_launch(const float* P, const float* C,
                                      float* out_min, int* out_arg, int S,
                                      int M, int k_pad, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_pad == 1)
    return launch<SingleTile>(distance_argmin_kernel<1, 1, 1>, P, C, out_min,
                              out_arg, S, M, k_pad, d, st);
  return launch<WideTile>(distance_argmin_kernel<16, 4, 4>, P, C, out_min,
                          out_arg, S, M, k_pad, d, st);
}

// The stacked-tenant entry (replaces the Pallas TPU kernel
// src/repro/kernels/distance_argmin.py:distance_argmin_batched, whose grid
// (T, m/bn, k/bk) led with the tenant axis): T tenants' queries (T, m, d)
// against their own centres (T, k_pad, d), tenant on blockIdx.y. Masked
// centre rows arrive at the sentinel. Serving's query buckets are small
// (m from 8 rows), so up to 32 rows per tenant take the 8-point tile;
// larger buckets take the general one. Any tile shape gives what
// distance_argmin_launch gives for the same tenant (argmin_tile.cuh), so a
// fused dispatch equals a loop of single-tenant launches bit for bit.
extern "C" int distance_argmin_batched_launch(const float* P, const float* C,
                                              float* out_min, int* out_arg,
                                              int T, int m, int k_pad, int d,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_pad == 1)
    return launch<SingleTile>(distance_argmin_kernel<1, 1, 1>, P, C, out_min,
                              out_arg, T, m, k_pad, d, st);
  if (m <= 4 * NarrowTile::BN)
    return launch<NarrowTile>(distance_argmin_kernel<32, 1, 2>, P, C, out_min,
                              out_arg, T, m, k_pad, d, st);
  return launch<WideTile>(distance_argmin_kernel<16, 4, 4>, P, C, out_min,
                          out_arg, T, m, k_pad, d, st);
}
