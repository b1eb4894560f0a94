// lloyd_stats: one fused pass of weighted Lloyd statistics,
//   sums[c]   = sum_{p : argmin(p) = c} w_p * p      (k, d)
//   counts[c] = sum_{p : argmin(p) = c} w_p          (k,)
//   cost      = sum_p w_p * min_d2(p)                ()
// for S independent (points, centres, weights) triples in one launch.
//
// Replaces src/repro/kernels/lloyd_update.py:lloyd_stats (the Pallas TPU
// kernel _kernel). On the TPU the grid runs in order and the outputs are
// accumulators carried across grid steps; on the card blocks run in no
// order, so each block owns a fixed slice of rows_per_block rows, keeps
// its sums/counts/cost in shared memory, and writes them as one partial; a
// second kernel sums the partials of a site in block order. No float
// atomics, so the result is bit-identical from run to run, and a site's
// result depends only on its own length, not on how many sites share the
// launch.
//
// Bound on an H100: the assignment step dominates, as in distance_argmin
// (operations at k = 50, d = 90); the accumulation adds 2 d flops and no
// extra device-memory pass per point (the tile's rows are re-read from
// L1/L2). The per-block accumulators need k (d + 1) floats of shared
// memory, the limit ops.py checks (LLOYD_RESIDENT_FLOATS).
#include "argmin_tile.cuh"
#include "partials.cuh"

namespace {

using namespace repro;

template <int TX, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    lloyd_partials_kernel(const float* __restrict__ P,
                          const float* __restrict__ C,
                          const float* __restrict__ W,
                          float* __restrict__ partials, int M, int k,
                          int k_pad, int d, int rows_per_block) {
  using T = Tile<TX, TM, TN>;
  __shared__ float smem[T::kSmemFloats];  // tile staging
  extern __shared__ float acc[];          // accumulators, sized at launch
  float* sums = acc;                      // [k][d]
  float* counts = sums + k * d;           // [k]
  float* mins = counts + k;             // [BN]
  int* args = reinterpret_cast<int*>(mins + T::BN);  // [BN]
  float* ws = reinterpret_cast<float*>(args + T::BN);  // [BN]
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int start = blockIdx.x * rows_per_block;
  const int stop = min(M, start + rows_per_block);
  const int last = kThreads - 1;  // the lane that also sums counts and cost

  for (int e = tid; e < k * (d + 1); e += kThreads) sums[e] = 0.f;
  float cost = 0.f;

  for (int row0 = start; row0 < stop; row0 += T::BN) {
    const int rows = min(T::BN, stop - row0);
    const float* Pt = P + ((size_t)b * M + row0) * d;
    float best[TM];
    int arg[TM];
    tile_argmin<TX, TM, TN>(Pt, C + (size_t)b * k_pad * d, rows, k_pad, d,
                            smem, best, arg);
    if (tid % TX == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = tid / TX + i * T::TY;
        mins[r] = best[i];
        args[r] = arg[i];
      }
    }
    for (int r = tid; r < rows; r += kThreads)
      ws[r] = W[(size_t)b * M + row0 + r];
    __syncthreads();

    // each thread owns whole columns of sums: no two threads add to one
    // entry, and rows are added in order
    for (int j = tid; j < d; j += kThreads) {
      for (int r = 0; r < rows; ++r) {
        const int a = args[r];
        if (a < k) sums[a * d + j] = fmaf(ws[r], Pt[(size_t)r * d + j],
                                          sums[a * d + j]);
      }
    }
    if (tid == last) {
      for (int r = 0; r < rows; ++r) {
        if (args[r] < k) counts[args[r]] += ws[r];
        cost = fmaf(ws[r], mins[r], cost);
      }
    }
    __syncthreads();
  }

  const int E = k * d + k + 1;
  float* out = partials + ((size_t)b * gridDim.x + blockIdx.x) * E;
  for (int e = tid; e < k * (d + 1); e += kThreads) out[e] = sums[e];
  if (tid == last) out[E - 1] = cost;
}

template <typename T, typename K>
int launch(K kernel, const float* P, const float* C, const float* W,
           float* partials, float* out, int S, int M, int k, int k_pad, int d,
           int rows_per_block, cudaStream_t stream) {
  if (k_pad % T::BK != 0 || k > k_pad) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)k * (d + 1) + 3 * T::BN);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = (M + rows_per_block - 1) / rows_per_block;
  const int E = k * d + k + 1;
  kernel<<<dim3(G, S), kThreads, smem, stream>>>(P, C, W, partials, M, k,
                                                 k_pad, d, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_partials_reduce(partials, out, S, G, E, stream);
}

}  // namespace

// points (S, M, d), centres (S, k_pad, d), weights (S, M), partials
// (S, ceil(M / rows_per_block), k d + k + 1), out (S, k d + k + 1) laid out
// as sums (k, d), counts (k), cost; all contiguous. Returns the CUDA error
// of the launches (0 on success).
extern "C" int lloyd_stats_launch(const float* P, const float* C,
                                  const float* W, float* partials, float* out,
                                  int S, int M, int k, int k_pad, int d,
                                  int rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_pad == 1)
    return launch<SingleTile>(lloyd_partials_kernel<1, 1, 1>, P, C, W,
                              partials, out, S, M, k, k_pad, d,
                              rows_per_block, st);
  return launch<WideTile>(lloyd_partials_kernel<16, 4, 4>, P, C, W, partials,
                          out, S, M, k, k_pad, d, rows_per_block, st);
}
