// weiszfeld_stats: one fused pass of weighted Weiszfeld statistics (the
// k-median refinement step), with a(p) the argmin centre of p,
// d2(p) = sum_j (p_j - c[a(p)]_j)^2 in exact form and
// inv(p) = max(w_p, 0) / sqrt(d2(p) + eta^2):
//   nums[c]   = sum_{p : a(p) = c} inv(p) * p        (k, d)
//   denoms[c] = sum_{p : a(p) = c} inv(p)            (k,)
//   cost      = sum_p w_p * sqrt(d2(p))              ()
// for S independent (points, centres, weights) triples in one launch.
//
// Replaces src/repro/kernels/weiszfeld.py:weiszfeld_stats (the Pallas TPU
// kernel _kernel). The TPU kernel ran three MXU products per tile: the
// distance block, a one-hot product gathering each point's assigned centre,
// and the one-hot product of the numerators. Here the argmin comes from
// tile_argmin (the same routine and tile shape as distance_argmin and
// lloyd_stats, so all three assign bit-identically); the assigned centre is
// read from global memory (L2: the centres are a few KB) and subtracted from
// the point, so a centre that is a data point gives d2 = 0 exactly, as in
// the plain version -- never |p|^2 + |c|^2 - 2 p.c, whose cancellation
// 1/sqrt would amplify near zero. The numerators go into shared memory with
// each thread owning whole columns, as lloyd_stats.cu does. Each block owns
// a fixed slice of rows and writes one partial; partials.cuh sums a site's
// partials in block order: no float atomics, bit-identical reruns.
//
// Bound on an H100: the assignment dominates (2 k d flops per point against
// 4 d bytes, operations at k = 50, d = 90); the exact distance and the
// numerators add 5 d flops and no device-memory pass (the tile's rows and
// the assigned centre come from L1/L2). The per-block accumulators need
// k (d + 1) floats of shared memory, the limit ops.py checks
// (LLOYD_RESIDENT_FLOATS, shared with lloyd_stats).
#include "argmin_tile.cuh"
#include "partials.cuh"

namespace {

using namespace repro;

constexpr float kEta2 = 1e-6f;  // ref.WEISZFELD_ETA2
constexpr int kWarps = kThreads / 32;

template <int TX, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    weiszfeld_partials_kernel(const float* __restrict__ P,
                              const float* __restrict__ C,
                              const float* __restrict__ W,
                              float* __restrict__ partials, int M, int k,
                              int k_pad, int d, int rows_per_block) {
  using T = Tile<TX, TM, TN>;
  __shared__ float smem[T::kSmemFloats];  // tile staging
  extern __shared__ float acc[];          // accumulators, sized at launch
  float* nums = acc;                      // [k][d]
  float* denoms = nums + k * d;           // [k]
  float* invs = denoms + k;               // [BN] inv(p)
  float* roots = invs + T::BN;            // [BN] sqrt(d2(p))
  float* ws = roots + T::BN;              // [BN]
  int* args = reinterpret_cast<int*>(ws + T::BN);  // [BN]
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.y;
  const int start = blockIdx.x * rows_per_block;
  const int stop = min(M, start + rows_per_block);
  const int last = kThreads - 1;  // the lane that also sums denoms and cost
  const float* Cb = C + (size_t)b * k_pad * d;

  for (int e = tid; e < k * (d + 1); e += kThreads) nums[e] = 0.f;
  float cost = 0.f;

  for (int row0 = start; row0 < stop; row0 += T::BN) {
    const int rows = min(T::BN, stop - row0);
    const float* Pt = P + ((size_t)b * M + row0) * d;
    float best[TM];
    int arg[TM];
    tile_argmin<TX, TM, TN>(Pt, Cb, rows, k_pad, d, smem, best, arg);
    if (tid % TX == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) args[tid / TX + i * T::TY] = arg[i];
    }
    for (int r = tid; r < rows; r += kThreads)
      ws[r] = W[(size_t)b * M + row0 + r];
    __syncthreads();

    // exact-form distance to the assigned centre: one warp per row, lanes
    // across features, a fixed butterfly sum (every lane ends with the same
    // value). Rows assigned to a padded centre (a >= k) add nothing.
    for (int r = warp; r < rows; r += kWarps) {
      const int a = args[r];
      float s = 0.f;
      if (a < k) {
        const float* p = Pt + (size_t)r * d;
        const float* c = Cb + (size_t)a * d;
        for (int j = lane; j < d; j += 32) {
          const float x = p[j] - c[j];
          s = fmaf(x, x, s);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        invs[r] = a < k ? fmaxf(ws[r], 0.f) / sqrtf(s + kEta2) : 0.f;
        roots[r] = a < k ? sqrtf(s) : 0.f;
      }
    }
    __syncthreads();

    // each thread owns whole columns of nums: no two threads add to one
    // entry, and rows are added in order
    for (int j = tid; j < d; j += kThreads) {
      for (int r = 0; r < rows; ++r) {
        const int a = args[r];
        if (a < k) nums[a * d + j] = fmaf(invs[r], Pt[(size_t)r * d + j],
                                          nums[a * d + j]);
      }
    }
    if (tid == last) {
      for (int r = 0; r < rows; ++r) {
        if (args[r] < k) denoms[args[r]] += invs[r];
        cost = fmaf(ws[r], roots[r], cost);
      }
    }
    __syncthreads();
  }

  const int E = k * d + k + 1;
  float* out = partials + ((size_t)b * gridDim.x + blockIdx.x) * E;
  for (int e = tid; e < k * (d + 1); e += kThreads) out[e] = nums[e];
  if (tid == last) out[E - 1] = cost;
}

template <typename T, typename K>
int launch(K kernel, const float* P, const float* C, const float* W,
           float* partials, float* out, int S, int M, int k, int k_pad, int d,
           int rows_per_block, cudaStream_t stream) {
  if (k_pad % T::BK != 0 || k > k_pad) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)k * (d + 1) + 4 * T::BN);
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
// as nums (k, d), denoms (k), cost; all contiguous. Returns the CUDA error
// of the launches (0 on success).
extern "C" int weiszfeld_stats_launch(const float* P, const float* C,
                                      const float* W, float* partials,
                                      float* out, int S, int M, int k,
                                      int k_pad, int d, int rows_per_block,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_pad == 1)
    return launch<SingleTile>(weiszfeld_partials_kernel<1, 1, 1>, P, C, W,
                              partials, out, S, M, k, k_pad, d,
                              rows_per_block, st);
  return launch<WideTile>(weiszfeld_partials_kernel<16, 4, 4>, P, C, W,
                          partials, out, S, M, k, k_pad, d, rows_per_block,
                          st);
}
