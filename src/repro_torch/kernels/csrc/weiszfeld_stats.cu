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
// and the one-hot product of the numerators. Each block here owns a fixed
// slice of rows_per_block rows of one site and writes one partial;
// partials.cuh sums a site's partials in block order: no float atomics,
// bit-identical reruns.
//
// Bound on an H100: operations. The assignment is 2 k d flops per point
// against 4 d bytes read (~25 flops per byte at k = 50, above the fp32
// CUDA-core ridge of ~20); the exact distance and the numerators add 5 d
// flops and no device-memory pass. So every row is read from device memory
// once and every operand of the inner loop comes from shared memory: the
// resident centres, one cp.async copy of each 64-row point tile, the
// assignment bit for bit distance_argmin's, and the column sums over the
// rows sorted by centre are resident_tile.cuh's. What is this kernel's own:
// the exact distance, one warp per row, lanes over features and a fixed
// xor butterfly, from the two resident copies: a centre that is a data
// point gives d2 = 0 exactly, never |p|^2 + |c|^2 - 2 p.c, whose
// cancellation 1/sqrt would amplify near zero. Each row's value for the
// column sums is inv(p) (the numerators, and the denominators as column
// d); the cost is one row-order chain of fmaf(w, sqrt(d2)). A row assigned
// to a padded centre (a >= k) adds nothing.
// One stage per block: at k = 50, d = 90 a block holds 67,268 bytes of
// shared memory, so three blocks share an SM and overlap each other's
// copies and computations; a second stage (the next tile's copy during this
// tile's work) leaves room for two blocks, and was slower on an H100.
#include "resident_tile.cuh"

namespace {

using namespace repro;

constexpr float kEta2 = 1e-6f;         // ref.WEISZFELD_ETA2
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kOwn = 2;                // per-row inv(p) and sqrt(d2(p))

__global__ void __launch_bounds__(kThreads)
    weiszfeld_stats_kernel(const float* __restrict__ P,
                           const float* __restrict__ C,
                           const float* __restrict__ W,
                           float* __restrict__ partials, int M, int k,
                           int k_pad, int d, int rows_per_block) {
  extern __shared__ float4 smem4[];
  const ResidentTile<kOwn> s(smem4, k, k_pad, d);
  float* invs = s.own;                  // [64] inv(p)
  float* roots = s.own + kTileRows;     // [64] sqrt(d2(p))
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int b = blockIdx.y;
  const int first = blockIdx.x * rows_per_block;
  const int stop = min(M, first + rows_per_block);
  const float* Pb = P + (size_t)b * M * d;
  const float* Wb = W + (size_t)b * M;
  const float* Cb = C + (size_t)b * k_pad * d;

  int mis = copy_tile(s.stage, s.ws, Pb, Wb, first,
                      min(kTileRows, stop - first), d);
  stage_centers(s, Cb, k, k_pad, d);
  float cost = 0.f;

  for (int row0 = first; row0 < stop; row0 += kTileRows) {
    const int rows = min(kTileRows, stop - row0);
    wait_tile();
    __syncthreads();  // every thread's copies of this tile have landed
    const float* x = s.stage + mis;  // row r at x + r d
    tile_norms(x, s.p2s, rows, d);
    float best[kTM];
    int arg[kTM];
    assign_tile(s, x, d, best, arg);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        if (ty + i * kTY < rows) s.args[ty + i * kTY] = arg[i];
    }
    __syncthreads();

    // exact-form distance to the assigned centre: one warp per row, lanes
    // across features, a fixed butterfly sum (every lane ends with the same
    // value). A warp takes its eight rows at once, and lane u finishes row
    // warp + 8 u.
    {
      float v[kRowsPerWarp];
      int as[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int r = warp + kWarps * u;
        as[u] = r < rows ? s.args[r] : k;
        v[u] = 0.f;
      }
      for (int j = lane; j < d; j += 32) {
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u) {
          if (as[u] < k) {
            const float e = x[(warp + kWarps * u) * d + j] -
                            s.Ct[j * s.ks + as[u]];
            v[u] = fmaf(e, e, v[u]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u)
          v[u] += __shfl_xor_sync(0xffffffffu, v[u], off);
      float mine = 0.f;
      int ma = k;
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        if (lane == u) {
          mine = v[u];
          ma = as[u];
        }
      }
      const int r = warp + kWarps * lane;
      if (lane < kRowsPerWarp && r < rows) {
        invs[r] = ma < k ? fmaxf(s.ws[r], 0.f) / sqrtf(mine + kEta2) : 0.f;
        roots[r] = ma < k ? sqrtf(mine) : 0.f;
      }
    }
    sort_rows(s, rows, k);
    __syncthreads();

    walk_columns(s, x, invs, k, d);
    if (tid == kCostThread) cost = row_cost(s.ws, roots, rows, cost);
    __syncthreads();  // the stage and the per-row arrays are free again
    if (row0 + kTileRows < stop)
      mis = copy_tile(s.stage, s.ws, Pb, Wb, row0 + kTileRows,
                      min(kTileRows, stop - row0 - kTileRows), d);
  }
  write_partial(s, partials, k, d, cost);
}

}  // namespace

// points (S, M, d), centres (S, k_pad, d) with k_pad 1 or a multiple of 64
// (rows past k at the sentinel), weights (S, M), partials
// (S, ceil(M / rows_per_block), k d + k + 1), out (S, k d + k + 1) laid out
// as nums (k, d), denoms (k), cost; all contiguous. Returns the CUDA error
// of the launches (0 on success; see launch_resident).
extern "C" int weiszfeld_stats_launch(const float* P, const float* C,
                                      const float* W, float* partials,
                                      float* out, int S, int M, int k,
                                      int k_pad, int d, int rows_per_block,
                                      void* stream) {
  return launch_resident<weiszfeld_stats_kernel, kOwn>(
      P, C, W, partials, out, S, M, k, k_pad, d, rows_per_block, stream);
}
