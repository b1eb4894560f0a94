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
// Bound on an H100: operations. The assignment is 2 k d flops per point
// against 4 d bytes read (~25 flops per byte at k = 50, above the fp32
// CUDA-core ridge of ~20); the sums add 2 d flops and no device-memory
// pass. So the kernel is resident_tile.cuh's core as it stands: the site's
// centres resident in shared memory with their norms taken once, one
// cp.async copy of each 64-row point tile that the norms, the dot products
// and the sums all read, and the column sums with every thread over the
// rows sorted by centre. Each row's value is its weight: sums[a][j] takes
// fmaf(w, x[j], .), counts[a] (column d) takes + w, and one thread keeps
// the cost chain fmaf(w, min_d2, .) in row order. A row assigned to a
// padded centre (a >= k) adds to no sum and no count, and still to the
// cost. k_pad = 1 runs the same kernel with the centre padded to 64
// sentinel columns in shared memory.
//
// Every partial equals the earlier kernel's bit for bit (the general tile
// of tile_argmin with the sums, counts and cost kept by one thread per
// column and one thread for the rest, over rows in order):
// - the block owns the same rows (rows_per_block) and writes the same
//   layout k d + k + 1, summed by the same partials.cuh;
// - each sum entry is the same fmaf chain from 0.f over the block's rows
//   of that centre in row order: the counting sort is stable and the
//   walker continues one register chain from tile to tile; counts are the
//   same chain of adds, and the cost the same fmaf chain over all rows;
// - each row's assignment and min d2 are tile_argmin's chain of roundings
//   (argmin_tile.cuh's note on tile shapes), for k_pad = 1 too: a sentinel
//   column never wins for data far inside ref.CENTER_SENTINEL, and a row
//   whose every d2 is NaN or +inf keeps best = +inf at index 0 in both.
// One stage per block: at k = 50, d = 90 a block holds 67,012 bytes of
// shared memory, so three blocks share an SM, as weiszfeld_stats'.
#include "resident_tile.cuh"

namespace {

using namespace repro;

constexpr int kOwn = 1;                // per-row min d2

__global__ void __launch_bounds__(kThreads)
    lloyd_stats_kernel(const float* __restrict__ P,
                       const float* __restrict__ C,
                       const float* __restrict__ W,
                       float* __restrict__ partials, int M, int k, int k_pad,
                       int d, int rows_per_block) {
  extern __shared__ float4 smem4[];
  const ResidentTile<kOwn> s(smem4, k, k_pad, d);
  float* mins = s.own;                  // [64] min d2
  const int tid = threadIdx.x;
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
      for (int i = 0; i < kTM; ++i) {
        const int r = ty + i * kTY;
        if (r < rows) {
          s.args[r] = arg[i];
          mins[r] = best[i];
        }
      }
    }
    __syncthreads();
    sort_rows(s, rows, k);
    __syncthreads();

    walk_columns(s, x, s.ws, k, d);
    if (tid == kCostThread) cost = row_cost(s.ws, mins, rows, cost);
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
// as sums (k, d), counts (k), cost; all contiguous. Returns the CUDA error
// of the launches (0 on success; see launch_resident).
extern "C" int lloyd_stats_launch(const float* P, const float* C,
                                  const float* W, float* partials, float* out,
                                  int S, int M, int k, int k_pad, int d,
                                  int rows_per_block, void* stream) {
  return launch_resident<lloyd_stats_kernel, kOwn>(
      P, C, W, partials, out, S, M, k, k_pad, d, rows_per_block, stream);
}
