// lloyd_reduce: the weighted Lloyd statistics given an assignment,
//   sums[c]   = sum_{p : a(p) = c} w_p * p      (k, d)
//   counts[c] = sum_{p : a(p) = c} w_p          (k,)
//   cost      = sum_p w_p * min_d2(p)           ()
// for S sites in one launch. It is the second pass of lloyd_stats' two-pass
// form, after distance_argmin has assigned the points: the shapes whose
// centres do not fit the fused kernel's shared memory (lloyd_update.fits),
// such as k = 8 centres of d = 4,096 features. The Pallas TPU kernel
// src/repro/kernels/lloyd_update.py:lloyd_stats ran fused at such shapes
// (its limit was 2**20 floats of centres); here the assignment and the sums
// are two kernels, and this one does the sums.
//
// Bound on an H100: bytes. Each point feature is read once for one fmaf
// (2 flops per 4 bytes), so the points' read sets the time. A block owns
// kCols columns (one per thread: a feature j < d, the counts at j = d, the
// cost at j = d + 1), a group of at most kGroup centres, and a fixed slice
// of rows_per_block rows of one site. Each thread walks the slice's rows in
// order -- the row's feature reads are coalesced across the warp, its
// assignment and weight are one broadcast each -- and keeps one accumulator
// per centre of its group in shared memory (column-major, so a warp's
// accesses hit 32 banks). Loads run kUnroll rows ahead of the
// read-modify-writes: the rows in flight set the rate, since a small grid
// (528 blocks of 4 warps at 8 sites x 2,048 rows x 4,096 features) holds
// few warps per SM; 16 rows ran faster than 8, 32, or loads double-buffered
// across groups of rows. Each block writes one partial, which partials.cuh
// sums in block order: no float atomics, so results are bit-identical run
// to run.
//
// With rows_per_block = lloyd_update.ROWS_PER_BLOCK each partial is the
// fused lloyd_stats kernel's bit for bit, given that kernel's assignment
// and min d2 (which distance_argmin's are): each sum entry is the fmaf
// chain fmaf(w, x[j], .) from 0.f over the slice's rows of that centre in
// row order, each count the chain + w, the cost the chain fmaf(w, min_d2,
// .) over all rows; a row assigned outside [0, k) adds to no sum and no
// count, and still to the cost.
#include "partials.cuh"

namespace {

using namespace repro;

constexpr int kCols = 128;    // columns per block, one per thread
constexpr int kGroup = 64;    // centres per block
constexpr int kUnroll = 16;   // rows loaded ahead of the accumulation

// Feature column j < d: acc[c] = fmaf(w, x[j], acc[c]); the counts column
// (Feature = false): acc[c] = acc[c] + w. Rows of centres outside the
// group [c0, c0 + kg) are skipped.
template <bool Feature>
__device__ __forceinline__ void accumulate(const float* __restrict__ Pj,
                                           const float* __restrict__ Wb,
                                           const int* __restrict__ Ab,
                                           float* acc, int first, int stop,
                                           int c0, int kg, int d) {
  int r = first;
  for (; r + kUnroll <= stop; r += kUnroll) {
    int a[kUnroll];
    float w[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = Ab[r + u] - c0;
      w[u] = Wb[r + u];
      x[u] = Feature ? Pj[(size_t)(r + u) * d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((unsigned)a[u] < (unsigned)kg) {
        float* v = acc + a[u] * kCols;
        *v = Feature ? fmaf(w[u], x[u], *v) : *v + w[u];
      }
    }
  }
  for (; r < stop; ++r) {
    const int a = Ab[r] - c0;
    if ((unsigned)a < (unsigned)kg) {
      float* v = acc + a * kCols;
      *v = Feature ? fmaf(Wb[r], Pj[(size_t)r * d], *v) : *v + Wb[r];
    }
  }
}

__global__ void __launch_bounds__(kCols)
    lloyd_reduce_kernel(const float* __restrict__ P,
                        const float* __restrict__ W,
                        const float* __restrict__ MD,
                        const int* __restrict__ A,
                        float* __restrict__ partials, int M, int k, int d,
                        int rows_per_block, int groups) {
  extern __shared__ float acc_all[];   // [kg][kCols]
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x / groups;
  const int grp = blockIdx.x - chunk * groups;
  const int j = chunk * kCols + tid;
  const int c0 = grp * kGroup;
  const int kg = min(kGroup, k - c0);
  const int g = blockIdx.y, b = blockIdx.z;
  const int first = g * rows_per_block;
  const int stop = min(M, first + rows_per_block);
  const float* Wb = W + (size_t)b * M;
  const int* Ab = A + (size_t)b * M;
  float* acc = acc_all + tid;   // this thread's column
  // each thread reads and writes only its own column: no barrier needed
  for (int c = 0; c < kg; ++c) acc[c * kCols] = 0.f;

  const int E = k * d + k + 1;
  float* out = partials + ((size_t)b * gridDim.y + g) * E;
  if (j < d) {
    accumulate<true>(P + (size_t)b * M * d + j, Wb, Ab, acc, first, stop, c0,
                     kg, d);
    for (int c = 0; c < kg; ++c)
      out[(size_t)(c0 + c) * d + j] = acc[c * kCols];
  } else if (j == d) {
    accumulate<false>(nullptr, Wb, Ab, acc, first, stop, c0, kg, d);
    for (int c = 0; c < kg; ++c) out[(size_t)k * d + c0 + c] = acc[c * kCols];
  } else if (j == d + 1 && grp == 0) {
    const float* MDb = MD + (size_t)b * M;
    float cost = 0.f;
#pragma unroll 8
    for (int r = first; r < stop; ++r) cost = fmaf(Wb[r], MDb[r], cost);
    out[E - 1] = cost;
  }
}

}  // namespace

// points (S, M, d), weights (S, M), min d2 (S, M), assignment (S, M) int32,
// partials (S, ceil(M / rows_per_block), k d + k + 1), out (S, k d + k + 1)
// laid out as sums (k, d), counts (k), cost; all contiguous. Returns the
// CUDA error of the launches (0 on success; cudaErrorInvalidValue for sizes
// the kernel does not take).
extern "C" int lloyd_reduce_launch(const float* P, const float* W,
                                   const float* MD, const int* A,
                                   float* partials, float* out, int S, int M,
                                   int k, int d, int rows_per_block,
                                   void* stream) {
  if (S < 1 || S > 65535 || M < 1 || k < 1 || d < 1 || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = (k + kGroup - 1) / kGroup;
  const long long chunks = (d + 2 + kCols - 1) / kCols;
  const int G = (M + rows_per_block - 1) / rows_per_block;
  if (chunks * groups > 0x7fffffffLL || G > 65535)
    return (int)cudaErrorInvalidValue;
  const int E = k * d + k + 1;
  const size_t bytes = sizeof(float) * kCols * (size_t)min(k, kGroup);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lloyd_reduce_kernel<<<dim3((unsigned)(chunks * groups), G, S), kCols, bytes,
                        st>>>(P, W, MD, A, partials, M, k, d, rows_per_block,
                              groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_partials_reduce(partials, out, S, G, E, st);
}
