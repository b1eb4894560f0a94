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
// weiszfeld_reduce, the second entry, is the same for weiszfeld_stats'
// two-pass form (src/repro/kernels/weiszfeld.py:weiszfeld_stats ran fused
// up to the same limit): a row pass computes each point's exact-form d2 to
// its assigned centre, inv(p) = max(w_p, 0) / sqrt(d2 + eta^2) and
// sqrt(d2), then the column walk below sums inv(p) * p and inv(p) (the
// numerators and denominators) and w_p * sqrt(d2) (the cost). It reads the
// points twice, once per pass.
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
// fused kernel's bit for bit, given that kernel's assignment (which
// distance_argmin's is): each sum entry is the fmaf chain fmaf(v, x[j], .)
// from 0.f over the slice's rows of that centre in row order, each count
// the chain + v, the cost the chain fmaf(w, t, .) over all rows, with
// (v, t) = (w, min d2) for lloyd_stats and (inv, sqrt(d2)) for
// weiszfeld_stats; a row assigned outside [0, k) adds to no sum and no
// count, and still to the cost (weiszfeld_reduce gives it t = 0, as the
// fused kernel does). The row pass computes d2 as weiszfeld_stats.cu does:
// lane u of a warp takes features u, u + 32, ... in order with
// fmaf(e, e, .), then a fixed xor butterfly.
#include "partials.cuh"

namespace {

using namespace repro;

constexpr int kCols = 128;    // columns per block, one per thread
constexpr int kGroup = 64;    // centres per block
constexpr int kUnroll = 16;   // rows loaded ahead of the accumulation
constexpr int kRowWarps = 8;  // rows per block of the row pass
constexpr float kEta2 = 1e-6f;  // ref.WEISZFELD_ETA2

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

// V weighs the sums and counts, W and T the cost's terms (W and MD for
// Lloyd; inv, W and sqrt(d2) for Weiszfeld).
__global__ void __launch_bounds__(kCols)
    lloyd_reduce_kernel(const float* __restrict__ P,
                        const float* __restrict__ V,
                        const float* __restrict__ W,
                        const float* __restrict__ T,
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
  const float* Vb = V + (size_t)b * M;
  const int* Ab = A + (size_t)b * M;
  float* acc = acc_all + tid;   // this thread's column
  // each thread reads and writes only its own column: no barrier needed
  for (int c = 0; c < kg; ++c) acc[c * kCols] = 0.f;

  const int E = k * d + k + 1;
  float* out = partials + ((size_t)b * gridDim.y + g) * E;
  if (j < d) {
    accumulate<true>(P + (size_t)b * M * d + j, Vb, Ab, acc, first, stop, c0,
                     kg, d);
    for (int c = 0; c < kg; ++c)
      out[(size_t)(c0 + c) * d + j] = acc[c * kCols];
  } else if (j == d) {
    accumulate<false>(nullptr, Vb, Ab, acc, first, stop, c0, kg, d);
    for (int c = 0; c < kg; ++c) out[(size_t)k * d + c0 + c] = acc[c * kCols];
  } else if (j == d + 1 && grp == 0) {
    const float* Wb = W + (size_t)b * M;
    const float* Tb = T + (size_t)b * M;
    float cost = 0.f;
#pragma unroll 8
    for (int r = first; r < stop; ++r) cost = fmaf(Wb[r], Tb[r], cost);
    out[E - 1] = cost;
  }
}

// The row pass of weiszfeld_reduce: one warp per row, inv(p) and sqrt(d2)
// of the row's exact-form distance to its assigned centre; 0 for both where
// the row is assigned outside [0, k).
__global__ void __launch_bounds__(kRowWarps * 32)
    weiszfeld_rows_kernel(const float* __restrict__ P,
                          const float* __restrict__ C,
                          const float* __restrict__ W,
                          const int* __restrict__ A, float* __restrict__ inv,
                          float* __restrict__ root, int M, int k, int d) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (r >= M) return;  // the whole warp: r is the warp's
  const size_t row = (size_t)blockIdx.y * M + r;
  const int a = A[row];
  const bool live = (unsigned)a < (unsigned)k;
  float v = 0.f;
  if (live) {
    const float* p = P + row * d;
    const float* c = C + ((size_t)blockIdx.y * k + a) * d;
    for (int j = lane; j < d; j += 32) {
      const float e = p[j] - c[j];
      v = fmaf(e, e, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) {
    inv[row] = live ? fmaxf(W[row], 0.f) / sqrtf(v + kEta2) : 0.f;
    root[row] = live ? sqrtf(v) : 0.f;
  }
}

// The column walk and the partials' sum, shared by both entries.
int launch_reduce(const float* P, const float* V, const float* W,
                  const float* T, const int* A, float* partials, float* out,
                  int S, int M, int k, int d, int rows_per_block,
                  cudaStream_t st) {
  const int groups = (k + kGroup - 1) / kGroup;
  const long long chunks = (d + 2 + kCols - 1) / kCols;
  const int G = (M + rows_per_block - 1) / rows_per_block;
  if (chunks * groups > 0x7fffffffLL || G > 65535)
    return (int)cudaErrorInvalidValue;
  const int E = k * d + k + 1;
  const size_t bytes = sizeof(float) * kCols * (size_t)min(k, kGroup);
  lloyd_reduce_kernel<<<dim3((unsigned)(chunks * groups), G, S), kCols, bytes,
                        st>>>(P, V, W, T, A, partials, M, k, d,
                              rows_per_block, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_partials_reduce(partials, out, S, G, E, st);
}

bool bad_sizes(int S, int M, int k, int d, int rows_per_block) {
  return S < 1 || S > 65535 || M < 1 || k < 1 || d < 1 || rows_per_block < 1;
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
  if (bad_sizes(S, M, k, d, rows_per_block))
    return (int)cudaErrorInvalidValue;
  return launch_reduce(P, W, W, MD, A, partials, out, S, M, k, d,
                       rows_per_block, static_cast<cudaStream_t>(stream));
}

// points (S, M, d), centres (S, k, d), weights (S, M), assignment (S, M)
// int32, rows (2, S, M) for inv and sqrt(d2), partials
// (S, ceil(M / rows_per_block), k d + k + 1), out (S, k d + k + 1) laid out
// as nums (k, d), denoms (k), cost; all contiguous. Returns the CUDA error
// of the launches, as lloyd_reduce_launch.
extern "C" int weiszfeld_reduce_launch(const float* P, const float* C,
                                       const float* W, const int* A,
                                       float* rows, float* partials,
                                       float* out, int S, int M, int k, int d,
                                       int rows_per_block, void* stream) {
  if (bad_sizes(S, M, k, d, rows_per_block))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* inv = rows;
  float* root = rows + (size_t)S * M;
  weiszfeld_rows_kernel<<<dim3((M + kRowWarps - 1) / kRowWarps, S),
                          kRowWarps * 32, 0, st>>>(P, C, W, A, inv, root, M,
                                                   k, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(P, inv, W, root, A, partials, out, S, M, k, d,
                       rows_per_block, st);
}
