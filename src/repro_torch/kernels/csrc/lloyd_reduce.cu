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
// up to the same limit): each point's exact-form d2 to its assigned centre
// gives inv(p) = max(w_p, 0) / sqrt(d2 + eta^2) and sqrt(d2), and the sums
// are inv(p) * p and inv(p) (the numerators and denominators) and
// w_p * sqrt(d2) (the cost).
//
// Bound on an H100: bytes. Each point feature is read once for one fmaf
// (2 flops per 4 bytes), so one read of the points sets the time. Each
// block of the sums writes one partial over a fixed slice of
// rows_per_block rows of one site, which partials.cuh sums in block order:
// no float atomics, so results are bit-identical run to run. A block owns
// one chunk of columns (one per thread, sized to d: a feature j < d, the
// counts at j = d, the cost at j = d + 1), the accumulators of as many
// centres as fit shared memory (all k up to 505 at d = 90 and 355 at
// d = 4,096, else groups of that many, each reading the points again) and
// one slice; it streams the slice's rows of its columns, with their
// assignments and values, through a ring of kWalkStages stages of
// kWalkRows rows with cp.async, and each thread walks its column in row
// order, each row one read-modify-write of its centre's accumulator in
// shared memory. Each block writes a partial and partials.cuh sums them.
// weiszfeld_reduce runs a row pass first (weiszfeld_rows_kernel, one warp
// per row), so it reads the points twice.
//
// With rows_per_block = lloyd_update.ROWS_PER_BLOCK each partial is the
// fused kernel's bit for bit, given that kernel's assignment (which
// distance_argmin's is), in any grouping of the centres: each sum entry is
// the fmaf chain fmaf(v, x[j], .) from 0.f over the slice's rows of that
// centre in row order, each count the chain + v, the cost the chain
// fmaf(w, t, .) over all rows, with (v, t) = (w, min d2) for lloyd_stats
// and (inv, sqrt(d2)) for weiszfeld_stats; a row assigned outside [0, k)
// adds to no sum and no count, and still to the cost (weiszfeld_reduce
// gives it t = 0, as the fused kernel does). d2 is taken as
// weiszfeld_stats.cu takes it: lane u of a warp takes features u, u + 32,
// ... in order with fmaf(e, e, .), then a fixed xor butterfly.
#include "resident_tile.cuh"

namespace {

using namespace repro;

constexpr float kEta2 = 1e-6f;  // ref.WEISZFELD_ETA2

constexpr int kWalkCols = 128;   // most columns per block, one per thread
constexpr int kWalkRows = 32;    // rows per stage
constexpr int kWalkStages = 3;   // stages in the ring
constexpr int kRowWarps = 8;     // rows per block of the row pass

// Floats of one stage of the ring for `cols` columns: the rows' features,
// then their assignment, value, weight and cost term.
__host__ __device__ inline int walk_stage_floats(int cols) {
  return kWalkRows * (cols + 4);
}

// One stage's rows into this thread's column: acc[a][.] (a relative to the
// group's first centre, its row stride `cols`) takes fmaf(v_r, x_r, .) for
// a feature column (Feature), + v_r for the counts. The stage's arrays do
// not alias the accumulators, so the next rows' loads overlap this row's
// read-modify-write.
template <bool Feature>
__device__ __forceinline__ void walk_stage(const int* __restrict__ ar,
                                           const float* __restrict__ vr,
                                           const float* __restrict__ xs,
                                           float* __restrict__ acc, int rows,
                                           int c0, int kg, int cols) {
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    const int a = ar[r] - c0;
    if ((unsigned)a < (unsigned)kg) {
      float* p = acc + a * cols;
      *p = Feature ? fmaf(vr[r], xs[r * cols], *p) : *p + vr[r];
    }
  }
}

// V weighs the sums and counts, W and T the cost's terms (W and MD for
// Lloyd; inv, W and sqrt(d2) for Weiszfeld). Block: `cols` threads, column
// chunk blockIdx.x / groups, centres [grp kg_max, grp kg_max + kg), slice
// blockIdx.y of site blockIdx.z. kVec: 16-byte copies (d % 4 == 0 and
// 16-byte-aligned points).
template <bool kVec>
__global__ void __launch_bounds__(kWalkCols)
    lloyd_reduce_kernel(const float* __restrict__ P,
                        const float* __restrict__ V,
                        const float* __restrict__ W,
                        const float* __restrict__ T,
                        const int* __restrict__ A,
                        float* __restrict__ partials, int M, int k, int d,
                        int rows_per_block, int cols, int kg_max,
                        int groups) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int stage_floats = walk_stage_floats(cols);
  float* acc_all = ring + kWalkStages * stage_floats;  // [kg][cols]
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x / groups;
  const int grp = blockIdx.x - chunk * groups;
  const int j0 = chunk * cols;
  const int j = j0 + tid;
  const int c0 = grp * kg_max;
  const int kg = min(kg_max, k - c0);
  const int g = blockIdx.y, b = blockIdx.z;
  const int first = g * rows_per_block;
  const int stop = min(M, first + rows_per_block);
  const float* Pb = P + (size_t)b * M * d;
  const int* Ab = A + (size_t)b * M;
  const float* Vb = V + (size_t)b * M;
  const float* Wb = W + (size_t)b * M;
  const float* Tb = T + (size_t)b * M;
  // the block that holds the cost column copies the cost's terms too
  const bool has_cost = grp == 0 && j0 <= d + 1 && d + 1 < j0 + cols;
  const int steps = (stop - first + kWalkRows - 1) / kWalkRows;

  auto issue = [&](int s) {
    if (s < steps) {
      float* st = ring + (s % kWalkStages) * stage_floats;
      const int row0 = first + s * kWalkRows;
      const int rows = min(kWalkRows, stop - row0);
      constexpr int Wd = kVec ? 4 : 1;  // floats a copy
      const int per_row = cols / Wd;
      for (int e = tid; e < kWalkRows * per_row; e += cols) {
        const int r = e / per_row, jj = Wd * (e - r * per_row);
        float* dst = st + r * cols + jj;
        if (r < rows && j0 + jj < d) {
          const float* src = Pb + (size_t)(row0 + r) * d + j0 + jj;
          if (kVec)
            cp_async16(dst, src);
          else
            cp_async4(dst, src);
        } else if (kVec) {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          *dst = 0.f;
        }
      }
      float* rs = st + kWalkRows * cols;  // a, v, w, t
      if (tid < rows) {
        cp_async4(rs + tid, reinterpret_cast<const float*>(Ab + row0 + tid));
        cp_async4(rs + kWalkRows + tid, Vb + row0 + tid);
        if (has_cost) {
          cp_async4(rs + 2 * kWalkRows + tid, Wb + row0 + tid);
          cp_async4(rs + 3 * kWalkRows + tid, Tb + row0 + tid);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kWalkStages - 1; ++s) issue(s);

  float* acc = acc_all + tid;  // this thread's column
  // each thread reads and writes only its own column: no barrier needed
  for (int c = 0; c < kg; ++c) acc[c * cols] = 0.f;
  float cost = 0.f;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWalkStages - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is free
    issue(s + kWalkStages - 1);
    const float* st = ring + (s % kWalkStages) * stage_floats;
    const int* ar = reinterpret_cast<const int*>(st + kWalkRows * cols);
    const float* vr = st + kWalkRows * cols + kWalkRows;
    const int rows = min(kWalkRows, stop - first - s * kWalkRows);
    if (j < d) {
      walk_stage<true>(ar, vr, st + tid, acc, rows, c0, kg, cols);
    } else if (j == d) {
      walk_stage<false>(ar, vr, st + tid, acc, rows, c0, kg, cols);
    } else if (j == d + 1 && grp == 0) {
      const float* wr = vr + kWalkRows;
      const float* tr = vr + 2 * kWalkRows;
      for (int r = 0; r < rows; ++r) cost = fmaf(wr[r], tr[r], cost);
    }
  }
  const int E = k * d + k + 1;
  float* out = partials + ((size_t)b * gridDim.y + g) * E;
  if (j < d) {
    for (int c = 0; c < kg; ++c)
      out[(size_t)(c0 + c) * d + j] = acc[c * cols];
  } else if (j == d) {
    for (int c = 0; c < kg; ++c) out[(size_t)k * d + c0 + c] = acc[c * cols];
  } else if (j == d + 1 && grp == 0) {
    out[E - 1] = cost;
  }
}

// The row pass of weiszfeld_reduce: one warp per row, inv(p)
// and sqrt(d2) of the row's exact-form distance to its assigned centre; 0
// for both where the row is assigned outside [0, k).
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

// The column walk: chunks of columns sized to d, the centres in as few
// groups as shared memory allows (of at most kg_cap centres where
// kg_cap > 0).
template <bool kVec>
int launch_walk(const float* P, const float* V, const float* W,
                const float* T, const int* A, float* partials, int S, int M,
                int k, int d, int rows_per_block, int G, int kg_cap,
                cudaStream_t st) {
  int most = 0;
  cudaError_t err = shared_limit<lloyd_reduce_kernel<kVec>>(&most);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (d + 2 + kWalkCols - 1) / kWalkCols;
  const int cols = (int)(((d + 2 + chunks - 1) / chunks + 31) / 32 * 32);
  const long long ring = (long long)sizeof(float) * kWalkStages *
                         walk_stage_floats(cols);
  long long kg_fit = (most - ring) / ((long long)sizeof(float) * cols);
  if (kg_cap > 0) kg_fit = std::min<long long>(kg_fit, kg_cap);
  const int kg_max = (int)std::min<long long>(k, kg_fit);
  if (kg_max < 1) return (int)cudaErrorInvalidValue;
  const int groups = (k + kg_max - 1) / kg_max;
  if (chunks * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = ring + sizeof(float) * (size_t)kg_max * cols;
  lloyd_reduce_kernel<kVec><<<dim3((unsigned)(chunks * groups), G, S), cols,
                              bytes, st>>>(P, V, W, T, A, partials, M, k, d,
                                           rows_per_block, cols, kg_max,
                                           groups);
  return (int)cudaGetLastError();
}

// Both entries: Weiszfeld's row pass, the column walk, then the partials'
// sum.
template <bool kWeiszfeld>
int launch_reduce(const float* P, const float* C, const float* W,
                  const float* MD, const int* A, float* rows, float* partials,
                  float* out, int S, int M, int k, int d, int rows_per_block,
                  int kg_cap, cudaStream_t st) {
  const int G = (M + rows_per_block - 1) / rows_per_block;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  const float* V = W;  // Lloyd: the sums weigh by w, the cost is w md
  const float* T = MD;
  cudaError_t err;
  if (kWeiszfeld) {
    float* inv = rows;
    float* root = rows + (size_t)S * M;
    weiszfeld_rows_kernel<<<dim3((M + kRowWarps - 1) / kRowWarps, S),
                            kRowWarps * 32, 0, st>>>(P, C, W, A, inv, root, M,
                                                     k, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    V = inv;
    T = root;
  }
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0;
  err = (cudaError_t)(vec ? launch_walk<true>(P, V, W, T, A, partials, S, M,
                                              k, d, rows_per_block, G,
                                              kg_cap, st)
                          : launch_walk<false>(P, V, W, T, A, partials, S, M,
                                               k, d, rows_per_block, G,
                                               kg_cap, st));
  if (err != cudaSuccess) return (int)err;
  return (int)launch_partials_reduce(partials, out, S, G, k * d + k + 1, st);
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
  return launch_reduce<false>(P, nullptr, W, MD, A, nullptr, partials, out, S,
                              M, k, d, rows_per_block, 0,
                              static_cast<cudaStream_t>(stream));
}

// lloyd_reduce_launch with the accumulators of at most kg_cap >= 1 centres
// a block: the column walk's grouping, which k above what one block holds
// takes (k > 355 at d = 4,096), at shapes where the fused kernel runs too.
// Arguments as lloyd_reduce_launch's, kg_cap before the stream.
extern "C" int lloyd_reduce_grouped_launch(const float* P, const float* W,
                                           const float* MD, const int* A,
                                           float* partials, float* out, int S,
                                           int M, int k, int d,
                                           int rows_per_block, int kg_cap,
                                           void* stream) {
  if (bad_sizes(S, M, k, d, rows_per_block) || kg_cap < 1)
    return (int)cudaErrorInvalidValue;
  return launch_reduce<false>(P, nullptr, W, MD, A, nullptr, partials, out, S,
                              M, k, d, rows_per_block, kg_cap,
                              static_cast<cudaStream_t>(stream));
}

// points (S, M, d), centres (S, k, d), weights (S, M), assignment (S, M)
// int32, rows (2, S, M) of scratch for inv and sqrt(d2) (the row pass'),
// partials (S, ceil(M / rows_per_block), k d + k + 1), out (S, k d + k + 1)
// laid out as nums (k, d), denoms (k), cost; all contiguous. Returns the
// CUDA error of the launches, as lloyd_reduce_launch.
extern "C" int weiszfeld_reduce_launch(const float* P, const float* C,
                                       const float* W, const int* A,
                                       float* rows, float* partials,
                                       float* out, int S, int M, int k, int d,
                                       int rows_per_block, void* stream) {
  if (bad_sizes(S, M, k, d, rows_per_block))
    return (int)cudaErrorInvalidValue;
  return launch_reduce<true>(P, C, W, nullptr, A, rows, partials, out, S, M,
                             k, d, rows_per_block, 0,
                             static_cast<cudaStream_t>(stream));
}
