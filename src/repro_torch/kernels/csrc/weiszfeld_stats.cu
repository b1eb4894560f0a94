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
// once and every operand of the inner loop comes from shared memory:
// 1. Resident centres. Once per block the site's centres go to shared
//    memory, transposed (Ct[j][c], rows past k_pad at the sentinel up to
//    the 64-centre tile, so k_pad = 1 takes this kernel too), and their
//    norms are taken once from that copy.
// 2. One copy of each point tile. A 64-row tile is a contiguous span of
//    rows x d floats; it is copied once with 16-byte cp.async into a stage
//    shifted by the span's misalignment (scalar head and tail), so odd d
//    and odd storage offsets work. The norms, the dot products, the exact
//    distance and the numerators all read this copy.
// 3. The assignment keeps tile_argmin's arithmetic (argmin_tile.cuh): 4
//    points x 4 centres per thread, 64 x 64 per block tile, in fp32 on the
//    CUDA cores (no TF32: it flips argmins near ties); p2, c2 and p.c as
//    fmaf chains over j = 0..d-1 from 0.f; (p2 + c2) - 2 p.c rounded as
//    written and clamped at 0 (NaN never wins); a strict `<` across centre
//    tiles and (value, index) order across lanes. So every assignment
//    equals distance_argmin's bit for bit. A thread's four centres are
//    adjacent (two 8-byte loads), and the centre copy's row stride is 2
//    more than a multiple of 32 floats, so the exact-distance reads of one
//    centre are at most 2-way bank conflicts.
// 4. The exact distance, one warp per row, lanes over features and a
//    fixed xor butterfly, from the two resident copies: a centre that is a
//    data point gives d2 = 0 exactly, never |p|^2 + |c|^2 - 2 p.c, whose
//    cancellation 1/sqrt would amplify near zero. A row assigned to a
//    padded centre (a >= k) adds nothing.
// 5. Numerators with every thread: the tile's rows are grouped stably by
//    assigned centre (a counting sort in shared memory); the threads split
//    into column groups, each owning a range of centres, and each entry
//    nums[a][j] is one thread's, which adds the rows of centre a in row
//    order, a running fmaf chain continued from tile to tile. The
//    denominators are one more column; the cost is one row-order chain.
// One stage per block: at k = 50, d = 90 a block holds 67,268 bytes of
// shared memory, so three blocks share an SM and overlap each other's
// copies and computations; a second stage (the next tile's copy during this
// tile's work) leaves room for two blocks, and was slower on an H100.
#include <atomic>

#include "argmin_tile.cuh"
#include "cp_async.cuh"
#include "partials.cuh"

namespace {

using namespace repro;

constexpr float kEta2 = 1e-6f;         // ref.WEISZFELD_ETA2
constexpr float kSentinel = 1.0e15f;   // ref.CENTER_SENTINEL
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 16;                // lanes across centres
constexpr int kTY = kThreads / kTX;    // lanes across points
constexpr int kTM = 4;                 // points per thread
constexpr int kTN = 4;                 // centres per thread (adjacent)
constexpr int kTileRows = kTY * kTM;   // weiszfeld.TILE_ROWS
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kCostThread = kThreads - 1;
static_assert(kTX * kTN == kCenterTile, "centre tile mismatch");

// Centres held per block: k_pad rounded up to the centre tile.
__host__ __device__ inline int resident_centers(int k_pad) {
  return (k_pad + kCenterTile - 1) / kCenterTile * kCenterTile;
}

// Floats of dynamic shared memory of one block, in the order of the
// kernel's layout; weiszfeld.shared_floats must count the same:
//   point stage 64 d (+ 4 for the misalignment shift), centres d (kc + 2),
//   their norms kc, nums k d and denoms k, seven per-row arrays of 64 (p2,
//   inv, sqrt(d2), w, argmin, order and its centres) and k + 1 group
//   starts.
__host__ __device__ inline long long shared_floats(int k, int kc, int d) {
  return (long long)kTileRows * d + 4 + (long long)d * (kc + 2) + kc +
         (long long)k * (d + 1) + 7 * kTileRows + k + 1;
}

// Start the cp.async copies of one tile (rows x d floats from row0, and its
// weights); returns the stage shift, the span's misalignment in floats.
__device__ __forceinline__ int copy_tile(float* stage, float* ws,
                                         const float* __restrict__ P,
                                         const float* __restrict__ W,
                                         int row0, int rows, int d) {
  const int tid = threadIdx.x;
  const float* src = P + (size_t)row0 * d;
  const int len = rows * d;
  const int mis = misalignment(src);
  float* dst = stage + mis;  // dst % 16 bytes == src % 16 bytes
  const int head = min(len, (4 - mis) & 3);
  const int nvec = (len - head) >> 2;
  const int body = head + 4 * nvec;
  for (int i = tid; i < nvec; i += kThreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  if (tid < head) cp_async4(dst + tid, src + tid);
  if (tid < len - body) cp_async4(dst + body + tid, src + body + tid);
  if (tid < rows) cp_async4(ws + tid, W + row0 + tid);
  return mis;
}

__global__ void __launch_bounds__(kThreads)
    weiszfeld_stats_kernel(const float* __restrict__ P,
                           const float* __restrict__ C,
                           const float* __restrict__ W,
                           float* __restrict__ partials, int M, int k,
                           int k_pad, int d, int rows_per_block) {
  extern __shared__ float4 smem4[];
  const int kc = resident_centers(k_pad);
  const int ks = kc + 2;  // row stride of the transposed centres
  float* stage = reinterpret_cast<float*>(smem4);  // [64 d + 4]
  float* Ct = stage + kTileRows * d + 4;           // [d][ks]
  float* c2s = Ct + d * ks;                        // [kc]
  float* acc = c2s + kc;                           // nums [k][d], denoms [k]
  float* p2s = acc + k * (d + 1);                  // [64]
  float* invs = p2s + kTileRows;                   // [64] inv(p)
  float* roots = invs + kTileRows;                 // [64] sqrt(d2(p))
  float* ws = roots + kTileRows;                   // [64]
  int* args = reinterpret_cast<int*>(ws + kTileRows);  // [64]
  int* order = args + kTileRows;                   // [64] rows by centre
  int* skey = order + kTileRows;                   // [64] their centres
  int* group = skey + kTileRows;                   // [k + 1] group starts
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

  int mis = copy_tile(stage, ws, Pb, Wb, first,
                      min(kTileRows, stop - first), d);
  for (int e = tid; e < kc * d; e += kThreads) {
    const int c = e / d, j = e - c * d;
    Ct[j * ks + c] = c < k_pad ? Cb[(size_t)c * d + j] : kSentinel;
  }
  for (int e = tid; e < k * (d + 1); e += kThreads) acc[e] = 0.f;
  __syncthreads();
  for (int c = tid; c < kc; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(Ct[j * ks + c], Ct[j * ks + c], s);
    c2s[c] = s;
  }
  float cost = 0.f;
  const int kd = k * d;
  // column groups of the numerator pass: as many as fill the block
  const int ranges = max(1, kThreads / (d + 1));

  for (int row0 = first; row0 < stop; row0 += kTileRows) {
    const int rows = min(kTileRows, stop - row0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // every thread's copies of this tile have landed
    const float* x = stage + mis;  // row r at x + r d
    if (tid < kTileRows) {
      float s = 0.f;
      if (tid < rows) {
#pragma unroll 8
        for (int j = 0; j < d; ++j)
          s = fmaf(x[tid * d + j], x[tid * d + j], s);
      }
      p2s[tid] = s;
    }

    // the assignment: 4 x 4 dot products per thread over each centre tile
    float best[kTM];
    int arg[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      best[i] = INFINITY;
      arg[i] = 0;
    }
    for (int c0 = 0; c0 < kc; c0 += kCenterTile) {
      float dot[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int n = 0; n < kTN; ++n) dot[i][n] = 0.f;
      const float* pr = x + ty * d;
      const float* cr = Ct + c0 + kTN * tx;
#pragma unroll 4
      for (int j = 0; j < d; ++j) {
        float a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = pr[i * kTY * d + j];
        const float2 lo = *reinterpret_cast<const float2*>(cr + j * ks);
        const float2 hi = *reinterpret_cast<const float2*>(cr + j * ks + 2);
        const float bv[kTN] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int n = 0; n < kTN; ++n)
            dot[i][n] = fmaf(a[i], bv[n], dot[i][n]);
      }
      __syncthreads();  // p2s of this tile are written
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float p2 = p2s[ty + i * kTY];
        float lb = INFINITY;
        int la = 0;
#pragma unroll
        for (int n = 0; n < kTN; ++n) {
          const int c = c0 + kTN * tx + n;  // ascending in n
          float v = __fsub_rn(__fadd_rn(p2, c2s[c]), __fmul_rn(2.f, dot[i][n]));
          v = v < 0.f ? 0.f : v;  // NaN stays NaN and never wins
          if (v < lb) {
            lb = v;
            la = c;
          }
        }
#pragma unroll
        for (int off = kTX / 2; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, lb, off);
          const int oa = __shfl_xor_sync(0xffffffffu, la, off);
          if (ob < lb || (ob == lb && oa < la)) {
            lb = ob;
            la = oa;
          }
        }
        if (lb < best[i]) {  // strict: an earlier tile keeps a tie
          best[i] = lb;
          arg[i] = la;
        }
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        if (ty + i * kTY < rows) args[ty + i * kTY] = arg[i];
    }
    __syncthreads();

    // exact-form distance to the assigned centre: one warp per row, lanes
    // across features, a fixed butterfly sum (every lane ends with the same
    // value). A warp takes its eight rows at once, and lane u finishes row
    // warp + 8 u.
    {
      float s[kRowsPerWarp];
      int as[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int r = warp + kWarps * u;
        as[u] = r < rows ? args[r] : k;
        s[u] = 0.f;
      }
      for (int j = lane; j < d; j += 32) {
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u) {
          if (as[u] < k) {
            const float v = x[(warp + kWarps * u) * d + j] - Ct[j * ks + as[u]];
            s[u] = fmaf(v, v, s[u]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float mine = 0.f;
      int ma = k;
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        if (lane == u) {
          mine = s[u];
          ma = as[u];
        }
      }
      const int r = warp + kWarps * lane;
      if (lane < kRowsPerWarp && r < rows) {
        invs[r] = ma < k ? fmaxf(ws[r], 0.f) / sqrtf(mine + kEta2) : 0.f;
        roots[r] = ma < k ? sqrtf(mine) : 0.f;
      }
    }
    // the rows grouped stably by assigned centre (rows at a padded centre
    // last): order[group[a] .. group[a + 1]) are centre a's rows in order,
    // and skey holds each sorted row's centre
    for (int r = tid; r < rows; r += kThreads) {
      const int a = min(args[r], k);
      int pos = 0;
#pragma unroll 8
      for (int q = 0; q < rows; ++q) {
        const int o = min(args[q], k);
        pos += o < a || (o == a && q < r);
      }
      order[pos] = r;
      skey[pos] = a;
    }
    for (int t = kThreads - 1 - tid; t <= k; t += kThreads) {
      int n = 0;
#pragma unroll 8
      for (int q = 0; q < rows; ++q) n += min(args[q], k) < t;
      group[t] = n;
    }
    __syncthreads();

    // numerators and denominators: thread (g, j) owns column j (column d
    // is the denominators) of the centres of range g, and walks their
    // rows in sorted order, keeping the running value in a register while
    // the centre stays the same; so each entry takes its centre's rows in
    // row order, one chain from tile to tile
    for (int q = tid; q < ranges * (d + 1); q += kThreads) {
      const int g = q / (d + 1), j = q - g * (d + 1);
      const int base = j < d ? j : kd;  // entry of centre a: base + a step
      const int step = j < d ? d : 1;
      const int s1 = group[(g + 1) * k / ranges];
      int cur = -1;
      float v = 0.f;
#pragma unroll 4
      for (int s = group[g * k / ranges]; s < s1; ++s) {
        const int r = order[s], a = skey[s];
        if (a != cur) {
          if (cur >= 0) acc[base + cur * step] = v;
          cur = a;
          v = acc[base + a * step];
        }
        v = j < d ? fmaf(invs[r], x[r * d + j], v) : v + invs[r];
      }
      if (cur >= 0) acc[base + cur * step] = v;
    }
    if (tid == kCostThread) {
#pragma unroll 8
      for (int r = 0; r < rows; ++r) cost = fmaf(ws[r], roots[r], cost);
    }
    __syncthreads();  // the stage and the per-row arrays are free again
    if (row0 + kTileRows < stop)
      mis = copy_tile(stage, ws, Pb, Wb, row0 + kTileRows,
                      min(kTileRows, stop - row0 - kTileRows), d);
  }

  const int E = kd + k + 1;
  float* out = partials + ((size_t)b * gridDim.x + blockIdx.x) * E;
  for (int e = tid; e < k * (d + 1); e += kThreads) out[e] = acc[e];
  if (tid == kCostThread) out[E - 1] = cost;
}

// The most dynamic shared memory a block may use on this device; the
// kernel's limit is raised to it at the first launch on each device.
cudaError_t shared_limit(int* bytes) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> limit[kMaxDevices];  // 0: not worked out yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int most = limit[dev].load(std::memory_order_relaxed);
  if (most == 0) {
    if ((err = cudaDeviceGetAttribute(
             &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             weiszfeld_stats_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize, most)) !=
            cudaSuccess)
      return err;
    limit[dev].store(most, std::memory_order_relaxed);
  }
  *bytes = most;
  return cudaSuccess;
}

}  // namespace

// points (S, M, d), centres (S, k_pad, d) with k_pad 1 or a multiple of 64
// (rows past k at the sentinel), weights (S, M), partials
// (S, ceil(M / rows_per_block), k d + k + 1), out (S, k d + k + 1) laid out
// as nums (k, d), denoms (k), cost; all contiguous. Returns the CUDA error
// of the launches (0 on success; cudaErrorInvalidValue for shapes the
// kernel does not take, such as a block's shared memory above the
// device's limit).
extern "C" int weiszfeld_stats_launch(const float* P, const float* C,
                                      const float* W, float* partials,
                                      float* out, int S, int M, int k,
                                      int k_pad, int d, int rows_per_block,
                                      void* stream) {
  if (k < 1 || k > k_pad || (k_pad > 1 && k_pad % kCenterTile != 0) ||
      d < 1 || M < 1 || rows_per_block < kTileRows ||
      rows_per_block % kTileRows != 0)
    return (int)cudaErrorInvalidValue;
  int most = 0;
  cudaError_t err = shared_limit(&most);
  if (err != cudaSuccess) return (int)err;
  const long long bytes =
      (long long)sizeof(float) * shared_floats(k, resident_centers(k_pad), d);
  if (bytes > most) return (int)cudaErrorInvalidValue;
  const int G = (M + rows_per_block - 1) / rows_per_block;
  const int E = k * d + k + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  weiszfeld_stats_kernel<<<dim3(G, S), kThreads, (size_t)bytes, st>>>(
      P, C, W, partials, M, k, k_pad, d, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_partials_reduce(partials, out, S, G, E, st);
}
