// The core of the resident statistics kernels (lloyd_stats,
// weiszfeld_stats): per-centre sums over a site's points, with each point
// assigned to its nearest centre bit for bit as distance_argmin assigns it.
// distance_argmin's resident tile (distance_argmin.cu) runs steps 1-3 alone,
// with no accumulators (k = 0) and no per-row array of its own.
//
// Each block owns a fixed slice of rows_per_block rows of one site and
// writes one partial of k d + k + 1 floats (partials.cuh sums a site's
// partials in block order). Every operand of the inner loops comes from
// shared memory, and every row is read from device memory once:
// 1. Resident centres. Once per block the site's centres go to shared
//    memory, transposed (Ct[j][c], rows past k_pad at the sentinel up to
//    the 64-centre tile, so k_pad = 1 takes the same kernel), and their
//    norms are taken once from that copy.
// 2. One copy of each point tile. A 64-row tile is a contiguous span of
//    rows x d floats; copy_rows copies it once with 16-byte cp.async into a
//    stage shifted by the span's misalignment (scalar head and tail), so odd
//    d and odd storage offsets work. Everything the kernel computes for a
//    row reads this copy.
// 3. The assignment keeps tile_argmin's arithmetic (argmin_tile.cuh): 4
//    points x 4 centres per thread, 64 x 64 per block tile, in fp32 on the
//    CUDA cores (no TF32: it flips argmins near ties); p2, c2 and p.c as
//    fmaf chains over j = 0..d-1 from 0.f; (p2 + c2) - 2 p.c rounded as
//    written and clamped at 0 (NaN never wins); a strict `<` across centre
//    tiles and (value, index) order across lanes. So every assignment and
//    its min d2 equal distance_argmin's bit for bit. A thread's four centres
//    are adjacent (two 8-byte loads), and the centre copy's row stride is 2
//    more than a multiple of 32 floats, so reads of one centre down its
//    column are at most 2-way bank conflicts.
// 4. Column sums with every thread: the tile's rows are grouped stably by
//    assigned centre (a counting sort in shared memory); the threads split
//    into column groups, each owning a range of centres, and each entry
//    acc[a][j] is one thread's, which adds the rows of centre a in row
//    order, a running chain continued from tile to tile. Column d is the
//    per-centre total of the caller's per-row value. Rows assigned to a
//    padded centre (a >= k) add to no entry.
// The kernels differ only in the per-row value (and whatever they compute
// for it) and the cost's per-row term.
#pragma once

#include <atomic>

#include "argmin_tile.cuh"
#include "cp_async.cuh"
#include "partials.cuh"

namespace repro {

constexpr float kSentinel = 1.0e15f;   // ref.CENTER_SENTINEL
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 16;                // lanes across centres
constexpr int kTY = kThreads / kTX;    // lanes across points
constexpr int kTM = 4;                 // points per thread
constexpr int kTN = 4;                 // centres per thread (adjacent)
constexpr int kTileRows = kTY * kTM;   // lloyd_update.TILE_ROWS
constexpr int kCostThread = kThreads - 1;
static_assert(kTX * kTN == kCenterTile, "centre tile mismatch");

// Centres held per block: k_pad rounded up to the centre tile.
__host__ __device__ inline int resident_centers(int k_pad) {
  return (k_pad + kCenterTile - 1) / kCenterTile * kCenterTile;
}

// Floats of dynamic shared memory of one block, in the order of
// ResidentTile's layout; lloyd_update.shared_floats must count the same:
//   point stage 64 d (+ 4 for the misalignment shift), centres d (kc + 2),
//   their norms kc, accumulators k (d + 1), own + 5 per-row arrays of 64
//   (p2, the kernel's own, w, argmin, order and its centres) and k + 1
//   group starts.
__host__ __device__ inline long long shared_floats(int k, int kc, int d,
                                                   int own) {
  return (long long)kTileRows * d + 4 + (long long)d * (kc + 2) + kc +
         (long long)k * (d + 1) + (own + 5) * kTileRows + k + 1;
}

// One block's shared memory, carved in the order shared_floats counts;
// `Own` per-row float arrays belong to the kernel.
template <int Own>
struct ResidentTile {
  int kc;        // resident centres
  int ks;        // row stride of the transposed centres
  float* stage;  // [64 d + 4]
  float* Ct;     // [d][ks]
  float* c2s;    // [kc]
  float* acc;    // [k][d], then column d: [k]
  float* p2s;    // [64]
  float* own;    // [Own][64]
  float* ws;     // [64]
  int* args;     // [64]
  int* order;    // [64] rows by centre
  int* skey;     // [64] their centres
  int* group;    // [k + 1] group starts

  __device__ __forceinline__ ResidentTile(float4* smem, int k, int k_pad,
                                          int d)
      : kc(resident_centers(k_pad)), ks(kc + 2) {
    stage = reinterpret_cast<float*>(smem);
    Ct = stage + kTileRows * d + 4;
    c2s = Ct + d * ks;
    acc = c2s + kc;
    p2s = acc + k * (d + 1);
    own = p2s + kTileRows;
    ws = own + Own * kTileRows;
    args = reinterpret_cast<int*>(ws + kTileRows);
    order = args + kTileRows;
    skey = order + kTileRows;
    group = skey + kTileRows;
  }
};

// Start the cp.async copies of one tile's rows (rows x d floats from row0);
// returns the stage shift, the span's misalignment in floats.
__device__ __forceinline__ int copy_rows(float* stage,
                                         const float* __restrict__ P,
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
  return mis;
}

// copy_rows, and the tile's weights after them.
__device__ __forceinline__ int copy_tile(float* stage, float* ws,
                                         const float* __restrict__ P,
                                         const float* __restrict__ W,
                                         int row0, int rows, int d) {
  const int mis = copy_rows(stage, P, row0, rows, d);
  if (threadIdx.x < rows) cp_async4(ws + threadIdx.x, W + row0 + threadIdx.x);
  return mis;
}

// Every cp.async copy this thread started has landed.
__device__ __forceinline__ void wait_tile() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The site's centres (k_pad rows of d at Cb) into shared memory, transposed
// and padded to kc with the sentinel, the accumulators zeroed; after a
// barrier, the centres' norms from that copy.
template <int Own>
__device__ __forceinline__ void stage_centers(const ResidentTile<Own>& s,
                                              const float* __restrict__ Cb,
                                              int k, int k_pad, int d) {
  const int tid = threadIdx.x;
  for (int e = tid; e < s.kc * d; e += kThreads) {
    const int c = e / d, j = e - c * d;
    s.Ct[j * s.ks + c] = c < k_pad ? Cb[(size_t)c * d + j] : kSentinel;
  }
  for (int e = tid; e < k * (d + 1); e += kThreads) s.acc[e] = 0.f;
  __syncthreads();
  for (int c = tid; c < s.kc; c += kThreads) {
    float v = 0.f;
    for (int j = 0; j < d; ++j)
      v = fmaf(s.Ct[j * s.ks + c], s.Ct[j * s.ks + c], v);
    s.c2s[c] = v;
  }
}

// p2 of the tile's rows from the stage x (row r at x + r d); 0 past rows.
__device__ __forceinline__ void tile_norms(const float* x, float* p2s,
                                           int rows, int d) {
  const int tid = threadIdx.x;
  if (tid < kTileRows) {
    float v = 0.f;
    if (tid < rows) {
#pragma unroll 8
      for (int j = 0; j < d; ++j)
        v = fmaf(x[tid * d + j], x[tid * d + j], v);
    }
    p2s[tid] = v;
  }
}

// The assignment: 4 x 4 dot products per thread over each centre tile. On
// return every lane of point ty + i kTY holds its min d2 in best[i] and its
// argmin in arg[i]. The barrier inside orders tile_norms' p2 before its
// first use.
template <int Own>
__device__ __forceinline__ void assign_tile(const ResidentTile<Own>& s,
                                            const float* x, int d,
                                            float (&best)[kTM],
                                            int (&arg)[kTM]) {
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }
  for (int c0 = 0; c0 < s.kc; c0 += kCenterTile) {
    float dot[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) dot[i][n] = 0.f;
    const float* pr = x + ty * d;
    const float* cr = s.Ct + c0 + kTN * tx;
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = pr[i * kTY * d + j];
      const float2 lo = *reinterpret_cast<const float2*>(cr + j * s.ks);
      const float2 hi = *reinterpret_cast<const float2*>(cr + j * s.ks + 2);
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
      const float p2 = s.p2s[ty + i * kTY];
      float lb = INFINITY;
      int la = 0;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const int c = c0 + kTN * tx + n;  // ascending in n
        float v = __fsub_rn(__fadd_rn(p2, s.c2s[c]), __fmul_rn(2.f, dot[i][n]));
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
}

// The tile's rows grouped stably by assigned centre (rows at a padded
// centre last): order[group[a] .. group[a + 1]) are centre a's rows in
// order, and skey holds each sorted row's centre.
template <int Own>
__device__ __forceinline__ void sort_rows(const ResidentTile<Own>& s,
                                          int rows, int k) {
  const int tid = threadIdx.x;
  for (int r = tid; r < rows; r += kThreads) {
    const int a = min(s.args[r], k);
    int pos = 0;
#pragma unroll 8
    for (int q = 0; q < rows; ++q) {
      const int o = min(s.args[q], k);
      pos += o < a || (o == a && q < r);
    }
    s.order[pos] = r;
    s.skey[pos] = a;
  }
  for (int t = kThreads - 1 - tid; t <= k; t += kThreads) {
    int n = 0;
#pragma unroll 8
    for (int q = 0; q < rows; ++q) n += min(s.args[q], k) < t;
    s.group[t] = n;
  }
}

// The column sums of one tile, given each row's value v_r: thread (g, j)
// owns column j of the centres of range g and walks their rows in sorted
// order, keeping the running value in a register while the centre stays
// the same: acc[a][j] takes fmaf(v_r, x[r][j], .) for j < d and column d
// takes + v_r, the rows of centre a in row order, one chain from tile to
// tile.
template <int Own>
__device__ __forceinline__ void walk_columns(const ResidentTile<Own>& s,
                                             const float* x,
                                             const float* vals, int k,
                                             int d) {
  const int kd = k * d;
  // column groups: as many as fill the block
  const int ranges = max(1, kThreads / (d + 1));
  for (int q = threadIdx.x; q < ranges * (d + 1); q += kThreads) {
    const int g = q / (d + 1), j = q - g * (d + 1);
    const int base = j < d ? j : kd;  // entry of centre a: base + a step
    const int step = j < d ? d : 1;
    const int s1 = s.group[(g + 1) * k / ranges];
    int cur = -1;
    float v = 0.f;
#pragma unroll 4
    for (int e = s.group[g * k / ranges]; e < s1; ++e) {
      const int r = s.order[e], a = s.skey[e];
      if (a != cur) {
        if (cur >= 0) s.acc[base + cur * step] = v;
        cur = a;
        v = s.acc[base + a * step];
      }
      v = j < d ? fmaf(vals[r], x[r * d + j], v) : v + vals[r];
    }
    if (cur >= 0) s.acc[base + cur * step] = v;
  }
}

// The cost's chain over the tile's rows in row order: fmaf(w_r, t_r, .).
__device__ __forceinline__ float row_cost(const float* ws, const float* t,
                                          int rows, float cost) {
#pragma unroll 8
  for (int r = 0; r < rows; ++r) cost = fmaf(ws[r], t[r], cost);
  return cost;
}

// The block's partial: the accumulators, then the cost (kCostThread's).
template <int Own>
__device__ __forceinline__ void write_partial(const ResidentTile<Own>& s,
                                              float* __restrict__ partials,
                                              int k, int d, float cost) {
  const int E = k * d + k + 1;
  float* out = partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * E;
  for (int e = threadIdx.x; e < k * (d + 1); e += kThreads) out[e] = s.acc[e];
  if (threadIdx.x == kCostThread) out[E - 1] = cost;
}

using ResidentKernel = void (*)(const float*, const float*, const float*,
                                float*, int, int, int, int, int);

// The most dynamic shared memory a block may use on this device; Kernel's
// limit is raised to it at its first launch on each device.
template <auto Kernel>
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
             Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most)) !=
            cudaSuccess)
      return err;
    limit[dev].store(most, std::memory_order_relaxed);
  }
  *bytes = most;
  return cudaSuccess;
}

// Launch a resident statistics kernel with `Own` per-row arrays over S
// sites, then the block-order sum of its partials: points (S, M, d),
// centres (S, k_pad, d) with k_pad 1 or a multiple of 64 (rows past k at
// the sentinel), weights (S, M), partials (S, ceil(M / rows_per_block),
// k d + k + 1), out (S, k d + k + 1); all contiguous. Returns the CUDA
// error of the launches (0 on success; cudaErrorInvalidValue for shapes the
// kernel does not take, such as a block's shared memory above the device's
// limit).
template <ResidentKernel Kernel, int Own>
int launch_resident(const float* P, const float* C, const float* W,
                    float* partials, float* out, int S, int M, int k,
                    int k_pad, int d, int rows_per_block, void* stream) {
  if (k < 1 || k > k_pad || (k_pad > 1 && k_pad % kCenterTile != 0) ||
      d < 1 || M < 1 || rows_per_block < kTileRows ||
      rows_per_block % kTileRows != 0)
    return (int)cudaErrorInvalidValue;
  int most = 0;
  cudaError_t err = shared_limit<Kernel>(&most);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = (long long)sizeof(float) *
                          shared_floats(k, resident_centers(k_pad), d, Own);
  if (bytes > most) return (int)cudaErrorInvalidValue;
  const int G = (M + rows_per_block - 1) / rows_per_block;
  const int E = k * d + k + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Kernel<<<dim3(G, S), kThreads, (size_t)bytes, st>>>(
      P, C, W, partials, M, k, k_pad, d, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_partials_reduce(partials, out, S, G, E, st);
}

}  // namespace repro
