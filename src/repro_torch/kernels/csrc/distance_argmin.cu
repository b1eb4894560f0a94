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
// by operations. With one centre (D^2 seeding, k launches in a row) it reads
// 4 d bytes for 3 d flops and is bound by bytes: 0.234 ms for the 100 x
// 21,280 x 90 sites.
// Design, by shape (route() below; every entry reports the kernel it
// launched, which distance_argmin.ROUTES counts):
// * k_pad == 1: a kernel of its own streams the points once, coalesced,
//   through shared memory (distance_one_center_kernel).
// * k_pad > 1 and more than kNarrowRows rows per site where the block fits
//   shared memory: the resident tile (distance_argmin_resident_kernel), on
//   the core of the resident statistics kernels (resident_tile.cuh): the
//   site's centres and their norms stay in shared memory for the block's
//   life, and each 64-row point tile is copied once with cp.async and
//   assigned from that copy.
// * otherwise the general tile (distance_argmin_kernel, from
//   argmin_tile.cuh), which stages points and centres 32 features at a
//   time: larger k_pad x d, and sites of up to 8 rows (serving's smallest
//   bucket), where its 8-point shape does an eighth of the resident tile's
//   64-row work.
// Every route gives each (point, centre) pair the same chain of roundings
// and reduces with the same order (argmin_tile.cuh's note on tile shapes),
// so the output does not depend on the route. fp32 FMAs on the CUDA cores,
// not the tensor cores: TF32 would flip argmins, and exact-fp32 tensor-core
// emulation is later work. The (n, k) matrix is never written.
#include <limits.h>

#include <algorithm>
#include <atomic>

#include "resident_tile.cuh"

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

// The general tile: 8-point tiles for up to 32 rows per site (a small
// serving bucket fills its block), 64-point tiles above.
int launch_tile(const float* P, const float* C, float* out_min, int* out_arg,
                int S, int M, int k_pad, int d, cudaStream_t stream) {
  if (M <= 4 * NarrowTile::BN)
    return launch<NarrowTile>(distance_argmin_kernel<32, 1, 2>, P, C, out_min,
                              out_arg, S, M, k_pad, d, stream);
  return launch<WideTile>(distance_argmin_kernel<16, 4, 4>, P, C, out_min,
                          out_arg, S, M, k_pad, d, stream);
}

// ---- resident tile (k_pad > 1) ---------------------------------------------
//
// One block owns a fixed slice of rows_per_block rows of one site
// (blockIdx.y). Once per block it stages the site's centres with
// stage_centers (transposed, k_pad a multiple of the 64-centre tile, norms
// from the shared copy); then for each 64-row tile of its slice copy_rows
// copies the rows once with cp.async, tile_norms takes p2 from that copy and
// assign_tile runs the 4 x 4 assignment, and lane tx == 0 of each point
// writes its min d2 and argmin. No accumulators, no partials, no second
// launch: the layout is ResidentTile's with k = 0 and no per-row array of
// the kernel's own.
//
// Bit for bit the general tile's output (tile_argmin): for every pair, p2,
// c2 and p.c are fmaf chains over j = 0..d-1 from 0.f (the general tile's
// zero-padded features past d add fmaf(0, 0, acc) = acc), and d2 is
// (p2 + c2) - 2 p.c with the same explicit roundings, clamped at 0. Both
// reduce with a strict `<` within a lane and across centre tiles, and with
// (value, index) order across lanes, so both return the least d2 and, among
// equal values, the lowest index, whichever lane held which centre. A row
// whose every d2 is NaN (a NaN feature) or +inf keeps best = +inf at index
// 0 in both. The centres past k are sentinel rows of the caller's k_pad
// rows in both.
//
// Rows per block: the output has no sum across rows, so any slice gives the
// same per-row result, and the slice is chosen per launch to fill the card:
// as many blocks as fit at once share each site's tiles evenly, at least
// one block per site and at most one per tile (resident_rows). The launch
// is then one wave and each block pays its centre staging once.
//
// One point stage: the next tile's copy starts after this tile's
// assignment, and the SM's other blocks (four at k = 50, d = 90) hide its
// wait. A second stage, copying tile t + 1 while tile t is assigned, was
// measured slower on an H100 where the work is (PERF.md): it takes three
// blocks per SM instead of four.

// Floats of dynamic shared memory of one resident block: ResidentTile's
// layout with no accumulators and no per-row array of the kernel's own
// (distance_argmin.resident_fits counts the same).
__host__ __device__ inline long long argmin_floats(int k_pad, int d) {
  return shared_floats(0, resident_centers(k_pad), d, 0);
}

// Rows per block for S sites of M rows when `slots` blocks fit on the card
// at once.
inline int resident_rows(int S, int M, int slots) {
  const int tiles = (M + kTileRows - 1) / kTileRows;
  const int blocks = std::min(tiles, std::max(1, slots / S));
  return (tiles + blocks - 1) / blocks * kTileRows;
}

__global__ void __launch_bounds__(kThreads)
    distance_argmin_resident_kernel(const float* __restrict__ P,
                                    const float* __restrict__ C,
                                    float* __restrict__ out_min,
                                    int* __restrict__ out_arg, int M,
                                    int k_pad, int d, int rows_per_block) {
  extern __shared__ float4 smem4[];
  const ResidentTile<0> s(smem4, 0, k_pad, d);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int b = blockIdx.y;
  const int first = blockIdx.x * rows_per_block;
  const int stop = min(M, first + rows_per_block);
  const float* Pb = P + (size_t)b * M * d;
  float* mins = out_min + (size_t)b * M;
  int* args = out_arg + (size_t)b * M;

  int mis = copy_rows(s.stage, Pb, first, min(kTileRows, stop - first), d);
  stage_centers(s, C + (size_t)b * k_pad * d, 0, k_pad, d);

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
          mins[row0 + r] = best[i];
          args[row0 + r] = arg[i];
        }
      }
    }
    __syncthreads();  // the stage and p2s are free again
    if (row0 + kTileRows < stop)
      mis = copy_rows(s.stage, Pb, row0 + kTileRows,
                      min(kTileRows, stop - row0 - kTileRows), d);
  }
}

// Launch the resident kernel with a block of `bytes` of shared memory (its
// limit already raised by route()).
int launch_resident_argmin(const float* P, const float* C, float* out_min,
                           int* out_arg, int S, int M, int k_pad, int d,
                           int bytes, cudaStream_t stream) {
  // blocks that fit on the card at once for the last block size launched
  // on each device (serving repeats one size), as (bytes << 20) | slots
  constexpr int kMaxDevices = 64;
  static std::atomic<long long> fit[kMaxDevices];  // 0: none worked out
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  long long known = fit[dev].load(std::memory_order_relaxed);
  if (known >> 20 != bytes) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, distance_argmin_resident_kernel, kThreads, bytes)) !=
            cudaSuccess)
      return (int)err;
    known = (long long)bytes << 20 | sms * std::max(per_sm, 1);
    fit[dev].store(known, std::memory_order_relaxed);
  }
  const int rows = resident_rows(S, M, (int)(known & ((1 << 20) - 1)));
  distance_argmin_resident_kernel<<<dim3((M + rows - 1) / rows, S), kThreads,
                                    (size_t)bytes, stream>>>(
      P, C, out_min, out_arg, M, k_pad, d, rows);
  return (int)cudaGetLastError();
}

// ---- one centre per site (D^2 seeding) ------------------------------------
//
// With one centre the work is a stream: each point row is read once and
// meets d centre values. The (S, M, d) points are one contiguous run of
// S M rows (row r belongs to site r / M), so the kernel tiles that flat run
// and never leaves a ragged tail in every site. Persistent blocks (as many
// as fit on the card) walk the tiles; each tile's bytes go to shared memory
// once, coalesced, with cp.async, and one thread then walks one row in
// shared memory in feature order, loading kOneCenterUnroll features ahead
// of their chain, and keeps the chain of roundings of tile_argmin
// (argmin_tile.cuh) for the pair:
//   p2 = fmaf(p[j], p[j], .), c2 = fmaf(c[j], c[j], .), acc = fmaf(p[j],
//   c[j], .) over j = 0..d-1 from 0.f, then (p2 + c2) - 2 acc clamped at 0,
// so its output equals the general tile's with the centre padded to 64 rows
// bit for bit. A NaN distance gives +inf and index 0, as the strict `<` of
// tile_argmin does. The centre row is read from L1 (a few hundred bytes per
// site, the same address across a warp).
//
// Two layouts of a stage:
// * flat (any d, any alignment): the tile's span of rows x d floats is
//   copied as it lies, 16 bytes at a time with a scalar head and tail to
//   reach the 16-byte boundaries; the stage is offset by the span's
//   misalignment so both sides of every 16-byte copy are aligned. A span
//   longer than the stage goes through it in several steps, each thread
//   taking the part of its row that a step holds. Threads read at a stride
//   of d words: at most 2-way bank conflicts when d % 4 != 0.
// * rows (d % 4 == 0 and 16-byte-aligned points): each row goes to its own
//   slot of s floats, s / 4 odd, and threads read 16 bytes at a time, so
//   every quarter-warp touches 8 distinct 16-byte bank groups: power-of-two
//   d (32-way conflicts in the flat layout) costs no conflicts.
// Launch shape, measured on an H100 (PERF.md): the per-row chain, not the
// copy, is what needs hiding, so the most rows computing at once wins. One
// stage of 128 rows per block lets an SM hold four blocks (16 warps); their
// copies and chains overlap each other, so a block waits for its own copy
// before it computes. Rings of 2 or 3 stages per block hold fewer rows per
// SM and were slower.
constexpr int kOneCenterThreads = 128;  // rows per flat tile, one per thread
// floats per stage: a whole 128-row tile for d <= 96 (d = 90: 46 KB)
constexpr int kOneCenterChunk = kOneCenterThreads * 96;
constexpr int kOneCenterStageFloats = kOneCenterChunk + 4;  // + head offset
// features a thread loads before it runs their chain: the loads of a group
// are in flight together instead of one latency per feature
constexpr int kOneCenterUnroll = 16;
static_assert(kOneCenterUnroll % 4 == 0, "whole float4s per group");

// One feature of the chain, in tile_argmin's order and roundings.
__device__ __forceinline__ void one_center_step(float v, float w, float& p2,
                                                float& c2, float& acc) {
  p2 = fmaf(v, v, p2);
  c2 = fmaf(w, w, c2);
  acc = fmaf(v, w, acc);
}

// Which floats of a tile a stage holds: rows * d floats from the tile's
// first row, cut into chunks of kOneCenterChunk (flat layout; the rows
// layout holds a whole tile in one stage).
template <bool kRows>
__device__ __forceinline__ int chunks_of(int rows, int d) {
  return kRows ? 1 : (rows * d + kOneCenterChunk - 1) / kOneCenterChunk;
}

template <bool kRows>
__device__ __forceinline__ void copy_stage(float* stage,
                                           const float* __restrict__ P,
                                           long long r0, int rows, int chunk,
                                           int d, int stride) {
  const int tid = threadIdx.x;
  if (kRows) {
    const int dq = d >> 2;
    const float* src = P + r0 * d;
    for (int e = tid; e < rows * dq; e += kOneCenterThreads) {
      const int r = e / dq, q = e - r * dq;
      cp_async16(stage + r * stride + 4 * q, src + (size_t)r * d + 4 * q);
    }
    return;
  }
  const int c0 = chunk * kOneCenterChunk;
  const int len = min(rows * d - c0, kOneCenterChunk);
  const float* src = P + r0 * d + c0;
  float* dst = stage + misalignment(src);  // dst % 16 bytes == src % 16
  const int head = min(len, (4 - misalignment(src)) & 3);
  const int nvec = (len - head) >> 2;
  const int body = head + 4 * nvec;
  for (int i = tid; i < nvec; i += kOneCenterThreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  if (tid < head) cp_async4(dst + tid, src + tid);
  if (tid < len - body) cp_async4(dst + body + tid, src + body + tid);
}

template <bool kRows>
__global__ void __launch_bounds__(kOneCenterThreads)
    distance_one_center_kernel(const float* __restrict__ P,
                               const float* __restrict__ C,
                               float* __restrict__ out_min,
                               int* __restrict__ out_arg, long long R, int M,
                               int d, int stride, int tile_rows) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const long long tiles = (R + tile_rows - 1) / tile_rows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * tile_rows;
    const int rows = (int)min((long long)tile_rows, R - r0);
    const long long row = r0 + tid;
    const float* c = C + (tid < rows ? row / M : 0) * d;
    float p2 = 0.f, c2 = 0.f, acc = 0.f;
    const int nch = chunks_of<kRows>(rows, d);
    for (int ch = 0; ch < nch; ++ch) {
      copy_stage<kRows>(stage, P, r0, rows, ch, d, stride);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // every thread's copies into the stage have landed
      if (tid < rows) {
        if (kRows) {
          const float4* x =
              reinterpret_cast<const float4*>(stage + tid * stride);
          constexpr int U4 = kOneCenterUnroll / 4;
          const int dq = d >> 2;
          int q = 0;
          for (; q + U4 <= dq; q += U4) {
            float4 v[U4];
            float w[4 * U4];
#pragma unroll
            for (int u = 0; u < U4; ++u) v[u] = x[q + u];
#pragma unroll
            for (int u = 0; u < 4 * U4; ++u) w[u] = __ldg(c + 4 * q + u);
#pragma unroll
            for (int u = 0; u < U4; ++u) {
              one_center_step(v[u].x, w[4 * u], p2, c2, acc);
              one_center_step(v[u].y, w[4 * u + 1], p2, c2, acc);
              one_center_step(v[u].z, w[4 * u + 2], p2, c2, acc);
              one_center_step(v[u].w, w[4 * u + 3], p2, c2, acc);
            }
          }
          for (; q < dq; ++q) {
            const float4 v = x[q];
            one_center_step(v.x, __ldg(c + 4 * q), p2, c2, acc);
            one_center_step(v.y, __ldg(c + 4 * q + 1), p2, c2, acc);
            one_center_step(v.z, __ldg(c + 4 * q + 2), p2, c2, acc);
            one_center_step(v.w, __ldg(c + 4 * q + 3), p2, c2, acc);
          }
        } else {
          // this stage holds floats [c0, c1) of the tile; the row [a, a + d)
          const int c0 = ch * kOneCenterChunk;
          const int c1 = min(rows * d, c0 + kOneCenterChunk);
          const int a = tid * d;
          const int f0 = max(a, c0), f1 = min(a + d, c1);
          const float* x = stage + misalignment(P + r0 * d + c0) - c0;
          constexpr int U = kOneCenterUnroll;
          int f = f0;
          for (; f + U <= f1; f += U) {
            float v[U], w[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              v[u] = x[f + u];
              w[u] = __ldg(c + (f - a) + u);
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
              one_center_step(v[u], w[u], p2, c2, acc);
          }
          for (; f < f1; ++f)
            one_center_step(x[f], __ldg(c + (f - a)), p2, c2, acc);
        }
      }
      __syncthreads();  // the stage is read; the next step refills it
    }
    if (tid < rows) {
      float x = __fsub_rn(__fadd_rn(p2, c2), __fmul_rn(2.f, acc));
      x = x < 0.f ? 0.f : x;
      out_min[row] = x < INFINITY ? x : INFINITY;  // NaN -> +inf, index 0
      out_arg[row] = 0;
    }
  }
}

constexpr int kOneCenterSmem = (int)sizeof(float) * kOneCenterStageFloats;

// Persistent blocks: as many as fit on the card at once, at most one a tile.
// That number depends only on the device, so it is worked out (and the
// kernel's shared-memory limit raised) at the first launch on each device;
// D^2 seeding's serial launches then pay one cudaGetDevice each.
template <bool kRows>
cudaError_t one_center_grid(long long tiles, int* grid) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> resident[kMaxDevices];  // 0: not worked out yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = resident[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    auto kernel = distance_one_center_kernel<kRows>;
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kOneCenterSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kOneCenterThreads, kOneCenterSmem)) !=
            cudaSuccess)
      return err;
    blocks = sms * std::max(per_sm, 1);
    resident[dev].store(blocks, std::memory_order_relaxed);
  }
  *grid = (int)std::min(tiles, (long long)blocks);
  return cudaSuccess;
}

template <bool kRows>
int launch_one_center_as(const float* P, const float* C, float* out_min,
                         int* out_arg, long long R, int M, int d, int stride,
                         int tile_rows, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = one_center_grid<kRows>((R + tile_rows - 1) / tile_rows,
                                           &grid);
  if (err != cudaSuccess) return (int)err;
  distance_one_center_kernel<kRows>
      <<<grid, kOneCenterThreads, kOneCenterSmem, stream>>>(
          P, C, out_min, out_arg, R, M, d, stride, tile_rows);
  return (int)cudaGetLastError();
}

// points (S, M, d) and one centre per site (S, 1, d): the rows layout where
// the points allow it, else the flat one.
int launch_one_center(const float* P, const float* C, float* out_min,
                      int* out_arg, int S, int M, int d, cudaStream_t stream) {
  if ((long long)kOneCenterThreads * d > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long R = (long long)S * M;
  const int stride = (d >> 2) & 1 ? d : d + 4;  // stride / 4 odd
  if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0 &&
      stride <= kOneCenterChunk)
    return launch_one_center_as<true>(
        P, C, out_min, out_arg, R, M, d, stride,
        std::min(kOneCenterThreads, kOneCenterChunk / stride), stream);
  return launch_one_center_as<false>(P, C, out_min, out_arg, R, M, d, d,
                                     kOneCenterThreads, stream);
}

// Which kernel serves a launch; the codes are the order of
// distance_argmin.ROUTES.
enum Route { kOneCenter = 0, kResident = 1, kTile = 2 };

// Up to this many rows per site take the general tile (its 8-point shape)
// even where the resident block fits: at 8 rows the 8-point tile measured
// faster on an H100, at 16 and 32 rows the resident tile (PERF.md).
constexpr int kNarrowRows = NarrowTile::BN;

// The resident block's bytes of shared memory for k_pad centres of d
// features, and whether it fits the device (the kernel's limit raised).
cudaError_t resident_block(int k_pad, int d, bool* fits, int* bytes) {
  int most = 0;
  const cudaError_t err =
      shared_limit<distance_argmin_resident_kernel>(&most);
  if (err != cudaSuccess) return err;
  const long long need = (long long)sizeof(float) * argmin_floats(k_pad, d);
  *fits = need <= most;
  *bytes = (int)std::min(need, (long long)most);
  return cudaSuccess;
}

// The kernel for M rows per site and k_pad centres of d features, and the
// resident block's bytes of shared memory.
cudaError_t route(int M, int k_pad, int d, int* which, int* bytes) {
  if (k_pad == 1) {
    *which = kOneCenter;
    return cudaSuccess;
  }
  bool fits = false;
  const cudaError_t err = resident_block(k_pad, d, &fits, bytes);
  *which = fits && M > kNarrowRows ? kResident : kTile;
  return err;
}

// Both entries: points (S, M, d), centres (S, k_pad, d) with k_pad 1 or a
// multiple of 64, outputs (S, M); all contiguous. *served is the Route of
// the kernel launched.
int launch_routed(const float* P, const float* C, float* out_min,
                  int* out_arg, int S, int M, int k_pad, int d,
                  cudaStream_t stream, int* served) {
  if (S < 1 || M < 1 || d < 1 || k_pad < 1 ||
      (k_pad > 1 && k_pad % kCenterTile != 0))
    return (int)cudaErrorInvalidValue;
  int which = kTile, bytes = 0;
  const cudaError_t err = route(M, k_pad, d, &which, &bytes);
  if (err != cudaSuccess) return (int)err;
  *served = which;
  switch (which) {
    case kOneCenter:
      return launch_one_center(P, C, out_min, out_arg, S, M, d, stream);
    case kResident:
      return launch_resident_argmin(P, C, out_min, out_arg, S, M, k_pad, d,
                                    bytes, stream);
    default:
      return launch_tile(P, C, out_min, out_arg, S, M, k_pad, d, stream);
  }
}

}  // namespace

// points (S, M, d), centres (S, k_pad, d), outputs (S, M); all contiguous.
// Every entry returns the CUDA error of the launch (0 on success) and
// writes the Route of the kernel it launched to *served (a host int).
extern "C" int distance_argmin_launch(const float* P, const float* C,
                                      float* out_min, int* out_arg, int S,
                                      int M, int k_pad, int d, void* stream,
                                      int* served) {
  return launch_routed(P, C, out_min, out_arg, S, M, k_pad, d,
                       static_cast<cudaStream_t>(stream), served);
}

// The stacked-tenant entry (replaces the Pallas TPU kernel
// src/repro/kernels/distance_argmin.py:distance_argmin_batched, whose grid
// (T, m/bn, k/bk) led with the tenant axis): T tenants' queries (T, m, d)
// against their own centres (T, k_pad, d), tenant on blockIdx.y. Masked
// centre rows arrive at the sentinel. It takes the same route as
// distance_argmin_launch for the same shape, and no route's output depends
// on the route, the number of tenants or the rows per block, so a fused
// dispatch equals a loop of single-tenant launches bit for bit.
extern "C" int distance_argmin_batched_launch(const float* P, const float* C,
                                              float* out_min, int* out_arg,
                                              int T, int m, int k_pad, int d,
                                              void* stream, int* served) {
  return launch_routed(P, C, out_min, out_arg, T, m, k_pad, d,
                       static_cast<cudaStream_t>(stream), served);
}

// The general tile alone, whatever the shape (k_pad a multiple of 64), so
// the resident tile can be held against it bit for bit.
extern "C" int distance_argmin_tile_launch(const float* P, const float* C,
                                           float* out_min, int* out_arg,
                                           int S, int M, int k_pad, int d,
                                           void* stream, int* served) {
  if (S < 1 || M < 1 || d < 1 || k_pad < 1) return (int)cudaErrorInvalidValue;
  *served = kTile;
  return launch_tile(P, C, out_min, out_arg, S, M, k_pad, d,
                     static_cast<cudaStream_t>(stream));
}

// The resident tile alone at any row count (k_pad a multiple of 64 whose
// block fits shared memory, else cudaErrorInvalidValue), so it can be held
// against the general tile where the entries route to that.
extern "C" int distance_argmin_resident_launch(const float* P, const float* C,
                                               float* out_min, int* out_arg,
                                               int S, int M, int k_pad, int d,
                                               void* stream, int* served) {
  if (S < 1 || M < 1 || d < 1 || k_pad < 2 || k_pad % kCenterTile != 0)
    return (int)cudaErrorInvalidValue;
  bool fits = false;
  int bytes = 0;
  const cudaError_t err = resident_block(k_pad, d, &fits, &bytes);
  if (err != cudaSuccess) return (int)err;
  if (!fits) return (int)cudaErrorInvalidValue;
  *served = kResident;
  return launch_resident_argmin(P, C, out_min, out_arg, S, M, k_pad, d,
                                bytes, static_cast<cudaStream_t>(stream));
}
