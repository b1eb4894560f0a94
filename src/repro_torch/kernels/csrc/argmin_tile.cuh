// The assignment step of the general distance_argmin tiles: for one tile of
// points, the min squared distance and its argmin over every centre.
//
// d2 = |p|^2 + |c|^2 - 2 p.c, clamped at 0, in full fp32 on the CUDA cores
// (no TF32: it flips argmins near ties). A block of kThreads threads holds
// a BN x BK block of dot products in registers (TM points x TN centres per
// thread); points and centres are staged through shared memory kDepth
// features at a time, so any d works without padding. The running min
// moves across centre tiles with a strict `<` and the lanes of one point
// merge with (value, index) order, so the lowest index wins ties, as
// jnp.argmin does. The (n, k) matrix never leaves registers.
//
// distance_argmin assigns through tile_argmin, and lloyd_stats and
// weiszfeld_stats keep its arithmetic with both operands resident in shared
// memory (resident_tile.cuh), so all three assign every point
// bit-identically (see the note on tile shapes below).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kDepth = 32;        // features staged per step
constexpr int kCenterTile = 64;   // BK of the general tile; Python's
                                  // ops.CENTER_TILE must equal it

template <int TX, int TM, int TN>
struct Tile {
  static constexpr int TY = kThreads / TX;   // lanes across points
  static constexpr int BN = TY * TM;         // points per tile
  static constexpr int BK = TX * TN;         // centres per tile
  // +1 column: the transposed stores hit 32 distinct banks
  static constexpr int kPStride = BN + 1;
  static constexpr int kCStride = BK + 1;
  static constexpr int kSmemFloats =
      kDepth * kPStride + kDepth * kCStride + BN + BK;
};

// General tile: 16 lanes across centres, 64 points x 64 centres.
using WideTile = Tile<16, 4, 4>;
// Small query buckets (serving): a warp across centres, 8 points x 64
// centres, so an 8-row tenant fills its block.
using NarrowTile = Tile<32, 1, 2>;
// distance_argmin's one-centre path (D^2 seeding) does not come here:
// distance_one_center_kernel (distance_argmin.cu) copies the points once
// with cp.async and keeps the same chain of roundings per pair.
static_assert(WideTile::BK == kCenterTile, "centre tile mismatch");
static_assert(NarrowTile::BK == kCenterTile, "centre tile mismatch");
// Every tile shape gives the same result for a point: each (point, centre)
// distance is the same chain of roundings whatever the shape -- p2, c2 and
// p.c as fmaf chains over j = 0..d-1 from 0.f, then (p2 + c2) - 2 p.c,
// clamped at 0 -- and the reduction returns the least value and, among
// equal values, the lowest index, in any order of comparison.

// `P` points at the tile's first row (row-major, `d` features), `rows` of
// its BN rows are real; `C` holds k_pad centres (k_pad % BK == 0; padded
// rows carry the CENTER_SENTINEL coordinate and never win). On return every
// lane of a point holds that point's min and argmin in best/arg.
template <int TX, int TM, int TN>
__device__ __forceinline__ void tile_argmin(
    const float* __restrict__ P, const float* __restrict__ C, int rows,
    int k_pad, int d, float* smem, float (&best)[TM], int (&arg)[TM]) {
  using T = Tile<TX, TM, TN>;
  float* Ps = smem;                           // [kDepth][kPStride]
  float* Cs = Ps + kDepth * T::kPStride;      // [kDepth][kCStride]
  float* p2s = Cs + kDepth * T::kCStride;     // [BN]
  float* c2s = p2s + T::BN;                   // [BK]
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  __syncthreads();  // earlier users of this shared memory are done
  for (int r = tid; r < T::BN; r += kThreads) {
    float s = 0.f;
    if (r < rows) {
      const float* p = P + (size_t)r * d;
      for (int j = 0; j < d; ++j) s = fmaf(p[j], p[j], s);
    }
    p2s[r] = s;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }

  for (int c0 = 0; c0 < k_pad; c0 += T::BK) {
    __syncthreads();  // the previous tile's epilogue has read c2s
    for (int c = tid; c < T::BK; c += kThreads) {
      const float* cp = C + (size_t)(c0 + c) * d;
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(cp[j], cp[j], s);
      c2s[c] = s;
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kDepth) {
      __syncthreads();  // the previous chunk has been consumed
      for (int e = tid; e < T::BN * kDepth; e += kThreads) {
        const int r = e / kDepth, j = e % kDepth;
        float v = 0.f;
        if (r < rows && d0 + j < d) v = P[(size_t)r * d + d0 + j];
        Ps[j * T::kPStride + r] = v;
      }
      for (int e = tid; e < T::BK * kDepth; e += kThreads) {
        const int c = e / kDepth, j = e % kDepth;
        float v = 0.f;
        if (d0 + j < d) v = C[(size_t)(c0 + c) * d + d0 + j];
        Cs[j * T::kCStride + c] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < kDepth; ++j) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Ps[j * T::kPStride + ty + i * T::TY];
#pragma unroll
        for (int n = 0; n < TN; ++n) b[n] = Cs[j * T::kCStride + tx + n * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(a[i], b[n], acc[i][n]);
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float p2 = p2s[ty + i * T::TY];
      float lb = INFINITY;
      int la = 0;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int c = tx + n * TX;  // ascending in n for a fixed lane
        // explicit roundings: (p2 + c2) - 2 p.c, as the plain version
        float x = __fsub_rn(__fadd_rn(p2, c2s[c]), __fmul_rn(2.f, acc[i][n]));
        x = x < 0.f ? 0.f : x;  // NaN stays NaN and never wins
        if (x < lb) {
          lb = x;
          la = c0 + c;
        }
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) {
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

}  // namespace repro
