// The radix-2 Walsh-Hadamard butterfly on Hopper, shared by csrc/hadamard.cu
// (the plain transform) and csrc/rotated_encode.cu (signs, transform, 1/scale
// and per-row min/max).
//
// Bit-exactness.  The result must equal the butterfly of
// src/repro_torch/kernels/hadamard/ref.py (and of the reference's CPU path,
// which the golden wire bytes pin): stage s pairs the indices that differ in
// bit s, lowest bit first, the lower one gets lo + hi and the upper one
// lo - hi, each rounded once.  The TPU kernel's two Kronecker matmuls give
// other last bits and are not followed.  Every float operation is an _rn
// intrinsic, so nvcc cannot contract a multiply into an add, and the division
// by the scale is a true division (a reciprocal would move bits where the
// scale is not a power of two).
//
// Design.  A row of c = 2^m floats is cut into tiles of at most 2^13 floats
// (32 KB of shared memory per block, 256 threads).  A tile runs log_r
// consecutive stages s0 .. s0 + log_r - 1 over 2^log_r elements 2^s0 apart,
// for 2^log_tc adjacent columns at once.
//   m <= 13: one pass, one tile per row (s0 = 0, all stages).
//   m > 13:  pass A runs stages 0..12 on contiguous 2^13 segments; pass B
//            runs stages 13..m-1 on the strided columns, in tiles of
//            2^(13 - (m - 13)) >= 64 adjacent columns, so every global
//            access is a run of at least 256 contiguous bytes.  Pass A
//            before pass B is the stage order of the butterfly; the reverse
//            order would not be bit-exact.
// Loads and stores are coalesced; the stages run in shared memory with one
// barrier per stage.  Pass A of a short stage (h < 32) has two-way bank
// conflicts.
//
// Bound: bytes.  One pass reads and writes every float once (8 B a
// coordinate, 12 B with signs); two passes move them twice.  The m float adds
// per coordinate are far below the card's float32 rate.
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace fwht {

constexpr int kLogTile = 13;
constexpr int kTile = 1 << kLogTile;
constexpr int kThreads = 256;

// min / max that propagate NaN, as torch.amin / torch.amax do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// One pass over tiles of `rows` rows of length c.  kSigns multiplies
// `signs` in at the load; kScale divides by `scale` at the store and writes
// the tile's (min, max) of the stored values to partial[block].
template <bool kSigns, bool kScale>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const float* in, const float* __restrict__ signs, float* out,
            int64_t c, int s0, int log_r, int log_tc, int64_t tiles, float scale,
            float2* __restrict__ partial) {
  __shared__ float buf[kTile];
  __shared__ float red[2][kThreads / 32];
  const int64_t blk = blockIdx.x;
  const int64_t row = blk / tiles;
  const int64_t t = blk - row * tiles;
  const int tc = 1 << log_tc;
  const int size = 1 << (log_r + log_tc);
  const int64_t per_a = (int64_t(1) << s0) >> log_tc;   // tiles side by side
  const int64_t a = t / per_a;
  const int64_t l0 = (t - a * per_a) << log_tc;
  const int64_t base = row * c + (a << (s0 + log_r)) + l0;
  const int64_t stride = int64_t(1) << s0;

  for (int i = threadIdx.x; i < size; i += kThreads) {
    const int64_t g = base + (i >> log_tc) * stride + (i & (tc - 1));
    float v = in[g];
    if constexpr (kSigns) v = __fmul_rn(v, signs[g]);
    buf[i] = v;
  }
  __syncthreads();
  for (int s = 0; s < log_r; ++s) {
    const int h = 1 << s;
    for (int b = threadIdx.x; b < size / 2; b += kThreads) {
      const int q = b >> log_tc;
      const int r = ((q >> s) << (s + 1)) | (q & (h - 1));
      const int lo = (r << log_tc) | (b & (tc - 1));
      const int hi = lo + (h << log_tc);
      const float x = buf[lo];
      const float y = buf[hi];
      buf[lo] = __fadd_rn(x, y);
      buf[hi] = __fsub_rn(x, y);
    }
    __syncthreads();
  }
  float mn = INFINITY, mx = -INFINITY;
  for (int i = threadIdx.x; i < size; i += kThreads) {
    const int64_t g = base + (i >> log_tc) * stride + (i & (tc - 1));
    float v = buf[i];
    if constexpr (kScale) {
      v = __fdiv_rn(v, scale);
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
    }
    out[g] = v;
  }
  if constexpr (kScale) {
    for (int off = 16; off > 0; off >>= 1) {
      mn = nan_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
      mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = mn;
      red[1][warp] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w) {
        mn = nan_min(mn, red[0][w]);
        mx = nan_max(mx, red[1][w]);
      }
      partial[blk] = make_float2(mn, mx);
    }
  }
}

// mm[row] = (min, max) over the row's `tiles` partials.
__global__ void reduce_partials_kernel(const float2* __restrict__ partial,
                                       int64_t tiles, float2* __restrict__ mm) {
  __shared__ float red[2][kThreads / 32];
  const int64_t row = blockIdx.x;
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t i = threadIdx.x; i < tiles; i += kThreads) {
    const float2 p = partial[row * tiles + i];
    mn = nan_min(mn, p.x);
    mx = nan_max(mx, p.y);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mn = nan_min(mn, red[0][w]);
      mx = nan_max(mx, red[1][w]);
    }
    mm[row] = make_float2(mn, mx);
  }
}

inline int log2_exact(int64_t c) {
  int m = 0;
  while ((int64_t(1) << m) < c) ++m;
  return (int64_t(1) << m) == c ? m : -1;
}

// Tiles per row of the last pass (the count of (min, max) partials per row).
inline int64_t last_pass_tiles(int64_t c) {
  return c > kTile ? c / kTile : 1;
}

// The whole transform of (rows, c) `in` into `out` (out may equal in; the
// blocks of a pass touch disjoint elements and each reads its tile before it
// writes).  Either neither `signs` nor `mm` is given (the plain transform),
// or both (kernel 9): signs multiplied in first, the result divided by
// `scale`, and mm (rows, 2) gets each row's (min, max) through `partial`, a
// scratch of rows * last_pass_tiles(c) float2 (unused when that is 1).
inline int launch(const float* in, const float* signs, float* out, int64_t rows,
                  int64_t c, float scale, float2* partial, float2* mm,
                  cudaStream_t s) {
  const int m = log2_exact(c);
  if (m < 0 || m > 20 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool fused = mm != nullptr;
  if (m <= kLogTile) {
    const unsigned grid = static_cast<unsigned>(rows);
    if (signs && fused)
      pass_kernel<true, true><<<grid, kThreads, 0, s>>>(in, signs, out, c, 0, m, 0, 1, scale, mm);
    else if (!signs && !fused)
      pass_kernel<false, false><<<grid, kThreads, 0, s>>>(in, nullptr, out, c, 0, m, 0, 1, 1.0f, nullptr);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = c / kTile;
  const unsigned grid = static_cast<unsigned>(rows * tiles);
  const int log_b = m - kLogTile;
  if (signs)
    pass_kernel<true, false><<<grid, kThreads, 0, s>>>(in, signs, out, c, 0, kLogTile, 0, tiles, 1.0f, nullptr);
  else
    pass_kernel<false, false><<<grid, kThreads, 0, s>>>(in, nullptr, out, c, 0, kLogTile, 0, tiles, 1.0f, nullptr);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (fused) {
    pass_kernel<false, true><<<grid, kThreads, 0, s>>>(out, nullptr, out, c, kLogTile, log_b,
                                                       kLogTile - log_b, tiles, scale, partial);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    reduce_partials_kernel<<<static_cast<unsigned>(rows), kThreads, 0, s>>>(partial, tiles, mm);
  } else {
    pass_kernel<false, false><<<grid, kThreads, 0, s>>>(out, nullptr, out, c, kLogTile, log_b,
                                                        kLogTile - log_b, tiles, 1.0f, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwht
