// The radix-2 Walsh-Hadamard butterfly on Hopper, shared by csrc/hadamard.cu
// (the plain transform) and csrc/rotated_encode.cu (signs, transform, 1/scale
// and per-row min/max).
//
// Bit-exactness.  The result must equal the butterfly of
// src/repro_torch/kernels/hadamard/ref.py (and of the reference's CPU path,
// which the golden wire bytes pin): stage s pairs the indices that differ in
// bit s, lowest bit first, the lower one gets lo + hi and the upper one
// lo - hi, each rounded once.  How stages are grouped is free, their order
// is not.  Every float operation is an _rn intrinsic, so nvcc cannot
// contract a multiply into an add, and the division by the scale is a true
// division (a reciprocal would move bits where the scale is not a power of
// two).
//
// Design.  A row of c = 2^m floats is cut into tiles of 2^13 floats; 256
// threads hold 32 values of a tile each, in registers.
//   * Register radix.  A thread's 32 values differ in 5 bits of the tile
//     index (a "layout" names those 5 bits, the 5 lane bits and the 3 warp
//     bits), so the stages on those bits run in registers.  One exchange
//     through the tile's shared memory (32 stores, a barrier, 32 loads a
//     thread) brings the next bits into the registers.  The tile is XOR
//     swizzled (word e at e ^ swizzle(e)) so that every exchange's stores and
//     loads hit 32 different banks.  Loads and stores to global memory are
//     float4 (float2 for the last pass at m = 20) with neighbouring lanes on
//     neighbouring addresses.
//   * Passes.  m <= 13: one pass; a tile holds 2^(13-m) whole rows and runs
//     stages 0..m-1 (layouts LA0 -> LA1 -> LA2 -> LA0, each round's stages
//     in registers).  m > 13: pass A runs stages 0..12 on contiguous 2^13
//     segments (as above) and pass B runs stages 13..m-1 on tiles of
//     2^(13-nb) adjacent columns by 2^nb rows, nb = m - 13, each global
//     access a run of at least 256 contiguous bytes (layouts LB0 [-> LB1]).
//     Pass A before pass B is the stage order of the butterfly.
//   * L2-resident passes.  For m > 13 one persistent kernel runs both passes.
//     Work items are claimed by an atomic ticket in the order A(r), B(r - 2)
//     row by row (all tiles of A(r), then all of B(r - 2)); a B item waits
//     until its row's count of finished A tiles is complete (release by the
//     A tile, acquire by the B tile).  An item waits only on items claimed
//     before it, which are running, so there is no deadlock whatever the
//     residency.  A row's intermediate stays in L2 (4 MiB a row at m = 20)
//     between its passes: HBM sees x read once and the result written once.
//     Pass B and the spin read with .cg / acquire loads, never from L1.  The
//     ticket and the counters are a per-call scratch the caller zeroes on
//     the stream.
//
// In place (out == in) is allowed: the tiles of a pass are disjoint and each
// reads its tile whole before it writes it.
//
// Bound: bytes.  x read once and the result written once: 8 B a coordinate
// (12 B with signs).  Shared memory moves 24 B a coordinate in pass A and 8 B
// in pass B (m = 20), below its 128 B a clock per SM.
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace fwht {
// Internal linkage: a library built from another revision of this header may
// be loaded beside this one (launch/bench_wire.py), and the function-local
// statics of templates would otherwise be one object across both.
namespace {

constexpr int kLogTile = 13;
constexpr int kTile = 1 << kLogTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLag = 2;       // rows between a row's pass A and its pass B
// resident blocks an SM is built for: 80 registers a thread, or 128 for
// kernel 9's (signs, division and min / max spill at 80)
constexpr int min_blocks(bool rot) { return rot ? 2 : 3; }

using u64 = unsigned long long;

// min / max that propagate NaN, as torch.amin / torch.amax do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// ------------------------------------------------------------------ layouts

// A layout packs, 4 bits each, the tile-index bit of register bits 0..4
// (slots 0-4), lane bits 0..4 (slots 5-9) and warp bits 0..2 (slots 10-12).
__host__ __device__ constexpr u64 layout(int r0, int r1, int r2, int r3, int r4, int l0, int l1,
                                         int l2, int l3, int l4, int w0, int w1, int w2) {
  const int s[13] = {r0, r1, r2, r3, r4, l0, l1, l2, l3, l4, w0, w1, w2};
  u64 v = 0;
  for (int j = 0; j < 13; ++j) v |= u64(s[j]) << (4 * j);
  return v;
}

__host__ __device__ constexpr int slot(u64 L, int j) { return int((L >> (4 * j)) & 15); }

// tile-index bits of register k
__host__ __device__ constexpr int reg_e(u64 L, int k) {
  int e = 0;
  for (int j = 0; j < 5; ++j) e |= ((k >> j) & 1) << slot(L, j);
  return e;
}

// the register bit that holds tile-index bit b (-1 if none)
__host__ __device__ constexpr int reg_of(u64 L, int b) {
  for (int j = 0; j < 5; ++j)
    if (slot(L, j) == b) return j;
  return -1;
}

template <u64 L>
__device__ __forceinline__ int thread_e(int lane, int warp) {
  int e = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) e |= ((lane >> j) & 1) << slot(L, 5 + j);
#pragma unroll
  for (int j = 0; j < 3; ++j) e |= ((warp >> j) & 1) << slot(L, 10 + j);
  return e;
}

// A swizzle packs, 8 bits each, the bank bits that tile-index bits 5..12
// flip: word e of a tile lives at e ^ (XOR of the masks of e's set bits).
__host__ __device__ constexpr int swz(u64 S, int e) {
  int m = 0;
  for (int h = 5; h < 13; ++h)
    if ((e >> h) & 1) m ^= int((S >> (8 * (h - 5))) & 31);
  return e ^ m;
}

// bits 5..9 flip banks 0..4
constexpr u64 kSwzStd = 0x1ull | (0x2ull << 8) | (0x4ull << 16) | (0x8ull << 24) | (0x10ull << 32);
// bit 5 flips bank 0, bit 9 bank 1 (pass B at nb = 7)
constexpr u64 kSwzB7 = 0x1ull | (0x2ull << 32);

// Pass A and the single pass: stages on tile bits 0..12.
constexpr u64 kLA0 = layout(0, 1, 10, 11, 12, 2, 3, 4, 5, 6, 7, 8, 9);
constexpr u64 kLA1 = layout(2, 3, 4, 5, 6, 0, 1, 7, 8, 9, 10, 11, 12);
constexpr u64 kLA2 = layout(7, 8, 9, 10, 11, 0, 1, 2, 3, 4, 5, 6, 12);

// Pass B at nb = m - 13: tile bits 0..12-nb are columns, 13-nb..12 the
// stage bits S0..S(nb-1).  LB0 holds (columns 0, 1, S0, S1, S2), LB1 the rest.
__host__ __device__ constexpr u64 lb0(int nb) {
  return nb == 1   ? layout(0, 1, 12, 7, 8, 2, 3, 4, 5, 6, 9, 10, 11)
         : nb == 2 ? layout(0, 1, 11, 12, 7, 2, 3, 4, 5, 6, 8, 9, 10)
         : nb == 3 ? layout(0, 1, 10, 11, 12, 2, 3, 4, 5, 6, 7, 8, 9)
         : nb == 4 ? layout(0, 1, 9, 10, 11, 2, 3, 4, 5, 6, 7, 8, 12)
         : nb == 5 ? layout(0, 1, 8, 9, 10, 2, 3, 4, 5, 6, 7, 11, 12)
         : nb == 6 ? layout(0, 1, 7, 8, 9, 2, 3, 4, 5, 6, 10, 11, 12)
                   : layout(0, 1, 6, 7, 8, 2, 3, 4, 5, 9, 10, 11, 12);
}
__host__ __device__ constexpr u64 lb1(int nb) {
  return nb == 4   ? layout(0, 1, 12, 7, 8, 2, 3, 4, 5, 6, 9, 10, 11)
         : nb == 5 ? layout(0, 1, 11, 12, 7, 2, 3, 4, 5, 6, 8, 9, 10)
         : nb == 6 ? layout(0, 1, 10, 11, 12, 2, 3, 4, 5, 6, 7, 8, 9)
                   : layout(0, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 7, 8);
}

// ------------------------------------------------------------------ pieces

// The stages on tile bits B..HI-1, in that order, in registers.
template <u64 L, int B, int HI>
__device__ __forceinline__ void stages(float (&v)[32]) {
  if constexpr (B < HI) {
    constexpr int j = reg_of(L, B);
    static_assert(j >= 0, "stage bit not in registers");
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (!((k >> j) & 1)) {
        const float a = v[k];
        const float b = v[k | (1 << j)];
        v[k] = __fadd_rn(a, b);
        v[k | (1 << j)] = __fsub_rn(a, b);
      }
    }
    stages<L, B + 1, HI>(v);
  }
}

// Registers from layout F to layout T through the swizzled tile.
template <u64 F, u64 T, u64 S>
__device__ __forceinline__ void exchange(float (&v)[32], float* buf, int lane, int warp) {
  __syncthreads();  // the tile's previous readers are done
  const int pf = swz(S, thread_e<F>(lane, warp));
#pragma unroll
  for (int k = 0; k < 32; ++k) buf[pf ^ swz(S, reg_e(F, k))] = v[k];
  __syncthreads();
  const int pt = swz(S, thread_e<T>(lane, warp));
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = buf[pt ^ swz(S, reg_e(T, k))];
}

// Global offset of tile index e: pass A and the single pass map it to
// itself; pass B (kNB > 0) keeps the columns and moves the stage bits to
// bits 13.. of the row.
template <int kNB>
__host__ __device__ constexpr int64_t goff(int e) {
  if constexpr (kNB == 0) {
    return e;
  } else {
    constexpr int cb = kLogTile - kNB;
    return int64_t(e & ((1 << cb) - 1)) | (int64_t(e >> cb) << kLogTile);
  }
}

enum Load { kStream, kGlobal };   // ld.global.cs (read once) or .cg (not L1)

template <Load kLd>
__device__ __forceinline__ float4 ld4(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return kLd == kStream ? __ldcs(q) : __ldcg(q);
}

// Layout L's 32 values of the tile at `base` (register bits 0 and 1 are tile
// bits 0 and 1: one float4 per 4 registers); times signs if given.  kMasked:
// elements at or past n read as 0.
template <u64 L, int kNB, Load kLd, bool kSigns, bool kMasked>
__device__ __forceinline__ void load(float (&v)[32], const float* src, const float* signs,
                                     int64_t base, int64_t n, int lane, int warp) {
  static_assert(slot(L, 0) == 0 && slot(L, 1) == 1, "loads need tile bits 0, 1 in registers");
  const int64_t gt = base + goff<kNB>(thread_e<L>(lane, warp));
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const int64_t g = gt + goff<kNB>(reg_e(L, k));
    float4 a, s = make_float4(1.f, 1.f, 1.f, 1.f);
    if (!kMasked || g + 4 <= n) {
      a = ld4<kLd>(src + g);
      if constexpr (kSigns) s = ld4<kLd>(signs + g);
    } else {
      float t[4], u[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        t[i] = g + i < n ? src[g + i] : 0.0f;
        if constexpr (kSigns) u[i] = g + i < n ? signs[g + i] : 1.0f;
      }
      a = make_float4(t[0], t[1], t[2], t[3]);
      s = make_float4(u[0], u[1], u[2], u[3]);
    }
    if constexpr (kSigns) {
      a.x = __fmul_rn(a.x, s.x);
      a.y = __fmul_rn(a.y, s.y);
      a.z = __fmul_rn(a.z, s.z);
      a.w = __fmul_rn(a.w, s.w);
    }
    v[k] = a.x;
    v[k + 1] = a.y;
    v[k + 2] = a.z;
    v[k + 3] = a.w;
  }
}

// Block-wide (min, max) of each thread's (mn, mx), written by thread 0.
__device__ __forceinline__ void block_minmax(float mn, float mx, float2* dst, int lane, int warp) {
  __shared__ float red[2][kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  __syncthreads();  // red's previous readers are done
  if (lane == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mn = nan_min(mn, red[0][w]);
      mx = nan_max(mx, red[1][w]);
    }
    *dst = make_float2(mn, mx);
  }
}

// Layout L's 32 values to the tile at `base`: float4 stores where register
// bits 0 and 1 are tile bits 0 and 1, float2 where only bit 0 is.  kDiv:
// each value divided by `scale` first; kPart: the tile's (min, max) written
// to *part (a tile within one row).  kMasked: elements at or past n are not
// written.
template <u64 L, int kNB, bool kDiv, bool kPart, bool kMasked>
__device__ __forceinline__ void store(float (&v)[32], float* dst, int64_t base, int64_t n,
                                      float scale, float2* part, int lane, int warp) {
  static_assert(slot(L, 0) == 0, "stores need tile bit 0 in registers");
  static_assert(!(kPart && kMasked), "a masked tile holds several rows");
  float mn = INFINITY, mx = -INFINITY;
  if constexpr (kDiv) {
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = __fdiv_rn(v[k], scale);
  }
  if constexpr (kPart) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      mn = nan_min(mn, v[k]);
      mx = nan_max(mx, v[k]);
    }
  }
  const int64_t gt = base + goff<kNB>(thread_e<L>(lane, warp));
  if constexpr (slot(L, 1) == 1) {
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      const int64_t g = gt + goff<kNB>(reg_e(L, k));
      if (!kMasked || g + 4 <= n) {
        *reinterpret_cast<float4*>(dst + g) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (g + i < n) dst[g + i] = v[k + i];
      }
    }
  } else {
    static_assert(!kMasked, "float2 stores are never masked");
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int64_t g = gt + goff<kNB>(reg_e(L, k));
      *reinterpret_cast<float2*>(dst + g) = make_float2(v[k], v[k + 1]);
    }
  }
  if constexpr (kPart) block_minmax(mn, mx, part, lane, warp);
}

// Stages 0..kStages-1 (kStages <= 13) of the tile at `base` (pass A, or the
// single pass with 2^(13 - m) rows a tile).
template <int kStages, Load kLd, bool kSigns, bool kDiv, bool kPart, bool kMasked>
__device__ __forceinline__ void tile_a(const float* src, const float* signs, float* dst,
                                       int64_t base, int64_t n, float scale, float2* part,
                                       float* buf, int lane, int warp) {
  float v[32];
  load<kLA0, 0, kLd, kSigns, kMasked>(v, src, signs, base, n, lane, warp);
  stages<kLA0, 0, (kStages < 2 ? kStages : 2)>(v);
  if constexpr (kStages > 2) {
    exchange<kLA0, kLA1, kSwzStd>(v, buf, lane, warp);
    stages<kLA1, 2, (kStages < 7 ? kStages : 7)>(v);
    if constexpr (kStages > 7) {
      exchange<kLA1, kLA2, kSwzStd>(v, buf, lane, warp);
      stages<kLA2, 7, (kStages < 12 ? kStages : 12)>(v);
      exchange<kLA2, kLA0, kSwzStd>(v, buf, lane, warp);
      stages<kLA0, 12, kStages>(v);
    } else {
      exchange<kLA1, kLA0, kSwzStd>(v, buf, lane, warp);
    }
  }
  store<kLA0, 0, kDiv, kPart, kMasked>(v, dst, base, n, scale, part, lane, warp);
}

// Stages 13..13+kNB-1 of the pass-B tile at `base` (its first column).
template <int kNB, bool kScale>
__device__ __forceinline__ void tile_b(float* z, int64_t base, float scale, float2* part,
                                       float* buf, int lane, int warp) {
  constexpr int s0 = kLogTile - kNB;   // tile bit of stage 13
  constexpr u64 L0 = lb0(kNB);
  float v[32];
  load<L0, kNB, kGlobal, false, false>(v, z, nullptr, base, 0, lane, warp);
  stages<L0, s0, s0 + (kNB < 3 ? kNB : 3)>(v);
  if constexpr (kNB > 3) {
    constexpr u64 L1 = lb1(kNB);
    exchange<L0, L1, (kNB == 7 ? kSwzB7 : kSwzStd)>(v, buf, lane, warp);
    stages<L1, s0 + 3, kLogTile>(v);
    store<L1, kNB, kScale, kScale, false>(v, z, base, 0, scale, part, lane, warp);
  } else {
    store<L0, kNB, kScale, kScale, false>(v, z, base, 0, scale, part, lane, warp);
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// ------------------------------------------------------------------ kernels

// The transform of (rows, 2^M) `in` into `out`.  kRot: signs multiplied in
// at the first load, the result divided by `scale` at the last store, and
// each last-pass tile's (min, max) written to partial (M >= 13).
// sched (M > 13): the ticket, then one finished-A-tile count per row, zeroed.
template <int M, bool kRot>
__global__ void __launch_bounds__(kThreads, min_blocks(kRot))
fwht_kernel(const float* in, const float* signs, float* out, int64_t rows, float scale,
            float2* partial, int* sched) {
  __shared__ __align__(16) float buf[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (M <= kLogTile) {
    const int64_t n = rows << M;
    const int64_t tiles = (n + kTile - 1) / kTile;
    // at m = 13 a tile is a row and writes its (min, max); below, rows are
    // reduced from the stored values (row_minmax_kernel)
    constexpr bool kPart = kRot && M == kLogTile;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      if ((t + 1) * kTile <= n)
        tile_a<M, kStream, kRot, kRot, kPart, false>(in, signs, out, t * kTile, n, scale,
                                                     kPart ? partial + t : nullptr, buf, lane,
                                                     warp);
      else
        tile_a<M, kStream, kRot, kRot, false, true>(in, signs, out, t * kTile, n, scale,
                                                    nullptr, buf, lane, warp);
    }
  } else {
    constexpr int kNB = M - kLogTile;
    constexpr int kT = 1 << kNB;   // A tiles and B tiles per row
    __shared__ int item[2];
    const int64_t lag = rows < kLag ? rows : kLag;
    const int64_t total = 2 * rows * kT;
    int* done = sched + 1;
    for (int it = 0;; ++it) {
      if (threadIdx.x == 0) item[it & 1] = atomicAdd(sched, 1);
      __syncthreads();
      const int64_t q = item[it & 1];
      if (q >= total) break;
      // the order: A(0) .. A(lag-1), then A(s), B(s - lag) for s = lag ..
      // rows-1, then B(rows - lag) .. B(rows - 1)
      bool is_b;
      int64_t row, t;
      if (q < lag * kT) {
        is_b = false;
        row = q / kT;
        t = q % kT;
      } else if (q < (2 * rows - lag) * kT) {
        const int64_t r = q - lag * kT;
        const int64_t s = lag + r / (2 * kT);
        const int64_t w = r % (2 * kT);
        is_b = w >= kT;
        row = is_b ? s - lag : s;
        t = w % kT;
      } else {
        const int64_t r = q - (2 * rows - lag) * kT;
        is_b = true;
        row = rows - lag + r / kT;
        t = r % kT;
      }
      const int64_t rbase = row << M;
      if (!is_b) {
        tile_a<kLogTile, kStream, kRot, false, false, false>(in, signs, out, rbase + t * kTile,
                                                             0, 1.0f, nullptr, buf, lane, warp);
        __syncthreads();  // every store of the tile is made
        if (threadIdx.x == 0) {
          __threadfence();
          atomicAdd(done + row, 1);
        }
      } else {
        if (threadIdx.x == 0)
          while (ld_acquire(done + row) < kT) __nanosleep(100);
        __syncthreads();
        tile_b<kNB, kRot>(out, rbase + (t << (kLogTile - kNB)), scale,
                          kRot ? partial + row * kT + t : nullptr, buf, lane, warp);
      }
    }
  }
}

// mm[row] = (min, max) over `len` values of the row: float2 partials, or the
// row's own floats.  One warp a row.
template <typename T>
__global__ void row_minmax_kernel(const T* __restrict__ p, int64_t len, int64_t rows,
                                  float2* __restrict__ mm) {
  const int64_t row = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t i = lane; i < len; i += 32) {
    const T v = p[row * len + i];
    if constexpr (sizeof(T) == sizeof(float2)) {
      mn = nan_min(mn, v.x);
      mx = nan_max(mx, v.y);
    } else {
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) mm[row] = make_float2(mn, mx);
}

// ------------------------------------------------------------------ host

inline int log2_exact(int64_t c) {
  int m = 0;
  while ((int64_t(1) << m) < c) ++m;
  return (int64_t(1) << m) == c ? m : -1;
}

// Per-row (min, max) partials (float2) of kernel 9: one per last-pass tile.
inline int64_t partials_per_row(int64_t c) { return c >= kTile ? c / kTile : 0; }

// Scratch bytes of a call: kernel 9's partials, then (m > 13) the ticket and
// one counter per row.
inline int64_t scratch_bytes(int64_t rows, int64_t c, bool rot) {
  const int64_t part = rot ? rows * partials_per_row(c) * int64_t(sizeof(float2)) : 0;
  return part + (c > kTile ? (rows + 1) * int64_t(sizeof(int)) : 0);
}

template <int M, bool kRot>
int run(const float* in, const float* signs, float* out, int64_t rows, float scale,
        float2* partial, float2* mm, int* sched, cudaStream_t s) {
  auto kernel = fwht_kernel<M, kRot>;
  static int per_sm = [&] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t items;
  if constexpr (M <= kLogTile) {
    items = ((rows << M) + kTile - 1) / kTile;
  } else {
    items = 2 * rows * (int64_t(1) << (M - kLogTile));
    const cudaError_t err = cudaMemsetAsync(sched, 0, (rows + 1) * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t cap = int64_t(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(items < cap ? items : cap);
  kernel<<<grid, kThreads, 0, s>>>(in, signs, out, rows, scale, partial, sched);
  int err = static_cast<int>(cudaGetLastError());
  if (err || !kRot) return err;
  const unsigned mgrid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  if constexpr (M >= kLogTile)
    row_minmax_kernel<float2><<<mgrid, kThreads, 0, s>>>(partial, int64_t(1) << (M - kLogTile),
                                                         rows, mm);
  else
    row_minmax_kernel<float><<<mgrid, kThreads, 0, s>>>(out, int64_t(1) << M, rows, mm);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRot, int M = 0>
int dispatch(int m, const float* in, const float* signs, float* out, int64_t rows, float scale,
             float2* partial, float2* mm, int* sched, cudaStream_t s) {
  if constexpr (M > 20) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (m == M) return run<M, kRot>(in, signs, out, rows, scale, partial, mm, sched, s);
    return dispatch<kRot, M + 1>(m, in, signs, out, rows, scale, partial, mm, sched, s);
  }
}

// The whole transform of (rows, c) `in` into `out` (out may equal in), c a
// power of two <= 2^20.  kRot (kernel 9): signs multiplied in first, the
// result divided by `scale`, and mm (rows, 2) gets each row's (min, max).
// scratch: scratch_bytes(rows, c, kRot) bytes, 8-byte aligned; in, signs and
// out 16-byte aligned.
template <bool kRot>
int launch(const float* in, const float* signs, float* out, int64_t rows, int64_t c,
           float scale, float2* mm, void* scratch, cudaStream_t s) {
  const int m = log2_exact(c);
  if (m < 0 || m > 20 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kRot != (signs != nullptr && mm != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(signs)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  float2* partial = static_cast<float2*>(scratch);
  int* sched = reinterpret_cast<int*>(static_cast<char*>(scratch) +
                                      (kRot ? rows * partials_per_row(c) * sizeof(float2) : 0));
  return dispatch<kRot>(m, in, signs, out, rows, scale, partial, mm, sched, s);
}

}  // namespace
}  // namespace fwht
