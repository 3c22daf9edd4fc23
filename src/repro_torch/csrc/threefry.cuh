// Threefry-2x32 as a CUDA device function: the stream of
// repro.kernels.threefry.ref (threefry2x32 :38, counter_words :60,
// bits_to_uniform :87), which every Pallas wire kernel of the JAX package
// inlines.  Bit-exact with JAX's non-partitionable Threefry layout: for a
// (d,) draw the counter arange(d) is zero-padded to 2*ceil(d/2) and split in
// halves, lane j < half takes cipher word x0 of the pair (j, half + j) and
// lane j >= half takes x1 of (j - half, j).
//
// Cost: 2 key adds, 20 rounds of (add, rotate, xor) and 5 key injections of
// one add on x0 and one 3-input add on x1: 2 + 20*3 + 5*2 = 72 integer
// operations per cipher call with the rotate as one funnel shift, plus a few
// for the counter words and the mantissa fill.  The kernels that call it are
// bound by the 32-bit integer issue rate.
#pragma once
#include <cmath>
#include <cstdint>

namespace threefry {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)        \
  x0 += x1;                \
  x1 = rotl(x1, r);        \
  x1 ^= x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
}

#undef TF_ROUND

// The 32 random bits of coordinate idx (< d) of a (d,) draw under key (k0, k1).
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint64_t idx, uint64_t d) {
  const uint64_t half = (d + 1) / 2;
  const bool lo = idx < half;
  const uint64_t pair = lo ? idx : idx - half;
  uint64_t c1 = pair + half;
  if (c1 >= d) c1 = 0;  // odd-d zero pad
  uint32_t x0 = static_cast<uint32_t>(pair);
  uint32_t x1 = static_cast<uint32_t>(c1);
  threefry2x32(k0, k1, x0, x1);
  return lo ? x0 : x1;
}

// uint32 bits -> U[0, 1) float32 as jax.random.uniform: mantissa fill of
// [1, 2), minus 1, clamped at 0.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf(__fsub_rn(f, 1.0f), 0.0f);
}

// bits_to_uniform(bits) < p on the integer: u is exactly m * 2^-23 with m =
// bits >> 9 (the fill minus 1 is exact), so u < p iff m < ceil(p * 2^23).
inline uint32_t uniform_threshold(float p) {
  const double t = std::ceil(static_cast<double>(p) * 8388608.0);
  return t <= 0.0 ? 0u : t >= 8388608.0 ? 8388608u : static_cast<uint32_t>(t);
}

__device__ __forceinline__ bool uniform_below(uint32_t bits, uint32_t threshold) {
  return (bits >> 9) < threshold;
}

__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint64_t idx, uint64_t d) {
  return bits_to_uniform(bits_at(k0, k1, idx, d));
}

}  // namespace threefry
