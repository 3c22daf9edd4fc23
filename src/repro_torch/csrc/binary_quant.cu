// Hopper kernel for stochastic binary quantization (Example 4) with the hash
// PRNG, fused with the 8:1 bit packing.
//
// Replaces the Pallas TPU kernel binary_encode_2d
// (src/repro/kernels/binary_quant/binary_quant.py:54, _kernel :25):
//   p_j = (x_j - vmin) / (vmax - vmin), or 0 where vmax - vmin <= 0,
//   bit_j = uniform_hash(seed, j) < p_j,
// packed 8 coordinates to a byte, least significant bit first.  Bit-equal to
// the plain version in src/repro_torch/kernels/binary_quant/ref.py (explicit
// round-to-nearest intrinsics, no FMA) and to the reference's bytes.
//
// Design.  The TPU kernel packs 8 lanes of a (512, 128) tile into a byte.
// Here a warp walks the unpadded flat vector in chunks of 32 x 16 bytes (4
// f32 or 8 bf16 coordinates a lane, one 16-byte load); a lane's bits form a
// nibble or a byte, and an OR over the 8 (f32) or 4 (bf16) lanes that share
// a 32-coordinate word, by xor shuffles, assembles the word.  A uint32 word
// with bit b = coordinate 32w + b is, on this little-endian card, exactly
// the reference's four LSB-first bytes in ascending order.  Coordinates past
// n are the reference's vmin padding, whose p is 0: their bits are 0.  vmin
// and vmax are read from the card (computed there by the caller).
//
// Bound: bytes.  4 (f32) or 2 (bf16) bytes read a coordinate and 1/8 byte
// written.  The hash is about 13 integer operations a coordinate, and the
// IEEE division (reciprocal, refinement and correction: about 6 f32
// operations) plus the subtraction and compare about 8 f32 operations: below
// the byte time at the int32 and f32 rates.
#include <cstdint>
#include <cuda_runtime.h>

#include "prng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 16;   // grid-stride loops beyond this

__device__ __forceinline__ uint32_t bit_of(float x, int64_t j, float vmin, float delta,
                                           uint32_t seed) {
  const float p = delta > 0.0f ? __fdiv_rn(__fsub_rn(x, vmin), delta) : 0.0f;
  return uniform_hash(seed, static_cast<uint32_t>(j)) < p ? 1u : 0u;
}

__device__ __forceinline__ float bf16_at(const uint16_t* x, int64_t k) {
  return __uint_as_float(static_cast<uint32_t>(x[k]) << 16);
}

// E coordinates a lane from one 16-byte group: bit e of the result is
// coordinate j + e
__device__ __forceinline__ uint32_t group_bits(const float* x, int64_t j, int64_t n, bool vec,
                                               float vmin, float delta, uint32_t seed) {
  uint32_t b = 0;
  if (vec && j + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + j);
    b = bit_of(v.x, j, vmin, delta, seed) | (bit_of(v.y, j + 1, vmin, delta, seed) << 1) |
        (bit_of(v.z, j + 2, vmin, delta, seed) << 2) |
        (bit_of(v.w, j + 3, vmin, delta, seed) << 3);
  } else {
    for (int e = 0; e < 4 && j + e < n; ++e) b |= bit_of(x[j + e], j + e, vmin, delta, seed) << e;
  }
  return b;
}

__device__ __forceinline__ uint32_t group_bits(const uint16_t* x, int64_t j, int64_t n, bool vec,
                                               float vmin, float delta, uint32_t seed) {
  uint32_t b = 0;
  if (vec && j + 8 <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + j);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      b |= bit_of(__uint_as_float(w[k] << 16), j + 2 * k, vmin, delta, seed) << (2 * k);
      b |= bit_of(__uint_as_float(w[k] & 0xFFFF0000u), j + 2 * k + 1, vmin, delta, seed)
           << (2 * k + 1);
    }
  } else {
    for (int e = 0; e < 8 && j + e < n; ++e)
      b |= bit_of(bf16_at(x, j + e), j + e, vmin, delta, seed) << e;
  }
  return b;
}

// E = 16 / sizeof(T) coordinates a lane; 32 / E lanes share a word
template <typename T>
__global__ void encode_pack(const T* __restrict__ x, int64_t n, const float* __restrict__ vmin_p,
                            const float* __restrict__ vmax_p, uint32_t seed,
                            uint32_t* __restrict__ words, int64_t nwords, int vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kLanesPerWord = 32 / E;
  const float vmin = *vmin_p;
  const float delta = __fsub_rn(*vmax_p, vmin);
  const int lane = threadIdx.x & 31;
  const int64_t chunks = nwords / E;           // a warp's chunk: E words
  const int64_t warp0 = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t c = warp0; c < chunks; c += nwarps) {   // uniform within the warp
    const int64_t j = c * 32 * E + static_cast<int64_t>(lane) * E;
    uint32_t v = group_bits(x, j, n, vec != 0, vmin, delta, seed) << (E * (lane % kLanesPerWord));
#pragma unroll
    for (int off = 1; off < kLanesPerWord; off <<= 1) v |= __shfl_xor_sync(0xFFFFFFFFu, v, off);
    if (lane % kLanesPerWord == 0) words[c * E + lane / kLanesPerWord] = v;
  }
}

inline bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15) == 0; }

}  // namespace

extern "C" {

// x: (n,) of dtype 0 = f32 or 1 = bf16, contiguous; vmin, vmax: device f32
// scalars; out: (padded / 8,) bytes, padded >= n a multiple of 256.
int bq_encode(const void* x, int64_t n, int dtype, const float* vmin, const float* vmax,
              uint32_t seed, void* out, int64_t padded, void* stream) {
  if (n < 1 || padded < n || padded % 256 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nwords = padded / 32;
  const int vec = aligned16(x);
  const int E = dtype == 0 ? 4 : 8;
  int64_t blocks = (nwords / E + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (dtype == 0) {
    encode_pack<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), n, vmin, vmax, seed, static_cast<uint32_t*>(out), nwords,
        vec);
  } else {
    encode_pack<uint16_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), n, vmin, vmax, seed, static_cast<uint32_t*>(out),
        nwords, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
