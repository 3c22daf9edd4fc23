// Hopper kernel for the dense Bernoulli sparsification encoder (Eq. (1),
// uniform p) with the hash PRNG.
//
// Replaces the Pallas TPU kernel bernoulli_encode_2d
// (src/repro/kernels/bernoulli_encode/bernoulli_encode.py:53, _kernel :27):
//   y_j = x_j / p - ((1 - p) / p) * mu   where uniform_hash(seed, j) < p,
//   y_j = mu                             elsewhere,
// computed in f32 and stored in x's dtype (f32, or bf16 rounded to nearest
// even).  Bit-equal to the plain version in
// src/repro_torch/kernels/bernoulli_encode/ref.py: every operation is an
// explicit round-to-nearest intrinsic in the reference's order, so nvcc
// contracts nothing into an FMA (NVCC_FLAGS leave -fmad on).
//
// Design.  The TPU kernel takes (512, 128) tiles of a copy of x padded to a
// multiple of 65,536 and rebuilds each coordinate's global index from the
// tile's position.  Here a grid-stride loop walks the unpadded flat vector in
// 16-byte groups (4 f32 or 8 bf16 coordinates a thread, one 16-byte load and
// one 16-byte store) and the PRNG counter is the coordinate's own index, so
// the result equals the reference's padded grid without the copy; a ragged
// tail or an unaligned view takes scalar loads.  The seed is one uint32
// argument (the TPU kernel's two f32 halves only carried it through an f32
// scalar buffer).
//
// Bound: bytes.  It reads and writes every coordinate once: 8 bytes a
// coordinate in f32, 4 in bf16.  The hash and compare are about 13 integer
// operations a coordinate and the sent coordinates add one f32 division and
// one subtraction: below the byte time at the int32 and f32 rates.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "prng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // grid-stride loops beyond this

inline unsigned blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b);
}

struct Enc {
  float p, mu, c;
  uint32_t seed;
  __device__ __forceinline__ float operator()(float x, int64_t j) const {
    return uniform_hash(seed, static_cast<uint32_t>(j)) < p ? __fsub_rn(__fdiv_rn(x, p), c) : mu;
  }
};

__device__ __forceinline__ Enc make_enc(float p, float mu, uint32_t seed) {
  // ((1 - p) / p) * mu, once a thread, as the reference computes it
  return Enc{p, mu, __fmul_rn(__fdiv_rn(__fsub_rn(1.0f, p), p), mu), seed};
}

__device__ __forceinline__ float bf16_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t f32_to_bf16(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__global__ void encode_f32(const float* __restrict__ x, float* __restrict__ out, int64_t n,
                           float p, float mu, uint32_t seed, int vec) {
  const Enc enc = make_enc(p, mu, seed);
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const int64_t j = 4 * g;
    if (vec && j + 4 <= n) {
      const float4 v = *reinterpret_cast<const float4*>(x + j);
      float4 o;
      o.x = enc(v.x, j);
      o.y = enc(v.y, j + 1);
      o.z = enc(v.z, j + 2);
      o.w = enc(v.w, j + 3);
      *reinterpret_cast<float4*>(out + j) = o;
    } else {
      for (int64_t k = j; k < j + 4 && k < n; ++k) out[k] = enc(x[k], k);
    }
  }
}

// bf16 travels as raw 16-bit patterns: 8 a 16-byte group, two a 32-bit word
// (element 2k in the low half, little-endian)
__global__ void encode_bf16(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
                            int64_t n, float p, float mu, uint32_t seed, int vec) {
  const Enc enc = make_enc(p, mu, seed);
  const int64_t groups = (n + 7) / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const int64_t j = 8 * g;
    if (vec && j + 8 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + j);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lo = enc(bf16_to_f32(w[k] & 0xFFFFu), j + 2 * k);
        const float hi = enc(bf16_to_f32(w[k] >> 16), j + 2 * k + 1);
        r[k] = f32_to_bf16(lo) | (f32_to_bf16(hi) << 16);
      }
      *reinterpret_cast<uint4*>(out + j) = make_uint4(r[0], r[1], r[2], r[3]);
    } else {
      for (int64_t k = j; k < j + 8 && k < n; ++k)
        out[k] = static_cast<uint16_t>(f32_to_bf16(enc(bf16_to_f32(x[k]), k)));
    }
  }
}

inline bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15) == 0; }

}  // namespace

extern "C" {

// x, out: (n,) of dtype 0 = f32 or 1 = bf16, contiguous; 0 < p <= 1.
int be_encode(const void* x, void* out, int64_t n, int dtype, float p, float mu,
              uint32_t seed, void* stream) {
  if (n < 1 || dtype < 0 || dtype > 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(x) && aligned16(out);
  if (dtype == 0) {
    encode_f32<<<blocks_for((n + 3) / 4), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, p, mu, seed, vec);
  } else {
    encode_bf16<<<blocks_for((n + 7) / 8), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), n, p, mu, seed, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
