// The counter-based hash PRNG of the dense encoders, as device functions.
//
// The CUDA counterpart of src/repro/kernels/prng.py (and of its plain port
// src/repro_torch/kernels/prng.py): hash_u32 is the murmur3 fmix32
// finalizer of idx * 0x9E3779B9 + seed in uint32 arithmetic (wrapping, as
// uint32 does on the TPU); uniform_hash is its top 24 bits times 2^-24, an
// exact float.  The counter is the global flat coordinate, so a kernel may
// tile the vector any way it likes.
//
// Work: 3 multiplies, 1 add, 3 shifts and 3 xors for the hash, a shift and
// a conversion for the uniform: about 12 integer operations a draw.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t idx) {
  uint32_t h = idx * 0x9E3779B9u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float uniform_hash(uint32_t seed, uint32_t idx) {
  // (h >> 8) < 2^24 converts exactly; the product by 2^-24 is exact
  return __fmul_rn(__uint2float_rn(hash_u32(seed, idx) >> 8), 5.9604644775390625e-08f);
}
