// Hopper kernel for the block-structured fixed-k gather-encode (Eq. (4)).
//
// Replaces the Pallas TPU kernel fixed_k_gather_2d
// (src/repro/kernels/fixed_k_encode/fixed_k_encode.py:39, _kernel :23): gather
// the kb selected 1024-coordinate blocks of x and write scale * (x - mu) into
// the compacted (kb, 1024) wire values.  Bit-equal to the plain version in
// src/repro_torch/kernels/fixed_k_encode/ref.py: one round-to-nearest
// difference, then one round-to-nearest product.
//
// Design.  One CUDA block per selected block, 256 threads, one 16-byte float4
// load and store per thread.  The block loads its own id (the TPU version
// took the ids by scalar prefetch).  x is not padded to a block multiple:
// lanes past n read as 0, which is the zero padding of the reference.
//
// Bound: memory.  It reads k = kb * 1024 floats and writes k floats, so its
// floor is 8k bytes over the card's HBM rate; the arithmetic is two flops a
// coordinate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kThreads = kBlock / 4;

__device__ __forceinline__ float enc(float v, float scale, float mu) {
  return __fmul_rn(scale, __fsub_rn(v, mu));
}

__global__ void gather_kernel(const float* __restrict__ x, int64_t n,
                              const int64_t* __restrict__ ids, float scale,
                              const float* __restrict__ mu_ptr,
                              float* __restrict__ out) {
  const int64_t blk = ids[blockIdx.x];
  const float mu = *mu_ptr;
  const int64_t src = blk * kBlock + 4 * threadIdx.x;
  float4 v;
  if (src + 4 <= n && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    v = *reinterpret_cast<const float4*>(x + src);
  } else {
    v.x = src + 0 < n ? x[src + 0] : 0.0f;
    v.y = src + 1 < n ? x[src + 1] : 0.0f;
    v.z = src + 2 < n ? x[src + 2] : 0.0f;
    v.w = src + 3 < n ? x[src + 3] : 0.0f;
  }
  float4 o;
  o.x = enc(v.x, scale, mu);
  o.y = enc(v.y, scale, mu);
  o.z = enc(v.z, scale, mu);
  o.w = enc(v.w, scale, mu);
  *reinterpret_cast<float4*>(out + static_cast<int64_t>(blockIdx.x) * kBlock +
                             4 * threadIdx.x) = o;
}

}  // namespace

extern "C" {

// x: (n,) f32; ids: (kb,) int64 block ids < ceil(n / 1024); mu: device f32
// scalar; out: (kb, 1024) f32, 16-byte aligned.
int fk_gather(const float* x, int64_t n, const int64_t* ids, int64_t kb,
              float scale, const float* mu, float* out, void* stream) {
  if (kb < 1) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<static_cast<unsigned>(kb), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, n, ids, scale, mu, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
