// Hopper kernels for the fused §7.2 rotate + 1-bit encode of
// RotatedCodec(inner=binary).pack.
//
// Replace the Pallas TPU kernels of src/repro/kernels/rotated_encode/kernel.py:
//   rotate_minmax_pallas (:70, _rotate_kernel :48) -> re_rotate_minmax
//   encode_pack_pallas (:121, _encode_pack_kernel :84) -> re_encode_pack
// and are bit-equal to the plain versions in
// src/repro_torch/kernels/rotated_encode/ref.py, hence to the chain
// rotation.rotate -> bitplane.binary_pack (the reference's CPU path and the
// golden wire bytes), the (vmin, vmax) tail included.
//
// re_rotate_minmax: per row of c = 2^m coordinates (one MAX_D chunk of the
//   block-diagonal rotation), z = H (x * signs) / scale and the row's
//   (min, max) of z.  The butterfly is fwht.cuh's (register radix, both
//   passes of a row in one persistent kernel, the intermediate in L2): the
//   signs multiply in at the first pass's load, the true division by scale =
//   sqrt(c) (not a power of two for odd m) and the min / max at the last
//   pass's store; each last-pass tile writes its (min, max) and one small
//   kernel reduces a row's tiles (below m = 13 it reduces the stored rows).
//   min and max are order-free, so the result equals torch.amin / amax,
//   except that which zero is kept when both signs of zero are the extreme
//   depends on the order on either side.
//   Bound: bytes.  12 B a coordinate: x and signs read, z written, once.
//
// re_encode_pack: the stochastic binary threshold of encoders.encode_binary
//   with the global (vmin, vmax) already reduced, and the 1-bit plane pack.
//   A thread takes the pair (j, j + half), half = ceil(dp/2), of the (dp,)
//   draw: one threefry2x32 call gives coordinate j word x0 and j + half word
//   x1 (for odd dp the last pair's partner is the zero pad, as
//   threefry.cuh::bits_at), both z loads are coalesced, and each coordinate
//   votes u < p with p = (z - vmin) / delta (0 unless delta > 0, the guard of
//   the reference).  A warp's low ballot is plane word j0/32 (bit l = lane l,
//   little-endian as the plane layout); its high ballot covers coordinates
//   half + j0 .. + 31, which start at bit r = half % 32 of word (half +
//   j0)/32: b << r there and b >> (32 - r) in the next word, a whole word at
//   r = 0.  A block of 1024 pairs stages its 32 low and 32 high ballots in
//   shared memory and writes 32 low words and 32 (r = 0) or 33 high words,
//   coalesced; at r != 0 neighbouring ballots meet in shared memory and only
//   the block's two edge high words and the seam word at coordinate half are
//   shared with another block: those meet by atomicOr on a plane the launch
//   zeroes first.  On the rotation path dp is a power of two or a multiple of
//   2^20, so r = 0 for every dp >= 64.
//   Bound: integer operations.  ceil(dp/2) cipher calls of 72 int32
//   operations, one per pair.  Bytes: 4 dp read, dp / 8 written.
#include <cstdint>
#include <cuda_runtime.h>

#include "fwht.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 4;                        // pairs a thread
constexpr int kPairs = kThreads * kSteps;        // pairs a block
constexpr int kBallots = kPairs / 32;            // low (and high) ballots a block

__device__ __forceinline__ bool vote(float z, float vmin, float delta, uint32_t bits) {
  const float p = delta > 0.0f ? __fdiv_rn(__fsub_rn(z, vmin), delta) : 0.0f;
  return threefry::bits_to_uniform(bits) < p;
}

// grid (ceil(half / kPairs),).  Thread t of block b takes, in sub-step s,
// the pair j = kPairs*b + kThreads*s + t; warp w's ballots of sub-step s are
// the block's ballot k = kWarps*s + w: low word 32b + k, high words from
// half/32 + 32b + k on.
__global__ void encode_pack_kernel(const float* __restrict__ z, int64_t dp, int64_t half,
                                   uint32_t k0, uint32_t k1, const float* __restrict__ vmm,
                                   uint32_t* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ uint32_t low[kBallots];
  __shared__ uint32_t high_lo[kBallots + 1];   // b << r of ballot k, at word k
  __shared__ uint32_t high_up[kBallots + 1];   // b >> (32 - r) of ballot k, at word k + 1
  const float vmin = vmm[0];
  const float delta = __fsub_rn(vmm[1], vmin);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = static_cast<int>(half & 31);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kPairs;
  if (threadIdx.x == 0) {
    high_lo[kBallots] = 0u;
    high_up[0] = 0u;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t j = first + s * kThreads + threadIdx.x;
    bool lo = false, hi = false;
    if (j < half) {
      const int64_t c1 = j + half;
      const bool has_hi = c1 < dp;
      const float z0 = z[j];
      const float z1 = has_hi ? z[c1] : 0.0f;
      uint32_t x0 = static_cast<uint32_t>(j);
      uint32_t x1 = has_hi ? static_cast<uint32_t>(c1) : 0u;   // odd-dp zero pad
      threefry::threefry2x32(k0, k1, x0, x1);
      lo = vote(z0, vmin, delta, x0);
      hi = has_hi && vote(z1, vmin, delta, x1);
    }
    const uint32_t bl = __ballot_sync(0xffffffffu, lo);
    const uint32_t bh = __ballot_sync(0xffffffffu, hi);
    if (lane == 0) {
      const int k = s * kWarps + warp;
      low[k] = bl;
      high_lo[k] = bh << r;
      high_up[k + 1] = r ? bh >> (32 - r) : 0u;
    }
  }
  __syncthreads();
  const int64_t nw = (dp + 31) / 32;
  const int64_t seam = half / 32;                // the word holding coordinate half
  const int t = threadIdx.x;
  if (t < kBallots) {
    const int64_t w = first / 32 + t;
    if (w * 32 < half) {                         // the word's first coordinate is low
      if (r != 0 && w == seam)
        atomicOr(out + w, low[t]);
      else
        out[w] = low[t];
    }
  } else if (t < 2 * kBallots + 1) {
    const int k = t - kBallots;
    const int64_t w = seam + first / 32 + k;
    const bool edge = k == 0 || k == kBallots;
    if (w < nw && first + 32 * k < half + 32 && (r != 0 || k < kBallots)) {
      const uint32_t v = high_lo[k] | high_up[k];
      if (r != 0 && edge)
        atomicOr(out + w, v);
      else
        out[w] = v;
    }
  }
}

}  // namespace

extern "C" {

// x, signs, z: (rows, c) f32, 16-byte aligned; mm: (rows, 2) f32; scratch:
// re_scratch_bytes(rows, c) bytes.
int re_rotate_minmax(const float* x, const float* signs, float* z, float* mm, void* scratch,
                     int64_t rows, int64_t c, float scale, void* stream) {
  if (!signs || !mm) return static_cast<int>(cudaErrorInvalidValue);
  return fwht::launch<true>(x, signs, z, rows, c, scale, reinterpret_cast<float2*>(mm), scratch,
                            static_cast<cudaStream_t>(stream));
}

int64_t re_scratch_bytes(int64_t rows, int64_t c) { return fwht::scratch_bytes(rows, c, true); }

// z: (dp,) f32; vmm: (vmin, vmax) f32 on the card; out: ceil(dp/32) words.
int re_encode_pack(const float* z, int64_t dp, uint32_t k0, uint32_t k1, const float* vmm,
                   uint32_t* out, void* stream) {
  if (dp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t half = (dp + 1) / 2;
  if (half % 32 != 0) {   // edge and seam words meet by atomicOr
    const cudaError_t err = cudaMemsetAsync(out, 0, (dp + 31) / 32 * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (half + kPairs - 1) / kPairs;
  encode_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(z, dp, half, k0, k1,
                                                                       vmm, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
