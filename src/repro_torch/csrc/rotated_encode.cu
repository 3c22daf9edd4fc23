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
//   One warp per 32-bit word: lane l takes coordinate 32w + l (coalesced
//   loads), computes p = (z - vmin) / delta (0 unless delta > 0, the guard of
//   the reference), draws the Threefry uniform of that coordinate of the
//   full-length (dp,) draw (threefry.cuh::uniform_at) and votes u < p; the
//   ballot is the word, bit l = lane l, little-endian as the plane layout.
//   Lanes past dp vote 0.
//   Bound: integer operations.  A full-length draw needs ceil(dp/2) cipher
//   calls of 72 int32 operations; this kernel makes one call per coordinate
//   and keeps one of its two words, so it does twice that work.  Bytes:
//   4 dp read, dp / 8 written.
#include <cstdint>
#include <cuda_runtime.h>

#include "fwht.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;   // grid-stride loops beyond this

__global__ void encode_pack_kernel(const float* __restrict__ z, int64_t dp,
                                   int64_t nw, uint32_t k0, uint32_t k1,
                                   const float* __restrict__ vmm,
                                   uint32_t* __restrict__ out) {
  const float vmin = vmm[0];
  const float delta = __fsub_rn(vmm[1], vmin);
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       w < nw; w += warps) {
    const int64_t j = w * 32 + lane;
    bool bit = false;
    if (j < dp) {
      const float p = delta > 0.0f ? __fdiv_rn(__fsub_rn(z[j], vmin), delta) : 0.0f;
      bit = threefry::uniform_at(k0, k1, static_cast<uint64_t>(j),
                                 static_cast<uint64_t>(dp)) < p;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) out[w] = word;
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
  const int64_t nw = (dp + 31) / 32;
  int64_t blocks = (nw * 32 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  encode_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(z, dp, nw, k0, k1, vmm, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
