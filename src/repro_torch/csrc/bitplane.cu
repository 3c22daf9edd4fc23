// Hopper kernels for the packed bit-plane wire (§4.5 binary 1-bit plane,
// §7.1 ternary 2-bit plane).
//
// Replace the Pallas TPU kernels of src/repro/kernels/bitplane/bitplane.py:
//   pack_bits_2d (:53, _pack_kernel :27)         -> bp_pack
//   unpack_bits_2d (:109, _unpack_kernel :37)    -> bp_unpack
//   binary_accum_2d (:92, _accum_kernel :63)     -> bp_binary_accum
// and are bit-equal to the plain versions in
// src/repro_torch/kernels/bitplane/ref.py.
//
// Layout: symbol j of a w-bit plane sits in word j / (32/w) at bit offset
// (j % (32/w)) * w, little-endian within the word; symbols are masked to w
// bits.  Words are uint32 (int32 tensors on the Python side).
//
// Design.  The TPU kernels take (8|256, 128) tiles of a padded 2-D copy of
// the plane.  Here every kernel reads the unpadded 1-D buffer and masks its
// ragged end itself (the last word holds only the symbols below d, the rest
// of it zero, as the reference's zero padding leaves it), so no padded copy
// is made: at the 388,956,160-coordinate embed bucket the reference's
// padded u32 copy alone would be 1.6 GB.
//   pack:   one thread per output word reads its 32/w symbols -- uint8
//           symbols (w <= 8) as 4-byte loads, 4 symbols each -- masks them
//           and ORs them into place.  Symbols come as uint8 (bool viewed as
//           uint8 for the binary plane) or as int32 bit patterns.
//   unpack: one thread per input word writes its 32/w symbols, uint8 (w <=
//           8, as 4-byte stores) or int32 (w = 16).
//   binary_accum: the fused §13 scatter decode of the 1-bit plane.  One
//           thread owns 4 coordinates (one nibble of a word), walks the
//           peers 0..n-1, selects c_hi or c_lo per bit and adds with
//           __fadd_rn into 4 register accumulators from 0.f -- the order of
//           ref.binary_accum and of the sequential flat decode, hence
//           bit-equal to both.  A row stride lets the caller pass a word
//           window of the gathered rows without copying it.
//
// Bound: bytes.  pack reads d symbols (1 or 4 bytes each) and writes
// 4 * ceil(d*w/32) bytes; unpack the reverse; binary_accum reads
// n * 4 * ceil(d/32) word bytes and 8n center bytes and writes 4d bytes.
// The integer work is a few operations per symbol, far below the int32
// rate for these byte counts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;   // grid-stride loops beyond this

inline unsigned blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b);
}

__device__ __forceinline__ int64_t first_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

template <typename T, int W>
__global__ void pack_kernel(const T* __restrict__ sym, int64_t d, int64_t nw,
                            bool vec, uint32_t* __restrict__ out) {
  constexpr int kPer = 32 / W;
  constexpr uint32_t kMask = (1u << W) - 1u;
  for (int64_t j = first_index(); j < nw; j += grid_stride()) {
    const int64_t s0 = j * kPer;
    uint32_t word = 0;
    bool done = false;
    if constexpr (sizeof(T) == 1 && kPer % 4 == 0) {
      if (vec && s0 + kPer <= d) {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(sym + s0);
#pragma unroll
        for (int g = 0; g < kPer / 4; ++g) {
          const uint32_t v = q[g];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            word |= ((v >> (8 * b)) & kMask) << ((4 * g + b) * W);
        }
        done = true;
      }
    }
    if (!done) {
      const int64_t rem = d - s0;
      const int cnt = rem < kPer ? static_cast<int>(rem) : kPer;
      for (int k = 0; k < cnt; ++k)
        word |= (static_cast<uint32_t>(sym[s0 + k]) & kMask) << (k * W);
    }
    out[j] = word;
  }
}

template <typename T, int W>
__global__ void unpack_kernel(const uint32_t* __restrict__ words, int64_t d,
                              int64_t nw, bool vec, T* __restrict__ out) {
  constexpr int kPer = 32 / W;
  constexpr uint32_t kMask = (1u << W) - 1u;
  for (int64_t j = first_index(); j < nw; j += grid_stride()) {
    const uint32_t w = words[j];
    const int64_t s0 = j * kPer;
    bool done = false;
    if constexpr (sizeof(T) == 1 && kPer % 4 == 0) {
      if (vec && s0 + kPer <= d) {
        uint32_t* q = reinterpret_cast<uint32_t*>(out + s0);
#pragma unroll
        for (int g = 0; g < kPer / 4; ++g) {
          uint32_t v = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            v |= ((w >> ((4 * g + b) * W)) & kMask) << (8 * b);
          q[g] = v;
        }
        done = true;
      }
    }
    if (!done) {
      const int64_t rem = d - s0;
      const int cnt = rem < kPer ? static_cast<int>(rem) : kPer;
      for (int k = 0; k < cnt; ++k)
        out[s0 + k] = static_cast<T>((w >> (k * W)) & kMask);
    }
  }
}

__global__ void binary_accum_kernel(const uint32_t* __restrict__ words,
                                    int64_t ld, int n,
                                    const float* __restrict__ c_lo,
                                    const float* __restrict__ c_hi, int64_t d,
                                    bool vec, float* __restrict__ out) {
  const int64_t groups = (d + 3) / 4;
  for (int64_t q = first_index(); q < groups; q += grid_stride()) {
    const int64_t c0 = q * 4;
    const int64_t wi = c0 >> 5;
    const int sh = static_cast<int>(c0 & 31);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int i = 0; i < n; ++i) {
      const uint32_t w = __ldg(words + i * ld + wi) >> sh;
      const float lo = __ldg(c_lo + i);
      const float hi = __ldg(c_hi + i);
      a0 = __fadd_rn(a0, (w & 1u) ? hi : lo);
      a1 = __fadd_rn(a1, (w & 2u) ? hi : lo);
      a2 = __fadd_rn(a2, (w & 4u) ? hi : lo);
      a3 = __fadd_rn(a3, (w & 8u) ? hi : lo);
    }
    if (vec && c0 + 4 <= d) {
      *reinterpret_cast<float4*>(out + c0) = make_float4(a0, a1, a2, a3);
    } else {
      out[c0] = a0;
      if (c0 + 1 < d) out[c0 + 1] = a1;
      if (c0 + 2 < d) out[c0 + 2] = a2;
      if (c0 + 3 < d) out[c0 + 3] = a3;
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, int W>
int launch_pack(const T* sym, int64_t d, uint32_t* out, cudaStream_t s) {
  constexpr int kPer = 32 / W;
  const int64_t nw = (d + kPer - 1) / kPer;
  pack_kernel<T, W><<<blocks_for(nw), kThreads, 0, s>>>(sym, d, nw, aligned(sym, 4), out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pack_width(const T* sym, int64_t d, int width, uint32_t* out, cudaStream_t s) {
  switch (width) {
    case 1: return launch_pack<T, 1>(sym, d, out, s);
    case 2: return launch_pack<T, 2>(sym, d, out, s);
    case 4: return launch_pack<T, 4>(sym, d, out, s);
    case 8: return launch_pack<T, 8>(sym, d, out, s);
    case 16: return launch_pack<T, 16>(sym, d, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int W>
int launch_unpack(const uint32_t* words, int64_t d, T* out, cudaStream_t s) {
  constexpr int kPer = 32 / W;
  const int64_t nw = (d + kPer - 1) / kPer;
  unpack_kernel<T, W><<<blocks_for(nw), kThreads, 0, s>>>(words, d, nw, aligned(out, 4), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// sym: (d,) symbols of sym_bytes = 1 (uint8) or 4 (int32 bit patterns);
// out: (ceil(d * width / 32),) uint32 words.
int bp_pack(const void* sym, int sym_bytes, int64_t d, int width, uint32_t* out,
            void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sym_bytes == 1) return pack_width(static_cast<const uint8_t*>(sym), d, width, out, s);
  if (sym_bytes == 4) return pack_width(static_cast<const int32_t*>(sym), d, width, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// words: (>= ceil(d * width / 32),) uint32; out: (d,) uint8 for width <= 8,
// int32 for width 16 (out_bytes says which).
int bp_unpack(const uint32_t* words, int64_t d, int width, void* out, int out_bytes,
              void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o8 = static_cast<uint8_t*>(out);
  if (out_bytes == 1) {
    switch (width) {
      case 1: return launch_unpack<uint8_t, 1>(words, d, o8, s);
      case 2: return launch_unpack<uint8_t, 2>(words, d, o8, s);
      case 4: return launch_unpack<uint8_t, 4>(words, d, o8, s);
      case 8: return launch_unpack<uint8_t, 8>(words, d, o8, s);
      default: break;
    }
  } else if (out_bytes == 4 && width == 16) {
    return launch_unpack<int32_t, 16>(words, d, static_cast<int32_t*>(out), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// words: n rows of >= ceil(d / 32) uint32 plane words, row i at words + i*ld;
// c_lo, c_hi: (n,) f32; out: (d,) f32.
int bp_binary_accum(const uint32_t* words, int64_t ld, int n, const float* c_lo,
                    const float* c_hi, int64_t d, float* out, void* stream) {
  if (d < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (d + 3) / 4;
  binary_accum_kernel<<<blocks_for(groups), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      words, ld, n, c_lo, c_hi, d, aligned(out, 16), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
