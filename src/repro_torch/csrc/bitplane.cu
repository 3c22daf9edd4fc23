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
//   unpack: one 128-bit store a 16-byte item (16 uint8 symbols: half a
//           word at w = 1, one word at w = 2, two at w = 4, four at w = 8;
//           or 4 int32 symbols, two words, at w = 16), consecutive items on
//           consecutive lanes, so a warp's store covers 512 contiguous
//           bytes.  Each thread takes 4 items of its block's tile and issues
//           all their 32-bit word loads (the input may be 4-byte aligned
//           only) before its first store.  Symbols are spread into bytes by
//           shifts and masks (a multiply at w = 1), a few operations per 4
//           symbols.  The last, partial item takes a scalar path.
//   binary_accum: the fused §13 scatter decode of the 1-bit plane.  A block
//           takes a tile of 256 words of the window; for each chunk of up to
//           8 peers it stages the chunk's tile rows (coalesced 4-byte loads,
//           rows at any 4-byte stride) and centers in shared memory, then
//           each thread adds, peer by peer, c_hi or c_lo by the bit into
//           register accumulators for 8 float4 groups (a nibble of a word
//           each) from 0.f with __fadd_rn -- the order of ref.binary_accum
//           and of the sequential flat decode, hence bit-equal to both --
//           and stores them as float4s consecutive across lanes.  Chunks
//           keep any n in bounded shared memory.  A row stride lets the
//           caller pass a word window of the gathered rows without copying
//           it.
//
// Bound: bytes.  pack reads d symbols (1 or 4 bytes each) and writes
// 4 * ceil(d*w/32) bytes; unpack the reverse; binary_accum reads
// n * 4 * ceil(d/32) word bytes and 8n center bytes and writes 4d bytes.
// The integer and float work is a few operations per symbol and peer, below
// the card's rates for these byte counts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;   // grid-stride loops beyond this
constexpr int64_t kMaxTileBlocks = int64_t{1} << 20;

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

// ---- unpack ---------------------------------------------------------------
// An item is the 16 output bytes of symbols [i*kSym, (i+1)*kSym): 16 uint8
// symbols (w <= 8) or 4 int32 symbols (w = 16), taken from the item's
// kSym*w bits, which start at bit i*kSym*w of the plane.

constexpr int kUnpackThreads = 256;
constexpr int kUnpackItems = 4;    // 16-byte items a thread, loads before stores

// Four w-bit symbols, the low 4w bits of n, spread into the four bytes of a
// word, symbol k into byte k.  A symbol k needs a shift of (8 - w)*k; for w
// <= 2 the shifted copies land only on bits that the final mask clears (w = 1
// copies do not overlap at all, so a multiply places them); w = 4 first puts
// the two byte halves 16 bits apart.
template <int W>
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  if constexpr (W == 1) {
    return ((n & 0xFu) * 0x00204081u) & 0x01010101u;
  } else if constexpr (W == 2) {
    uint32_t x = n & 0xFFu;
    x |= x << 6;
    x |= x << 12;
    return x & 0x03030303u;
  } else if constexpr (W == 4) {
    const uint32_t x = (n & 0xFFu) | ((n & 0xFF00u) << 8);
    return (x | (x << 4)) & 0x0F0F0F0Fu;
  } else {
    return n;
  }
}

template <typename T, int W>
struct UnpackItem {
  static constexpr int kSym = 16 / static_cast<int>(sizeof(T));
  static constexpr int kWords = (kSym * W + 31) / 32;   // words an item reads

  __device__ static __forceinline__ int64_t first_word(int64_t i) {
    return (i * kSym * W) >> 5;
  }

  // The item's 16 bytes from its words u (w = 1: half a word, the high half
  // for odd i).
  __device__ static __forceinline__ uint4 expand(const uint32_t (&u)[kWords], int64_t i) {
    if constexpr (sizeof(T) == 4) {           // w = 16: two symbols a word
      return make_uint4(u[0] & 0xFFFFu, u[0] >> 16, u[1] & 0xFFFFu, u[1] >> 16);
    } else if constexpr (W == 1) {
      const uint32_t h = u[0] >> (16 * static_cast<int>(i & 1));
      return make_uint4(spread4<1>(h), spread4<1>(h >> 4), spread4<1>(h >> 8),
                        spread4<1>(h >> 12));
    } else if constexpr (W == 2) {
      return make_uint4(spread4<2>(u[0]), spread4<2>(u[0] >> 8), spread4<2>(u[0] >> 16),
                        spread4<2>(u[0] >> 24));
    } else if constexpr (W == 4) {
      return make_uint4(spread4<4>(u[0]), spread4<4>(u[0] >> 16), spread4<4>(u[1]),
                        spread4<4>(u[1] >> 16));
    } else {                                  // w = 8: the words are the bytes
      return make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
};

// Block tile: kUnpackThreads * kUnpackItems consecutive items, item k of a
// thread at tile + k*kUnpackThreads + lane, so each store instruction of a
// warp writes 512 contiguous bytes.  Every thread issues its word loads for
// all its items before its first store.  Only the last, partial item (d %
// kSym symbols) takes the scalar path.
template <typename T, int W>
__global__ void __launch_bounds__(kUnpackThreads)
unpack_kernel(const uint32_t* __restrict__ words, int64_t d, T* __restrict__ out) {
  using Item = UnpackItem<T, W>;
  constexpr int kPer = 32 / W;
  constexpr uint32_t kMask = (1u << W) - 1u;
  constexpr int kTile = kUnpackThreads * kUnpackItems;
  const int64_t full = d / Item::kSym;
  const int64_t items = full + (full * Item::kSym < d ? 1 : 0);
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile; t0 < items;
       t0 += static_cast<int64_t>(gridDim.x) * kTile) {
    uint32_t u[kUnpackItems][Item::kWords] = {};
#pragma unroll
    for (int k = 0; k < kUnpackItems; ++k) {
      const int64_t i = t0 + k * kUnpackThreads + threadIdx.x;
      if (i < full) {
        const uint32_t* src = words + Item::first_word(i);
#pragma unroll
        for (int q = 0; q < Item::kWords; ++q) u[k][q] = __ldg(src + q);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnpackItems; ++k) {
      const int64_t i = t0 + k * kUnpackThreads + threadIdx.x;
      if (i < full) {
        reinterpret_cast<uint4*>(out)[i] = Item::expand(u[k], i);
      } else if (i == full && i < items) {
        for (int64_t j = full * Item::kSym; j < d; ++j)
          out[j] = static_cast<T>((__ldg(words + j / kPer) >> ((j % kPer) * W)) & kMask);
      }
    }
  }
}

// ---- binary accumulate ------------------------------------------------------
// Block tile: kAccWords words of the window (32*kAccWords coordinates), one
// word a thread.  For each chunk of up to kAccPeers peers the block stages
// the chunk's rows of the tile in shared memory (lane l reads word l of a
// row: 128 bytes a warp a peer, 4-byte loads, so rows need only 4-byte
// alignment) and its centers; then thread t adds, peer by peer, its
// kAccGroups float4 groups t + kAccThreads*g: word (t >> 3) + 32g, nibble
// t & 7.  The accumulators stay in registers across chunks, so any n works
// and every coordinate's adds run in peer order.  Stores are float4s,
// consecutive across lanes.

constexpr int kAccThreads = 256;
constexpr int kAccWords = kAccThreads;                 // words a tile, one a thread
constexpr int kAccPeers = 8;                           // peers staged at a time
constexpr int kAccGroups = kAccWords * 8 / kAccThreads;  // float4 groups a thread

__global__ void __launch_bounds__(kAccThreads)
binary_accum_kernel(const uint32_t* __restrict__ words, int64_t ld, int n,
                    const float* __restrict__ c_lo, const float* __restrict__ c_hi,
                    int64_t d, float* __restrict__ out) {
  __shared__ uint32_t s_words[kAccPeers][kAccWords];
  __shared__ float s_lo[kAccPeers], s_hi[kAccPeers];
  const int t = threadIdx.x;
  const int sh = 4 * (t & 7);
  const int64_t nwd = (d + 31) >> 5;
  for (int64_t w0 = static_cast<int64_t>(blockIdx.x) * kAccWords; w0 < nwd;
       w0 += static_cast<int64_t>(gridDim.x) * kAccWords) {
    float acc[kAccGroups][4];
#pragma unroll
    for (int g = 0; g < kAccGroups; ++g)
      acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.0f;
    for (int c0 = 0; c0 < n; c0 += kAccPeers) {
      const int cnt = min(kAccPeers, n - c0);
      uint32_t v[kAccPeers];
#pragma unroll
      for (int k = 0; k < kAccPeers; ++k)
        v[k] = (k < cnt && w0 + t < nwd) ? __ldg(words + (c0 + k) * ld + w0 + t) : 0u;
      __syncthreads();                        // the previous chunk is consumed
#pragma unroll
      for (int k = 0; k < kAccPeers; ++k) s_words[k][t] = v[k];
      if (t < cnt) {
        s_lo[t] = __ldg(c_lo + c0 + t);
        s_hi[t] = __ldg(c_hi + c0 + t);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kAccPeers; ++k) {
        if (k < cnt) {
          const float lo = s_lo[k], hi = s_hi[k];
#pragma unroll
          for (int g = 0; g < kAccGroups; ++g) {
            const uint32_t w = s_words[k][(t >> 3) + 32 * g] >> sh;
            acc[g][0] = __fadd_rn(acc[g][0], (w & 1u) ? hi : lo);
            acc[g][1] = __fadd_rn(acc[g][1], (w & 2u) ? hi : lo);
            acc[g][2] = __fadd_rn(acc[g][2], (w & 4u) ? hi : lo);
            acc[g][3] = __fadd_rn(acc[g][3], (w & 8u) ? hi : lo);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kAccGroups; ++g) {
      const int64_t c = 32 * w0 + 4 * static_cast<int64_t>(t + kAccThreads * g);
      if (c + 4 <= d) {
        *reinterpret_cast<float4*>(out + c) = make_float4(acc[g][0], acc[g][1], acc[g][2],
                                                          acc[g][3]);
      } else if (c < d) {
        out[c] = acc[g][0];
        if (c + 1 < d) out[c + 1] = acc[g][1];
        if (c + 2 < d) out[c + 2] = acc[g][2];
      }
    }
  }
}

// One block a tile, up to kMaxTileBlocks blocks (tile loops beyond).
inline unsigned blocks_for_tiles(int64_t tiles) {
  return static_cast<unsigned>(tiles < kMaxTileBlocks ? tiles : kMaxTileBlocks);
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
  constexpr int64_t kSym = UnpackItem<T, W>::kSym;
  constexpr int64_t kTile = kUnpackThreads * kUnpackItems;
  const int64_t tiles = ((d + kSym - 1) / kSym + kTile - 1) / kTile;
  unpack_kernel<T, W><<<blocks_for_tiles(tiles), kUnpackThreads, 0, s>>>(words, d, out);
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

// words: (>= ceil(d * width / 32),) uint32, 4-byte aligned; out: (d,) uint8
// for width <= 8, int32 for width 16 (out_bytes says which), 16-byte aligned
// (as torch.empty allocates it).
int bp_unpack(const uint32_t* words, int64_t d, int width, void* out, int out_bytes,
              void* stream) {
  if (d < 1 || !aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
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

// words: n rows of >= ceil(d / 32) uint32 plane words, row i at words + i*ld
// (4-byte aligned); c_lo, c_hi: (n,) f32; out: (d,) f32, 16-byte aligned.
int bp_binary_accum(const uint32_t* words, int64_t ld, int n, const float* c_lo,
                    const float* c_hi, int64_t d, float* out, void* stream) {
  if (d < 1 || n < 1 || !aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = ((d + 31) / 32 + kAccWords - 1) / kAccWords;
  binary_accum_kernel<<<blocks_for_tiles(tiles), kAccThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(words, ld, n, c_lo, c_hi, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
