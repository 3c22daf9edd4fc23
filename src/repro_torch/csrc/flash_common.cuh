// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels: the reference's finite
// mask sentinel, bf16 packing, and the f32 (SIMT) kernels' 64-row tile
// loader.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr float kMasked = -1e30f;   // the reference's NEG_INF (flash_attention.py:27)
constexpr int kTile = 64;           // rows of a q tile and keys of a key tile

// Columns of a bf16 kernel's shared-memory tile: hd rounded up to whole
// 64-column TMA boxes -- one box at hd 16, 32 and 64, two at hd 120 and 128.
// The maps span hd columns (a row of hd 120 is 240 bytes, a multiple of 16
// as TMA requires), so TMA zero-fills the tile's columns past hd on loads
// and clips them from stores.
__host__ __device__ constexpr int tile_cols(int hd) { return (hd + 63) / 64 * 64; }

// k-steps of 16 columns that a product over hd takes: hd / 16, and at hd
// 120 one more over columns 112-127, whose last eight are the zero fill (they
// add nothing to Q.K^T or dO.V^T).
__host__ __device__ constexpr int k_steps(int hd) { return (hd + 15) / 16; }

// Copy rows [row0, row0 + 64) of a (S, stride) row set into smem rows of LD
// elements; rows at or past n_rows are zero-filled.  16-byte global loads,
// 4-byte shared stores (LD keeps rows 4-byte aligned, not 16).
template <typename T, int HD, int LD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride,
                                          int64_t row0, int64_t n_rows) {
  constexpr int kPer = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int kChunks = HD / kPer;            // chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += NT) {
    const int r = c / kChunks;
    const int e = (c % kChunks) * kPer;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + e);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * LD + e);
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// Two bf16 values as one wgmma A fragment register: lo in the low half.
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_round(float lo, float hi) {
  return pack_raw(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

}  // namespace flash
