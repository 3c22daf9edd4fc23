// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels: the reference's finite
// mask sentinel, bf16 packing, and, for the f32 forward and the backward,
// the 64-row tile loader and bf16 mma.sync fragments.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr float kMasked = -1e30f;   // the reference's NEG_INF (flash_attention.py:27)
constexpr int kTile = 64;           // rows of a q tile and keys of a key tile

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values as one A/B fragment register: lo in the low half.
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_round(float lo, float hi) {
  return pack_raw(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// d += a . b, one m16n8k16 tile (A row-major 16x16, B 16x8, f32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace flash
