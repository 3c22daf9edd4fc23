// Hopper kernels for the flash-attention backward: the two sweeps of the
// FlashAttention-2 backward, recomputing p from the forward's row log-sum-exp.
//
// Replace the Pallas TPU kernels of flash_attention_bwd
// (src/repro/kernels/flash_attention/flash_attention.py): fa_bwd_dkv the
// dK/dV sweep (pallas_call at :280, body _bwd_dkv_kernel :162), fa_bwd_dq
// the dQ sweep (pallas_call at :318, body _bwd_dq_kernel :207).  Held within
// tolerance of the plain blockwise version flash_attention_bwd in
// src/repro_torch/kernels/flash_attention/ref.py, which follows those bodies:
//   s  = (q . k^T in f32) * scale,  -1e30 where masked (the finite sentinel)
//   p  = exp(s - lse)                 (not rounded: the backward keeps f32 p)
//   dp = do . v^T;   ds = p * (dp - delta)     delta = rowsum(do * o), given
//   dv = sum p^T . do;   dk = sum ds^T . q * scale;   dq = sum ds . k * scale
// over the live tiles (the reference's _block_live at 64 x 64 here).  A q row
// or key past the end of a ragged tile does not exist: its p is 0.  (A row
// with no unmasked key at all gets p = 1/l on the masked keys of the forward's
// live blocks in the reference, which depends on its block sizes; the model's
// causal masks never make one.)  The scale multiplies the finished f32 sums,
// where the reference scales each block's product before adding it.
//
// Layout: q, do (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd), contiguous, one
// dtype -- the model's layout, read in place; lse, delta (B, Hq, Sq) f32;
// outputs dq (B, Sq, Hq, hd), dk, dv (B, Sk, Hkv, hd) in f32.
//
// fa_bwd_dkv: one CTA per (batch * kv head, 64-key tile).  K and V tiles
//   stay in shared memory; dK and dV are summed in f32 registers over the g =
//   Hq / Hkv q heads of the kv head and, for each, over its live 64-row q
//   tiles (for a causal mask from the first live one; a window's dead tiles
//   end the sweep).  This is _bwd_dkv_kernel's grid with the group folded into
//   the loop: no atomics.
// fa_bwd_dq: one CTA per (batch * q head, 64-row q tile), Q and dO in shared
//   memory, dQ in f32 registers, looping over the live key tiles.
//
//   bf16 (the training path): 4 warps, warp-level mma.sync m16n8k16 (bf16 in,
//     f32 accumulate).  Q.K^T and dO.V^T take the bf16 inputs, which the
//     reference casts to f32 exactly: these products are exact.  The three
//     products with p or ds (P^T.dO, dS^T.Q, dS.K) have f32 operands in the
//     reference; here p and ds are split as hi + lo, two bf16 values whose
//     sum is the f32 value to about 2^-16 relative, and each product is two
//     mma.sync (hi, then lo) into one f32 sum -- not FlashAttention-2's single
//     bf16 rounding of p and ds.  P and dS go from the accumulators to the A
//     fragments in registers.  fa_bwd_dkv warps own 16 keys each and compute
//     S^T = K.Q^T and dP^T = V.dO^T over a q tile in two halves of 32 columns
//     (64 accumulator registers for dK and 64 for dV at hd 128).
//   f32: 256 threads, SIMT f32 FMAs (no TF32): each thread 4 x 4 entries of
//     S and dP, P and dS through shared memory, then 4 rows x hd/16 columns of
//     the output sums.
//
// Bound (the training path, bf16, causal): operations.  Per live (q, k) pair
// fa_bwd_dkv does 4 products of 2 * hd flops (S, dP, dV, dK) and fa_bwd_dq 3
// (S, dP, dQ), at 989 TFLOP/s dense bf16; bytes (q, k, v, do once, lse,
// delta, f32 outputs) are a tenth of that time at (1, 4096, 32/8, 128).  The
// hi + lo split doubles the tensor-core work of the products with p or ds;
// tiles are loaded synchronously (no cp.async / TMA pipeline, no wgmma): this
// first version sits well below the bound.
#include "flash_common.cuh"

namespace {

using namespace flash;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int64_t sq, sk, hq, hkv;
  int64_t q_offset;
  int64_t window;   // <= 0: none
  int causal;
  float scale;
};

// The reference's _block_live for a (64-row, 64-key) tile.
__device__ __forceinline__ bool tile_live(const Args& a, int64_t q_start, int64_t k_start) {
  bool run = true;
  if (a.causal) run = q_start + kTile - 1 >= k_start;
  if (a.window > 0) run = run && (k_start + kTile - 1 > q_start - a.window);
  return run;
}

// A window makes every later q tile (dK/dV sweep) dead once one is.
__device__ __forceinline__ bool window_passed(const Args& a, int64_t q_start, int64_t k_start) {
  return a.window > 0 && k_start + kTile - 1 <= q_start - a.window;
}

// The first q tile whose rows can see key k_start under a causal mask.
__device__ __forceinline__ int64_t first_q_tile(const Args& a, int64_t k_start) {
  if (!a.causal) return 0;
  const int64_t need = k_start - a.q_offset - (kTile - 1);
  return need <= 0 ? 0 : (need + kTile - 1) / kTile;
}

// p of q row q_row (0-based within the sequence) against key k_pos, from the
// raw product s: 0 for a row or key that does not exist.
__device__ __forceinline__ float prob(const Args& a, float s, float lse, int64_t q_row,
                                      int64_t k_pos) {
  if (q_row >= a.sq || k_pos >= a.sk) return 0.f;
  const int64_t q_pos = a.q_offset + q_row;
  float x = s * a.scale;
  if (a.causal && q_pos < k_pos) x = kMasked;
  if (a.window > 0 && k_pos <= q_pos - a.window) x = kMasked;
  return expf(x - lse);
}

// 64 entries of a (.., Sq) f32 row from row0; zeros past n.
template <int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int64_t row0, int64_t n) {
  for (int i = threadIdx.x; i < kTile; i += NT) dst[i] = row0 + i < n ? src[row0 + i] : 0.f;
}

// --------------------------------------------------------- bf16 (mma.sync)

// x, y as hi + lo bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack_raw(hx, hy);
  lo = pack_round(x - __bfloat162float(hx), y - __bfloat162float(hy));
}

// acc[j] (16 x 8 n-tiles j < NJ) += A . B^T for one warp: A the 16 smem rows
// at a_rows, B the 8 * NJ smem rows at b_rows, both row-major with LD and HD
// columns.
template <int HD, int LD, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const __nv_bfloat16* a_rows,
                                        const __nv_bfloat16* b_rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* r = a_rows + g * LD + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(r), ld32(r + 8 * LD), ld32(r + 8), ld32(r + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const __nv_bfloat16* bp = b_rows + (8 * j + g) * LD + kk * 16 + 2 * t;
      mma_bf16(acc[j], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// out (16 x HD, n-tiles of 8) += X . B for one warp, X the 16 x (8 * NJ)
// f32 accumulator tile x (split hi + lo), B the 8 * NJ smem rows at b_rows
// (row-major, LD, HD columns).
template <int HD, int LD, int NJ>
__device__ __forceinline__ void mma_xb(float (&out)[HD / 8][4], float (&x)[NJ][4],
                                       const __nv_bfloat16* b_rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t hi[4], lo[4];
    split2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
    const __nv_bfloat16* bp = b_rows + (16 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      const __nv_bfloat16* c = bp + 8 * jd;
      const uint32_t b0 = pack_raw(c[0], c[LD]), b1 = pack_raw(c[8 * LD], c[9 * LD]);
      mma_bf16(out[jd], hi, b0, b1);
      mma_bf16(out[jd], lo, b0, b1);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(128) fa_bwd_dkv_mma(Args a) {
  constexpr int LD = HD + 8;     // 16-byte rows, conflict-free fragment loads
  constexpr int ND = HD / 8;
  constexpr int QW = 32;         // q columns of S^T per pass (two per q tile)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * LD;
  __nv_bfloat16* Qs = Vs + kTile * LD;
  __nv_bfloat16* Os = Qs + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(Os + kTile * LD);
  float* delta_s = lse_s + kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t c = blockIdx.x;
  const int64_t b = c / a.hkv, kvh = c % a.hkv;
  const int64_t group = a.hq / a.hkv;
  const int64_t k_start = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t q_stride = a.hq * HD, kv_stride = a.hkv * HD;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + (b * a.sk * a.hkv + kvh) * HD;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + (b * a.sk * a.hkv + kvh) * HD;
  load_tile<__nv_bfloat16, HD, LD, 128>(Ks, kg, kv_stride, k_start, a.sk);
  load_tile<__nv_bfloat16, HD, LD, 128>(Vs, vg, kv_stride, k_start, a.sk);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[jd][e] = dv[jd][e] = 0.f;

  const int64_t kp0 = k_start + warp * 16 + g, kp1 = kp0 + 8;   // this thread's two keys
  const int64_t nq = (a.sq + kTile - 1) / kTile;
  for (int64_t j = 0; j < group; ++j) {
    const int64_t h = kvh * group + j;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + (b * a.sq * a.hq + h) * HD;
    const __nv_bfloat16* og =
        static_cast<const __nv_bfloat16*>(a.dout) + (b * a.sq * a.hq + h) * HD;
    const float* lse_g = a.lse + (b * a.hq + h) * a.sq;
    const float* delta_g = a.delta + (b * a.hq + h) * a.sq;
    for (int64_t qt = first_q_tile(a, k_start); qt < nq; ++qt) {
      const int64_t row0 = qt * kTile, q_start = a.q_offset + row0;
      if (!tile_live(a, q_start, k_start)) {
        if (window_passed(a, q_start, k_start)) break;
        continue;
      }
      __syncthreads();   // the previous tile's readers are done
      load_tile<__nv_bfloat16, HD, LD, 128>(Qs, qg, q_stride, row0, a.sq);
      load_tile<__nv_bfloat16, HD, LD, 128>(Os, og, q_stride, row0, a.sq);
      load_vec<128>(lse_s, lse_g, row0, a.sq);
      load_vec<128>(delta_s, delta_g, row0, a.sq);
      __syncthreads();
#pragma unroll
      for (int half = 0; half < kTile / QW; ++half) {
        const int c0 = half * QW;
        float s[QW / 8][4], dp[QW / 8][4];
#pragma unroll
        for (int jj = 0; jj < QW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
        mma_abt<HD, LD, QW / 8>(s, Ks + warp * 16 * LD, Qs + c0 * LD);    // S^T
        mma_abt<HD, LD, QW / 8>(dp, Vs + warp * 16 * LD, Os + c0 * LD);   // dP^T
#pragma unroll
        for (int jj = 0; jj < QW / 8; ++jj) {
          const int qc = c0 + 8 * jj + 2 * t;
          const int64_t qr = row0 + qc;
          s[jj][0] = prob(a, s[jj][0], lse_s[qc], qr, kp0);
          s[jj][1] = prob(a, s[jj][1], lse_s[qc + 1], qr + 1, kp0);
          s[jj][2] = prob(a, s[jj][2], lse_s[qc], qr, kp1);
          s[jj][3] = prob(a, s[jj][3], lse_s[qc + 1], qr + 1, kp1);
          dp[jj][0] = s[jj][0] * (dp[jj][0] - delta_s[qc]);
          dp[jj][1] = s[jj][1] * (dp[jj][1] - delta_s[qc + 1]);
          dp[jj][2] = s[jj][2] * (dp[jj][2] - delta_s[qc]);
          dp[jj][3] = s[jj][3] * (dp[jj][3] - delta_s[qc + 1]);
        }
        mma_xb<HD, LD, QW / 8>(dv, s, Os + c0 * LD);    // dV += P^T . dO
        mma_xb<HD, LD, QW / 8>(dk, dp, Qs + c0 * LD);   // dK += dS^T . Q
      }
    }
  }

  float* dkg = a.dk + (b * a.sk * a.hkv + kvh) * HD;
  float* dvg = a.dv + (b * a.sk * a.hkv + kvh) * HD;
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) {
    const int col = 8 * jd + 2 * t;
    if (kp0 < a.sk) {
      *reinterpret_cast<float2*>(dkg + kp0 * kv_stride + col) =
          make_float2(dk[jd][0] * a.scale, dk[jd][1] * a.scale);
      *reinterpret_cast<float2*>(dvg + kp0 * kv_stride + col) = make_float2(dv[jd][0], dv[jd][1]);
    }
    if (kp1 < a.sk) {
      *reinterpret_cast<float2*>(dkg + kp1 * kv_stride + col) =
          make_float2(dk[jd][2] * a.scale, dk[jd][3] * a.scale);
      *reinterpret_cast<float2*>(dvg + kp1 * kv_stride + col) = make_float2(dv[jd][2], dv[jd][3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(128) fa_bwd_dq_mma(Args a) {
  constexpr int LD = HD + 8;
  constexpr int ND = HD / 8;
  constexpr int NJ = kTile / 8;   // n-tiles of S over a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + kTile * LD;
  __nv_bfloat16* Ks = Os + kTile * LD;
  __nv_bfloat16* Vs = Ks + kTile * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t kvh = h / (a.hq / a.hkv);
  // heaviest causal tiles first
  const int64_t row0 = (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kTile;
  const int64_t q_start = a.q_offset + row0;
  const int64_t q_stride = a.hq * HD, kv_stride = a.hkv * HD;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + (b * a.sq * a.hq + h) * HD;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(a.dout) + (b * a.sq * a.hq + h) * HD;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + (b * a.sk * a.hkv + kvh) * HD;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + (b * a.sk * a.hkv + kvh) * HD;
  load_tile<__nv_bfloat16, HD, LD, 128>(Qs, qg, q_stride, row0, a.sq);
  load_tile<__nv_bfloat16, HD, LD, 128>(Os, og, q_stride, row0, a.sq);

  const int64_t r0 = row0 + warp * 16 + g, r1 = r0 + 8;   // this thread's two rows
  const float* lse_g = a.lse + bh * a.sq;
  const float* delta_g = a.delta + bh * a.sq;
  const float lse0 = r0 < a.sq ? lse_g[r0] : 0.f, lse1 = r1 < a.sq ? lse_g[r1] : 0.f;
  const float dl0 = r0 < a.sq ? delta_g[r0] : 0.f, dl1 = r1 < a.sq ? delta_g[r1] : 0.f;
  float dq[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) dq[jd][0] = dq[jd][1] = dq[jd][2] = dq[jd][3] = 0.f;

  const int64_t nk = (a.sk + kTile - 1) / kTile;
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int64_t k_start = kt * kTile;
    if (!tile_live(a, q_start, k_start)) {
      if (a.causal && k_start > q_start + kTile - 1) break;   // past the diagonal
      continue;
    }
    __syncthreads();   // the previous tile's readers are done
    load_tile<__nv_bfloat16, HD, LD, 128>(Ks, kg, kv_stride, k_start, a.sk);
    load_tile<__nv_bfloat16, HD, LD, 128>(Vs, vg, kv_stride, k_start, a.sk);
    __syncthreads();
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<HD, LD, NJ>(s, Qs + warp * 16 * LD, Ks);    // S
    mma_abt<HD, LD, NJ>(dp, Os + warp * 16 * LD, Vs);   // dP
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int64_t kp = k_start + 8 * j + 2 * t;
      const float p0 = prob(a, s[j][0], lse0, r0, kp), p1 = prob(a, s[j][1], lse0, r0, kp + 1);
      const float p2 = prob(a, s[j][2], lse1, r1, kp), p3 = prob(a, s[j][3], lse1, r1, kp + 1);
      s[j][0] = p0 * (dp[j][0] - dl0);
      s[j][1] = p1 * (dp[j][1] - dl0);
      s[j][2] = p2 * (dp[j][2] - dl1);
      s[j][3] = p3 * (dp[j][3] - dl1);
    }
    mma_xb<HD, LD, NJ>(dq, s, Ks);   // dQ += dS . K
  }

  float* dqg = a.dq + (b * a.sq * a.hq + h) * HD;
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) {
    const int col = 8 * jd + 2 * t;
    if (r0 < a.sq)
      *reinterpret_cast<float2*>(dqg + r0 * q_stride + col) =
          make_float2(dq[jd][0] * a.scale, dq[jd][1] * a.scale);
    if (r1 < a.sq)
      *reinterpret_cast<float2*>(dqg + r1 * q_stride + col) =
          make_float2(dq[jd][2] * a.scale, dq[jd][3] * a.scale);
  }
}

// ---------------------------------------------------------------- f32 (SIMT)

constexpr int kPLD = kTile + 1;   // P / dS rows in shared memory

// P and dS of a (64 q rows from row0) x (64 keys from k_start) tile into
// shared memory, from the Q, dO, K, V tiles (rows of LD floats) and the
// tile's lse and delta; 256 threads, each 4 x 4 entries.
template <int HD, int LD>
__device__ __forceinline__ void simt_p_ds(const Args& a, const float* Qs, const float* Os,
                                          const float* Ks, const float* Vs, const float* lse_s,
                                          const float* delta_s, float* Ps, float* dSs,
                                          int64_t row0, int64_t k_start) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 2) {
    float2 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float2*>(Qs + (ty + 16 * i) * LD + d);
      ov[i] = *reinterpret_cast<const float2*>(Os + (ty + 16 * i) * LD + d);
      kv[i] = *reinterpret_cast<const float2*>(Ks + (tx + 16 * i) * LD + d);
      vv[i] = *reinterpret_cast<const float2*>(Vs + (tx + 16 * i) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
        dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = tx + 16 * j;
      const float p = prob(a, s[i][j], lse_s[qi], row0 + qi, k_start + kj);
      Ps[qi * kPLD + kj] = p;
      dSs[qi * kPLD + kj] = p * (dp[i][j] - delta_s[qi]);
    }
  }
}

template <int HD>
constexpr size_t simt_smem() {
  return (4 * kTile * (HD + 2) + 2 * kTile * kPLD + 2 * kTile) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(256) fa_bwd_dkv_simt(Args a) {
  constexpr int LD = HD + 2;
  constexpr int NJ = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* Os = Qs + kTile * LD;
  float* Ps = Os + kTile * LD;
  float* dSs = Ps + kTile * kPLD;
  float* lse_s = dSs + kTile * kPLD;
  float* delta_s = lse_s + kTile;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t c = blockIdx.x;
  const int64_t b = c / a.hkv, kvh = c % a.hkv;
  const int64_t group = a.hq / a.hkv;
  const int64_t k_start = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t q_stride = a.hq * HD, kv_stride = a.hkv * HD;
  const float* kg = static_cast<const float*>(a.k) + (b * a.sk * a.hkv + kvh) * HD;
  const float* vg = static_cast<const float*>(a.v) + (b * a.sk * a.hkv + kvh) * HD;
  load_tile<float, HD, LD, 256>(Ks, kg, kv_stride, k_start, a.sk);
  load_tile<float, HD, LD, 256>(Vs, vg, kv_stride, k_start, a.sk);

  float dk[4][NJ], dv[4][NJ];   // keys ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int64_t nq = (a.sq + kTile - 1) / kTile;
  for (int64_t j = 0; j < group; ++j) {
    const int64_t h = kvh * group + j;
    const float* qg = static_cast<const float*>(a.q) + (b * a.sq * a.hq + h) * HD;
    const float* og = static_cast<const float*>(a.dout) + (b * a.sq * a.hq + h) * HD;
    const float* lse_g = a.lse + (b * a.hq + h) * a.sq;
    const float* delta_g = a.delta + (b * a.hq + h) * a.sq;
    for (int64_t qt = first_q_tile(a, k_start); qt < nq; ++qt) {
      const int64_t row0 = qt * kTile, q_start = a.q_offset + row0;
      if (!tile_live(a, q_start, k_start)) {
        if (window_passed(a, q_start, k_start)) break;
        continue;
      }
      __syncthreads();
      load_tile<float, HD, LD, 256>(Qs, qg, q_stride, row0, a.sq);
      load_tile<float, HD, LD, 256>(Os, og, q_stride, row0, a.sq);
      load_vec<256>(lse_s, lse_g, row0, a.sq);
      load_vec<256>(delta_s, delta_g, row0, a.sq);
      __syncthreads();
      simt_p_ds<HD, LD>(a, Qs, Os, Ks, Vs, lse_s, delta_s, Ps, dSs, row0, k_start);
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[qq * kPLD + ty + 16 * i];
          dsv[i] = dSs[qq * kPLD + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float ov = Os[qq * LD + tx + 16 * jj], qv = Qs[qq * LD + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][jj] = fmaf(pv[i], ov, dv[i][jj]);
            dk[i][jj] = fmaf(dsv[i], qv, dk[i][jj]);
          }
        }
      }
    }
  }

  float* dkg = a.dk + (b * a.sk * a.hkv + kvh) * HD;
  float* dvg = a.dv + (b * a.sk * a.hkv + kvh) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k_start + ty + 16 * i;
    if (key >= a.sk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      dkg[key * kv_stride + tx + 16 * jj] = dk[i][jj] * a.scale;
      dvg[key * kv_stride + tx + 16 * jj] = dv[i][jj];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(256) fa_bwd_dq_simt(Args a) {
  constexpr int LD = HD + 2;
  constexpr int NJ = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + kTile * LD;
  float* Ks = Os + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  float* dSs = Ps + kTile * kPLD;
  float* lse_s = dSs + kTile * kPLD;
  float* delta_s = lse_s + kTile;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t kvh = h / (a.hq / a.hkv);
  const int64_t row0 = (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kTile;
  const int64_t q_start = a.q_offset + row0;
  const int64_t q_stride = a.hq * HD, kv_stride = a.hkv * HD;
  const float* qg = static_cast<const float*>(a.q) + (b * a.sq * a.hq + h) * HD;
  const float* og = static_cast<const float*>(a.dout) + (b * a.sq * a.hq + h) * HD;
  const float* kg = static_cast<const float*>(a.k) + (b * a.sk * a.hkv + kvh) * HD;
  const float* vg = static_cast<const float*>(a.v) + (b * a.sk * a.hkv + kvh) * HD;
  load_tile<float, HD, LD, 256>(Qs, qg, q_stride, row0, a.sq);
  load_tile<float, HD, LD, 256>(Os, og, q_stride, row0, a.sq);
  load_vec<256>(lse_s, a.lse + bh * a.sq, row0, a.sq);
  load_vec<256>(delta_s, a.delta + bh * a.sq, row0, a.sq);

  float dq[4][NJ];   // rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int64_t nk = (a.sk + kTile - 1) / kTile;
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int64_t k_start = kt * kTile;
    if (!tile_live(a, q_start, k_start)) {
      if (a.causal && k_start > q_start + kTile - 1) break;
      continue;
    }
    __syncthreads();
    load_tile<float, HD, LD, 256>(Ks, kg, kv_stride, k_start, a.sk);
    load_tile<float, HD, LD, 256>(Vs, vg, kv_stride, k_start, a.sk);
    __syncthreads();
    simt_p_ds<HD, LD>(a, Qs, Os, Ks, Vs, lse_s, delta_s, Ps, dSs, row0, k_start);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * kPLD + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float kv = Ks[kk * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][jj] = fmaf(dsv[i], kv, dq[i][jj]);
      }
    }
  }

  float* dqg = a.dq + (b * a.sq * a.hq + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dqg[row * q_stride + tx + 16 * jj] = dq[i][jj] * a.scale;
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
size_t mma_smem() {
  return 4 * kTile * (HD + 8) * sizeof(__nv_bfloat16) + 2 * kTile * sizeof(float);
}

bool bad_shape(int64_t b, int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t q_offset) {
  return b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || q_offset < 0 ||
         b * hq > 0x7fffffff || (sq + kTile - 1) / kTile > 65535 ||
         (sk + kTile - 1) / kTile > 65535;
}

}  // namespace

extern "C" {

// q, dout: (b, sq, hq, hd); k, v: (b, sk, hkv, hd), contiguous, of one dtype
// (0: f32, 1: bf16); lse, delta: (b, hq, sq) f32; dk, dv: (b, sk, hkv, hd)
// f32, written whole.  hd is 64 or 128, hq a multiple of hkv, window <= 0 for
// none.  Returns the cudaError_t of the launch.
int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, float* dk, float* dv, int64_t b, int64_t sq, int64_t sk,
               int64_t hq, int64_t hkv, int64_t hd, int64_t q_offset, int causal, int64_t window,
               float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, sk, hq, hkv, q_offset)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, sq, sk, hq, hkv, q_offset, window,
               causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(b * hkv), static_cast<unsigned>((sk + kTile - 1) / kTile));
  if (dtype == 0 && hd == 64) return launch(fa_bwd_dkv_simt<64>, grid, 256, simt_smem<64>(), a, s);
  if (dtype == 0 && hd == 128)
    return launch(fa_bwd_dkv_simt<128>, grid, 256, simt_smem<128>(), a, s);
  if (dtype == 1 && hd == 64) return launch(fa_bwd_dkv_mma<64>, grid, 128, mma_smem<64>(), a, s);
  if (dtype == 1 && hd == 128) return launch(fa_bwd_dkv_mma<128>, grid, 128, mma_smem<128>(), a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As fa_bwd_dkv; dq: (b, sq, hq, hd) f32, written whole.
int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, float* dq, int64_t b, int64_t sq, int64_t sk, int64_t hq,
              int64_t hkv, int64_t hd, int64_t q_offset, int causal, int64_t window, float scale,
              int dtype, void* stream) {
  if (bad_shape(b, sq, sk, hq, hkv, q_offset)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, sq, sk, hq, hkv, q_offset, window,
               causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(b * hq), static_cast<unsigned>((sq + kTile - 1) / kTile));
  if (dtype == 0 && hd == 64) return launch(fa_bwd_dq_simt<64>, grid, 256, simt_smem<64>(), a, s);
  if (dtype == 0 && hd == 128)
    return launch(fa_bwd_dq_simt<128>, grid, 256, simt_smem<128>(), a, s);
  if (dtype == 1 && hd == 64) return launch(fa_bwd_dq_mma<64>, grid, 128, mma_smem<64>(), a, s);
  if (dtype == 1 && hd == 128) return launch(fa_bwd_dq_mma<128>, grid, 128, mma_smem<128>(), a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
