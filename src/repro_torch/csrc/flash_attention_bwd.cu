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
// bf16 (the training path): warp-specialised wgmma kernels on hopper.cuh,
// 384 threads, one CTA per SM.  Warpgroup 0 is the producer (setmaxnreg 24);
// warpgroups 1 and 2 are the consumers (setmaxnreg 240), each owning 64 of
// the CTA's 128 rows, the native wgmma M.  Q.K^T and dO.V^T take the bf16
// inputs, which the reference casts to f32 exactly: these products are
// exact.  The three products with p or ds (P^T.dO, dS^T.Q, dS.K) have f32
// operands in the reference; here p and ds are split as hi + lo, two bf16
// values whose sum is the f32 value to about 2^-16 relative, and each
// product is two wgmma (hi, then lo, A from registers) into one f32 sum --
// not FlashAttention-2's single bf16 rounding of p and ds.  4-D TMA maps over
// (hd, H, S, B) read the model's layout in place with the 128-byte swizzle
// (boxes of 64 columns, rows past S zero-filled); exp is ex2 with log2(e)
// folded into the scale and lse.
//   fa_bwd_dkv_wgmma: one CTA per (batch * kv head, 128-key tile), heaviest
//     causal tiles first.  The producer's thread 0 loads K and V once, then
//     streams the live 64-row Q and dO tiles of each of the g = Hq / Hkv q
//     heads of the kv head through a 3-stage ring (a full and an empty
//     mbarrier per stage).  Each consumer, on its 64 keys and each tile:
//     S^T = K.Q^T and dP^T = V.dO^T by wgmma m64n64k16, both operands K-major
//     in shared memory; meanwhile its threads load the tile's lse (times
//     log2 e) and delta with plain loads (a (B, Hq, Sq) f32 row is 16-byte
//     aligned only when Sq is a multiple of 4: no TMA) into a buffer of its
//     own; P^T and dS^T in the accumulators (lse and delta by column, the q
//     row; masks only on tiles across the diagonal, the window
//     edge, Sq or Sk; a 64 x 64 block that _block_live calls dead is
//     skipped); then dV += P^T.dO, started as soon as P^T's fragments
//     exist, and dK += dS^T.Q by m64n{hd}k16 with the dO and Q tiles read as
//     the MN-major B.  dK and dV (64 + 64 f32 registers a thread at hd 128)
//     sum over the group's heads: no atomics.
//   fa_bwd_dq_wgmma: one CTA per (batch * q head, 128-row q tile), heaviest
//     causal tiles first.  The producer loads Q and dO once and then the live
//     64-key K and V tiles through a 3-stage ring, K and V each with a full
//     and an empty mbarrier (V goes back once dP has read it).  Each
//     consumer, on its 64 rows and its own live key tiles: S = Q.K^T and dP =
//     dO.V^T (K-major), dS in registers with lse and delta per row, dQ +=
//     dS.K with the K tile as the MN-major B.  Step u starts S_u and dP_u
//     beside dS_{u-1}.K_{u-1} and forms dS_u while that product is in flight
//     (the first and last steps peeled, so ptxas sees which wgmma groups are
//     outstanding); the two consumers take turns to start their products
//     (named barriers), so one's dS runs while the other's products hold the
//     tensor cores.  64-key tiles keep dQ, S, dP and the hi + lo fragments
//     in registers (64 + 32 + 32 + 32 a thread at hd 128).
//   hd 32 (lm-8m) and hd 16 (the smoke configs) take the hd-64 tiles
//   (flash_common.cuh, tile_cols): TMA zero-fills columns hd-63 of every Q,
//   dO, K and V tile; S and dP run their 2 (1) real k-steps of 16 only, while
//   dV, dK and dQ run at n = 64, half (three quarters) of it on the zero
//   columns, whose sums are never stored (store_rows writes hd columns).
//   hd 120 (h2o-danube-3-4b) takes the hd-128 tiles the same way: the maps
//   span 120 columns (rows of 240 bytes) and TMA zero-fills columns 120-127
//   of every tile; S and dP run 8 k-steps, the last over columns 112-127;
//   dV, dK and dQ run at n = 128 and their columns 120-127 (zero) are not
//   stored, so an f32 output row of one head never reaches the next head's
//   first columns.  Registers and shared memory are hd 128's.
//   f32: fa_bwd_dkv_simt, one CTA per (batch * kv head, 64-key tile) over the
//     group's q heads and their live 64-row q tiles, and fa_bwd_dq_simt, one
//     CTA per (batch * q head, 64-row q tile) over its live 64-key tiles; 256
//     threads, SIMT f32 FMAs (no TF32): each thread 4 x 4 entries of S and
//     dP, P and dS through shared memory, then 4 rows x ceil(hd/16) columns
//     of the output sums (at hd 120 the columns past 119 read zeros and are
//     not stored).  Neither main path runs them.
//
// Bound (the training path, bf16, causal): operations.  Per live (q, k) pair
// fa_bwd_dkv does 4 products of 2 * hd flops (S, dP, dV, dK) and fa_bwd_dq 3
// (S, dP, dQ), at 989 TFLOP/s dense bf16; bytes (q, k, v, do once, lse,
// delta, f32 outputs) are a tenth of that time at (1, 4096, 32/8, 128).  The
// hi + lo split makes the kernels issue 12 * hd and 8 * hd flops a pair, so
// at the tensor cores' peak they reach 67% and 75% of the bound.  What the
// design leaves: a dK/dV consumer waits for each of its product groups (the
// registers of dK, dV and the next tile's S^T and dP^T do not fit together
// at hd 128), so only the other consumer's work overlaps its elementwise
// pass (turns, as in the dQ kernel, measured slower there and cost a
// spill); each CTA's prologue and epilogue run alone (no persistent CTAs); each
// Q and dO tile is read once per 128-key tile and each K and V tile once per
// 128-row q tile (L2 serves the repeats).
#include "flash_common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------ bf16 (wgmma)

constexpr int kBlock = 128;          // keys of a dK/dV CTA; q rows of a dQ CTA
constexpr int kStrip = kTile;        // q rows (dK/dV) or keys (dQ) of a ring tile
constexpr int kStages = 3;           // depth of the rings
constexpr int kConsumerWarps = 8;
constexpr int kTurn = 3;             // dQ: named barriers 3, 4 (dK/dV: 1, 2)
constexpr float kLog2e = 1.4426950408889634f;

// One 64-column TMA box of `rows` rows (128-byte rows, swizzled).
__host__ __device__ constexpr int box_bytes(int rows) { return rows * 128; }

// Offsets in the (1024-aligned) dynamic shared memory.
template <int HD>
struct DkvSmem {
  static constexpr int kKVTile = tile_cols(HD) / 64 * box_bytes(kBlock);   // 128 keys of hd
  static constexpr int kQTile = tile_cols(HD) / 64 * box_bytes(kStrip);    // 64 q rows of hd
  static constexpr int kK = 0;
  static constexpr int kV = kKVTile;
  static constexpr int kQ = 2 * kKVTile;                        // the ring: Q, dO
  static constexpr int kO = kQ + kStages * kQTile;
  static constexpr int kRows = kO + kStages * kQTile;           // [lse, delta] x 2 a consumer
  static constexpr int kBars = kRows + 2 * 2 * 2 * kStrip * 4;  // full, empty per stage; K/V
  static constexpr int kBytes = kBars + 128 + 1024;             // + alignment slack
};

template <int HD>
struct DqSmem {
  static constexpr int kQTile = tile_cols(HD) / 64 * box_bytes(kBlock);    // 128 q rows of hd
  static constexpr int kKTile = tile_cols(HD) / 64 * box_bytes(kStrip);    // 64 keys of hd
  static constexpr int kQ = 0;
  static constexpr int kO = kQTile;
  static constexpr int kK = 2 * kQTile;                         // the ring: K, V
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBars = kV + kStages * kKTile;           // K, V full and empty; Q/dO
  static constexpr int kBytes = kBars + 128 + 1024;
};

struct Range {
  int lo, hi;   // empty when lo > hi
};

// The live 64-row q tiles of a dK/dV CTA's 128 keys from k_start: live for
// its first 64 keys under a causal mask, for its last 64 under a window.
__device__ __forceinline__ Range q_span(const Args& a, int64_t k_start) {
  int64_t lo = 0, hi = (a.sq + kStrip - 1) / kStrip - 1;
  if (a.causal) {
    const int64_t need = k_start - a.q_offset - (kStrip - 1);   // q_start >= need
    lo = need <= 0 ? 0 : (need + kStrip - 1) / kStrip;
  }
  if (a.window > 0) {
    const int64_t x = k_start + kBlock - 1 + a.window - a.q_offset;   // q_start - q_offset < x
    hi = x <= 0 ? -1 : min(hi, (x - 1) / kStrip);
  }
  return {static_cast<int>(lo), static_cast<int>(hi)};
}

// The live 64-key tiles of `rows` q rows from position q0.
__device__ __forceinline__ Range key_span(const Args& a, int64_t q0, int rows) {
  int64_t lo = 0, hi = (a.sk + kStrip - 1) / kStrip - 1;
  if (a.causal) hi = min(hi, (q0 + rows - 1) / kStrip);
  if (a.window > 0) {
    const int64_t x = q0 - a.window - (kStrip - 1);   // live iff k_start > x
    lo = x < 0 ? 0 : x / kStrip + 1;
  }
  return {static_cast<int>(lo), static_cast<int>(hi)};
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x, y as hi + lo bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_round(x, y);
  lo = pack_round(x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
}

// The wgmma A fragments, hi and lo, of a 64 x 64 f32 accumulator tile x:
// k-step kk takes its n-tiles 2kk and 2kk + 1.
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) split2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

// acc = A . B^T over hd: A and B 64-row K-major tiles at descriptors a and b,
// whose 64-column boxes lie a_box and b_box bytes apart.
template <int HD>
__device__ __forceinline__ void mma_kmajor(float (&acc)[32], uint64_t a, int a_box, uint64_t b,
                                           int b_box) {
#pragma unroll
  for (int kk = 0; kk < k_steps(HD); ++kk) {
    const int col = (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(acc, a + (((kk / 4) * a_box + col) >> 4),
                               b + (((kk / 4) * b_box + col) >> 4), kk > 0);
  }
}

// d += X . B: X the 64 x 64 tile whose A fragments are hi + lo (two wgmma per
// k-step into one f32 sum), B 64 rows of hd at descriptor b read MN-major
// (at hd 32 the tile's 64 columns, the upper 32 zero; at hd 120 its 128, the
// last 8 zero).
template <int HD>
__device__ __forceinline__ void mma_mn(float (&d)[tile_cols(HD) / 2], const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4], uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bk = b + ((kk * 16 * 128) >> 4);
    if constexpr (tile_cols(HD) == 128) {
      hopper::wgmma_m64n128k16_rs_mn(d, hi[kk], bk);
      hopper::wgmma_m64n128k16_rs_mn(d, lo[kk], bk);
    } else {
      hopper::wgmma_m64n64k16_rs_mn(d, hi[kk], bk);
      hopper::wgmma_m64n64k16_rs_mn(d, lo[kk], bk);
    }
  }
}

// Rows (or keys) r0, r0 + 8 of a warp's f32 output tile to global memory,
// scaled; rows at or past n, and a 64-column tile's columns past hd, are not
// written.
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, int64_t stride,
                                           const float (&x)[tile_cols(HD) / 2],
                                           int64_t r0, int64_t n, float scale, int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < n)
      *reinterpret_cast<float2*>(dst + r0 * stride + col) =
          make_float2(x[4 * j] * scale, x[4 * j + 1] * scale);
    if (r0 + 8 < n)
      *reinterpret_cast<float2*>(dst + (r0 + 8) * stride + col) =
          make_float2(x[4 * j + 2] * scale, x[4 * j + 3] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(384, 1)
    fa_bwd_dkv_wgmma(const Args a, const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  using L = DkvSmem<HD>;
  constexpr int TD = tile_cols(HD);
  constexpr int NO = TD / 2;               // dK (and dV) accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int b = blockIdx.x / static_cast<int>(a.hkv), kvh = blockIdx.x % static_cast<int>(a.hkv);
  const int group = static_cast<int>(a.hq / a.hkv);
  const int k_start = blockIdx.y * kBlock;   // heaviest causal tiles first
  const Range span = q_span(a, k_start);
  const int nqt = max(0, span.hi - span.lo + 1);
  const int n = group * nqt;                 // ring tiles: q tile span.lo + i % nqt of head i / nqt

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init(kvbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: K and V once; then, for each head of the group, its live
    // Q and dO tiles
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensormap(&qmap);
      hopper::prefetch_tensormap(&omap);
      hopper::mbar_expect_tx(kvbar, 2 * L::kKVTile);
      for (int j = 0; j < TD / 64; ++j) {
        hopper::tma_load_4d(base + L::kK + j * box_bytes(kBlock), &kmap, kvbar, 64 * j, kvh,
                            k_start, b);
        hopper::tma_load_4d(base + L::kV + j * box_bytes(kBlock), &vmap, kvbar, 64 * j, kvh,
                            k_start, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        const int h = kvh * group + i / nqt, row0 = (span.lo + i % nqt) * kStrip;
        hopper::mbar_expect_tx(&full[s], 2 * L::kQTile);
        for (int j = 0; j < TD / 64; ++j) {
          const int off = s * L::kQTile + j * box_bytes(kStrip);
          hopper::tma_load_4d(base + L::kQ + off, &qmap, &full[s], 64 * j, h, row0, b);
          hopper::tma_load_4d(base + L::kO + off, &omap, &full[s], 64 * j, h, row0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each
    hopper::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kc = k_start + 64 * c;                    // this warpgroup's first key
    const int kp0 = kc + 16 * warp + g, kp1 = kp0 + 8;  // this thread's keys
    const int sq = static_cast<int>(a.sq), sk = static_cast<int>(a.sk);
    const int q_offset = static_cast<int>(a.q_offset), window = static_cast<int>(a.window);
    const float sl2 = a.scale * kLog2e;
    // K-major: this warpgroup's K and V rows as A, the Q and dO tiles as B;
    // MN-major (LBO: the next box): the Q and dO tiles as B of dS^T.Q and
    // P^T.dO.  V, dO and the MN-major forms differ from ak and bq by constants.
    const uint64_t ak = hopper::desc_sw128(base + L::kK + c * box_bytes(64), 16, 1024);
    const uint64_t bq = hopper::desc_sw128(base + L::kQ, 16, 1024);
    constexpr uint64_t kToV = (L::kV - L::kK) >> 4, kToO = (L::kO - L::kQ) >> 4;
    constexpr uint64_t kToMn = static_cast<uint64_t>((box_bytes(kStrip) - 16) >> 4) << 16;
    // each live tile's lse (times log2 e) and delta, staged by this warpgroup
    // in two buffers of [lse, delta] taken in turn
    float* rows_s = reinterpret_cast<float*>(base + L::kRows) + c * 2 * 2 * kStrip;
    const int64_t head0 = static_cast<int64_t>(b) * a.hq + static_cast<int64_t>(kvh) * group;
    int live = 0;

    float dk[NO], dv[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) dk[j] = dv[j] = 0.f;
    hopper::mbar_wait(kvbar, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
      const int row0 = (span.lo + i % nqt) * kStrip, q_start = q_offset + row0;
      if (tile_live(a, q_start, kc)) {
        // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns q rows
        float st[32], dpt[32];
        const uint64_t so = (s * L::kQTile) >> 4;
        hopper::wgmma_fence();
        mma_kmajor<HD>(st, ak, box_bytes(kBlock), bq + so, box_bytes(kStrip));
        mma_kmajor<HD>(dpt, ak + kToV, box_bytes(kBlock), bq + kToO + so, box_bytes(kStrip));
        hopper::wgmma_commit();
        // the tile's lse and delta, loaded while the products run
        float* l2 = rows_s + (live++ & 1) * 2 * kStrip;
        const float* dl = l2 + kStrip;
        {
          const int row = row0 + (tid & (kStrip - 1));
          const int64_t at = (head0 + i / nqt) * a.sq + row;
          l2[tid] = row >= sq ? 0.f : tid < kStrip ? a.lse[at] * kLog2e : a.delta[at];
        }
        hopper::named_barrier_sync(1 + c, 128);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        // P^T and dS^T in place; lse and delta by column (the q row).  Masks
        // only on tiles across the diagonal, the window edge, Sq or Sk.
        const bool edge = row0 + kStrip > sq || kc + 64 > sk || (a.causal && kc + 63 > q_start) ||
                          (window > 0 && kc <= q_start + 63 - window);
        if (!edge) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 lv = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
            const float2 dlv = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = ex2(fmaf(st[4 * j + e], sl2, (e & 1) ? -lv.y : -lv.x));
              st[4 * j + e] = p;
              dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? dlv.y : dlv.x));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 lv = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
            const float2 dlv = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qr = row0 + 8 * j + 2 * t + (e & 1), kp = e < 2 ? kp0 : kp1;
              const int qp = q_offset + qr;
              float x = st[4 * j + e] * sl2;
              if ((a.causal && qp < kp) || (window > 0 && kp <= qp - window)) x = kMasked * kLog2e;
              const float p = qr >= sq || kp >= sk ? 0.f : ex2(x - ((e & 1) ? lv.y : lv.x));
              st[4 * j + e] = p;
              dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? dlv.y : dlv.x));
            }
          }
        }
        // dV += P^T.dO, started as soon as P^T's fragments exist, and
        // dK += dS^T.Q, each as hi + lo
        uint32_t ph[4][4], pl[4][4], dh[4][4], dlo[4][4];
        split_frags(st, ph, pl);
        hopper::wgmma_fence();
        mma_mn<HD>(dv, ph, pl, bq + kToMn + kToO + so);
        split_frags(dpt, dh, dlo);
        hopper::wgmma_fence();
        mma_mn<HD>(dk, dh, dlo, bq + kToMn + so);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dk);
        hopper::fence_regs(dv);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const int64_t stride = a.hkv * HD;
    const int64_t off = (static_cast<int64_t>(b) * a.sk * a.hkv + kvh) * HD;
    store_rows<HD>(a.dk + off, stride, dk, kp0, sk, a.scale, t);
    store_rows<HD>(a.dv + off, stride, dv, kp0, sk, 1.f, t);
  }
}

template <int HD>
__global__ void __launch_bounds__(384, 1)
    fa_bwd_dq_wgmma(const Args a, const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap omap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap) {
  using L = DqSmem<HD>;
  constexpr int TD = tile_cols(HD);
  constexpr int NO = TD / 2;               // dQ accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint64_t* qbar = empty_v + kStages;

  const int bh = blockIdx.x;
  const int b = bh / static_cast<int>(a.hq), h = bh % static_cast<int>(a.hq);
  const int kvh = h / static_cast<int>(a.hq / a.hkv);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBlock;   // heaviest causal tiles first
  const int q_start = static_cast<int>(a.q_offset) + row0;
  const Range span = key_span(a, q_start, kBlock);
  const int n = max(0, span.hi - span.lo + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_k[s], kConsumerWarps);
      hopper::mbar_init(&empty_v[s], kConsumerWarps);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: Q and dO once, then K and V of each live key tile, each
    // on its own full / empty pair (V is released a dS.K earlier than K)
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensormap(&kmap);
      hopper::prefetch_tensormap(&vmap);
      hopper::mbar_expect_tx(qbar, 2 * L::kQTile);
      for (int j = 0; j < TD / 64; ++j) {
        hopper::tma_load_4d(base + L::kQ + j * box_bytes(kBlock), &qmap, qbar, 64 * j, h, row0, b);
        hopper::tma_load_4d(base + L::kO + j * box_bytes(kBlock), &omap, qbar, 64 * j, h, row0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages, ks = (span.lo + i) * kStrip;
        const uint32_t parity = (i / kStages - 1) & 1;
        if (i >= kStages) hopper::mbar_wait(&empty_k[s], parity);
        hopper::mbar_expect_tx(&full_k[s], L::kKTile);
        for (int j = 0; j < TD / 64; ++j)
          hopper::tma_load_4d(base + L::kK + s * L::kKTile + j * box_bytes(kStrip), &kmap,
                              &full_k[s], 64 * j, kvh, ks, b);
        if (i >= kStages) hopper::mbar_wait(&empty_v[s], parity);
        hopper::mbar_expect_tx(&full_v[s], L::kKTile);
        for (int j = 0; j < TD / 64; ++j)
          hopper::tma_load_4d(base + L::kV + s * L::kKTile + j * box_bytes(kStrip), &vmap,
                              &full_v[s], 64 * j, kvh, ks, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    hopper::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q_start + 64 * c;                       // this warpgroup's first q position
    const int r0 = row0 + 64 * c + 16 * warp + g, r1 = r0 + 8;   // this thread's rows
    const int sq = static_cast<int>(a.sq), sk = static_cast<int>(a.sk);
    const int window = static_cast<int>(a.window);
    const float sl2 = a.scale * kLog2e;
    const float* lse_g = a.lse + static_cast<int64_t>(bh) * a.sq;
    const float* delta_g = a.delta + static_cast<int64_t>(bh) * a.sq;
    const float l0 = r0 < sq ? lse_g[r0] * kLog2e : 0.f, l1 = r1 < sq ? lse_g[r1] * kLog2e : 0.f;
    const float dl0 = r0 < sq ? delta_g[r0] : 0.f, dl1 = r1 < sq ? delta_g[r1] : 0.f;
    // this warpgroup's live key tiles, u0 .. u1 of the ring's 0 .. n - 1
    const Range mine = key_span(a, qw0, 64);
    const int u0 = mine.lo - span.lo, u1 = min(mine.hi, span.hi) - span.lo;
    // K-major: this warpgroup's Q and dO rows as A, the K and V tiles as B;
    // MN-major: the K tile as B of dS.K
    const uint64_t aq = hopper::desc_sw128(base + L::kQ + c * box_bytes(64), 16, 1024);
    const uint64_t ao = hopper::desc_sw128(base + L::kO + c * box_bytes(64), 16, 1024);
    const uint64_t bk = hopper::desc_sw128(base + L::kK, 16, 1024);
    const uint64_t bv = hopper::desc_sw128(base + L::kV, 16, 1024);
    const uint64_t mk = hopper::desc_sw128(base + L::kK, box_bytes(kStrip), 1024);

    float dq[NO], sc[32], dp[32];
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int j = 0; j < NO; ++j) dq[j] = 0.f;

    auto skip = [&](int u) {   // a ring tile this warpgroup does not read
      const int s = u % kStages;
      const uint32_t parity = (u / kStages) & 1;
      hopper::mbar_wait(&full_k[s], parity);
      if (lane == 0) hopper::mbar_arrive(&empty_k[s]);
      hopper::mbar_wait(&full_v[s], parity);
      if (lane == 0) hopper::mbar_arrive(&empty_v[s]);
    };
    auto start_sdp = [&](int u) {   // S = Q.K_u^T, dP = dO.V_u^T
      const int s = u % kStages;
      const uint32_t parity = (u / kStages) & 1;
      const int so = s * L::kKTile;
      hopper::mbar_wait(&full_k[s], parity);
      hopper::mbar_wait(&full_v[s], parity);
      hopper::wgmma_fence();
      mma_kmajor<HD>(sc, aq, box_bytes(kBlock), bk + (so >> 4), box_bytes(kStrip));
      mma_kmajor<HD>(dp, ao, box_bytes(kBlock), bv + (so >> 4), box_bytes(kStrip));
      hopper::wgmma_commit();
    };
    auto start_dq = [&](int u) {   // dQ += dS_u . K_u, hi then lo
      hopper::wgmma_fence();
      mma_mn<HD>(dq, fh, fl, mk + ((u % kStages * L::kKTile) >> 4));
      hopper::wgmma_commit();
    };
    auto form_ds = [&](int u) {   // S and dP of tile u have completed: dS in dp
      if (lane == 0) hopper::mbar_arrive(&empty_v[u % kStages]);   // V only fed dP
      const int ks = (span.lo + u) * kStrip;
      const bool edge = ks + kStrip > sk || (a.causal && ks + 63 > qw0) ||
                        (window > 0 && ks <= qw0 + 63 - window) || row0 + 64 * c + 64 > sq;
      if (!edge) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float p = ex2(fmaf(sc[j], sl2, (j & 2) ? -l1 : -l0));
          dp[j] = p * (dp[j] - ((j & 2) ? dl1 : dl0));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int kp = ks + 8 * (j / 4) + 2 * t + (j & 1);
          const int r = (j & 2) ? r1 : r0;
          const int qp = static_cast<int>(a.q_offset) + r;
          float x = sc[j] * sl2;
          if ((a.causal && qp < kp) || (window > 0 && kp <= qp - window)) x = kMasked * kLog2e;
          const float p = r >= sq || kp >= sk ? 0.f : ex2(x - ((j & 2) ? l1 : l0));
          dp[j] = p * (dp[j] - ((j & 2) ? dl1 : dl0));
        }
      }
    };
    auto release_k = [&](int u) {   // dS_u . K_u has completed
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      if (lane == 0) hopper::mbar_arrive(&empty_k[u % kStages]);
    };

    // The two consumers take turns to start their products (named barriers
    // kTurn + c, warpgroup 0 first), so one's dS runs while the other's
    // products hold the tensor cores.  Each start is one turn; the
    // warpgroup with fewer live key tiles pads with empty turns.
    auto my_turn = [&] { hopper::named_barrier_sync(kTurn + c, 256); };
    auto your_turn = [&] { hopper::named_barrier_arrive(kTurn + 1 - c, 256); };
    const Range other = key_span(a, q_start + 64 * (1 - c), 64);
    const int mine_turns = u1 >= u0 ? u1 - u0 + 2 : 0;
    const int total = max(mine_turns, other.hi >= other.lo ? other.hi - other.lo + 2 : 0);
    hopper::mbar_wait(qbar, 0);
    if (total > 0 && c == 1) your_turn();
    if (u1 >= u0) {
      for (int u = 0; u < u0; ++u) skip(u);
      my_turn();
      start_sdp(u0);
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      form_ds(u0);
      split_frags(dp, fh, fl);
      // step u: S_u and dP_u started beside dS_{u-1}.K_{u-1}; dS_u is formed
      // while that product is still in flight
      for (int u = u0 + 1; u <= u1; ++u) {
        my_turn();
        start_sdp(u);
        start_dq(u - 1);
        your_turn();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        form_ds(u);
        release_k(u - 1);
        split_frags(dp, fh, fl);
      }
      my_turn();
      start_dq(u1);
      your_turn();
      release_k(u1);
      for (int u = u1 + 1; u < n; ++u) skip(u);
    } else {
      for (int u = 0; u < n; ++u) skip(u);
    }
    for (int k = mine_turns; k < total; ++k) {
      my_turn();
      your_turn();
    }
    if (total > 0 && c == 0) my_turn();   // takes warpgroup 1's last turn

    const int64_t stride = a.hq * HD;
    store_rows<HD>(a.dq + (static_cast<int64_t>(b) * a.sq * a.hq + h) * HD, stride, dq, r0, sq,
                   a.scale, t);
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
  constexpr int NJ = (HD + 15) / 16;   // hd 120: columns 120-127 not stored
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
          const int col = tx + 16 * jj;
          const float ov = col < HD ? Os[qq * LD + col] : 0.f;
          const float qv = col < HD ? Qs[qq * LD + col] : 0.f;
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
      if (tx + 16 * jj >= HD) continue;
      dkg[key * kv_stride + tx + 16 * jj] = dk[i][jj] * a.scale;
      dvg[key * kv_stride + tx + 16 * jj] = dv[i][jj];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(256) fa_bwd_dq_simt(Args a) {
  constexpr int LD = HD + 2;
  constexpr int NJ = (HD + 15) / 16;   // hd 120: columns 120-127 not stored
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
        const int col = tx + 16 * jj;
        const float kv = col < HD ? Ks[kk * LD + col] : 0.f;
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
    for (int jj = 0; jj < NJ; ++jj)
      if (tx + 16 * jj < HD) dqg[row * q_stride + tx + 16 * jj] = dq[i][jj] * a.scale;
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel, typename... Maps>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s, const Args& a,
           const Maps&... maps) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(a, maps...);
  return static_cast<int>(cudaGetLastError());
}

// A 4-D map over a (b, s, h, hd) bf16 tensor: boxes of 64 columns x `rows` rows.
bool seq_map(CUtensorMap* map, const void* p, int64_t b, int64_t s, int64_t h, int64_t hd,
             uint32_t rows) {
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t dims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(h),
                            static_cast<uint64_t>(s), static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {hd * e, h * hd * e, s * h * hd * e};
  const uint32_t box[4] = {64, 1, rows, 1};
  return hopper::encode_bf16_4d(map, p, dims, strides, box);
}

template <int HD>
int launch_dkv_wgmma(const Args& a, int64_t b, cudaStream_t s) {
  CUtensorMap qm, om, km, vm;
  if (!seq_map(&qm, a.q, b, a.sq, a.hq, HD, kStrip) ||
      !seq_map(&om, a.dout, b, a.sq, a.hq, HD, kStrip) ||
      !seq_map(&km, a.k, b, a.sk, a.hkv, HD, kBlock) ||
      !seq_map(&vm, a.v, b, a.sk, a.hkv, HD, kBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(b * a.hkv),
                  static_cast<unsigned>((a.sk + kBlock - 1) / kBlock));
  return launch(fa_bwd_dkv_wgmma<HD>, grid, 384, DkvSmem<HD>::kBytes, s, a, qm, om, km, vm);
}

template <int HD>
int launch_dq_wgmma(const Args& a, int64_t b, cudaStream_t s) {
  CUtensorMap qm, om, km, vm;
  if (!seq_map(&qm, a.q, b, a.sq, a.hq, HD, kBlock) ||
      !seq_map(&om, a.dout, b, a.sq, a.hq, HD, kBlock) ||
      !seq_map(&km, a.k, b, a.sk, a.hkv, HD, kStrip) ||
      !seq_map(&vm, a.v, b, a.sk, a.hkv, HD, kStrip))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(b * a.hq),
                  static_cast<unsigned>((a.sq + kBlock - 1) / kBlock));
  return launch(fa_bwd_dq_wgmma<HD>, grid, 384, DqSmem<HD>::kBytes, s, a, qm, om, km, vm);
}

bool bad_shape(int64_t b, int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t q_offset,
               int64_t window) {
  return b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || q_offset < 0 ||
         b * hq > 0x7fffffff || (sq + kTile - 1) / kTile > 65535 ||
         (sk + kTile - 1) / kTile > 65535 || q_offset + sq > 0x7fffffff || window > 0x7fffffff;
}

}  // namespace

extern "C" {

// q, dout: (b, sq, hq, hd); k, v: (b, sk, hkv, hd), contiguous, of one dtype
// (0: f32, 1: bf16, whose pointers are 16-byte aligned for TMA); lse, delta:
// (b, hq, sq) f32; dk, dv: (b, sk, hkv, hd) f32, written whole.  hd is 16, 32,
// 64, 120 or 128, hq a multiple of hkv, window <= 0 for none.  Returns the cudaError_t
// of the launch.
int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, float* dk, float* dv, int64_t b, int64_t sq, int64_t sk,
               int64_t hq, int64_t hkv, int64_t hd, int64_t q_offset, int causal, int64_t window,
               float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, sk, hq, hkv, q_offset, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, sq, sk, hq, hkv, q_offset, window,
               causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(b * hkv), static_cast<unsigned>((sk + kTile - 1) / kTile));
  if (dtype == 0 && hd == 16) return launch(fa_bwd_dkv_simt<16>, grid, 256, simt_smem<16>(), s, a);
  if (dtype == 0 && hd == 32) return launch(fa_bwd_dkv_simt<32>, grid, 256, simt_smem<32>(), s, a);
  if (dtype == 0 && hd == 64) return launch(fa_bwd_dkv_simt<64>, grid, 256, simt_smem<64>(), s, a);
  if (dtype == 0 && hd == 120)
    return launch(fa_bwd_dkv_simt<120>, grid, 256, simt_smem<120>(), s, a);
  if (dtype == 0 && hd == 128)
    return launch(fa_bwd_dkv_simt<128>, grid, 256, simt_smem<128>(), s, a);
  if (dtype == 1 && hd == 16) return launch_dkv_wgmma<16>(a, b, s);
  if (dtype == 1 && hd == 32) return launch_dkv_wgmma<32>(a, b, s);
  if (dtype == 1 && hd == 64) return launch_dkv_wgmma<64>(a, b, s);
  if (dtype == 1 && hd == 120) return launch_dkv_wgmma<120>(a, b, s);
  if (dtype == 1 && hd == 128) return launch_dkv_wgmma<128>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As fa_bwd_dkv; dq: (b, sq, hq, hd) f32, written whole.
int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, float* dq, int64_t b, int64_t sq, int64_t sk, int64_t hq,
              int64_t hkv, int64_t hd, int64_t q_offset, int causal, int64_t window, float scale,
              int dtype, void* stream) {
  if (bad_shape(b, sq, sk, hq, hkv, q_offset, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, sq, sk, hq, hkv, q_offset, window,
               causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(b * hq), static_cast<unsigned>((sq + kTile - 1) / kTile));
  if (dtype == 0 && hd == 16) return launch(fa_bwd_dq_simt<16>, grid, 256, simt_smem<16>(), s, a);
  if (dtype == 0 && hd == 32) return launch(fa_bwd_dq_simt<32>, grid, 256, simt_smem<32>(), s, a);
  if (dtype == 0 && hd == 64) return launch(fa_bwd_dq_simt<64>, grid, 256, simt_smem<64>(), s, a);
  if (dtype == 0 && hd == 120)
    return launch(fa_bwd_dq_simt<120>, grid, 256, simt_smem<120>(), s, a);
  if (dtype == 0 && hd == 128)
    return launch(fa_bwd_dq_simt<128>, grid, 256, simt_smem<128>(), s, a);
  if (dtype == 1 && hd == 16) return launch_dq_wgmma<16>(a, b, s);
  if (dtype == 1 && hd == 32) return launch_dq_wgmma<32>(a, b, s);
  if (dtype == 1 && hd == 64) return launch_dq_wgmma<64>(a, b, s);
  if (dtype == 1 && hd == 120) return launch_dq_wgmma<120>(a, b, s);
  if (dtype == 1 && hd == 128) return launch_dq_wgmma<128>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one bf16 CTA of fa_bwd_dkv (dq = 0) or fa_bwd_dq
// (dq = 1) at head dim hd (16, 32, 64, 120 or 128), else 0.
int fa_bwd_smem_bytes(int64_t hd, int dq) {
  if (hd == 16) return dq ? DqSmem<16>::kBytes : DkvSmem<16>::kBytes;
  if (hd == 32) return dq ? DqSmem<32>::kBytes : DkvSmem<32>::kBytes;
  if (hd == 64) return dq ? DqSmem<64>::kBytes : DkvSmem<64>::kBytes;
  if (hd == 120) return dq ? DqSmem<120>::kBytes : DkvSmem<120>::kBytes;
  if (hd == 128) return dq ? DqSmem<128>::kBytes : DkvSmem<128>::kBytes;
  return 0;
}

}  // extern "C"
