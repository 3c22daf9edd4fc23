// Hopper kernels for the flash-attention forward: causal / sliding-window
// GQA attention by online softmax, writing o and the row log-sum-exp.
//
// Replaces the Pallas TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/flash_attention.py:121, body _kernel
// :50) and computes what its body computes, held within tolerance (not bit
// for bit: exp and the summation order differ) against the plain blockwise
// version in src/repro_torch/kernels/flash_attention/ref.py:
//   s    = (q . k^T in f32) * scale, scale = f32(hd^-0.5)
//   s    = -1e30 where masked (causal: q_pos < k_pos; window w:
//          k_pos <= q_pos - w) -- the reference's finite sentinel, never -inf
//   m'   = max(m, rowmax s);  p = exp(s - m');  corr = exp(m - m')
//   l    = l * corr + rowsum p           (p unrounded)
//   acc  = acc * corr + round_v(p) . v   (p rounded to v's dtype, f32 sums)
//   o    = acc / max(l, 1e-30) in q's dtype;  lse = m + log(max(l, 1e-30))
// q_pos = q_offset + row.  q-head h reads kv head h / (Hq / Hkv) (the
// reference's kv_map, :118).  A key tile that the reference's _block_live
// (:41) calls dead for a CTA's rows is not visited.  With the finite
// sentinel a row that is fully masked inside a live tile takes weight 1 per
// masked key until its first real key, whose corr = exp(-1e30 - m) = 0
// wipes them: so the result does not depend on the tile sizes, and 128- or
// 64-row tiles here agree with the reference's 512-row blocks.  Keys past
// the end of a ragged last tile do not exist: they get -inf (p = 0 exactly;
// m stays finite, it starts at -1e30), and their V rows are zero-filled.
//
// Layout: q, o (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd), contiguous -- the
// model's layout, read in place (no transposes); lse (B, Hq, Sq) f32.
// Heaviest causal tiles first (blockIdx.y counts down the q tiles).
//
// bf16 (the serving and training paths): fa_fwd_wgmma.  One CTA per
// (batch * q head, 128-row q tile), three warpgroups:
//   - warpgroup 0, the producer, gives up its registers (setmaxnreg 24);
//     one thread loads Q once and then the live K and V tiles of 128 keys
//     by TMA into a 2-stage ring, K and V each with a full and an empty
//     mbarrier per stage (K goes back a P.V earlier than V).  4-D tensor
//     maps over (hd, H, S, B) read the model's layout in place; boxes of
//     64 x 1 x 128 x 1 with the 128-byte swizzle (hd 128 is two boxes);
//     TMA zero-fills rows past S.
//   - warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 q rows
//     each, the native wgmma M.  S = Q.K^T by wgmma m64n128k16 with Q and
//     K both K-major from shared-memory descriptors; the online softmax on
//     the accumulators in registers (each warp's 16 rows have the m16n8
//     C-fragment pattern: row max over quads of lanes), exp2 with
//     scale * log2(e) folded in, masks only on tiles that cross the
//     diagonal, the window edge or sk (classified once per tile), l kept as
//     per-thread partial sums until the end; O += P.V by wgmma m64n{hd}k16
//     with P from registers (rounded to bf16, as the reference's
//     p.astype(v.dtype)) and V read from its row-major tile as the MN-major
//     B operand.  Step i starts S_i and P_{i-1}.V_{i-1} together and runs
//     tile i's softmax while P.V is in flight (the first and last steps
//     peeled, so ptxas sees which wgmma groups are outstanding and keeps
//     them asynchronous); the two consumers take turns to start them (named
//     barriers), so one's softmax overlaps the other's products.
//   - epilogue: o normalised, rounded to bf16, written swizzled into the
//     warpgroup's own rows of the Q tile and stored by TMA (rows past Sq
//     are clipped); lse by the lanes that own each row.
//   Shared memory at hd 128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) =
//   160 KB (one CTA per SM); half at hd 64.
//   hd 32 (lm-8m) and hd 16 (the smoke configs) take the hd-64 tiles: the
//   4-D maps span the tensor's 32 (16) columns with the same 64-column boxes
//   (rows of 64 (32) bytes, within TMA's 16-byte rule), so TMA zero-fills
//   the other columns of each Q, K and V tile and clips them from the o
//   store.  S = Q.K^T runs its 2 (1) real k-steps of 16 only; P.V runs at
//   n = 64, half (three quarters) of it on the zero columns (2x (4x) the
//   operations the bound counts for that product).
//   hd 120 (h2o-danube-3-4b) takes the hd-128 tiles the same way: the maps
//   span the tensor's 120 columns (rows of 240 bytes), so the second box of
//   each Q, K and V tile holds columns 64-119 and TMA zero-fills 120-127.
//   S = Q.K^T runs 8 k-steps, the last over columns 112-127, whose zero half
//   adds nothing; P.V runs at n = 128 and its columns 120-127 are zero, and
//   the o store clips them.  The registers, shared memory and schedule are
//   hd 128's; the scale is the caller's, 120^-0.5.
// f32: fa_fwd_simt, 64-row tiles, 256 threads, each 4 rows x 4 keys of S
//   and 4 rows x ceil(hd/16) columns of o with f32 FMAs (the reference's f32
//   products; no TF32); at hd 120 a thread's last column is 120-127 for half
//   the threads, which read zeros for V there and store nothing.  Neither
//   main path runs it.
//
// Bound (bf16, causal): operations -- 4 * B * Hq * hd flops per live (q, k)
// pair on the tensor cores (989 TFLOP/s dense bf16) against
// 2 * (|q| + |k| + |v| + |o|) bytes + 4 * |lse| at 3.35 TB/s.  At
// (8, 2048, 32/8, 128) that is 0.275 TFLOP against 0.18 GB: 0.278 ms by
// operations.  The design keeps the tensor cores fed: wgmma reads Q, K and
// V from shared memory with no register staging, the loads run a tile
// ahead off the consumers' path, and softmax overlaps products within and
// across warpgroups.  What it leaves: each CTA's prologue (Q and the first
// K) and epilogue are not overlapped with another tile's work (no
// persistent CTAs), the diagonal tile's masked half is computed, and each
// K/V tile is read once per q head of its group (L2 serves the repeats).
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int kBQ = kTile;          // q rows per CTA (f32)
constexpr int kBK = kTile;          // keys per tile (f32)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int64_t sq, sk, hq, hkv;
  int64_t q_offset;
  int64_t window;   // <= 0: none
  int causal;
  float scale;
};

// The reference's _block_live for a (64-row, 64-key) tile.
__device__ __forceinline__ bool tile_live(const Args& a, int64_t q_start, int64_t k_start) {
  bool run = true;
  if (a.causal) run = q_start + kBQ - 1 >= k_start;
  if (a.window > 0) run = run && (k_start + kBK - 1 > q_start - a.window);
  return run;
}

// The masked score of (q_pos, k_pos) or s itself.
__device__ __forceinline__ float mask_score(const Args& a, float s, int64_t q_pos, int64_t k_pos) {
  if (k_pos >= a.sk) return -INFINITY;   // no such key
  if (a.causal && q_pos < k_pos) return kMasked;
  if (a.window > 0 && k_pos <= q_pos - a.window) return kMasked;
  return s;
}

// ---------------------------------------------------------------- f32 (SIMT)

template <int HD>
__global__ void __launch_bounds__(256) fa_fwd_simt(Args a) {
  constexpr int LD = HD + 2;     // even: float2 loads; conflict-free columns
  constexpr int PLD = kBK + 1;
  constexpr int NJ = (HD + 15) / 16;   // output columns per thread (hd 120: the last
                                       // one's columns 120-127 are not stored)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t kvh = h / (a.hq / a.hkv);
  const int64_t qt = gridDim.y - 1 - blockIdx.y;
  const int64_t row0 = qt * kBQ;
  const int64_t q_start = a.q_offset + row0;
  const int64_t q_stride = a.hq * HD, kv_stride = a.hkv * HD;
  const float* qg = static_cast<const float*>(a.q) + (b * a.sq * a.hq + h) * HD;
  const float* kg = static_cast<const float*>(a.k) + (b * a.sk * a.hkv + kvh) * HD;
  const float* vg = static_cast<const float*>(a.v) + (b * a.sk * a.hkv + kvh) * HD;

  load_tile<float, HD, LD, 256>(Qs, qg, q_stride, row0, a.sq);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int64_t nk = (a.sk + kBK - 1) / kBK;
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int64_t k_start = kt * kBK;
    if (!tile_live(a, q_start, k_start)) continue;
    __syncthreads();   // the previous tile's readers are done
    load_tile<float, HD, LD, 256>(Ks, kg, kv_stride, k_start, a.sk);
    load_tile<float, HD, LD, 256>(Vs, vg, kv_stride, k_start, a.sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float2*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float2*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q_pos = q_start + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mask_score(a, s[i][j] * a.scale, q_pos, k_start + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        sum += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - mx);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < HD ? Vs[kk * LD + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  float* og = static_cast<float*>(a.o) + (b * a.sq * a.hq + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    if (row >= a.sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < HD) og[row * q_stride + tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) a.lse[bh * a.sq + row] = m[i] + logf(li);
  }
}


// ------------------------------------------------------------ bf16 (wgmma)

constexpr int kRows = 128;                 // q rows per CTA; keys per K/V tile
constexpr int kStages = 2;                 // depth of the K/V ring
constexpr int kBoxBytes = kRows * 128;     // one 64-column box of 128 rows
constexpr int kConsumerWarps = 8;
constexpr int kTurn = 3;                   // named barriers 3, 4 (1, 2: the epilogue's)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Offsets in the (1024-aligned) dynamic shared memory.
template <int HD>
struct Smem {
  static constexpr int kTileBytes = tile_cols(HD) / 64 * kBoxBytes;   // 128 rows of hd
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // K, V full and empty; Q
  static constexpr int kBytes = kBars + 128 + 1024;        // + alignment slack
};

// The first and last key tile _block_live keeps for the CTA's 128 rows.
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span live_span(const Args& a, int64_t q_start) {
  int64_t hi = (a.sk + kRows - 1) / kRows - 1, lo = 0;
  if (a.causal) hi = min(hi, (q_start + kRows - 1) / kRows);
  if (a.window > 0) {
    const int64_t x = q_start - a.window - (kRows - 1);   // live iff k_start > x
    lo = x < 0 ? 0 : x / kRows + 1;
  }
  return {static_cast<int>(lo), static_cast<int>(hi)};
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(384, 1)
    fa_fwd_wgmma(const Args a, const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap) {
  using L = Smem<HD>;
  constexpr int TD = tile_cols(HD);
  constexpr int NO = TD / 2;               // o accumulators per thread
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
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int q_start = static_cast<int>(a.q_offset) + row0;
  const Span span = live_span(a, q_start);
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
    // ---- producer: Q once, then K and V of each live tile, each on its
    // own full / empty barrier pair (K is released a P.V earlier than V)
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensormap(&qmap);
      hopper::prefetch_tensormap(&kmap);
      hopper::prefetch_tensormap(&vmap);
      hopper::mbar_expect_tx(qbar, L::kTileBytes);
      for (int j = 0; j < TD / 64; ++j)
        hopper::tma_load_4d(base + L::kQ + j * kBoxBytes, &qmap, qbar, 64 * j, h, row0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages, ks = (span.lo + i) * kRows;
        const uint32_t parity = (i / kStages - 1) & 1;
        if (i >= kStages) hopper::mbar_wait(&empty_k[s], parity);
        hopper::mbar_expect_tx(&full_k[s], L::kTileBytes);
        for (int j = 0; j < TD / 64; ++j)
          hopper::tma_load_4d(base + L::kK + s * L::kTileBytes + j * kBoxBytes, &kmap,
                              &full_k[s], 64 * j, kvh, ks, b);
        if (i >= kStages) hopper::mbar_wait(&empty_v[s], parity);
        hopper::mbar_expect_tx(&full_v[s], L::kTileBytes);
        for (int j = 0; j < TD / 64; ++j)
          hopper::tma_load_4d(base + L::kV + s * L::kTileBytes + j * kBoxBytes, &vmap,
                              &full_v[s], 64 * j, kvh, ks, b);
      }
    }
  } else {
    // ---- consumers
    hopper::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q_start + 64 * c;                 // this warpgroup's first q position
    const int rr0 = 16 * warp + g, rr1 = rr0 + 8;     // rows within its 64
    const int qp0 = qw0 + rr0, qp1 = qw0 + rr1;
    const int sk = static_cast<int>(a.sk), window = static_cast<int>(a.window);
    const float sl2 = a.scale * kLog2e;
    unsigned char* qs = base + L::kQ + c * (64 * 128);   // its rows of the first Q box
    const uint64_t dq = hopper::desc_sw128(qs, 16, 1024);
    const uint64_t dk = hopper::desc_sw128(base + L::kK, 16, 1024);
    const uint64_t dv = hopper::desc_sw128(base + L::kV, kBoxBytes, 1024);

    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f, c0 = 1.f, c1 = 1.f;
    float o[NO], sc[64];
    uint32_t pa[8][4];
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = 0.f;

    auto start_s = [&](int i) {   // S_i = Q . K_i^T
      const int s = i % kStages;
      hopper::mbar_wait(&full_k[s], (i / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < k_steps(HD); ++kk) {
        const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        hopper::wgmma_m64n128k16_ss(sc, dq + (off >> 4), dk + ((s * L::kTileBytes + off) >> 4),
                                    kk > 0);
      }
      hopper::wgmma_commit();
    };
    auto start_pv = [&](int i) {   // O += P_i . V_i
      const int s = i % kStages;
      hopper::mbar_wait(&full_v[s], (i / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t d = dv + ((s * L::kTileBytes + kk * 16 * 128) >> 4);
        if constexpr (TD == 128)
          hopper::wgmma_m64n128k16_rs_mn(o, pa[kk], d);
        else
          hopper::wgmma_m64n64k16_rs_mn(o, pa[kk], d);
      }
      hopper::wgmma_commit();
    };
    auto softmax = [&](int i) {   // S_i has completed: p in place, m, l, corr
      if (lane == 0) hopper::mbar_arrive(&empty_k[i % kStages]);
      // scores in base 2: unmasked tiles fold the scale into the exponent;
      // tiles across the diagonal, the window edge or sk are scaled and
      // masked here (mul = 1)
      const int ks = (span.lo + i) * kRows;
      float mul = sl2;
      if (ks + kRows > sk || (a.causal && ks + kRows - 1 > qw0) ||
          (window > 0 && ks <= qw0 + 63 - window)) {
        mul = 1.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = ks + 8 * j + 2 * t + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            float x = sc[4 * j + e] * sl2;
            if (kp >= sk)
              x = -INFINITY;
            else if ((a.causal && kp > qp) || (window > 0 && kp <= qp - window))
              x = kMasked;
            sc[4 * j + e] = x;
          }
      }
      float r0 = fmaxf(sc[0], sc[1]), r1 = fmaxf(sc[2], sc[3]);
#pragma unroll
      for (int j = 1; j < 16; ++j) {
        r0 = fmaxf(r0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        r1 = fmaxf(r1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
        r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
      }
      const float mx0 = fmaxf(m0, r0 * mul), mx1 = fmaxf(m1, r1 * mul);
      c0 = ex2(m0 - mx0);
      c1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], mul, -mx0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], mul, -mx0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], mul, -mx1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], mul, -mx1));
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
    };
    auto rescale_pack = [&]() {   // O to the new max; P as bf16 A fragments
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_round(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_round(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_round(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_round(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto release_v = [&](int i) {   // P_i . V_i has completed
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(&empty_v[i % kStages]);
    };

    // The two consumers take turns to start their products (named barriers
    // kTurn + c, warpgroup 0 first), so one's softmax runs while the
    // other's products hold the tensor cores.
    auto my_turn = [&] { hopper::named_barrier_sync(kTurn + c, 256); };
    auto your_turn = [&] { hopper::named_barrier_arrive(kTurn + 1 - c, 256); };

    hopper::mbar_wait(qbar, 0);
    if (n > 0) {
      if (c == 1) your_turn();
      my_turn();
      start_s(0);
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      softmax(0);
      rescale_pack();
      // step i: S_i and P_{i-1}.V_{i-1} started together; tile i's softmax
      // runs while P.V is still in flight
      for (int i = 1; i < n; ++i) {
        my_turn();
        start_s(i);
        start_pv(i - 1);
        your_turn();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        softmax(i);
        release_v(i - 1);
        rescale_pack();
      }
      my_turn();
      start_pv(n - 1);
      your_turn();
      release_v(n - 1);
      if (c == 0) my_turn();   // takes warpgroup 1's last turn
    }

    // ---- epilogue: o through this warpgroup's Q rows, then a TMA store
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const float i0 = 1.f / d0, i1 = 1.f / d1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      unsigned char* box = qs + (j / 8) * kBoxBytes;
      const int ch = j % 8;
      *reinterpret_cast<uint32_t*>(box + rr0 * 128 + ((ch ^ (rr0 & 7)) << 4) + 4 * t) =
          pack_round(o[4 * j] * i0, o[4 * j + 1] * i0);
      *reinterpret_cast<uint32_t*>(box + rr1 * 128 + ((ch ^ (rr1 & 7)) << 4) + 4 * t) =
          pack_round(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
    hopper::fence_proxy_async_smem();
    hopper::named_barrier_sync(1 + c, 128);
    if (tid == 0) {
      for (int j = 0; j < TD / 64; ++j)
        hopper::tma_store_4d(&omap, qs + j * kBoxBytes, 64 * j, h, row0 + 64 * c, b);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
    if (t == 0) {
      float* lse = a.lse + static_cast<int64_t>(bh) * a.sq + row0 + 64 * c;
      if (row0 + 64 * c + rr0 < a.sq) lse[rr0] = (m0 == kMasked ? kMasked : m0 * kLn2) + logf(d0);
      if (row0 + 64 * c + rr1 < a.sq) lse[rr1] = (m1 == kMasked ? kMasked : m1 * kLn2) + logf(d1);
    }
  }
}

template <int HD>
int launch_simt(const Args& a, int64_t b, cudaStream_t stream) {
  const size_t smem = (3 * kBQ * (HD + 2) + kBQ * (kBK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_simt<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b * a.hq), static_cast<unsigned>((a.sq + kBQ - 1) / kBQ));
  fa_fwd_simt<HD><<<grid, 256, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma(const Args& a, int64_t b, cudaStream_t stream) {
  using L = Smem<HD>;
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t qdims[4] = {HD, static_cast<uint64_t>(a.hq), static_cast<uint64_t>(a.sq),
                             static_cast<uint64_t>(b)};
  const uint64_t kdims[4] = {HD, static_cast<uint64_t>(a.hkv), static_cast<uint64_t>(a.sk),
                             static_cast<uint64_t>(b)};
  const uint64_t qstrides[3] = {HD * e, a.hq * HD * e, a.sq * a.hq * HD * e};
  const uint64_t kstrides[3] = {HD * e, a.hkv * HD * e, a.sk * a.hkv * HD * e};
  const uint32_t box[4] = {64, 1, kRows, 1};
  const uint32_t obox[4] = {64, 1, 64, 1};   // one consumer warpgroup's rows
  CUtensorMap qmap, kmap, vmap, omap;
  if (!hopper::encode_bf16_4d(&qmap, a.q, qdims, qstrides, box) ||
      !hopper::encode_bf16_4d(&kmap, a.k, kdims, kstrides, box) ||
      !hopper::encode_bf16_4d(&vmap, a.v, kdims, kstrides, box) ||
      !hopper::encode_bf16_4d(&omap, a.o, qdims, qstrides, obox))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b * a.hq), static_cast<unsigned>((a.sq + kRows - 1) / kRows));
  fa_fwd_wgmma<HD><<<grid, 384, L::kBytes, stream>>>(a, qmap, kmap, vmap, omap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o: (b, sq, hq, hd); k, v: (b, sk, hkv, hd), contiguous, of one dtype
// (0: f32, 1: bf16, whose pointers are 16-byte aligned for TMA); lse:
// (b, hq, sq) f32.  hd is 16, 32, 64, 120 or 128, hq a multiple of hkv, window <= 0
// for none.  Returns the cudaError_t of the launch.
int fa_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int64_t b,
           int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t hd, int64_t q_offset,
           int causal, int64_t window, float scale, int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || q_offset < 0 ||
      b * hq > 0x7fffffff || (sq + kBQ - 1) / kBQ > 65535 || q_offset + sq > 0x7fffffff ||
      sk > 0x7fffffff || window > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, sq, sk, hq, hkv, q_offset, window, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 16) return launch_simt<16>(a, b, s);
  if (dtype == 0 && hd == 32) return launch_simt<32>(a, b, s);
  if (dtype == 0 && hd == 64) return launch_simt<64>(a, b, s);
  if (dtype == 0 && hd == 120) return launch_simt<120>(a, b, s);
  if (dtype == 0 && hd == 128) return launch_simt<128>(a, b, s);
  if (dtype == 1 && hd == 16) return launch_wgmma<16>(a, b, s);
  if (dtype == 1 && hd == 32) return launch_wgmma<32>(a, b, s);
  if (dtype == 1 && hd == 64) return launch_wgmma<64>(a, b, s);
  if (dtype == 1 && hd == 120) return launch_wgmma<120>(a, b, s);
  if (dtype == 1 && hd == 128) return launch_wgmma<128>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one bf16 CTA at head dim hd (16, 32, 64, 120 or
// 128), else 0.
int fa_fwd_smem_bytes(int64_t hd) {
  return hd == 16    ? Smem<16>::kBytes
         : hd == 32  ? Smem<32>::kBytes
         : hd == 64  ? Smem<64>::kBytes
         : hd == 120 ? Smem<120>::kBytes
         : hd == 128 ? Smem<128>::kBytes
                     : 0;
}

}  // extern "C"
