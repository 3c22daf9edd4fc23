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
// (:41) calls dead for the CTA's 64 rows is not visited.  With the finite
// sentinel a row that is fully masked inside a live tile takes weight 1 per
// masked key until its first real key, whose corr = exp(-1e30 - m) = 0
// wipes them: so the result does not depend on the tile sizes, and 64-row
// tiles here agree with the reference's 512-row blocks.  Keys past the end
// of a ragged last tile do not exist: they get -inf (p = 0 exactly; m stays
// finite, it starts at -1e30), and their V rows are zero-filled.
//
// Layout: q, o (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd), contiguous -- the
// model's layout, read in place (no transposes); lse (B, Hq, Sq) f32.
// One CTA per (batch * q-head, 64-row q tile), heaviest causal tiles first;
// K and V tiles of 64 keys staged in shared memory; the online-softmax
// state in registers.
//   bf16 (the serving path): fa_fwd_mma, 4 warps of 16 rows each, warp-level
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) for Q.K^T and P.V; Q's A
//     fragments stay in registers for the whole sweep; P goes from the S
//     accumulators to A fragments in registers (rounded to bf16, as the
//     reference's p.astype(v.dtype)).
//   f32: fa_fwd_simt, 256 threads, each 4 rows x 4 keys of S and 4 rows x
//     hd/16 columns of o with f32 FMAs (the reference's f32 products; no
//     TF32).
//
// Bound (the serving path, bf16, causal): operations -- 4 * B * Hq * hd
// flops per live (q, k) pair on the tensor cores (989 TFLOP/s dense bf16)
// against 2 * (|q| + |k| + |v| + |o|) bytes + 4 * |lse| at 3.35 TB/s.  At
// (8, 2048, 32/8, 128) that is 0.55 TFLOP against 0.18 GB.  This first
// kernel loads tiles synchronously (no cp.async / TMA pipeline, no wgmma),
// so it sits well below that bound; the tiles and the schedule are the
// parts a faster version keeps.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = kTile;          // q rows per CTA
constexpr int kBK = kTile;          // keys per tile

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
  constexpr int NJ = HD / 16;    // output columns per thread
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
        const float vv = Vs[kk * LD + tx + 16 * j];
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
    for (int j = 0; j < NJ; ++j) og[row * q_stride + tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) a.lse[bh * a.sq + row] = m[i] + logf(li);
  }
}

// --------------------------------------------------------- bf16 (mma.sync)

template <int HD>
__global__ void __launch_bounds__(128) fa_fwd_mma(Args a) {
  // Rows of LD bf16: 16-byte aligned (tile loads) and, at LD/2 words, a
  // stride of 4 banks mod 32, so the 8 x 4 lanes of a fragment load hit 32
  // distinct banks.
  constexpr int LD = HD + 8;
  constexpr int NK = HD / 16;    // k-steps of Q.K^T
  constexpr int NJ = kBK / 8;    // n-tiles of S
  constexpr int ND = HD / 8;     // n-tiles of o
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t kvh = h / (a.hq / a.hkv);
  const int64_t qt = gridDim.y - 1 - blockIdx.y;
  const int64_t row0 = qt * kBQ;
  const int64_t q_start = a.q_offset + row0;
  const int64_t q_stride = a.hq * HD, kv_stride = a.hkv * HD;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + (b * a.sq * a.hq + h) * HD;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + (b * a.sk * a.hkv + kvh) * HD;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + (b * a.sk * a.hkv + kvh) * HD;

  // Q through shared memory (the K buffer) into A fragments.
  load_tile<__nv_bfloat16, HD, LD, 128>(Ks, qg, q_stride, row0, a.sq);
  __syncthreads();
  uint32_t qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const __nv_bfloat16* r = Ks + (warp * 16 + g) * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld32(r);
    qa[kk][1] = ld32(r + 8 * LD);
    qa[kk][2] = ld32(r + 8);
    qa[kk][3] = ld32(r + 8 * LD + 8);
  }

  // this thread's two rows: warp*16 + g (fragment slots 0, 1) and + 8 (2, 3)
  const int64_t qp0 = q_start + warp * 16 + g, qp1 = qp0 + 8;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;

  const int64_t nk = (a.sk + kBK - 1) / kBK;
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int64_t k_start = kt * kBK;
    if (!tile_live(a, q_start, k_start)) continue;
    __syncthreads();   // Q fragments read / the previous tile's readers done
    load_tile<__nv_bfloat16, HD, LD, 128>(Ks, kg, kv_stride, k_start, a.sk);
    load_tile<__nv_bfloat16, HD, LD, 128>(Vs, vg, kv_stride, k_start, a.sk);
    __syncthreads();

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* kp = Ks + (8 * j + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int64_t kp = k_start + 8 * j + 2 * t;
      s[j][0] = mask_score(a, s[j][0] * a.scale, qp0, kp);
      s[j][1] = mask_score(a, s[j][1] * a.scale, qp0, kp + 1);
      s[j][2] = mask_score(a, s[j][2] * a.scale, qp1, kp);
      s[j][3] = mask_score(a, s[j][3] * a.scale, qp1, kp + 1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      acc[jd][0] *= c0;
      acc[jd][1] *= c0;
      acc[jd][2] *= c1;
      acc[jd][3] *= c1;
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_round(s[2 * kk][0], s[2 * kk][1]),
                              pack_round(s[2 * kk][2], s[2 * kk][3]),
                              pack_round(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_round(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vp = Vs + (16 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const __nv_bfloat16* c = vp + 8 * jd;
        mma_bf16(acc[jd], pa, pack_raw(c[0], c[LD]), pack_raw(c[8 * LD], c[9 * LD]));
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + (b * a.sq * a.hq + h) * HD;
  const int64_t r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (r0 < a.sq) {
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<uint32_t*>(og + r0 * q_stride + 8 * jd + 2 * t) =
          pack_round(acc[jd][0] / d0, acc[jd][1] / d0);
    if (t == 0) a.lse[bh * a.sq + r0] = m0 + logf(d0);
  }
  if (r1 < a.sq) {
#pragma unroll
    for (int jd = 0; jd < ND; ++jd)
      *reinterpret_cast<uint32_t*>(og + r1 * q_stride + 8 * jd + 2 * t) =
          pack_round(acc[jd][2] / d1, acc[jd][3] / d1);
    if (t == 0) a.lse[bh * a.sq + r1] = m1 + logf(d1);
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
int launch_mma(const Args& a, int64_t b, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(b * a.hq), static_cast<unsigned>((a.sq + kBQ - 1) / kBQ));
  fa_fwd_mma<HD><<<grid, 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o: (b, sq, hq, hd); k, v: (b, sk, hkv, hd), contiguous, of one dtype
// (0: f32, 1: bf16); lse: (b, hq, sq) f32.  hd is 64 or 128, hq a multiple
// of hkv, window <= 0 for none.  Returns the cudaError_t of the launch.
int fa_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int64_t b,
           int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t hd, int64_t q_offset,
           int causal, int64_t window, float scale, int dtype, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || q_offset < 0 ||
      b * hq > 0x7fffffff || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, sq, sk, hq, hkv, q_offset, window, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return launch_simt<64>(a, b, s);
  if (dtype == 0 && hd == 128) return launch_simt<128>(a, b, s);
  if (dtype == 1 && hd == 64) return launch_mma<64>(a, b, s);
  if (dtype == 1 && hd == 128) return launch_mma<128>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
