// Hopper kernels for the §4.4 seed-trick Bernoulli wire.
//
// Replace the Pallas TPU kernels of src/repro/kernels/bernoulli_wire/kernel.py:
//   encode_pallas (:184, _encode_kernel :127)       -> bw_encode (pair count +
//                                                      look-back write)
//   decode_sum_pallas (:248, _decode_kernel :193)   -> bw_decode_sum (pair
//                                                      count + tile scan +
//                                                      decode)
//   decode_sum_shard_pallas (:336, :257)            -> bw_support_counts, then
//                                                      bw_decode_sum_shard
//                                                      (tile scan + decode)
// and are bit-equal to the plain versions in
// src/repro_torch/kernels/bernoulli_wire/ref.py.
//
// Support semantics (peers regenerate them, so they must never drift):
// coordinate g of peer i is sent iff uniform(key_i, d)[g] < p, compared as
// f32; the j-th sent coordinate (support rank j) owns value slot j; ranks >=
// cap are dropped by encoder and decoder alike.
//
// Pair chunks.  One Threefry call serves the coordinate pair (j, j + half),
// half = ceil(d/2): word x0 is coordinate j's, x1 coordinate j + half's (for
// odd d the last pair's partner is the zero pad, threefry.cuh::bits_at).
// Chunks of 1024 coordinates are taken in the order low chunks [1024k, 1024k
// + 1024) ∩ [0, half), then high chunks half + [1024k, 1024k + 1024) ∩ [0, d
// - half): every low coordinate precedes every high one, so the chunk order
// is the coordinate order and ranks stay in it.  pair_count_kernel draws
// each pair once (ceil(d/2) calls a key) and writes the mask words and
// support counts of low chunk k and high chunk k; encode and flat decode
// both start with it.
//
// Encode.
//   1. pair count, one key;
//   2. write: persistent blocks take groups of 16 chunks in order by an
//      atomic ticket; a group's exclusive rank offset comes by a decoupled
//      look-back over the groups before it (a warp reads 32 status words at
//      once: the nearest published inclusive prefix plus the counts in
//      between, the counts being known from phase 1, so the look-back never
//      waits), the group publishes its inclusive prefix, then writes
//      x*inv_p - c*mu of each kept coordinate at rank = offset + the counts
//      of the group's chunks before its own + the popcount prefix of its
//      mask words (a thread per mask word, visiting only its set bits); the
//      last group zero-fills the slots [min(total, cap), cap).  The unscaled
//      variant (the error-feedback twin, bw_encode_ex's scaled = 0) writes x
//      itself, -0.0 kept: a template parameter, so the scaled loop is the
//      same code as before.
// So x is read once and the Threefry stream drawn once; no row scan.  The
// pair count runs at the int32 bound (72 operations a call); the write
// reads the mask and, at p = 1/16, most of x's sectors.
//
// Decode.  The TPU kernels carry the running support rank in an SMEM
// counter over a sequential grid.  CUDA blocks run in no order, so the rank
// is built in phases instead:
//   1. count: the flat decode runs the pair count with grid (nl, n), peer i's
//      key by blockIdx.y: ceil(d/2) calls a peer, both words used.  The shard
//      decode's count (bw_support_counts, run before the §12 count exchange)
//      takes coordinate-aligned chunks of its window [start, start + ds),
//      one call per coordinate and peer: a window's pair partners lie in
//      other shards.
//   2. scan: offsets[i, q] = init[i] + the counts of peer i's chunks before q
//      (init 0, or the shard decode's prior counts), in two kernels over the
//      card: the sums of tiles of 8192 counts, then each tile scanned from
//      the sum of the tiles before it, one block per (tile, peer), loads and
//      stores coalesced through shared memory.
//   3. decode: one block per chunk takes the peers 8 at a time, one a warp.
//      Lane k of warp u holds peer u's mask word k and its rank base (the
//      chunk's offset plus a warp scan of the words' popcounts) in
//      registers; every thread sets its own 4 coordinates' value slots (32
//      KB of shared memory for 8 peers) to the peers' centers mu_i; after a
//      barrier each lane writes the kept values of its word's set bits (rank
//      < cap) into their slots, a batch of loads before their stores, so a
//      value is loaded once and no thread works on the unsent 15/16; after a
//      second barrier each thread adds its slots for i = 0..n-1 in that
//      order, in f32 from 0 (__fadd_rn): the accumulation order of
//      ref.decode_sum_sequential, hence bit-equal results.  bw_decode_sum_from
//      starts the sums at a given acc0 instead: from -0.0, the additive
//      identity of IEEE addition (-0 + y = y for every y, -0.0 included),
//      one peer's sum is its reconstruction bit for bit (ref.decode_one, the
//      error-feedback twin's unpack).  Chunk q starts
//      at 1024q (q < nl) or half + 1024(q - nl) and ends at half or ds; the
//      shard decode's chunks are all low (nl = its chunk count, half = ds).
//
// Bound: one Threefry-2x32 call is at least 72 32-bit integer operations
// (threefry.cuh) and yields the bits of coordinates j and j + ceil(d/2), so
// a full-length draw needs ceil(d/2) calls per key and a shard window one
// call per coordinate and peer.  Encode and flat decode draw ceil(d/2)
// calls a key.  The write and decode phases move d*4 bytes in, cap*4 out
// (encode) or n*cap*4 in (the kept values), n*ds/8 of mask in and ds*4 out
// (decode).  At p = 1/16 the integer work dominates: the drawing kernels
// are bound by the card's int32 rate (64 lanes per SM), not by HBM.
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kChunk = 1024;               // coordinates per block
constexpr int kThreads = 256;              // threads per block
constexpr int kPerThread = kChunk / kThreads;
constexpr int kWords = kChunk / 32;        // mask words per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPeers = 256;
constexpr int kPeerGroup = kWarps;         // peers a decode block takes at once
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;                // counts a scan thread takes
constexpr int kTile = kScanThreads * kScanPer;

// (k0, k1) of up to kMax keys, passed by value in the launch.
template <int kMax>
struct KeysN {
  uint32_t w[2 * kMax];
};
using Keys = KeysN<kMaxPeers>;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shard count.  grid (nchunks, n).  Window coordinate l in [0, ds) of peer
// i is global coordinate start + l; lanes past ds or past d are never sent.
// Chunk word k covers window coordinates [32k, 32k + 32): word j*kWarps + w
// holds the ballot of warp w in sub-step j (coordinates j*256 + w*32 + lane).
__global__ void support_count_kernel(Keys keys, int64_t start, int64_t ds,
                                     int64_t d, float p, int nchunks,
                                     int32_t* __restrict__ counts,
                                     uint32_t* __restrict__ mask) {
  const int chunk = blockIdx.x;
  const int peer = blockIdx.y;
  const uint32_t k0 = keys.w[2 * peer];
  const uint32_t k1 = keys.w[2 * peer + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ int warp_total[kWarps];
  uint32_t* out_words = mask + (static_cast<int64_t>(peer) * nchunks + chunk) * kWords;
  int total = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t l = static_cast<int64_t>(chunk) * kChunk + j * kThreads + threadIdx.x;
    const int64_t g = start + l;
    bool sent = false;
    if (l < ds && g < d) {
      sent = threefry::uniform_at(k0, k1, static_cast<uint64_t>(g),
                                  static_cast<uint64_t>(d)) < p;
    }
    const uint32_t b = __ballot_sync(0xffffffffu, sent);
    if (lane == 0) {
      out_words[j * kWarps + warp] = b;
      total += __popc(b);
    }
  }
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_total[w];
    counts[static_cast<int64_t>(peer) * nchunks + chunk] = s;
  }
}

// Pair count.  grid (nl, keys): block (k, i) draws pairs j in [1024k, 1024k
// + 1024) ∩ [0, half) under key i.  Key i's chunk q has count counts[i *
// chunks + q] and mask words mask[(i * chunks + q) * 32 ..], chunks = nl +
// nh: low chunk k is q = k, high chunk k is q = nl + k (present for k < nh).
// Word j*kWarps + w holds the ballot of warp w in sub-step j.  The encode's
// single key (kMax = 1) is read at a fixed offset of the launch's
// parameters, so the cipher takes it as constant operands.  u < p is
// compared on the bits (threefry::uniform_below, thr from p on the host).
template <int kMax>
__global__ void pair_count_kernel(KeysN<kMax> keys, int64_t d, int64_t half, int64_t nl,
                                  int64_t nh, uint32_t thr, int32_t* __restrict__ counts,
                                  uint32_t* __restrict__ mask) {
  const int64_t k = blockIdx.x;
  const int peer = kMax == 1 ? 0 : blockIdx.y;
  const uint32_t k0 = keys.w[2 * peer];
  const uint32_t k1 = keys.w[2 * peer + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_high = k < nh;
  const int64_t row = static_cast<int64_t>(peer) * (nl + nh);
  __shared__ int warp_total[2][kWarps];
  uint32_t* lo_words = mask + (row + k) * kWords;
  uint32_t* hi_words = mask + (row + nl + k) * kWords;
  int tl = 0, th = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t c0 = k * kChunk + j * kThreads + threadIdx.x;
    bool lo = false, hi = false;
    if (c0 < half) {
      const int64_t c1 = c0 + half;
      uint32_t x0 = static_cast<uint32_t>(c0);
      uint32_t x1 = c1 < d ? static_cast<uint32_t>(c1) : 0u;   // odd-d zero pad
      threefry::threefry2x32(k0, k1, x0, x1);
      lo = threefry::uniform_below(x0, thr);
      hi = c1 < d && threefry::uniform_below(x1, thr);
    }
    const uint32_t bl = __ballot_sync(0xffffffffu, lo);
    const uint32_t bh = __ballot_sync(0xffffffffu, hi);
    if (lane == 0) {
      lo_words[j * kWarps + warp] = bl;
      tl += __popc(bl);
      if (has_high) {
        hi_words[j * kWarps + warp] = bh;
        th += __popc(bh);
      }
    }
  }
  if (lane == 0) {
    warp_total[0][warp] = tl;
    warp_total[1][warp] = th;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sl = 0, sh = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sl += warp_total[0][w];
      sh += warp_total[1][w];
    }
    counts[row + k] = sl;
    if (has_high) counts[row + nl + k] = sh;
  }
}

// ------------------------------------------------------------------- scan

// Scan, part 1.  grid (tiles, rows): sums[r * tiles + t] = the sum of
// counts[r, 8192t : 8192t + 8192] (rows of len counts).
__global__ void tile_sum_kernel(const int32_t* __restrict__ counts, int64_t len, int tiles,
                                int32_t* __restrict__ sums) {
  __shared__ int warp_part[kScanThreads / 32];
  const int row = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t hi = min64(lo + kTile, len);
  const int32_t* c = counts + static_cast<int64_t>(row) * len;
  int s = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kScanThreads) s += c[i];
  s = warp_sum(s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sum(warp_part[lane]);
    if (lane == 0) sums[static_cast<int64_t>(row) * tiles + blockIdx.x] = s;
  }
}

// Scan, part 2.  grid (tiles, rows).  offsets[r, c] = init[r] + sum(counts[r,
// :c]) (init may be null: 0).  The tile's base is init[r] plus the sums of
// the tiles before it; thread t scans the tile's counts 8t .. 8t + 7, staged
// through shared memory so that global loads and stores stay coalesced.
__global__ void scan_tile_kernel(const int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ sums,
                                 const int32_t* __restrict__ init, int64_t len, int tiles,
                                 int32_t* __restrict__ offsets) {
  __shared__ __align__(16) int vals[kTile];
  __shared__ int warp_incl[kScanThreads / 32];
  __shared__ int warp_pre[kScanThreads / 32];
  __shared__ int base_s;
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = static_cast<int64_t>(tile) * kTile;
  const int here = static_cast<int>(min64(kTile, len - lo));
  const int32_t* c = counts + static_cast<int64_t>(row) * len + lo;
  int32_t* o = offsets + static_cast<int64_t>(row) * len + lo;
  for (int i = threadIdx.x; i < kTile; i += kScanThreads) vals[i] = i < here ? c[i] : 0;
  int pre = 0;
  for (int t = threadIdx.x; t < tile; t += kScanThreads)
    pre += sums[static_cast<int64_t>(row) * tiles + t];
  __syncthreads();
  const int4* v4 = reinterpret_cast<const int4*>(vals) + 2 * threadIdx.x;
  const int4 a = v4[0], b = v4[1];
  const int v[kScanPer] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) s += v[k];
  const int incl = warp_inclusive_scan(s);
  pre = warp_sum(pre);
  if (lane == 31) warp_incl[warp] = incl;
  if (lane == 0) warp_pre[warp] = pre;
  __syncthreads();
  if (warp == 0) {
    const int ws = warp_incl[lane];
    warp_incl[lane] = warp_inclusive_scan(ws) - ws;   // exclusive
    const int total = warp_sum(warp_pre[lane]);
    if (lane == 0) base_s = (init ? init[row] : 0) + total;
  }
  __syncthreads();
  int run = base_s + warp_incl[warp] + incl - s;
  int e[kScanPer];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    e[k] = run;
    run += v[k];
  }
  int4* w4 = reinterpret_cast<int4*>(vals) + 2 * threadIdx.x;
  w4[0] = make_int4(e[0], e[1], e[2], e[3]);
  w4[1] = make_int4(e[4], e[5], e[6], e[7]);
  __syncthreads();
  for (int i = threadIdx.x; i < here; i += kScanThreads) o[i] = vals[i];
}

// ----------------------------------------------------------------- decode

// Decode.  grid (chunks,).  out[l] = sum over peers i = 0..n-1, in that
// order, of bufs[i, rank] where coordinate l is sent by peer i with rank <
// cap, else mus[i] (header, phase 3).  Slot l of a peer is vals[u][l]: the
// coordinates j*256 + t of thread t are its own, word k of the mask covers
// slots 32k .. 32k + 31.
__global__ void decode_kernel(const float* __restrict__ bufs, int64_t ld,
                              const float* __restrict__ mus,
                              const uint32_t* __restrict__ mask,
                              const int32_t* __restrict__ offsets, int n, int64_t chunks,
                              int64_t nl, int64_t half, int64_t ds, int64_t cap, float acc0,
                              float* __restrict__ out) {
  __shared__ float vals[kPeerGroup][kChunk];
  const int64_t q = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = acc0;
  for (int g0 = 0; g0 < n; g0 += kPeerGroup) {
    const int gn = n - g0 < kPeerGroup ? n - g0 : kPeerGroup;
    if (g0) __syncthreads();   // the previous group's slots are read
#pragma unroll
    for (int u = 0; u < kPeerGroup; ++u) {
      if (u < gn) {
        const float mu = mus[g0 + u];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) vals[u][j * kThreads + threadIdx.x] = mu;
      }
    }
    uint32_t w = 0;
    int64_t rank = 0;
    const float* row = bufs;
    if (warp < gn) {
      const int64_t pc = static_cast<int64_t>(g0 + warp) * chunks + q;
      w = mask[pc * kWords + lane];
      const int c = __popc(w);
      rank = offsets[pc] + warp_inclusive_scan(c) - c;
      row = bufs + static_cast<int64_t>(g0 + warp) * ld;
    }
    __syncthreads();           // every slot holds its center
    const int kept = static_cast<int>(min64(__popc(w), cap - rank < 0 ? 0 : cap - rank));
    float* slot = vals[warp] + 32 * lane;
#pragma unroll 4
    for (int t = 0; t < kept; ++t) {
      slot[__ffs(w) - 1] = row[rank + t];
      w &= w - 1u;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPeerGroup; ++u) {
      if (u < gn) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          acc[j] = __fadd_rn(acc[j], vals[u][j * kThreads + threadIdx.x]);
      }
    }
  }
  const int64_t base = q < nl ? q * kChunk : half + (q - nl) * kChunk;
  const int64_t len = min64((q < nl ? half : ds) - base, kChunk);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t l = j * kThreads + threadIdx.x;
    if (l < len) out[base + l] = acc[j];
  }
}

// ----------------------------------------------------------------- encode

__device__ __forceinline__ int64_t warp_sum64(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// Encode phase 2.  Persistent blocks; a ticket claims a group of kGroup
// consecutive chunks, in chunk order (one look-back per group keeps a block
// busy with bytes, not with the latency of the ticket and the look-back).
// status[g] = 1 + inclusive support count of groups 0..g once published, 0
// before.  Each kept coordinate with rank < cap writes x*inv_p - c*mu at its
// rank (round-to-nearest products and difference, never contracted into an
// FMA), or x itself when kScaled is false; a thread takes one mask word (32
// coordinates) at a time and visits only its set bits.
constexpr int kGroup = 16;

template <bool kScaled>
__global__ void encode_lookback_kernel(const float* __restrict__ x,
                                       const uint32_t* __restrict__ mask,
                                       const int32_t* __restrict__ counts,
                                       unsigned long long* status, unsigned int* ticket,
                                       int64_t half, int64_t nl, int64_t chunks, int64_t cap,
                                       float inv_p, float c, const float* __restrict__ mu,
                                       float* __restrict__ out) {
  __shared__ uint32_t words[kGroup][kWords];
  __shared__ int prefix[kGroup][kWords];
  __shared__ int chunk_total[kGroup];
  __shared__ int chunk_offset[kGroup];
  __shared__ int64_t offset_s, total_s;
  __shared__ unsigned int item[2];
  const float cmu = kScaled ? __fmul_rn(c, *mu) : 0.0f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t groups = (chunks + kGroup - 1) / kGroup;
  for (int it = 0;; ++it) {
    if (threadIdx.x == 0) item[it & 1] = atomicAdd(ticket, 1u);
    __syncthreads();
    const int64_t g = item[it & 1];
    if (g >= groups) break;
    // the group's mask words, their popcount prefix within each chunk and
    // each chunk's count: warp w takes chunks w, w + kWarps, ...
    for (int ci = warp; ci < kGroup; ci += kWarps) {
      const int64_t q = g * kGroup + ci;
      const uint32_t w = q < chunks ? mask[q * kWords + lane] : 0u;
      const int cnt = __popc(w);
      const int incl = warp_inclusive_scan(cnt);
      words[ci][lane] = w;
      prefix[ci][lane] = incl - cnt;
      if (lane == 31) chunk_total[ci] = incl;
    }
    __syncthreads();
    if (warp == 0) {
      const int t = lane < kGroup ? chunk_total[lane] : 0;
      const int incl = warp_inclusive_scan(t);
      if (lane < kGroup) chunk_offset[lane] = incl - t;
      const int own = __shfl_sync(0xffffffffu, incl, 31);
      // look-back: lane l reads group pos - l; a group before g is whole
      int64_t offset = 0;
      for (int64_t pos = g - 1; pos >= 0; pos -= 32) {
        const int64_t i = pos - lane;
        unsigned long long st = 0ull;
        int64_t n = 0;
        if (i >= 0) {
          st = ld_relaxed(status + i);
          if (st == 0ull)
            for (int k = 0; k < kGroup; ++k) n += counts[i * kGroup + k];
        }
        const uint32_t ready = __ballot_sync(0xffffffffu, st != 0ull);
        if (ready) {
          const int f = __ffs(ready) - 1;   // the nearest published group
          offset += warp_sum64(lane < f ? n : lane == f ? int64_t(st - 1ull) : 0);
          break;
        }
        offset += warp_sum64(n);
      }
      if (lane == 0) {
        st_relaxed(status + g, static_cast<unsigned long long>(offset + own) + 1ull);
        offset_s = offset;
        total_s = offset + own;
      }
    }
    __syncthreads();
    const int64_t offset = offset_s;
    for (int i = threadIdx.x; i < kGroup * kWords; i += kThreads) {
      const int ci = i / kWords, kw = i % kWords;
      const int64_t q = g * kGroup + ci;
      if (q >= chunks) break;
      const int64_t base = q < nl ? q * kChunk : half + (q - nl) * kChunk;
      uint32_t w = words[ci][kw];
      int64_t rank = offset + chunk_offset[ci] + prefix[ci][kw];
      const float* xw = x + base + 32 * kw;
      for (; w && rank < cap; w &= w - 1u, ++rank) {
        const float v = xw[__ffs(w) - 1];
        out[rank] = kScaled ? __fsub_rn(__fmul_rn(v, inv_p), cmu) : v;
      }
    }
    if (g == groups - 1) {
      for (int64_t s = min64(total_s, cap) + threadIdx.x; s < cap; s += kThreads) out[s] = 0.0f;
    }
  }
}

// Chunk geometry of a full-length (d,) pair draw.
struct PairGeometry {
  int64_t half, nl, nh;
  int64_t chunks() const { return nl + nh; }
  int64_t groups() const { return (chunks() + kGroup - 1) / kGroup; }
};

PairGeometry pair_geometry(int64_t d) {
  const int64_t half = (d + 1) / 2;
  return {half, (half + kChunk - 1) / kChunk, (d - half + kChunk - 1) / kChunk};
}

int64_t num_chunks(int64_t ds) { return (ds + kChunk - 1) / kChunk; }

int64_t num_tiles(int64_t len) { return (len + kTile - 1) / kTile; }

template <int kMax>
cudaError_t launch_pair_count(const KeysN<kMax>& keys, int n, int64_t d, float p,
                              int32_t* counts, uint32_t* mask, cudaStream_t s) {
  const PairGeometry g = pair_geometry(d);
  pair_count_kernel<kMax><<<dim3(static_cast<unsigned>(g.nl), n), kThreads, 0, s>>>(
      keys, d, g.half, g.nl, g.nh, threefry::uniform_threshold(p), counts, mask);
  return cudaGetLastError();
}

// offsets (rows, len) from counts (rows, len); sums: rows * num_tiles(len).
cudaError_t launch_scan(const int32_t* counts, const int32_t* init, int rows, int64_t len,
                        int32_t* sums, int32_t* offsets, cudaStream_t s) {
  const int tiles = static_cast<int>(num_tiles(len));
  tile_sum_kernel<<<dim3(tiles, rows), kScanThreads, 0, s>>>(counts, len, tiles, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tile_kernel<<<dim3(tiles, rows), kScanThreads, 0, s>>>(counts, sums, init, len, tiles,
                                                               offsets);
  return cudaGetLastError();
}

// Scratch of a decode of n rows of `chunks` chunks: offsets, then tile sums.
int64_t scan_scratch_ints(int n, int64_t chunks) {
  return static_cast<int64_t>(n) * (chunks + num_tiles(chunks));
}

// The encode's two launches (pair count, look-back write) on stream s.
template <bool kScaled>
int encode_launch(uint32_t k0, uint32_t k1, const float* x, int64_t d, float p, int64_t cap,
                  float inv_p, float c, const float* mu, float* out, void* scratch,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PairGeometry g = pair_geometry(d);
  const int64_t q = g.chunks();
  const int64_t groups = g.groups();
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned int*>(status + groups);
  auto* counts = reinterpret_cast<int32_t*>(status + groups + 1);
  auto* mask = reinterpret_cast<uint32_t*>(counts + q);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (groups + 1) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_pair_count(KeysN<1>{{k0, k1}}, 1, d, p, counts, mask, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, encode_lookback_kernel<kScaled>, kThreads,
                                                  0);
    return b > 0 ? b : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t grid = groups < int64_t(sms) * per_sm ? groups : int64_t(sms) * per_sm;
  encode_lookback_kernel<kScaled><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      x, mask, counts, status, ticket, g.half, g.nl, q, cap, inv_p, c, mu, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// counts: (n, nchunks) int32; mask: (n, nchunks * 32) uint32 words.
// keys_host: n (k0, k1) pairs in host memory, copied into the launch.
int bw_support_counts(const uint32_t* keys_host, int n, int64_t start,
                      int64_t ds, int64_t d, float p, int32_t* counts,
                      uint32_t* mask, void* stream) {
  if (n < 1 || n > kMaxPeers) return static_cast<int>(cudaErrorInvalidValue);
  Keys keys;
  for (int i = 0; i < 2 * n; ++i) keys.w[i] = keys_host[i];
  const int64_t nchunks = num_chunks(ds);
  support_count_kernel<<<dim3(static_cast<unsigned>(nchunks), n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      keys, start, ds, d, p, static_cast<int>(nchunks), counts, mask);
  return static_cast<int>(cudaGetLastError());
}

// Scratch bytes of bw_encode at length d: a status word per chunk group and
// the ticket (zeroed by bw_encode), chunk counts and mask words.
int64_t bw_encode_scratch_bytes(int64_t d) {
  const PairGeometry g = pair_geometry(d);
  return g.groups() * 8 + 8 + g.chunks() * 4 + g.chunks() * kWords * 4;
}

// x: (d,) f32; (k0, k1) the rank-folded key; mu: f32 on the card; out: (cap,)
// f32; scratch: bw_encode_scratch_bytes(d) bytes, 8-byte aligned.  Writes
// x*inv_p - c*mu at each kept rank (scaled != 0) or x itself (the
// error-feedback twin: inv_p, c and mu are not read).
int bw_encode_ex(uint32_t k0, uint32_t k1, const float* x, int64_t d, float p, int64_t cap,
                 int scaled, float inv_p, float c, const float* mu, float* out, void* scratch,
                 void* stream) {
  if (d < 1 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  return scaled ? encode_launch<true>(k0, k1, x, d, p, cap, inv_p, c, mu, out, scratch, stream)
                : encode_launch<false>(k0, k1, x, d, p, cap, 0.0f, 0.0f, mu, out, scratch,
                                       stream);
}

// bw_encode_ex with scaled = 1.
int bw_encode(uint32_t k0, uint32_t k1, const float* x, int64_t d, float p, int64_t cap,
              float inv_p, float c, const float* mu, float* out, void* scratch, void* stream) {
  return bw_encode_ex(k0, k1, x, d, p, cap, 1, inv_p, c, mu, out, scratch, stream);
}

// Scratch bytes of bw_decode_sum for n peers at length d: chunk counts,
// offsets and tile sums, then mask words.
int64_t bw_decode_scratch_bytes(int n, int64_t d) {
  const int64_t q = pair_geometry(d).chunks();
  return 4 * (static_cast<int64_t>(n) * q + scan_scratch_ints(n, q)) +
         static_cast<int64_t>(n) * q * kWords * 4;
}

// bufs: (n, cap) f32 rows ld apart; mus: (n,) f32; keys_host: n (k0, k1)
// pairs in host memory; out: (d,) f32, each sum started at acc0; scratch:
// bw_decode_scratch_bytes(n, d) bytes, 4-byte aligned.
int bw_decode_sum_from(const uint32_t* keys_host, int n, int64_t d, float p, const float* bufs,
                       int64_t ld, const float* mus, int64_t cap, float acc0, float* out,
                       void* scratch, void* stream) {
  if (n < 1 || n > kMaxPeers || d < 1 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Keys keys;
  for (int i = 0; i < 2 * n; ++i) keys.w[i] = keys_host[i];
  const PairGeometry g = pair_geometry(d);
  const int64_t q = g.chunks();
  auto* counts = static_cast<int32_t*>(scratch);
  int32_t* offsets = counts + n * q;
  int32_t* sums = offsets + n * q;
  auto* mask = reinterpret_cast<uint32_t*>(counts + n * q + scan_scratch_ints(n, q));
  cudaError_t err = launch_pair_count(keys, n, d, p, counts, mask, s);
  if (err == cudaSuccess) err = launch_scan(counts, nullptr, n, q, sums, offsets, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<<<static_cast<unsigned>(q), kThreads, 0, s>>>(
      bufs, ld, mus, mask, offsets, n, q, g.nl, g.half, d, cap, acc0, out);
  return static_cast<int>(cudaGetLastError());
}

// bw_decode_sum_from with acc0 = +0.0: Σ_i from 0, the averaging decode.
int bw_decode_sum(const uint32_t* keys_host, int n, int64_t d, float p, const float* bufs,
                  int64_t ld, const float* mus, int64_t cap, float* out, void* scratch,
                  void* stream) {
  return bw_decode_sum_from(keys_host, n, d, p, bufs, ld, mus, cap, 0.0f, out, scratch, stream);
}

// Scratch bytes of bw_decode_sum_shard for n peers over a window of ds:
// offsets and tile sums.
int64_t bw_shard_scratch_bytes(int n, int64_t ds) {
  return 4 * scan_scratch_ints(n, num_chunks(ds));
}

// counts, mask: bw_support_counts's over the window; prior: (n,) int32 ranks
// before it; out: (ds,) f32; scratch: bw_shard_scratch_bytes(n, ds) bytes.
int bw_decode_sum_shard(const float* bufs, int64_t ld, const float* mus, const int32_t* counts,
                        const uint32_t* mask, const int32_t* prior, int n, int64_t ds,
                        int64_t cap, float* out, void* scratch, void* stream) {
  if (n < 1 || ds < 1 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t q = num_chunks(ds);
  auto* offsets = static_cast<int32_t*>(scratch);
  int32_t* sums = offsets + n * q;
  cudaError_t err = launch_scan(counts, prior, n, q, sums, offsets, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<<<static_cast<unsigned>(q), kThreads, 0, s>>>(
      bufs, ld, mus, mask, offsets, n, q, q, ds, ds, cap, 0.0f, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
