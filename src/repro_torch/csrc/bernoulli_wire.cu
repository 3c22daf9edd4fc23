// Hopper kernels for the §4.4 seed-trick Bernoulli wire.
//
// Replace the Pallas TPU kernels of src/repro/kernels/bernoulli_wire/kernel.py:
//   encode_pallas (:184, _encode_kernel :127)       -> bw_encode (pair count +
//                                                      look-back write)
//   decode_sum_pallas (:248, _decode_kernel :193)   -> bw_support_counts +
//                                                      bw_scan_rows + bw_decode
//   decode_sum_shard_pallas (:336, :257)            -> the same, on a window
//                                                      [start, start + ds)
// and are bit-equal to the plain versions in
// src/repro_torch/kernels/bernoulli_wire/ref.py.
//
// Support semantics (peers regenerate them, so they must never drift):
// coordinate g of peer i is sent iff uniform(key_i, d)[g] < p, compared as
// f32; the j-th sent coordinate (support rank j) owns value slot j; ranks >=
// cap are dropped by encoder and decoder alike.
//
// Encode.  One Threefry call serves the coordinate pair (j, j + half), half =
// ceil(d/2): word x0 is coordinate j's, x1 coordinate j + half's (for odd d
// the last pair's partner is the zero pad, threefry.cuh::bits_at).  Chunks
// of 1024 coordinates are taken in the order low chunks [1024k, 1024k +
// 1024) ∩ [0, half), then high chunks half + [1024k, 1024k + 1024) ∩ [0, d -
// half): every low coordinate precedes every high one, so the chunk order is
// the coordinate order and ranks stay in it.
//   1. pair count: one block per 1024 pairs draws each pair once and writes
//      the mask words and support counts of low chunk k and high chunk k;
//   2. write: persistent blocks take groups of 16 chunks in order by an
//      atomic ticket; a group's exclusive rank offset comes by a decoupled
//      look-back over the groups before it (a warp reads 32 status words at
//      once: the nearest published inclusive prefix plus the counts in
//      between, the counts being known from phase 1, so the look-back never
//      waits), the group publishes its inclusive prefix, then writes
//      x*inv_p - c*mu of each kept coordinate at rank = offset + the counts
//      of the group's chunks before its own + the popcount prefix of its
//      mask words (a thread per mask word, visiting only its set bits); the
//      last group zero-fills the slots [min(total, cap), cap).
// So x is read once and the Threefry stream drawn once; no row scan.  The
// pair count runs at the int32 bound (72 operations a call); the write
// reads the mask and, at p = 1/16, most of x's sectors.
//
// Decode.  The TPU kernels carry the running support rank in an SMEM
// counter over a sequential grid.  CUDA blocks run in no order, so the rank
// is built in three phases instead:
//   1. count: one block per (1024-coordinate chunk, peer) draws the Threefry
//      bits, forms the support with __ballot_sync, writes the 32 ballot words
//      of the chunk (a d-bit support mask) and the chunk's support count;
//   2. scan: an exclusive scan of the chunk counts per peer, starting from the
//      peer's prior count (0 for the full decode, the ranks before the shard
//      for the §12 shard decode);
//   3. decode: ranks come from the chunk offset, the popcount prefix of the
//      chunk's mask words and __popc of the lane's own word, so phase 3 reads
//      the mask and never draws Threefry again.
// Decode lets each thread own 4 coordinates and loops over the peers in
// ascending order, adding in f32 into registers from 0 — the accumulation
// order of ref.decode_sum_sequential, hence bit-equal results.
//
// Bound: one Threefry-2x32 call is at least 72 32-bit integer operations
// (threefry.cuh) and yields the bits of coordinates j and j + ceil(d/2), so
// a full-length draw needs ceil(d/2) calls per peer and a shard window one
// call per coordinate and peer (its pair partners lie in other shards).  The
// encode draws ceil(d/2) calls; the decode's count phase draws one call per
// coordinate and keeps one word, twice the calls a full-length draw needs.
// The write and decode phases move d*4 bytes in, cap*4 out (encode) or
// n*cap*4 in, ds*4 out (decode).  At p = 1/16 the integer work dominates:
// these kernels are bound by the card's int32 rate (64 lanes per SM), not
// by HBM.
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
constexpr int kScanThreads = 1024;

struct Keys {
  uint32_t w[2 * kMaxPeers];
};

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

// Phase 1.  grid (nchunks, n).  Window coordinate l in [0, ds) of peer i is
// global coordinate start + l; lanes past ds or past d are never sent.
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

// Phase 2.  grid (rows,), kScanThreads threads.  offsets[r, c] = init[r] +
// sum(counts[r, :c]); totals[r] = init[r] + sum(counts[r, :]).  Each thread
// scans one contiguous segment; a block scan of the segment sums links them.
__global__ void scan_rows_kernel(const int32_t* __restrict__ counts,
                                 const int32_t* __restrict__ init, int64_t len,
                                 int32_t* __restrict__ offsets,
                                 int32_t* __restrict__ totals) {
  const int row = blockIdx.x;
  const int64_t seg = (len + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min64(static_cast<int64_t>(threadIdx.x) * seg, len);
  const int64_t hi = min64(lo + seg, len);
  const int32_t* c = counts + static_cast<int64_t>(row) * len;
  int32_t* o = offsets + static_cast<int64_t>(row) * len;
  int s = 0;
  for (int64_t i = lo; i < hi; ++i) s += c[i];

  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(s);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int ws = warp_sums[lane];
    warp_sums[lane] = warp_inclusive_scan(ws) - ws;  // exclusive
  }
  __syncthreads();
  int base = (init ? init[row] : 0) + warp_sums[warp] + incl - s;
  for (int64_t i = lo; i < hi; ++i) {
    o[i] = base;
    base += c[i];
  }
  if (threadIdx.x == kScanThreads - 1) totals[row] = base;
}

// Loads the chunk's 32 mask words into shared memory with their exclusive
// popcount prefix.  Called by the whole block; ends with a barrier.
__device__ __forceinline__ void load_chunk_words(const uint32_t* __restrict__ words_in,
                                                 uint32_t* words, int* prefix) {
  if (threadIdx.x < kWords) {
    const uint32_t w = words_in[threadIdx.x];
    const int c = __popc(w);
    words[threadIdx.x] = w;
    prefix[threadIdx.x] = warp_inclusive_scan(c) - c;
  }
  __syncthreads();
}

// Phase 3 of decode.  grid (nchunks,) over the window.  out[l] = sum over
// peers i = 0..n-1, in that order, of bufs[i, rank] where coordinate l is
// sent by peer i with rank < cap, else mus[i].
__global__ void decode_kernel(const float* __restrict__ bufs, int64_t ld,
                              const float* __restrict__ mus,
                              const uint32_t* __restrict__ mask,
                              const int32_t* __restrict__ offsets, int n,
                              int nchunks, int64_t ds, int64_t cap,
                              float* __restrict__ out) {
  const int chunk = blockIdx.x;
  __shared__ uint32_t words[kWords];
  __shared__ int prefix[kWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int64_t pc = static_cast<int64_t>(i) * nchunks + chunk;
    load_chunk_words(mask + pc * kWords, words, prefix);
    const int base = offsets[pc];
    const float mu = mus[i];
    const float* row = bufs + static_cast<int64_t>(i) * ld;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int k = j * kWarps + warp;
      const uint32_t w = words[k];
      float r = mu;
      if ((w >> lane) & 1u) {
        const int64_t rank = static_cast<int64_t>(base) + prefix[k] + __popc(w & below);
        if (rank < cap) r = row[rank];
      }
      acc[j] = __fadd_rn(acc[j], r);
    }
    __syncthreads();  // words/prefix are reloaded for the next peer
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t l = static_cast<int64_t>(chunk) * kChunk + j * kThreads + threadIdx.x;
    if (l < ds) out[l] = acc[j];
  }
}

// ----------------------------------------------------------------- encode

// Encode phase 1.  grid (nl,): block k draws pairs j in [1024k, 1024k + 1024)
// ∩ [0, half).  Mask words of chunk q live at mask[32q ..]: low chunk k is
// q = k, high chunk k is q = nl + k (present for k < nh).  Word j*kWarps + w
// holds the ballot of warp w in sub-step j, as in support_count_kernel.
__global__ void pair_count_kernel(uint32_t k0, uint32_t k1, int64_t d, int64_t half,
                                  int64_t nl, int64_t nh, float p,
                                  int32_t* __restrict__ counts, uint32_t* __restrict__ mask) {
  const int64_t k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_high = k < nh;
  __shared__ int warp_total[2][kWarps];
  uint32_t* lo_words = mask + k * kWords;
  uint32_t* hi_words = mask + (nl + k) * kWords;
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
      lo = threefry::bits_to_uniform(x0) < p;
      hi = c1 < d && threefry::bits_to_uniform(x1) < p;
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
    counts[k] = sl;
    if (has_high) counts[nl + k] = sh;
  }
}

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
// FMA); a thread takes one mask word (32 coordinates) at a time and visits
// only its set bits.
constexpr int kGroup = 16;

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
  const float cmu = __fmul_rn(c, *mu);
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
      for (; w && rank < cap; w &= w - 1u, ++rank)
        out[rank] = __fsub_rn(__fmul_rn(xw[__ffs(w) - 1], inv_p), cmu);
    }
    if (g == groups - 1) {
      for (int64_t s = min64(total_s, cap) + threadIdx.x; s < cap; s += kThreads) out[s] = 0.0f;
    }
  }
}

struct EncodeGeometry {
  int64_t half, nl, nh;
  int64_t chunks() const { return nl + nh; }
  int64_t groups() const { return (chunks() + kGroup - 1) / kGroup; }
};

EncodeGeometry encode_geometry(int64_t d) {
  const int64_t half = (d + 1) / 2;
  return {half, (half + kChunk - 1) / kChunk, (d - half + kChunk - 1) / kChunk};
}

int64_t num_chunks(int64_t ds) { return (ds + kChunk - 1) / kChunk; }

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

// init may be null (all rows start at 0).
int bw_scan_rows(const int32_t* counts, const int32_t* init, int rows,
                 int64_t len, int32_t* offsets, int32_t* totals, void* stream) {
  scan_rows_kernel<<<rows, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, init, len, offsets, totals);
  return static_cast<int>(cudaGetLastError());
}

// Scratch bytes of bw_encode at length d: a status word per chunk group and
// the ticket (zeroed by bw_encode), chunk counts and mask words.
int64_t bw_encode_scratch_bytes(int64_t d) {
  const EncodeGeometry g = encode_geometry(d);
  return g.groups() * 8 + 8 + g.chunks() * 4 + g.chunks() * kWords * 4;
}

// x: (d,) f32; (k0, k1) the rank-folded key; mu: f32 on the card; out: (cap,)
// f32; scratch: bw_encode_scratch_bytes(d) bytes, 8-byte aligned.
int bw_encode(uint32_t k0, uint32_t k1, const float* x, int64_t d, float p, int64_t cap,
              float inv_p, float c, const float* mu, float* out, void* scratch, void* stream) {
  if (d < 1 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EncodeGeometry g = encode_geometry(d);
  const int64_t q = g.chunks();
  const int64_t groups = g.groups();
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned int*>(status + groups);
  auto* counts = reinterpret_cast<int32_t*>(status + groups + 1);
  auto* mask = reinterpret_cast<uint32_t*>(counts + q);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (groups + 1) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_count_kernel<<<static_cast<unsigned>(g.nl), kThreads, 0, s>>>(k0, k1, d, g.half, g.nl,
                                                                      g.nh, p, counts, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, encode_lookback_kernel, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t grid = groups < int64_t(sms) * per_sm ? groups : int64_t(sms) * per_sm;
  encode_lookback_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      x, mask, counts, status, ticket, g.half, g.nl, q, cap, inv_p, c, mu, out);
  return static_cast<int>(cudaGetLastError());
}

int bw_decode(const float* bufs, int64_t ld, const float* mus,
              const uint32_t* mask, const int32_t* offsets, int n, int64_t ds,
              int64_t cap, float* out, void* stream) {
  const int64_t nchunks = num_chunks(ds);
  decode_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      bufs, ld, mus, mask, offsets, n, static_cast<int>(nchunks), ds, cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
