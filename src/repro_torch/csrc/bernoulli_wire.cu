// Hopper kernels for the §4.4 seed-trick Bernoulli wire.
//
// Replace the Pallas TPU kernels of src/repro/kernels/bernoulli_wire/kernel.py:
//   encode_pallas (:184, _encode_kernel :127)       -> bw_support_counts +
//                                                      bw_scan_rows + bw_encode_write
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
// Design.  The TPU kernels carry the running support rank in an SMEM counter
// over a sequential grid.  CUDA blocks run in no order, so the rank is built
// in three phases instead:
//   1. count: one block per (1024-coordinate chunk, peer) draws the Threefry
//      bits, forms the support with __ballot_sync, writes the 32 ballot words
//      of the chunk (a d-bit support mask) and the chunk's support count;
//   2. scan: an exclusive scan of the chunk counts per peer, starting from the
//      peer's prior count (0 for encode and full decode, the ranks before the
//      shard for the §12 shard decode);
//   3. write (encode) or decode: ranks come from the chunk offset, the
//      popcount prefix of the chunk's mask words and __popc of the lane's own
//      word, so phase 3 reads the mask and never draws Threefry again.
// Decode lets each thread own 4 coordinates and loops over the peers in
// ascending order, adding in f32 into registers from 0 — the accumulation
// order of ref.decode_sum_sequential, hence bit-equal results.
//
// Bound: one Threefry-2x32 call is at least 72 32-bit integer operations
// (threefry.cuh) and yields the bits of coordinates j and j + ceil(d/2), so
// a full-length draw needs ceil(d/2) calls per peer and a shard window one
// call per coordinate and peer (its pair partners lie in other shards).  The
// count phase here draws one call per coordinate and keeps one word, twice
// the calls a full-length draw needs.  The write and decode phases move d*4
// bytes in, cap*4 out (encode) or n*cap*4 in, ds*4 out (decode).  At p =
// 1/16 the integer work dominates: these kernels are bound by the card's
// int32 rate (64 lanes per SM), not by HBM.
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

// Phase 3 of encode.  grid (nchunks,).  Each kept coordinate with rank < cap
// writes x*inv_p - c*mu at its rank (round-to-nearest products and
// difference, never contracted into an FMA); then the grid zero-fills the
// slots [min(total, cap), cap).
__global__ void encode_write_kernel(const float* __restrict__ x,
                                    const uint32_t* __restrict__ mask,
                                    const int32_t* __restrict__ offsets,
                                    const int32_t* __restrict__ total,
                                    int64_t d, int64_t cap, float inv_p,
                                    float c, const float* __restrict__ mu,
                                    float* __restrict__ out) {
  const int chunk = blockIdx.x;
  __shared__ uint32_t words[kWords];
  __shared__ int prefix[kWords];
  load_chunk_words(mask + static_cast<int64_t>(chunk) * kWords, words, prefix);
  const float cmu = __fmul_rn(c, *mu);
  const int base = offsets[chunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = j * kWarps + warp;
    const uint32_t w = words[k];
    if ((w >> lane) & 1u) {
      const int64_t rank = static_cast<int64_t>(base) + prefix[k] + __popc(w & below);
      if (rank < cap) {
        const int64_t l = static_cast<int64_t>(chunk) * kChunk + j * kThreads + threadIdx.x;
        out[rank] = __fsub_rn(__fmul_rn(x[l], inv_p), cmu);
      }
    }
  }
  const int64_t filled = min64(static_cast<int64_t>(*total), cap);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = filled + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < cap; s += stride) {
    out[s] = 0.0f;
  }
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

int bw_encode_write(const float* x, const uint32_t* mask,
                    const int32_t* offsets, const int32_t* total, int64_t d,
                    int64_t cap, float inv_p, float c, const float* mu,
                    float* out, void* stream) {
  const int64_t nchunks = num_chunks(d);
  encode_write_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, mask, offsets, total, d, cap, inv_p, c, mu, out);
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
