// Hopper kernel for the unnormalised Walsh-Hadamard transform of each row.
//
// Replaces the Pallas TPU kernel fwht_pallas
// (src/repro/kernels/hadamard/hadamard.py:57, _fwht_kernel :40), which
// computes H_{d1} X H_{d2} as two f32 matmuls with the H factors built from
// iota parity.  This kernel runs the radix-2 butterfly of
// src/repro_torch/kernels/hadamard/ref.py instead and is bit-equal to it, so
// the rotation's bytes are those of the reference's CPU path (the golden
// wire bytes); design (register radix, both passes of a row in one
// persistent kernel with the intermediate in L2), stage order and bound are
// in fwht.cuh.  On the main path it runs every unrotate (and the rotations
// of an inner codec other than binary) at rows of c = 2^20.
#include "fwht.cuh"

extern "C" {

// x, out: (rows, c) f32, c a power of two <= 2^20, 16-byte aligned; out may
// equal x.  scratch: hd_scratch_bytes(rows, c) bytes, zeroed here.
int hd_fwht(const float* x, float* out, int64_t rows, int64_t c, void* scratch, void* stream) {
  return fwht::launch<false>(x, nullptr, out, rows, c, 1.0f, nullptr, scratch,
                             static_cast<cudaStream_t>(stream));
}

int64_t hd_scratch_bytes(int64_t rows, int64_t c) { return fwht::scratch_bytes(rows, c, false); }

}  // extern "C"
