// The lattice encode for q a power of two (1-bit colors among them), for
// Hopper (sm_90a); the kernels and their design are in lattice_encode.cuh.
//
// Replaces: repro/kernels/lattice_encode.py, lattice_encode_pallas
// (_encode_kernel), at the reference kernel's own shapes and at the ones
// it sends to its plain version (q = 1 and 2, n < 32).
#include "lattice_encode.cuh"

// anchor and coords may be null; q is a power of two in [1, 65536] and bits
// bits_for_q(q).  Returns the CUDA error code of the launch (0 = launched).
extern "C" int lattice_encode_launch(const float* x, const float* anchor,
                                     const float* u, const float* s,
                                     int s_shift, uint32_t* words,
                                     int32_t* coords, int64_t n, int q,
                                     int bits, void* stream) {
  return encode_launch<true>(x, anchor, u, s, s_shift, words, coords, n, q,
                             bits, stream);
}
