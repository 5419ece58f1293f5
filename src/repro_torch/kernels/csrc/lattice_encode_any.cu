// The lattice encode for q not a power of two, for Hopper (sm_90a); the
// kernels and their design are in lattice_encode.cuh.  The colors are the
// floor mod of k by q.
//
// Replaces: repro/kernels/lattice_encode.py, lattice_encode_pallas
// (_encode_kernel), at the shapes the reference's ops sends to its plain
// version (q not a power of two).
#include "lattice_encode.cuh"

// anchor and coords may be null; q is in [3, 65535], not a power of two,
// and bits bits_for_q(q).  Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int lattice_encode_any_launch(const float* x, const float* anchor,
                                         const float* u, const float* s,
                                         int s_shift, uint32_t* words,
                                         int32_t* coords, int64_t n, int q,
                                         int bits, void* stream) {
  return encode_launch<false>(x, anchor, u, s, s_shift, words, coords, n, q,
                              bits, stream);
}
