// The lattice decodes for q a power of two (1-bit colors among them), for
// Hopper (sm_90a); the kernels and their design are in lattice_decode.cuh.
//
// Replaces: repro/kernels/lattice_decode.py, lattice_decode_pallas and
// lattice_decode_batched_pallas, at the reference kernels' own shapes and
// at the ones they send to their plain version (q = 1 and 2, n < 32).
#include "lattice_decode.cuh"

// q is a power of two in [1, 65536] and bits bits_for_q(q); the rest as
// decode_launch and decode_batched_launch in lattice_decode.cuh.
extern "C" int lattice_decode_launch(
    const uint32_t* words, const float* anchor, const float* u,
    const float* ref, const float* s, int s_shift, void* out, int coords,
    int avg, float avg_cnt, float recip, int64_t n, int q, int bits,
    void* stream) {
  return decode_launch<true>(words, anchor, u, ref, s, s_shift, out, coords,
                             avg, avg_cnt, recip, n, q, bits, stream);
}

extern "C" int lattice_decode_batched_launch(
    const uint32_t* words, int64_t w_row, const float* anchor, const float* u,
    const float* ref, const float* s, int64_t s_row, int s_shift, void* out,
    int coords, int64_t senders, int64_t n, int q, int bits, void* stream) {
  return decode_batched_launch<true>(words, w_row, anchor, u, ref, s, s_row,
                                     s_shift, out, coords, senders, n, q,
                                     bits, stream);
}
