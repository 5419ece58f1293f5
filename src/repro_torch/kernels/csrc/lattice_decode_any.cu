// The lattice decodes for q not a power of two, for Hopper (sm_90a); the
// kernels and their design are in lattice_decode.cuh.  The color is masked
// by its field's width and the centered mod is a floor mod by q.
//
// Replaces: repro/kernels/lattice_decode.py, lattice_decode_pallas and
// lattice_decode_batched_pallas, at the shapes the reference's ops sends
// to their plain version (q not a power of two).
#include "lattice_decode.cuh"

// q is in [3, 65535], not a power of two, and bits bits_for_q(q); the rest
// as decode_launch and decode_batched_launch in lattice_decode.cuh.
extern "C" int lattice_decode_any_launch(
    const uint32_t* words, const float* anchor, const float* u,
    const float* ref, const float* s, int s_shift, void* out, int coords,
    int avg, float avg_cnt, float recip, int64_t n, int q, int bits,
    void* stream) {
  return decode_launch<false>(words, anchor, u, ref, s, s_shift, out, coords,
                              avg, avg_cnt, recip, n, q, bits, stream);
}

extern "C" int lattice_decode_batched_any_launch(
    const uint32_t* words, int64_t w_row, const float* anchor, const float* u,
    const float* ref, const float* s, int64_t s_row, int s_shift, void* out,
    int coords, int64_t senders, int64_t n, int q, int bits, void* stream) {
  return decode_batched_launch<false>(words, w_row, anchor, u, ref, s, s_row,
                                      s_shift, out, coords, senders, n, q,
                                      bits, stream);
}
