// Batched proximity decode of S packed payloads for Hopper (sm_90a).
//
// Replaces: repro/kernels/lattice_decode.py, lattice_decode_batched_pallas
// (_decode_batched_kernel, math in _decode_math).  For every sender i < S
// and coordinate c < n:
//     col  = (words[i, c / PER] >> ((c % PER) * BITS)) & (q-1)
//     av   = anchor[c] - ref[c]                         (ref optional)
//     k_a  = round_half_even(av / s - u[c])
//     k    = k_a + (((col - k_a + q/2) & (q-1)) - q/2)
// and writes k (coords mode, int32) or z = (k + u[c]) * s (+ ref[c])
// (point mode, f32) to out[i, c].  BITS is 2, 4, 8 or 16, the reference's
// kernel shapes.
//
// Sides: s[i * s_row + (c >> s_shift)].  The server's drain passes the
// per-sender per-bucket sidecars (S, nb) with s_row = nb and
// s_shift = log2(bucket), so the (S, n) per-coordinate broadcast the
// reference builds (17.8 GB at 16 senders of 278 M coordinates) never
// exists.  (n,) shared sides use s_row = 0, s_shift = 0; (S, n) use
// s_row = n; a scalar uses s_row = 0, s_shift = 63.
//
// Numerics copied from the reference: IEEE division (__fdiv_rn), round
// half to even (__float2int_rn), and no mul-add contraction in point mode
// (__fadd_rn / __fmul_rn; the file is also built with -fmad=false).  The
// centered-mod arithmetic runs in uint32 so that it wraps, as XLA's int32
// arithmetic does, without signed-overflow behaviour.
//
// Bound on this card: memory.  Per coordinate: S * BITS/8 B of words,
// 8 B of anchor + dither (12 B with ref) read once, and S * 4 B written
// (int32 coords or f32 points); the per-bucket sides are S * 4 B per
// bucket.  At q = 16 and S = 16 that is 80 B per coordinate.
//
// Design: one thread per coordinate, looping over the senders.  The
// anchor, dither and ref of a coordinate are loaded once into registers
// and reused for all S senders (the TPU kernel's "anchor block read once
// per tile"), every store is a coalesced 4-byte access across the warp,
// and the PER threads that share a word read the same address (one
// transaction).  No shared memory, no allocation; the launch goes on the
// caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int BITS, bool COORDS, bool REF>
__global__ void lattice_decode_batched_kernel(
    const uint32_t* __restrict__ words, int64_t w_row,
    const float* __restrict__ anchor, const float* __restrict__ u,
    const float* __restrict__ ref, const float* __restrict__ s,
    int64_t s_row, int s_shift, void* __restrict__ out, int64_t senders,
    int64_t n, uint32_t q) {
  constexpr int PER = 32 / BITS;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float av = anchor[c];
  const float uv = u[c];
  float rv = 0.f;
  if (REF) {
    rv = ref[c];
    av = __fsub_rn(av, rv);
  }
  const int64_t w = c / PER;
  const int shift = (int)(c % PER) * BITS;
  const uint32_t qm = q - 1u, half = q >> 1;
  const int64_t sc = c >> s_shift;
  for (int64_t i = 0; i < senders; ++i) {
    const uint32_t col = (words[i * w_row + w] >> shift) & qm;
    const float sv = s[i * s_row + sc];
    const int ka = __float2int_rn(__fsub_rn(__fdiv_rn(av, sv), uv));
    const uint32_t delta = ((col - (uint32_t)ka + half) & qm) - half;
    const int k = (int)((uint32_t)ka + delta);
    if (COORDS) {
      static_cast<int32_t*>(out)[i * n + c] = k;
    } else {
      float z = __fmul_rn(__fadd_rn(__int2float_rn(k), uv), sv);
      if (REF) z = __fadd_rn(z, rv);
      static_cast<float*>(out)[i * n + c] = z;
    }
  }
}

template <int BITS>
void launch(const uint32_t* words, int64_t w_row, const float* anchor,
            const float* u, const float* ref, const float* s, int64_t s_row,
            int s_shift, void* out, int coords, int64_t senders, int64_t n,
            uint32_t q, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
#define DECODE_LAUNCH(C, R)                                              \
  lattice_decode_batched_kernel<BITS, C, R><<<blocks, threads, 0, stream>>>( \
      words, w_row, anchor, u, ref, s, s_row, s_shift, out, senders, n, q)
  if (coords && ref) DECODE_LAUNCH(true, true);
  else if (coords) DECODE_LAUNCH(true, false);
  else if (ref) DECODE_LAUNCH(false, true);
  else DECODE_LAUNCH(false, false);
#undef DECODE_LAUNCH
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched).  ref may be
// null.  out is (senders, n) int32 when coords != 0, else f32.  Any stale
// error is cleared first so that the code reports this launch alone.
extern "C" int lattice_decode_batched_launch(
    const uint32_t* words, int64_t w_row, const float* anchor, const float* u,
    const float* ref, const float* s, int64_t s_row, int s_shift, void* out,
    int coords, int64_t senders, int64_t n, int q, int bits, void* stream) {
  cudaGetLastError();
  if (n <= 0 || senders <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t uq = (uint32_t)q;
  switch (bits) {
    case 2: launch<2>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    case 4: launch<4>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    case 8: launch<8>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    case 16: launch<16>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
