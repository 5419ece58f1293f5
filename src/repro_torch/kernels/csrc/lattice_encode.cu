// Fused dithered lattice encode + bit-pack for Hopper (sm_90a).
//
// Replaces: repro/kernels/lattice_encode.py, lattice_encode_pallas
// (_encode_kernel).  Computes, per coordinate c < n,
//     k[c] = round_half_even((x[c] - anchor[c]) / s - u[c])      (int32)
// and packs the mod-q colors k & (q-1) into 32-bit words, 32/BITS colors
// per word in little-endian lanes (BITS in {2, 4, 8, 16}, the reference's
// kernel shapes).  Lanes past n encode color 0, as the TPU kernel's
// zero-padded tail does.
//
// Sides: s[c >> s_shift].  s_shift = 0 reads a per-coordinate (n,) array,
// s_shift = log2(bucket) a per-bucket (nb,) array (so the caller never
// materializes the per-coordinate broadcast), and s_shift = 63 a scalar.
//
// Numerics copied from the reference: IEEE division (__fdiv_rn, never a
// reciprocal), round half to even (__float2int_rn), and each subtraction
// rounded on its own (__fsub_rn; the file is also built with -fmad=false).
//
// Bound on this card: memory.  Per coordinate it reads x and u (8 B), the
// anchor when given (4 B) and writes BITS/8 B of words plus 4 B of coords
// when asked; the per-bucket side is 4 B per bucket.  A few integer and one
// division per coordinate is far below the compute roof.
//
// Design: one thread per coordinate, so every load of x, u, anchor and
// every store of k is a coalesced 4-byte access across the warp.  The
// 32/BITS threads that share a word OR their shifted colors together with
// warp shuffles (log2(32/BITS) steps) and the first of them stores the
// word; a warp therefore writes BITS consecutive words.  No shared memory,
// no allocation; the launch goes on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int BITS, bool ANCHOR, bool COORDS>
__global__ void lattice_encode_kernel(const float* __restrict__ x,
                                      const float* __restrict__ anchor,
                                      const float* __restrict__ u,
                                      const float* __restrict__ s, int s_shift,
                                      uint32_t* __restrict__ words,
                                      int32_t* __restrict__ coords,
                                      int64_t n, uint32_t qmask) {
  constexpr int PER = 32 / BITS;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t color = 0;
  if (c < n) {
    float xv = x[c];
    if (ANCHOR) xv = __fsub_rn(xv, anchor[c]);
    const float t = __fsub_rn(__fdiv_rn(xv, s[c >> s_shift]), u[c]);
    const int k = __float2int_rn(t);
    if (COORDS) coords[c] = k;
    color = (uint32_t)k & qmask;
  }
  // every lane of the warp takes part in the shuffles, in range or not
  const int lane = threadIdx.x & 31;
  uint32_t v = color << ((lane % PER) * BITS);
#pragma unroll
  for (int off = 1; off < PER; off <<= 1) v |= __shfl_xor_sync(0xffffffffu, v, off);
  if (lane % PER == 0) {
    const int64_t w = c / PER;
    if (w * PER < n) words[w] = v;
  }
}

template <int BITS>
void launch(const float* x, const float* anchor, const float* u,
            const float* s, int s_shift, uint32_t* words, int32_t* coords,
            int64_t n, uint32_t qmask, cudaStream_t stream) {
  const int threads = 256;  // a multiple of 32: whole warps share words
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (anchor && coords)
    lattice_encode_kernel<BITS, true, true><<<blocks, threads, 0, stream>>>(
        x, anchor, u, s, s_shift, words, coords, n, qmask);
  else if (anchor)
    lattice_encode_kernel<BITS, true, false><<<blocks, threads, 0, stream>>>(
        x, anchor, u, s, s_shift, words, coords, n, qmask);
  else if (coords)
    lattice_encode_kernel<BITS, false, true><<<blocks, threads, 0, stream>>>(
        x, anchor, u, s, s_shift, words, coords, n, qmask);
  else
    lattice_encode_kernel<BITS, false, false><<<blocks, threads, 0, stream>>>(
        x, anchor, u, s, s_shift, words, coords, n, qmask);
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched).  anchor and
// coords may be null.  Any stale error is cleared first so that the code
// reports this launch alone.
extern "C" int lattice_encode_launch(const float* x, const float* anchor,
                                     const float* u, const float* s,
                                     int s_shift, uint32_t* words,
                                     int32_t* coords, int64_t n, int q,
                                     int bits, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  const uint32_t qmask = (uint32_t)q - 1u;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 2: launch<2>(x, anchor, u, s, s_shift, words, coords, n, qmask, st); break;
    case 4: launch<4>(x, anchor, u, s, s_shift, words, coords, n, qmask, st); break;
    case 8: launch<8>(x, anchor, u, s, s_shift, words, coords, n, qmask, st); break;
    case 16: launch<16>(x, anchor, u, s, s_shift, words, coords, n, qmask, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
