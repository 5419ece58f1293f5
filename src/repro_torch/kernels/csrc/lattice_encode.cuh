// Fused dithered lattice encode + bit-pack for Hopper (sm_90a): the kernels
// of lattice_encode.cu (q a power of two) and lattice_encode_any.cu (q not
// a power of two), two libraries that build in parallel.
//
// Replaces: repro/kernels/lattice_encode.py, lattice_encode_pallas
// (_encode_kernel).  Computes, per coordinate c < n,
//     k[c] = round_half_even((x[c] - anchor[c]) / s - u[c])      (int32)
// and packs the mod-q colors into 32-bit words, 32/BITS colors per word in
// little-endian lanes, BITS = bits_for_q(q) in {1, 2, 4, 8, 16}.  The
// color is k & (q-1) where q is a power of two (POW2) and the floor mod of
// k by q otherwise (jnp.mod, as repro/core/lattice.color_of takes it), for
// any q in [1, 65536] and any n >= 1: the reference's kernel takes q a
// power of two with 2 to 16 bits and n >= 32, and sends the rest to its
// plain version, which computes the same function.  Lanes past n encode
// color 0, as the TPU kernel's zero-padded tail does.
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
// division per coordinate (and, for q not a power of two, one integer
// remainder) is far below the compute roof.
//
// Design (lattice_run.cuh): lane l of a warp encodes 4 consecutive
// coordinates of each 128-coordinate step, so the warp's loads of x, u and
// the anchor and its stores of coords are contiguous 512-byte runs of
// 16-byte accesses, and the lane's 4 colors are one aligned unit of the
// payload (a byte at 2 bits, a half-word at 4, a word at 8, two at 16)
// that it writes whole: the warp's word stores are contiguous too, and no
// colors cross lanes.  At 1 bit the 4 colors are half a byte, so 8 lanes
// OR their nibbles into one word with three XOR shuffles and the first of
// them stores it.  A warp issues the loads of 4 steps (512
// coordinates) before their arithmetic and reads a group's side once when
// the group lies inside one bucket.  The grid is persistent (as many
// blocks as fit on the card at once, each warp striding over groups); the
// last, partial group takes guarded 4-byte accesses, and any pointer off a
// 16-byte boundary (a caller's view) takes the same kernel instantiated
// with 4-byte accesses.  No shared memory, no allocation; the launch goes
// on the caller's stream.
#pragma once
#include "lattice_run.cuh"

namespace {

using lattice_run::kIters;
using lattice_run::kThreads;

// One group of 512 coordinates: lane `lane`'s 4 coordinates of each step.
// qv is q - 1 when POW2, else q.
template <int BITS, int VEC, bool ANCHOR, bool COORDS, bool POW2, bool FULL,
          bool ONE_SIDE>
__device__ __forceinline__ void encode_group(
    const float* __restrict__ x, const float* __restrict__ anchor,
    const float* __restrict__ u, const float* __restrict__ s, int s_shift,
    uint32_t* __restrict__ words, int32_t* __restrict__ coords, int64_t n,
    uint32_t qv, int64_t g, int lane) {
  using lattice_run::load4;
  using lattice_run::store4;
  const int64_t c0 = g * lattice_run::kGroup + 4 * lane;
  const int64_t nw = (n * BITS + 31) / 32;
  const float s_group = ONE_SIDE ? __ldg(s + (c0 >> s_shift)) : 0.f;
  float xv[kIters][4], av[kIters][4], uv[kIters][4];
  // every load of the group is in flight before the arithmetic below
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int64_t c = c0 + it * 128;
    load4<VEC, FULL>(x + c, n - c, xv[it]);
    if (ANCHOR) load4<VEC, FULL>(anchor + c, n - c, av[it]);
    load4<VEC, FULL>(u + c, n - c, uv[it]);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int64_t c = c0 + it * 128;
    int32_t kv[4];
    lattice_run::Bits<BITS> b = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = FULL || c + j < n;
      const float sv =
          ONE_SIDE ? s_group : (in ? __ldg(s + ((c + j) >> s_shift)) : 1.f);
      const float t = ANCHOR ? __fsub_rn(xv[it][j], av[it][j]) : xv[it][j];
      kv[j] = __float2int_rn(__fsub_rn(__fdiv_rn(t, sv), uv[it][j]));
      uint32_t col;
      if constexpr (POW2) col = (uint32_t)kv[j] & qv;
      else col = (uint32_t)lattice_run::floor_mod(kv[j], (int)qv);
      // lanes past n keep color 0
      if (in) b |= (lattice_run::Bits<BITS>)col << (j * BITS);
    }
    if (COORDS) store4<VEC, FULL>(coords + c, n - c, kv);
    if constexpr (BITS == 1) {
      // the word of 8 lanes' nibbles, stored by the first of them
      uint32_t w = b << ((lane & 7) * 4);
      w |= __shfl_xor_sync(0xffffffffu, w, 1);
      w |= __shfl_xor_sync(0xffffffffu, w, 2);
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      if ((lane & 7) == 0)
        lattice_run::store_bits<BITS, VEC, FULL>(words, c >> 2, nw, w);
    } else {
      lattice_run::store_bits<BITS, VEC, FULL>(words, c >> 2, nw, b);
    }
  }
}

template <int BITS, int VEC, bool ANCHOR, bool COORDS, bool POW2>
__global__ void __launch_bounds__(kThreads, lattice_run::kMinBlocks<BITS, VEC>)
lattice_encode_kernel(const float* __restrict__ x,
                      const float* __restrict__ anchor,
                      const float* __restrict__ u,
                      const float* __restrict__ s, int s_shift,
                      uint32_t* __restrict__ words,
                      int32_t* __restrict__ coords, int64_t n,
                      uint32_t qv) {
  lattice_run::for_each_group(n, s_shift, [&](auto full, auto one_side,
                                              int64_t g, int lane) {
    encode_group<BITS, VEC, ANCHOR, COORDS, POW2, decltype(full)::value,
                 decltype(one_side)::value>(x, anchor, u, s, s_shift, words,
                                            coords, n, qv, g, lane);
  });
}

template <int BITS, int VEC, bool POW2>
void launch(const float* x, const float* anchor, const float* u,
            const float* s, int s_shift, uint32_t* words, int32_t* coords,
            int64_t n, uint32_t qv, cudaStream_t stream) {
  // each instance's occupancy is looked up once, at its first launch
#define ENCODE(A, C)                                                       \
  do {                                                                     \
    auto k = lattice_encode_kernel<BITS, VEC, A, C, POW2>;                \
    static int per_sm = 0;                                                 \
    if (per_sm == 0) per_sm = lattice_run::blocks_per_sm(k);               \
    k<<<lattice_run::grid(per_sm, n), kThreads, 0, stream>>>(              \
        x, anchor, u, s, s_shift, words, coords, n, qv);                  \
  } while (0)
  if (anchor && coords) ENCODE(true, true);
  else if (anchor) ENCODE(true, false);
  else if (coords) ENCODE(false, true);
  else ENCODE(false, false);
#undef ENCODE
}

template <int BITS, bool POW2>
void launch_vec(const float* x, const float* anchor, const float* u,
                const float* s, int s_shift, uint32_t* words,
                int32_t* coords, int64_t n, uint32_t qv,
                cudaStream_t stream) {
  if (lattice_run::aligned16(x, anchor, u, words, coords))
    launch<BITS, 4, POW2>(x, anchor, u, s, s_shift, words, coords, n, qv,
                          stream);
  else
    launch<BITS, 1, POW2>(x, anchor, u, s, s_shift, words, coords, n, qv,
                          stream);
}

// Launches the encode for q colors of `bits` bits each (bits_for_q(q))
// with the instances of POW2: q a power of two (1-bit colors among them),
// or not.  Returns the CUDA error code of the launch (0 = launched); any
// stale error is cleared first so that the code reports this launch alone.
template <bool POW2>
int encode_launch(const float* x, const float* anchor, const float* u,
                  const float* s, int s_shift, uint32_t* words,
                  int32_t* coords, int64_t n, int q, int bits,
                  void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  // bits must be bits_for_q(q): the packable width (1, 2, 4, 8, 16) that
  // holds q colors and the next narrower one does not
  if (bits < 1 || bits > 16 || q < 1 || q > (1 << bits)
      || (bits > 1 && q <= (1 << (bits >> 1)))
      || ((q & (q - 1)) == 0) != POW2)
    return (int)cudaErrorInvalidValue;
  const uint32_t qv = POW2 ? (uint32_t)q - 1u : (uint32_t)q;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 1:
      if constexpr (!POW2) return (int)cudaErrorInvalidValue;
      else launch_vec<1, true>(x, anchor, u, s, s_shift, words, coords, n, qv, st);
      break;
    case 2: launch_vec<2, POW2>(x, anchor, u, s, s_shift, words, coords, n, qv, st); break;
    case 4: launch_vec<4, POW2>(x, anchor, u, s, s_shift, words, coords, n, qv, st); break;
    case 8: launch_vec<8, POW2>(x, anchor, u, s, s_shift, words, coords, n, qv, st); break;
    case 16: launch_vec<16, POW2>(x, anchor, u, s, s_shift, words, coords, n, qv, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
