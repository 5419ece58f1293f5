// Proximity decode of packed lattice payloads for Hopper (sm_90a): one
// payload (lattice_decode_kernel) or S payloads against one anchor
// (lattice_decode_batched_kernel).  The kernels of lattice_decode.cu (q a
// power of two) and lattice_decode_any.cu (q not a power of two), two
// libraries that build in parallel.
//
// Replaces: repro/kernels/lattice_decode.py, lattice_decode_pallas
// (_decode_kernel) and lattice_decode_batched_pallas
// (_decode_batched_kernel), both with their math in _decode_math.  For a
// payload's coordinate c < n:
//     col  = (words[c / PER] >> ((c % PER) * BITS)) & (2^BITS - 1)
//     av   = anchor[c] - ref[c]                         (ref optional)
//     k_a  = round_half_even(av / s - u[c])
//     k    = k_a + (((col - k_a + q/2) mod q) - q/2)
// and writes k (coords mode, int32) or z = (k + u[c]) * s (+ ref[c])
// (point mode, f32).  The single decode's point mode may add the
// running-average epilogue z' = (z + anchor[c] * avg_cnt) * recip, with
// recip the f32 rounding of 1 / (avg_cnt + 1), a multiply as in the TPU
// kernel.  BITS = bits_for_q(q) is 1, 2, 4, 8 or 16, for any q in
// [1, 65536] and any n >= 1: the reference's kernels take q a power of two
// with 2 to 16 bits and n >= 32, and send the rest to their plain version,
// which computes the same function.  Where q is a power of two (POW2)
// "& (q-1)" is the mod and also masks the field; otherwise the field's
// mask comes first (a 2-bit field at q = 3 may hold 3, and the reference
// folds it), and the mod is the floor mod of the int32 col - k_a + q/2
// (jnp.mod; it wraps as XLA's int32 sum does).
//
// Sides: s[i * s_row + (c >> s_shift)] for payload i.  The collectives and
// the server's drain pass per-bucket sidecars ((nb,) or (S, nb)) with
// s_shift = log2(bucket), so the per-coordinate broadcast the reference
// builds (1.1 GB per payload at 278 M coordinates) never exists.  (n,)
// sides use s_shift = 0, (S, n) s_row = n, a scalar s_row = 0 and
// s_shift = 63.
//
// Numerics copied from the reference: IEEE division (__fdiv_rn), round
// half to even (__float2int_rn), and no mul-add contraction in point mode
// (__fadd_rn / __fmul_rn; the file is also built with -fmad=false).  The
// centered-mod arithmetic runs in uint32 so that it wraps, as XLA's int32
// arithmetic does, without signed-overflow behaviour.  Both kernels share
// that math (decode_coord, decode_point).  For q not a power of two the
// mod is one integer remainder a coordinate, far below the compute roof.
//
// Bound on this card: memory.  Single decode, per coordinate: BITS/8 B of
// words, 4 B each of anchor and dither (and of ref) read once, 4 B
// written; per-bucket sides 4 B per bucket.  At q = 16 in coords mode that
// is 12.5 B per coordinate (16.5 B with ref): 1.04 ms for 277,848,064
// coordinates at 3.35 TB/s.  Batched decode: S * BITS/8 B of words, 8 B of
// anchor + dither (12 B with ref) once, S * 4 B written; 80 B per
// coordinate at q = 16 and S = 16.
//
// Design of the single decode (lattice_run.cuh): lane l of a warp
// decodes 4 consecutive coordinates of each 128-coordinate step, so the
// warp's loads of anchor, dither and ref and its stores of k or z are
// contiguous 512-byte runs of 16-byte accesses, and the lane reads its 4
// colors as one aligned unit of the payload (a byte at 2 bits, a
// half-word at 4, a word at 8, two at 16; at 1 bit the word that holds
// its 4 bits, shifted, one address for 8 lanes): the warp's word loads are
// contiguous too.  A warp issues the loads of 4 steps (512 coordinates)
// before their arithmetic and reads a group's side once when the group
// lies inside one bucket.  The grid is persistent (as many blocks as fit on
// the card at once, each warp striding over groups); the last, partial
// group takes guarded 4-byte accesses, and any pointer off a 16-byte
// boundary (a caller's view) takes the same kernel instantiated with
// 4-byte accesses.
//
// The batched kernel runs one thread per coordinate and loops over the
// senders with the anchor, dither and ref of its coordinate held in
// registers (the TPU kernel's "anchor block read once per tile"): every
// load of anchor, dither and ref and every store is a coalesced 4-byte
// access across the warp, and the PER threads that share a word read the
// same address (one transaction).  No shared memory, no allocation; each
// launch goes on the caller's stream.
#pragma once
#include "lattice_run.cuh"

namespace {

// qv, the q argument of the two helpers below: q - 1 when POW2, else q.
template <bool POW2>
__host__ __device__ __forceinline__ uint32_t q_arg(uint32_t q) {
  return POW2 ? q - 1u : q;
}

// k of one coordinate: av is anchor - ref, uv the dither, sv the side.
// POW2: qv = q - 1 masks the mod; otherwise the floor mod by qv = q of the
// wrapped int32 sum.
template <bool POW2>
__device__ __forceinline__ int decode_coord(uint32_t col, float av, float uv,
                                            float sv, uint32_t qv,
                                            uint32_t half) {
  const int ka = __float2int_rn(__fsub_rn(__fdiv_rn(av, sv), uv));
  uint32_t delta;
  if constexpr (POW2) {
    delta = ((col - (uint32_t)ka + half) & qv) - half;
  } else {
    const int t = (int)(col - (uint32_t)ka + half);
    delta = (uint32_t)lattice_run::floor_mod(t, (int)qv) - half;
  }
  return (int)((uint32_t)ka + delta);
}

// The color in field j of packed bits: masked by qv = q - 1 where q is a
// power of two, else by the field's width (2^BITS - 1).
template <int BITS, bool POW2, typename B>
__device__ __forceinline__ uint32_t field(B bits, int j, uint32_t qv) {
  const uint32_t v = (uint32_t)(bits >> (j * BITS));
  if constexpr (POW2) return v & qv;
  else return v & ((1u << BITS) - 1u);
}

// z = (k + u) * s, plus ref when the sender subtracted one.
template <bool REF>
__device__ __forceinline__ float decode_point(int k, float uv, float sv,
                                              float rv) {
  float z = __fmul_rn(__fadd_rn(__int2float_rn(k), uv), sv);
  if (REF) z = __fadd_rn(z, rv);
  return z;
}

// One group of 512 coordinates: lane `lane`'s 4 coordinates of each step.
template <int BITS, int VEC, bool COORDS, bool REF, bool AVG, bool POW2,
          bool FULL, bool ONE_SIDE>
__device__ __forceinline__ void decode_group(
    const uint32_t* __restrict__ words, const float* __restrict__ anchor,
    const float* __restrict__ u, const float* __restrict__ ref,
    const float* __restrict__ s, int s_shift, void* __restrict__ out,
    int64_t n, uint32_t q, float avg_cnt, float recip, int64_t g,
    int lane) {
  using lattice_run::kIters;
  using lattice_run::load4;
  using lattice_run::store4;
  using Out = std::conditional_t<COORDS, int32_t, float>;
  const int64_t c0 = g * lattice_run::kGroup + 4 * lane;
  const int64_t nw = (n * BITS + 31) / 32;
  const float s_group = ONE_SIDE ? __ldg(s + (c0 >> s_shift)) : 0.f;
  const uint32_t qv = q_arg<POW2>(q), half = q >> 1;
  float av[kIters][4], uv[kIters][4], rv[kIters][4];
  lattice_run::Bits<BITS> wb[kIters];
  // every load of the group is in flight before the arithmetic below
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int64_t c = c0 + it * 128;
    wb[it] = lattice_run::load_bits<BITS, VEC, FULL>(words, c >> 2, nw);
    load4<VEC, FULL>(anchor + c, n - c, av[it]);
    load4<VEC, FULL>(u + c, n - c, uv[it]);
    if (REF) load4<VEC, FULL>(ref + c, n - c, rv[it]);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int64_t c = c0 + it * 128;
    Out ov[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sv = ONE_SIDE ? s_group
                       : (FULL || c + j < n) ? __ldg(s + ((c + j) >> s_shift))
                                             : 1.f;
      const uint32_t col = field<BITS, POW2>(wb[it], j, qv);
      const float a = av[it][j];
      const float r = REF ? rv[it][j] : 0.f;
      const int k = decode_coord<POW2>(col, REF ? __fsub_rn(a, r) : a,
                                       uv[it][j], sv, qv, half);
      if constexpr (COORDS) {
        ov[j] = k;
      } else {
        float z = decode_point<REF>(k, uv[it][j], sv, r);
        if (AVG) z = __fmul_rn(__fadd_rn(z, __fmul_rn(a, avg_cnt)), recip);
        ov[j] = z;
      }
    }
    store4<VEC, FULL>(static_cast<Out*>(out) + c, n - c, ov);
  }
}

template <int BITS, int VEC, bool COORDS, bool REF, bool AVG, bool POW2>
__global__ void __launch_bounds__(lattice_run::kThreads,
                                  lattice_run::kMinBlocks<BITS, VEC>)
lattice_decode_kernel(
    const uint32_t* __restrict__ words, const float* __restrict__ anchor,
    const float* __restrict__ u, const float* __restrict__ ref,
    const float* __restrict__ s, int s_shift, void* __restrict__ out,
    int64_t n, uint32_t q, float avg_cnt, float recip) {
  lattice_run::for_each_group(n, s_shift, [&](auto full, auto one_side,
                                              int64_t g, int lane) {
    decode_group<BITS, VEC, COORDS, REF, AVG, POW2, decltype(full)::value,
                 decltype(one_side)::value>(words, anchor, u, ref, s, s_shift,
                                            out, n, q, avg_cnt, recip, g,
                                            lane);
  });
}

template <int BITS, bool COORDS, bool REF, bool POW2>
__global__ void lattice_decode_batched_kernel(
    const uint32_t* __restrict__ words, int64_t w_row,
    const float* __restrict__ anchor, const float* __restrict__ u,
    const float* __restrict__ ref, const float* __restrict__ s,
    int64_t s_row, int s_shift, void* __restrict__ out, int64_t senders,
    int64_t n, uint32_t q) {
  constexpr int PER = 32 / BITS;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const float uv = u[c];
  const float rv = REF ? ref[c] : 0.f;
  const float av = REF ? __fsub_rn(anchor[c], rv) : anchor[c];
  const int64_t w = c / PER;
  const int shift = (int)(c % PER) * BITS;
  const uint32_t qv = q_arg<POW2>(q), half = q >> 1;
  const int64_t sc = c >> s_shift;
  for (int64_t i = 0; i < senders; ++i) {
    const uint32_t col =
        field<BITS, POW2>(words[i * w_row + w] >> shift, 0, qv);
    const float sv = s[i * s_row + sc];
    const int k = decode_coord<POW2>(col, av, uv, sv, qv, half);
    if (COORDS) {
      static_cast<int32_t*>(out)[i * n + c] = k;
    } else {
      static_cast<float*>(out)[i * n + c] = decode_point<REF>(k, uv, sv, rv);
    }
  }
}

constexpr int kThreads = 256;  // the batched kernel's block

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int BITS, int VEC, bool POW2>
void launch_one(const uint32_t* words, const float* anchor, const float* u,
                const float* ref, const float* s, int s_shift, void* out,
                int coords, int avg, float avg_cnt, float recip, int64_t n,
                uint32_t q, cudaStream_t stream) {
  // each instance's occupancy is looked up once, at its first launch
#define DECODE_ONE(C, R, A)                                                \
  do {                                                                     \
    auto k = lattice_decode_kernel<BITS, VEC, C, R, A, POW2>;             \
    static int per_sm = 0;                                                 \
    if (per_sm == 0) per_sm = lattice_run::blocks_per_sm(k);               \
    k<<<lattice_run::grid(per_sm, n), lattice_run::kThreads, 0,           \
        stream>>>(words, anchor, u, ref, s, s_shift, out, n, q, avg_cnt,  \
                  recip);                                                  \
  } while (0)
  if (coords && ref) DECODE_ONE(true, true, false);
  else if (coords) DECODE_ONE(true, false, false);
  else if (ref && avg) DECODE_ONE(false, true, true);
  else if (ref) DECODE_ONE(false, true, false);
  else if (avg) DECODE_ONE(false, false, true);
  else DECODE_ONE(false, false, false);
#undef DECODE_ONE
}

template <int BITS, bool POW2>
void launch_one_vec(const uint32_t* words, const float* anchor,
                    const float* u, const float* ref, const float* s,
                    int s_shift, void* out, int coords, int avg,
                    float avg_cnt, float recip, int64_t n, uint32_t q,
                    cudaStream_t stream) {
  if (lattice_run::aligned16(words, anchor, u, ref, out))
    launch_one<BITS, 4, POW2>(words, anchor, u, ref, s, s_shift, out, coords,
                              avg, avg_cnt, recip, n, q, stream);
  else
    launch_one<BITS, 1, POW2>(words, anchor, u, ref, s, s_shift, out, coords,
                              avg, avg_cnt, recip, n, q, stream);
}

template <int BITS, bool POW2>
void launch_batched_q(const uint32_t* words, int64_t w_row,
                      const float* anchor, const float* u, const float* ref,
                      const float* s, int64_t s_row, int s_shift, void* out,
                      int coords, int64_t senders, int64_t n, uint32_t q,
                      cudaStream_t stream) {
#define DECODE_BATCHED(C, R)                                              \
  lattice_decode_batched_kernel<BITS, C, R, POW2><<<blocks_for(n),        \
                                                    kThreads, 0,          \
                                                    stream>>>(            \
      words, w_row, anchor, u, ref, s, s_row, s_shift, out, senders, n, q)
  if (coords && ref) DECODE_BATCHED(true, true);
  else if (coords) DECODE_BATCHED(true, false);
  else if (ref) DECODE_BATCHED(false, true);
  else DECODE_BATCHED(false, false);
#undef DECODE_BATCHED
}

// bits is bits_for_q(q), q in [1, 65536]: the packable width (1, 2, 4, 8,
// 16) that holds q colors and the next narrower one does not; POW2 says
// whether q is a power of two
template <bool POW2>
bool q_fits(int q, int bits) {
  return bits >= 1 && bits <= 16 && q >= 1 && q <= (1 << bits)
         && (bits == 1 || q > (1 << (bits >> 1)))
         && ((q & (q - 1)) == 0) == POW2;
}

// The launchers of the instances of POW2: q a power of two (1-bit colors
// among them), or not.  Each returns the CUDA error code of its launch (0 =
// launched); any stale error is cleared first so that the code reports
// this launch alone.  ref may be null.

// One payload: out is (n,) int32 when coords != 0, else f32.  avg != 0
// (point mode only) adds the running-average epilogue with avg_cnt and
// recip = f32(1 / (avg_cnt + 1)).
template <bool POW2>
int decode_launch(const uint32_t* words, const float* anchor, const float* u,
                  const float* ref, const float* s, int s_shift, void* out,
                  int coords, int avg, float avg_cnt, float recip, int64_t n,
                  int q, int bits, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (coords && avg) return (int)cudaErrorInvalidValue;
  if (!q_fits<POW2>(q, bits)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t uq = (uint32_t)q;
  switch (bits) {
    case 1:
      if constexpr (!POW2) return (int)cudaErrorInvalidValue;
      else launch_one_vec<1, true>(words, anchor, u, ref, s, s_shift, out, coords, avg, avg_cnt, recip, n, uq, st);
      break;
    case 2: launch_one_vec<2, POW2>(words, anchor, u, ref, s, s_shift, out, coords, avg, avg_cnt, recip, n, uq, st); break;
    case 4: launch_one_vec<4, POW2>(words, anchor, u, ref, s, s_shift, out, coords, avg, avg_cnt, recip, n, uq, st); break;
    case 8: launch_one_vec<8, POW2>(words, anchor, u, ref, s, s_shift, out, coords, avg, avg_cnt, recip, n, uq, st); break;
    case 16: launch_one_vec<16, POW2>(words, anchor, u, ref, s, s_shift, out, coords, avg, avg_cnt, recip, n, uq, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// S payloads: out is (senders, n) int32 when coords != 0, else f32.
template <bool POW2>
int decode_batched_launch(const uint32_t* words, int64_t w_row,
                          const float* anchor, const float* u,
                          const float* ref, const float* s, int64_t s_row,
                          int s_shift, void* out, int coords,
                          int64_t senders, int64_t n, int q, int bits,
                          void* stream) {
  cudaGetLastError();
  if (n <= 0 || senders <= 0) return 0;
  if (!q_fits<POW2>(q, bits)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t uq = (uint32_t)q;
  switch (bits) {
    case 1:
      if constexpr (!POW2) return (int)cudaErrorInvalidValue;
      else launch_batched_q<1, true>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st);
      break;
    case 2: launch_batched_q<2, POW2>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    case 4: launch_batched_q<4, POW2>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    case 8: launch_batched_q<8, POW2>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    case 16: launch_batched_q<16, POW2>(words, w_row, anchor, u, ref, s, s_row, s_shift, out, coords, senders, n, uq, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
