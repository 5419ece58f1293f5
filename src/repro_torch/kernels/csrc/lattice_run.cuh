// The layout shared by the lattice encode (lattice_encode.cu) and the
// single-payload decode (lattice_decode_kernel in lattice_decode.cu).
//
// A lane handles a quad: 4 consecutive coordinates, 16 bytes of each f32
// or int32 stream, and 4 * BITS consecutive bits of the packed words (a
// byte at 2 bits, a half-word at 4, a word at 8, two words at 16): the
// words pack colors in little-endian lanes, so coordinate c's color is bits
// [c * BITS, (c + 1) * BITS) of the payload, and a quad's colors are one
// aligned unit of the payload that the lane reads or writes whole, with no
// shuffles.  At 1 bit a quad is half a byte: a lane reads the word that
// holds it (the 8 lanes of a word read one address) and shifts, and the
// encode ORs 8 lanes' nibbles into their word by shuffles before one lane
// of the 8 stores it (store_bits then takes the whole word).  Lane l of a
// warp takes quad l of each 128-coordinate step, so every access of the
// warp is one contiguous, coalesced run: 512 bytes of each stream,
// 32 * BITS / 2 bytes of words.
//
// A warp walks a group of kIters steps (kGroup = 512 coordinates), all of
// the group's loads issued before the arithmetic on them: 16 coordinates
// of each stream, 48-64 bytes, in flight per lane.  Groups are aligned, so
// a group lies inside one bucket whenever the bucket holds at least
// kGroup coordinates (the collectives' 1,024 and 4,096 always do), and
// then its side is read once.
//
// The grid is persistent: as many blocks as the card holds at once
// (blocks_per_sm from the occupancy calculator, times the SMs), each warp
// striding over the full groups, then one warp taking the last, partial
// group with guarded accesses.  VEC = 4 is the 16-byte body; VEC = 1 is the
// same code with 4-byte accesses, for pointers off a 16-byte boundary.
#pragma once
#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace lattice_run {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 4;                 // steps of a group
constexpr int kGroup = kIters * 32 * 4;   // coordinates of a group
constexpr int kLogGroup = 9;
// blocks an SM the launch bounds ask for: 3 (<= 80 registers) for the
// 16-byte body, 2 (<= 128) for the 4-byte one, whose scalar loads hold
// more addresses, for 16-bit colors, whose quads are 64-bit units, and for
// 1-bit colors, whose encode spilled 16 bytes at 80 (the shuffled word)
template <int BITS, int VEC>
constexpr int kMinBlocks = VEC == 4 && BITS > 1 && BITS < 16 ? 3 : 2;
static_assert(1 << kLogGroup == kGroup, "kLogGroup");

// The packed bits of one quad (4 * BITS of them).
template <int BITS>
using Bits = std::conditional_t<BITS == 16, uint64_t, uint32_t>;

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b) {
  if constexpr (std::is_same_v<T, float>) return __uint_as_float(b);
  else return (T)b;
}

template <typename T>
__device__ __forceinline__ uint32_t to_bits(T v) {
  if constexpr (std::is_same_v<T, float>) return __float_as_uint(v);
  else return (uint32_t)v;
}

// v[0..3] = p[0..3] (4-byte elements).  In a full group one 16-byte load
// when VEC == 4; in the partial group the `left` elements inside the
// payload, and zero past it.
template <int VEC, bool FULL, typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int64_t left,
                                      T* v) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  if constexpr (FULL && VEC == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = from_bits<T>(t.x);
    v[1] = from_bits<T>(t.y);
    v[2] = from_bits<T>(t.z);
    v[3] = from_bits<T>(t.w);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (FULL || i < left) ? __ldg(p + i) : T(0);
  }
}

// p[0..3] = v[0..3]; in the partial group only the `left` inside.
template <int VEC, bool FULL, typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, int64_t left,
                                       const T* v) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  if constexpr (FULL && VEC == 4) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(to_bits(v[0]), to_bits(v[1]), to_bits(v[2]), to_bits(v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (FULL || i < left) p[i] = v[i];
  }
}

// The packed bits of quad `quad` in a payload of nw words.  In the partial
// group, a word at or past nw reads as zero.
template <int BITS, int VEC, bool FULL>
__device__ __forceinline__ Bits<BITS> load_bits(
    const uint32_t* __restrict__ words, int64_t quad, int64_t nw) {
  if constexpr (BITS == 16) {
    const int64_t w = 2 * quad;
    if constexpr (FULL && VEC == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(words + w));
      return (uint64_t)t.x | ((uint64_t)t.y << 32);
    } else {
      const uint32_t lo = (FULL || w < nw) ? __ldg(words + w) : 0u;
      const uint32_t hi = (FULL || w + 1 < nw) ? __ldg(words + w + 1) : 0u;
      return (uint64_t)lo | ((uint64_t)hi << 32);
    }
  } else {
    constexpr int PER_WORD = 8 / BITS;  // quads a word
    if (!FULL && quad / PER_WORD >= nw) return 0u;
    if constexpr (BITS == 1)
      return __ldg(words + (quad >> 3)) >> ((int)(quad & 7) * 4);
    else if constexpr (BITS == 2)
      return __ldg(reinterpret_cast<const uint8_t*>(words) + quad);
    else if constexpr (BITS == 4)
      return __ldg(reinterpret_cast<const uint16_t*>(words) + quad);
    else
      return __ldg(words + quad);
  }
}

// Writes the packed bits of quad `quad`; in the partial group, not a word
// at or past nw.  At 1 bit, `b` is the whole word of quads quad..quad + 7
// (quad a multiple of 8), gathered by the caller.
template <int BITS, int VEC, bool FULL>
__device__ __forceinline__ void store_bits(uint32_t* __restrict__ words,
                                           int64_t quad, int64_t nw,
                                           Bits<BITS> b) {
  if constexpr (BITS == 16) {
    const int64_t w = 2 * quad;
    if constexpr (FULL && VEC == 4) {
      *reinterpret_cast<uint2*>(words + w) =
          make_uint2((uint32_t)b, (uint32_t)(b >> 32));
    } else {
      if (FULL || w < nw) words[w] = (uint32_t)b;
      if (FULL || w + 1 < nw) words[w + 1] = (uint32_t)(b >> 32);
    }
  } else {
    constexpr int PER_WORD = 8 / BITS;
    if (!FULL && quad / PER_WORD >= nw) return;
    if constexpr (BITS == 1)
      words[quad >> 3] = b;
    else if constexpr (BITS == 2)
      reinterpret_cast<uint8_t*>(words)[quad] = (uint8_t)b;
    else if constexpr (BITS == 4)
      reinterpret_cast<uint16_t*>(words)[quad] = (uint16_t)b;
    else
      words[quad] = b;
  }
}

// v mod q in [0, q), as jnp.mod of an int32 takes it (floor division; C's
// % truncates toward zero); q >= 1.
__device__ __forceinline__ int floor_mod(int v, int q) {
  const int r = v % q;
  return r < 0 ? r + q : r;
}

// True when every pointer (null counts) lies on a 16-byte boundary.
template <typename... P>
inline bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ... | uintptr_t(0)) & 15) == 0;
}

// Resident blocks an SM for one kernel instance (at least 1).
template <typename K>
int blocks_per_sm(K kernel) {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, 0);
  return b > 0 ? b : 1;
}

// SMs of the current device.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Blocks of the persistent grid over n coordinates: as many as the card
// holds at once, or fewer when the groups are fewer.
inline unsigned grid(int per_sm, int64_t n) {
  const int64_t groups = (n + kGroup - 1) / kGroup;
  const int64_t need = (groups + kWarps - 1) / kWarps;
  return (unsigned)std::min<int64_t>(need, (int64_t)per_sm * sm_count());
}

// Walks this warp's groups: body<FULL, ONE_SIDE>(g, lane) for each full
// group g, ONE_SIDE when a group lies inside one bucket (s_shift >=
// kLogGroup, scalar sides included), then the partial group, if any, on
// the one warp that reaches it.
template <typename Body>
__device__ __forceinline__ void for_each_group(int64_t n, int s_shift,
                                               Body body) {
  const int lane = threadIdx.x & 31;
  const int64_t full = n / kGroup;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s_shift >= kLogGroup) {
    for (; g < full; g += stride)
      body(std::true_type{}, std::true_type{}, g, lane);
  } else {
    for (; g < full; g += stride)
      body(std::true_type{}, std::false_type{}, g, lane);
  }
  if (g == full && full * kGroup < n)
    body(std::false_type{}, std::false_type{}, g, lane);
}

}  // namespace lattice_run
