// Normalized fast Walsh-Hadamard transform over rows, for Hopper (sm_90a).
//
// Replaces: repro/kernels/fwht.py, fwht_pallas -> _fwht_2d (_fwht_kernel).
// The TPU kernel multiplies each row by H_a (x) H_b on the matrix unit.
// Here the transform is the textbook butterfly, (a, b) -> (a + b, a - b)
// over index bit 0, 1, 2, ..., log2(d) - 1 in that order, then one product
// with float32(1/sqrt(d)).  Input and output are f32, or bf16 with f32
// inside (rounded to nearest even once, at the store); d is any power of
// two: the reference's kernel takes [4, 16384] and sends other lengths to
// its plain version, which computes the same function.
//
// Bitwise with the plain version (fwht_torch).  Every stage is one
// __fadd_rn / __fsub_rn with `a` the lower index, the stages run in the
// plain version's order (bit 0 first), and the scale is one __fmul_rn
// after the last stage.  Which bits sit in registers, lanes or warps, and
// which launch runs a stage, only moves values around; it never changes
// what is added to what, or when.
//
// Bound on this card: HBM.  Each coordinate is read once and written once:
// 8 bytes a coordinate in f32, 4 in bf16.  The log2(d) adds a coordinate
// are far below the CUDA cores' rate.
//
// Design.  A block owns a tile of 2^TB coordinates, TB = max(log2 d, 12):
// whole rows (4096 / d of them for d <= 4096), with 2^(TB-4) threads of 16
// coordinates each.  Index bits of the tile in each pass:
//
//   pass 0   registers 0-3     lanes 4-8          warps 9-11   (16-byte loads)
//   pass 1   registers 4-7     lanes 0-3, 8       warps 9-11
//   pass 2   registers 8-11    lanes 0-4          warps 5-7    (d = 4096: 8-11)
//   pass 3   registers TB-4..  lanes 0-4          (d = 8192, 16384 only)
//
// Bits >= log2(d) are row bits: they ride along and get no stage.  A pass
// runs the stages of its register bits that no earlier pass ran (pass 3
// overlaps pass 2 for d = 8192 and 16384).  Between passes the tile goes
// through shared memory once, in natural order with bank bits 2, 3, 4
// XORed with index bits 5, 6, 8.  That makes every access free of bank
// conflicts: the pass-0 writes are 16-byte stores whose 8-lane phases vary
// bits 4-6, and every other access is a 4-byte one whose 32 lanes vary five
// bits that the swizzle maps onto the 32 banks one to one.  After the last
// stage and the scale, two (f32) or three (bf16) XOR shuffles swap the
// lowest lane bits with the lowest register bits, so each thread holds runs
// of 16 bytes of output, and the stores are 16-byte ones too.
//
// Shared-memory traffic of a 4096-point f32 row (256 threads, 8 warps):
// per warp 4 STS.128 (16 wavefronts) + 16 LDS.32 into pass 1, 16 STS.32 +
// 16 LDS.32 into pass 2: 64 wavefronts, 512 a row (the shared-memory
// butterfly this replaces took 4,608), plus 16 SHFL a warp, 128 a row
// (bf16: 24 a warp, 192 a row).  No stage waits on shared memory, and with
// up to six 256-thread blocks an SM, one block's loads are in flight while
// another's stages run.
//
// d = 1 and 2 are rows of the same tile kernel with no stage or one.
//
// Rows of 2^15 to 2^18 take one launch of fwht_cluster_kernel: a thread
// block cluster of C = d / 16384 blocks (2 to 16; 16 is a non-portable
// cluster size, allowed at launch) owns a row, each block a chunk of
// 16,384 consecutive coordinates in 64 KB of f32 shared memory.  A block
// of 512 threads holds 32 coordinates a thread and runs index bits 0-13
// of its chunk in three register passes (bits 0-4, 5-9, 10-13; the last
// pass holds bits 9-13) with two transposes through shared memory in
// between (bank bits 2-4 XORed with index bits 5-7: the pass-0 16-byte
// stores and every 4-byte access are free of conflicts), then writes its
// f32 chunk to shared memory in natural order.  After a cluster barrier,
// block r reads its 1/C of the columns (the low 14 index bits) from all C
// chunks through distributed shared memory, in runs of 16 or 8 bytes that
// a warp reads as one contiguous run of a peer's chunk, runs the stages of
// index bits 14 .. 13 + log2(C) in registers (bit 14 first), scales once
// and stores its columns of every chunk.  A second cluster barrier (for
// f32 out arrived at after the reads and waited on after the stores)
// keeps every block's shared memory alive until its peers have read it.
// So a row is read once and written once, with no f32 scratch for bf16; the
// stage order and the single scale keep it bitwise with the plain
// version.  Two 512-thread blocks an SM (at most 64 registers a thread,
// 128 KB of shared memory) let one block's loads run while the other
// exchanges; the distributed reads add (C - 1) / C of a row a block.
//
// Rows of 2^19 to 2^22, d = 2^L, take one launch of fwht_fused_kernel,
// which runs in one grid what a tile launch over the low index bits and a
// further launch over the high ones would run.  A row of 2^20 f32 (4 MiB)
// does not fit in a cluster's shared memory, but a few rows fit in the 50
// MB L2, and the intermediate stays there.  A low item is the tile kernel's
// body over 2^S consecutive coordinates of a row (index bits 0 .. S - 1,
// S = L - 7 up to 2^20, L - 8 past it), written as unscaled f32 to a
// workspace; a high item is 2^(S - 12) of fwht_high_kernel's tiles of 4096
// (256 threads each) over bits S .. L - 1, read from the workspace, scaled
// once and written to out.  A row has 2^(L - S) items of each kind.
// Blocks have the tile kernel's threads at 2^S, as many an SM as fit, and
// loop over tickets they draw with atomicAdd, the next one while they work
// on this one.  In ticket order
// the low items of row r + lag come before the high items of row r, so
// that by the time a high item starts its row's low items are done; it
// waits (thread 0 spins on an acquire load) until all of them have
// published (a release add by thread 0 behind a block barrier, made once
// the next item's loads are issued), and reads the workspace with
// ld.global.cg, past L1, since other SMs wrote it in this launch.  A block
// publishes before it ever waits and waits only on lower tickets, so the
// lowest ticket not yet published always runs: no co-residency is needed
// and nothing can deadlock.  The workspace of f32 output is the output
// itself: a high item rewrites the low items' lines in place while they
// are still in L2.  bf16 output takes a ring of `slots` (>= lag + 1) f32
// rows: a low item of row r >= slots waits, before its stores, until the
// high items of row r - slots (whose tickets are lower) are done with the
// slot.  x is read and out written evict-first in L2, the workspace read
// evict-first, so that the lines the high items still need stay.  The
// block that finishes last sets the counters back to 0.  Every element
// gets the same adds in the same order as in the tile and further
// launches, so the bits are the same.
//
// Rows longer than 2^22, d = 2^L, take two launches (three past 2^30): the
// fused kernel over segments of 2^G, G = min(22, max(20, L - 8)) (index
// bits 0 .. G - 1 act on each segment on its own; 2^22 is the fused
// kernel's slowest length, so the shortest segments that leave at most 8
// bits), unscaled, writing f32 (into the output for f32, into a scratch
// tensor the wrapper allocates for bf16); then each further launch
// (fwht_high_kernel) runs the stages of K <= 8 of the high index bits, b0
// .. b0 + K - 1, in place on that f32 tensor: a block takes a tile of 2^K
// rows of those bits (2^b0 elements apart) by 4096 / 2^K consecutive
// columns, the same column across a warp so that every load and store is
// a coalesced run; a thread holds 16 values, 4 bits of stages in registers
// at a time, the next 4 through shared memory.  Only the last launch
// scales and rounds to the output type.  Intermediates stay f32 between
// launches, so the sums are the plain version's.
//
// A pointer that is not on a 16-byte boundary (a view that starts inside a
// row of a small bf16 tensor) takes the same kernel with one-element loads
// and stores.  No allocation; the launch goes on the caller's stream.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRegs = 16;  // coordinates a thread holds

template <int L>
struct Geo {
  static constexpr int TB = L > 12 ? L : 12;         // tile bits
  static constexpr int THREADS = 1 << (TB - 4);
  static constexpr int PASSES = L > 4 ? (L + 3) / 4 : 1;
  // six 256-thread blocks an SM (at most 40 registers a thread)
  static constexpr int MIN_BLOCKS = THREADS >= 1024 ? 1 : 1536 / THREADS;
};

// Lowest index bit held in registers in pass p.
template <int L>
__host__ __device__ constexpr int reg_lo(int p) {
  return 4 * p + 3 < Geo<L>::TB ? 4 * p : Geo<L>::TB - 4;
}

// Index bits of thread `tid` in a pass whose registers hold bits lo..lo+3.
__host__ __device__ constexpr int thread_bits(int lo, int tid) {
  return (tid & ((1 << lo) - 1)) | ((tid >> lo) << (lo + 4));
}

// Shared-memory word of tile index i: bank bits 2, 3, 4 XOR bits 5, 6, 8.
// Linear, so swz(a | b) = swz(a) ^ swz(b) for disjoint a and b.
__host__ __device__ constexpr int swz(int i) {
  return i ^ ((i >> 3) & 0xC) ^ ((i >> 4) & 0x10);
}

// 16-byte and one-element loads and stores, converting to and from f32.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  // evict-first in L2 (ld.global.cs): read once, by the fused kernel
  static __device__ __forceinline__ void load_once(const float* p, float* v) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
  static __device__ __forceinline__ void load_once(const __nv_bfloat16* p,
                                                   float* v) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// VEC coordinates from x[g..], zeros past n (only the last tile of rows
// shorter than a tile is ragged; n is a multiple of 4).
template <typename T, bool VEC_IO>
__device__ __forceinline__ void load_run(const T* __restrict__ x, int64_t g,
                                         int64_t n, float* v) {
  constexpr int VEC = Io<T>::VEC;
  if (VEC_IO && g + VEC <= n) {
    Io<T>::load(x + g, v);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) v[c] = g + c < n ? Io<T>::load1(x + g + c) : 0.0f;
  }
}

template <typename T, bool VEC_IO>
__device__ __forceinline__ void store_run(T* __restrict__ out, int64_t g,
                                          int64_t n, const float* v) {
  constexpr int VEC = Io<T>::VEC;
  if (VEC_IO && g + VEC <= n) {
    Io<T>::store(out + g, v);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      if (g + c < n) Io<T>::store1(out + g + c, v[c]);
  }
}

// The stages of pass P: register bit j holds index bit reg_lo(P) + j; the
// stages run over the bits in [4P, L), lowest first.
template <int L, int P>
__device__ __forceinline__ void stages(float (&v)[kRegs]) {
  constexpr int lo = reg_lo<L>(P);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (lo + j < 4 * P || lo + j >= L) continue;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      if (r & (1 << j)) continue;
      const float a = v[r], b = v[r | (1 << j)];
      v[r] = __fadd_rn(a, b);
      v[r | (1 << j)] = __fsub_rn(a, b);
    }
  }
}

// From the registers of pass P to those of pass P + 1 through shared memory.
template <int L, int P>
__device__ __forceinline__ void transpose(float (&v)[kRegs], float* sm, int tid) {
  constexpr int lo_a = reg_lo<L>(P), lo_b = reg_lo<L>(P + 1);
  if (P > 0) __syncthreads();  // the last transpose has been read
  if constexpr (lo_a == 0) {
    // 16 consecutive coordinates: four 16-byte stores (swz keeps bits 0-1)
    const int base = swz(tid << 4) >> 2;
    float4* sm4 = reinterpret_cast<float4*>(sm);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sm4[base ^ c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
    const int base = swz(thread_bits(lo_a, tid));
#pragma unroll
    for (int r = 0; r < kRegs; ++r) sm[base ^ swz(r << lo_a)] = v[r];
  }
  __syncthreads();
  const int base = swz(thread_bits(lo_b, tid));
#pragma unroll
  for (int r = 0; r < kRegs; ++r) v[r] = sm[base ^ swz(r << lo_b)];
}

// Swap lane bits 0..E-1 with register bits 0..E-1 (pure data movement).
template <int E>
__device__ __forceinline__ void exchange(float (&v)[kRegs], int lane) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const bool hi = (lane >> j) & 1;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      if (r & (1 << j)) continue;
      const int r1 = r | (1 << j);
      const float got = __shfl_xor_sync(0xffffffffu, hi ? v[r] : v[r1], 1 << j);
      if (hi) v[r] = got; else v[r1] = got;
    }
  }
}

// The tile kernel's work on one tile of 2^TB coordinates, TO out; SCALE
// false (a low item of the fused kernel) leaves the scale to the high
// items.  On every thread: load(v) fills v with the thread's 16 consecutive
// coordinates (index tid << 4 ...), loaded() runs next, pre() after the
// stages, and put(g, v) stores VEC values from tile index g on: runs of 16
// bytes of TO after an exchange, or (VEC = 1, f32) one value a store, a
// warp's 32 at consecutive indices.
template <int L, typename TO, bool SCALE, int VEC = Io<TO>::VEC,
          typename Load, typename Loaded, typename Pre, typename Put>
__device__ __forceinline__ void tile_body(float scale, int tid, float* sm,
                                          Load load, Loaded loaded, Pre pre,
                                          Put put) {
  constexpr int P = Geo<L>::PASSES;
  float v[kRegs];

  // pass 0: the thread's 16 consecutive coordinates
  load(v);
  loaded();
  stages<L, 0>(v);
  if constexpr (P > 1) { transpose<L, 0>(v, sm, tid); stages<L, 1>(v); }
  if constexpr (P > 2) { transpose<L, 1>(v, sm, tid); stages<L, 2>(v); }
  if constexpr (P > 3) { transpose<L, 2>(v, sm, tid); stages<L, 3>(v); }
  if constexpr (SCALE) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) v[r] = __fmul_rn(v[r], scale);
  }
  pre();

  if constexpr (P == 1) {
#pragma unroll
    for (int k = 0; k < kRegs / VEC; ++k)
      put((tid << 4) + k * VEC, v + k * VEC);
  } else if constexpr (VEC == 1) {
    // one value a store, a warp's 32 consecutive
    constexpr int lo = reg_lo<L>(P - 1);
    const int base = thread_bits(lo, tid);
#pragma unroll
    for (int r = 0; r < kRegs; ++r) put(base | (r << lo), v + r);
  } else {
    // Lane bits 0..E-1 hold index bits 0..E-1 in passes >= 1; after the
    // swap the registers hold them, and lane bits 0..E-1 index bits
    // lo..lo+E-1.
    constexpr int E = VEC == 4 ? 2 : 3, M = (1 << E) - 1;
    constexpr int lo = reg_lo<L>(P - 1);
    exchange<E>(v, tid & 31);
    const int base = ((tid & M) << lo) | (tid & ((1 << lo) - 1) & ~M)
                     | ((tid >> lo) << (lo + 4));
#pragma unroll
    for (int k = 0; k < kRegs / VEC; ++k)
      put(base | (k << (lo + E)), v + k * VEC);
  }
}

struct Nothing {
  __device__ void operator()() const {}
};

// Rows of 2^L <= 2^14 (whole, several a tile below 2^12): a block a tile.
template <typename T, int L, bool VEC_IO>
__global__ void __launch_bounds__(Geo<L>::THREADS, Geo<L>::MIN_BLOCKS)
fwht_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, float scale) {
  constexpr int VI = Io<T>::VEC;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int64_t g0 = (int64_t)blockIdx.x << Geo<L>::TB;
  auto load = [&](float* v) {
#pragma unroll
    for (int k = 0; k < kRegs / VI; ++k)
      load_run<T, VEC_IO>(x, g0 + (tid << 4) + k * VI, n, v + k * VI);
  };
  auto put = [&](int g, const float* v) {
    store_run<T, VEC_IO>(out, g0 + g, n, v);
  };
  tile_body<L, T, true>(scale, tid, reinterpret_cast<float*>(smem4), load,
                        Nothing{}, Nothing{}, put);
}

// Rows of 2^15 .. 2^18 in one launch: a cluster of C = 2^(L - 14) blocks a
// row, each a chunk of kChunk coordinates, 32 a thread.
constexpr int kChunkLog2 = 14, kChunk = 1 << kChunkLog2;
constexpr int kClusterThreads = 512, kClusterRegs = 32;

// Shared-memory word of chunk index i in the transposes: bank bits 2-4
// XOR index bits 5-7.  Linear; keeps bits 0-1, so 16-byte runs stay whole.
__device__ __forceinline__ int swz32(int i) { return i ^ (((i >> 5) & 7) << 2); }

// The stages over register bits LO .. HI - 1 of 32 registers, lowest first.
template <int LO, int HI>
__device__ __forceinline__ void reg_stages32(float (&v)[kClusterRegs]) {
#pragma unroll
  for (int j = LO; j < HI; ++j)
#pragma unroll
    for (int r = 0; r < kClusterRegs; ++r) {
      if (r & (1 << j)) continue;
      const float a = v[r], b = v[r | (1 << j)];
      v[r] = __fadd_rn(a, b);
      v[r | (1 << j)] = __fsub_rn(a, b);
    }
}

// N (2 or 4) consecutive values rounded to TO and stored: one 8- or 16-byte
// store where the pointers are on 16-byte boundaries, else one a value.
template <typename TO, int N, bool VEC_IO>
__device__ __forceinline__ void store_n(TO* p, const float* v) {
  if constexpr (!VEC_IO) {
#pragma unroll
    for (int c = 0; c < N; ++c) Io<TO>::store1(p + c, v[c]);
  } else if constexpr (std::is_same_v<TO, float>) {
    if constexpr (N == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    if constexpr (N == 4) {
      __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                             __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

// One row of 2^L (15 <= L <= 18) per cluster of C blocks, block rank r the
// row's chunk r.
template <typename T, int L, bool VEC_IO>
__global__ void __launch_bounds__(kClusterThreads, 2)
fwht_cluster_kernel(const T* __restrict__ x, T* __restrict__ out, float scale) {
  namespace cg = cooperative_groups;
  constexpr int CL = L - kChunkLog2, C = 1 << CL;   // cluster bits, blocks
  constexpr int W = kChunk / C;                      // columns a block owns
  constexpr int CP = kClusterRegs / C;               // columns a thread owns,
  constexpr int VW = CP < 4 ? CP : 4;                // in runs of VW
  constexpr int G = CP / VW;
  constexpr int VI = Io<T>::VEC;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int64_t g0 = (int64_t)blockIdx.x << kChunkLog2;         // the chunk
  const int64_t row0 = g0 - ((int64_t)rank << kChunkLog2);      // its row
  float v[kClusterRegs];

  // pass 0: the thread's 32 consecutive coordinates, index bits 0-4
#pragma unroll
  for (int k = 0; k < kClusterRegs / VI; ++k) {
    const int64_t g = g0 + (tid << 5) + k * VI;
    if constexpr (VEC_IO) {
      Io<T>::load(x + g, v + k * VI);
    } else {
#pragma unroll
      for (int c = 0; c < VI; ++c) v[k * VI + c] = Io<T>::load1(x + g + c);
    }
  }
  reg_stages32<0, 5>(v);
  {
    // eight 16-byte stores: swz32 XORs the run index with tid bits 0-2
    float4* sm4 = reinterpret_cast<float4*>(sm);
    const int base = swz32(tid << 5) >> 2;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      sm4[base ^ c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                                  v[4 * c + 3]);
  }
  __syncthreads();
  // pass 1: registers index bits 5-9, lanes bits 0-4, warps bits 10-13
  const int t1 = (tid & 31) | ((tid >> 5) << 10);
#pragma unroll
  for (int r = 0; r < kClusterRegs; ++r) v[r] = sm[swz32(t1 | (r << 5))];
  reg_stages32<0, 5>(v);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kClusterRegs; ++r) sm[swz32(t1 | (r << 5))] = v[r];
  __syncthreads();
  // pass 2: registers index bits 9-13 (bit 9 done), the thread bits 0-8
#pragma unroll
  for (int r = 0; r < kClusterRegs; ++r) v[r] = sm[swz32(tid | (r << 9))];
  reg_stages32<1, 5>(v);
  __syncthreads();
  // the chunk, unscaled f32, in natural order for the peers
#pragma unroll
  for (int r = 0; r < kClusterRegs; ++r) sm[tid | (r << 9)] = v[r];
  cluster.sync();

  // this block's columns of every chunk: run g of VW columns at rank * W +
  // (g * kClusterThreads + tid) * VW, a warp's runs contiguous; v[(p * G +
  // g) * VW + c] holds column c of run g of chunk p
#pragma unroll
  for (int p = 0; p < C; ++p) {
    const float* peer = cluster.map_shared_rank(sm, p);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = rank * W + (g * kClusterThreads + tid) * VW;
      float* d = v + (p * G + g) * VW;
      if constexpr (VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(peer + j);
        d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(peer + j);
        d[0] = t.x; d[1] = t.y;
      }
    }
  }
  // this block has read its peers; its own shared memory must stay until
  // they have read it too.  f32 out: arrive now, wait after the stores;
  // bf16 out: one barrier after the stores (each the faster of the two for
  // its type, timed in turns on an H100)
  constexpr bool kEarly = std::is_same_v<T, float>;
  if constexpr (kEarly)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  // the stages of index bits 14 .. 13 + CL: bit b of the chunk index
#pragma unroll
  for (int b = 0; b < CL; ++b)
#pragma unroll
    for (int p = 0; p < C; ++p) {
      if (p & (1 << b)) continue;
#pragma unroll
      for (int e = 0; e < CP; ++e) {
        const float a = v[p * CP + e], bb = v[(p | (1 << b)) * CP + e];
        v[p * CP + e] = __fadd_rn(a, bb);
        v[(p | (1 << b)) * CP + e] = __fsub_rn(a, bb);
      }
    }
#pragma unroll
  for (int r = 0; r < kClusterRegs; ++r) v[r] = __fmul_rn(v[r], scale);
#pragma unroll
  for (int p = 0; p < C; ++p)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = rank * W + (g * kClusterThreads + tid) * VW;
      store_n<T, VW, VEC_IO>(out + row0 + ((int64_t)p << kChunkLog2) + j,
                              v + (p * G + g) * VW);
    }
  if constexpr (kEarly)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  else
    cluster.sync();
}

// Tile of a further launch of a row of 2^L > 2^22, or of a high item of
// the fused kernel: 4096 elements, 2^K rows of index bits b0 .. b0 + K - 1
// by C = 4096 / 2^K consecutive columns.
constexpr int kHighTile = 4096, kHighThreads = 256;

// The stages over bits 0 .. KB - 1 of the register index, lowest first:
// each group of 2^KB registers (v[g * 2^KB + i]) holds the values of one
// column whose index bits differ in bit j of i.
template <int KB>
__device__ __forceinline__ void reg_stages(float (&v)[kRegs]) {
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      if (r & (1 << j)) continue;
      const float a = v[r], b = v[r | (1 << j)];
      v[r] = __fadd_rn(a, b);
      v[r | (1 << j)] = __fsub_rn(a, b);
    }
}

// The stages over index bits b0 .. b0 + K - 1 (b0 >= 12) of one tile of
// f32 values, its first element at `base` of in and of out: 2^K rows 2^b0
// elements apart by C = 4096 / 2^K consecutive columns, 256 threads (tid
// 0-255) and 4096 floats of shared memory.  LAST scales and writes TO;
// else f32, unscaled.  A thread's 16 values are 16 >> K0 items (columns,
// in steps of 256 threads) of 2^K0 rows each: first the rows of bits 0 ..
// K0 - 1 of the tile's row index (K0 = min(K, 4)), then, through shared
// memory, of bits 4 .. K - 1.  Not restrict: in and out may be one
// tensor, each tile read whole before it is written.  The loads go past L1
// (ld.global.cg): in the fused kernel another SM wrote `in` in the same
// launch.  STREAM (the fused kernel) reads and writes evict-first in L2:
// this tile's lines are not needed again there, and the workspace lines
// still to be read are.
template <int K, typename TO, bool LAST, bool STREAM = false>
__device__ __forceinline__ void high_body(const float* in, TO* out,
                                          int64_t base, int b0, float scale,
                                          int tid, float* sm) {
  constexpr int C = kHighTile >> K, LC = 12 - K;   // columns, their bits
  constexpr int K0 = K < 4 ? K : 4, K1 = K - K0;
  float v[kRegs];
  uint64_t first = 0;   // STREAM: an L2 policy, evict first
  if constexpr (STREAM)
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(first));

  // round 0: item i = tid + 256 j is column i % C of rows i / C << K0 | r
  constexpr int N0 = 1 << K0;
#pragma unroll
  for (int j = 0; j < kRegs / N0; ++j) {
    const int i = tid + kHighThreads * j;
    const int c = i & (C - 1), rr = i >> LC;
#pragma unroll
    for (int r = 0; r < N0; ++r) {
      const float* p = in + base + ((int64_t)(r | (rr << K0)) << b0) + c;
      if constexpr (STREAM)
        asm volatile("ld.global.cg.L2::cache_hint.f32 %0, [%1], %2;"
                     : "=f"(v[j * N0 + r]) : "l"(p), "l"(first) : "memory");
      else
        v[j * N0 + r] = __ldcg(p);
    }
  }
  reg_stages<K0>(v);

  // round 1 (K > 4): rows r | i / C << 4 ... through shared memory
  constexpr int N1 = 1 << K1;
  if constexpr (K1 > 0) {
#pragma unroll
    for (int j = 0; j < kRegs / N0; ++j) {
      const int i = tid + kHighThreads * j;
      const int c = i & (C - 1), rr = i >> LC;
#pragma unroll
      for (int r = 0; r < N0; ++r) sm[((r | (rr << K0)) << LC) + c] = v[j * N0 + r];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRegs / N1; ++j) {
      const int i = tid + kHighThreads * j;
      const int c = i & (C - 1), rr = i >> LC;
#pragma unroll
      for (int r = 0; r < N1; ++r)
        v[j * N1 + r] = sm[((rr | (r << K0)) << LC) + c];
    }
    reg_stages<K1>(v);
  }

  // the store, in the layout of the last round
  constexpr int NL = K1 > 0 ? N1 : N0, SH = K1 > 0 ? 0 : K0;
  constexpr int RS = K1 > 0 ? K0 : 0;
#pragma unroll
  for (int j = 0; j < kRegs / NL; ++j) {
    const int i = tid + kHighThreads * j;
    const int c = i & (C - 1), rr = i >> LC;
#pragma unroll
    for (int r = 0; r < NL; ++r) {
      const int row = (r << RS) | (rr << SH);
      const int64_t at = base + ((int64_t)row << b0) + c;
      if constexpr (LAST) {
        const float z = __fmul_rn(v[j * NL + r], scale);
        TO w;
        if constexpr (std::is_same_v<TO, float>) w = z;
        else w = __float2bfloat16_rn(z);
        if constexpr (STREAM) __stcs(out + at, w);
        else out[at] = w;
      } else if constexpr (STREAM) {
        __stcs(out + at, v[j * NL + r]);
      } else {
        out[at] = v[j * NL + r];
      }
    }
  }
}

// One further launch: a block a tile of high_body, of f32 rows, in place
// unless LAST.  n is a multiple of the tile.
template <int K, typename TO, bool LAST>
__global__ void __launch_bounds__(kHighThreads)
fwht_high_kernel(const float* in, TO* out, int64_t n, int b0, float scale) {
  constexpr int LC = 12 - K;
  extern __shared__ float4 smem4[];
  // tile -> (column block, everything above the tile's bits)
  const int cbits = b0 - LC;
  const int64_t t = blockIdx.x;
  const int64_t base = ((t >> cbits) << (b0 + K))
                       + ((t & ((int64_t(1) << cbits) - 1)) << LC);
  high_body<K, TO, LAST>(in, out, base, b0, scale, threadIdx.x,
                         reinterpret_cast<float*>(smem4));
}

// Rows of 2^19 .. 2^22 in one launch (see the top of the file).  A high
// item runs K = 7 (L <= 20) or 8 bits, in 2^(S - 12) high_body tiles, one a
// 256 threads; a low item is a tile of the tile kernel, 2^S coordinates, S
// = L - K (12 to 14).  A block has the tile kernel's threads at 2^S (256,
// 512 or 1024), as many an SM as run at once.  (At 2^20, K = 7 timed
// faster on an H100 than K = 8, whose smaller S leaves the low items
// cheaper but the high items' shared-memory round slower.)
template <int L>
struct Fused {
  static constexpr int K = L <= 20 ? 7 : 8;
  static constexpr int S = L - K;
  static constexpr int THREADS = Geo<S>::THREADS;
  static constexpr int TILES = THREADS / kHighThreads;
  // four 256-thread blocks an SM (at most 64 registers a thread)
  static constexpr int MIN_BLOCKS = 1024 / THREADS;
  static_assert(TILES * kHighTile == 1 << S, "items of one size");
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Thread 0 waits until *p >= want, then the block goes on.
__device__ __forceinline__ void wait_for(const unsigned* p, unsigned want) {
  if (threadIdx.x == 0)
    while (ld_acquire(p) < want) __nanosleep(32);
  __syncthreads();
}

// Every thread's stores before this, then one release add of 1 to *p.
__device__ __forceinline__ void publish(unsigned* p) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(p)
                 : "memory");
}

// sync: [0] tickets drawn, [1] blocks finished, [2, 2 + rows) low items of
// row r published, [2 + rows, 2 + 2 rows) high items of row r done (a ring
// only); all 0 at the start and left 0.  TO = float: the workspace is out
// (ring unused); else a ring of `slots` f32 rows.  SCALE false: a segment
// of a longer row, written unscaled.  A block loops over tickets, the next
// one drawn while it works on this one.  It publishes an item once the
// next item's loads are issued, and always before it waits, so that the
// lowest ticket not yet published never waits.
template <typename T, int L, bool VEC_IO, typename TO, bool SCALE>
__global__ void __launch_bounds__(Fused<L>::THREADS, Fused<L>::MIN_BLOCKS)
fwht_fused_kernel(const T* __restrict__ x, TO* out, float* ring,
                  unsigned* sync, int rows, int lag, int slots, float scale) {
  using F = Fused<L>;
  constexpr int S = F::S, K = F::K, NL = 1 << K;  // items of a row, each kind
  constexpr int VI = Io<T>::VEC;
  constexpr bool kRing = !std::is_same_v<TO, float>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ unsigned s_word, s_next[2];
  const int tid = threadIdx.x;
  const unsigned total = 2u * rows * NL;
  const int head = min(rows, lag + 1), pairs = max(0, rows - lag - 1);
  unsigned* lows = sync + 2;
  unsigned* highs = lows + rows;
  // the last item's counter, not yet added to: lows[r] as r, highs[r] as
  // rows + r; -1 none
  int pending = -1;
  auto flush = [&]() {
    if (pending >= 0) publish(lows + pending);
    pending = -1;
  };

  if (tid == 0) s_word = atomicAdd(sync, 1u);
  __syncthreads();
  unsigned t = s_word;
  int nb = 0;
  while (t < total) {
    unsigned next = 0;
    if (tid == 0) next = atomicAdd(sync, 1u);
    // ticket -> group (a row's items of one kind) -> kind and row: the low
    // rows 0 .. lag first, then high row j before low row lag + 1 + j,
    // then the high rows left
    const int grp = (int)(t >> K), item = (int)(t & (NL - 1));
    bool high;
    int r;
    if (grp < head) {
      high = false;
      r = grp;
    } else if (grp < head + 2 * pairs) {
      const int j = grp - head;
      high = (j & 1) == 0;
      r = high ? j >> 1 : lag + 1 + (j >> 1);
    } else {
      high = true;
      r = grp - head - pairs;
    }
    const int64_t row = (int64_t)r << L, at = (int64_t)item << S;
    auto workspace = [&]() -> float* {
      if constexpr (kRing) return ring + ((int64_t)(r % slots) << L);
      else return out + row;
    };
    if (!high) {
      const T* src = x + row + at;
      auto load = [&](float* v) {
#pragma unroll
        for (int k = 0; k < kRegs / VI; ++k) {
          const int g = (tid << 4) + k * VI;
          if constexpr (VEC_IO) {
            Io<T>::load_once(src + g, v + k * VI);
          } else {
#pragma unroll
            for (int c = 0; c < VI; ++c)
              v[k * VI + c] = Io<T>::load1(src + g + c);
          }
        }
      };
      auto pre = [&]() {
        // the slot's last row: its high items have read it
        if (kRing && r >= slots) wait_for(highs + r - slots, NL);
      };
      // f32 to the workspace, one value a store: no exchange
      float* o = workspace() + at;
      auto put = [&](int g, const float* v) { o[g] = v[0]; };
      tile_body<S, float, false, 1>(scale, tid, sm, load, flush, pre, put);
      pending = r;
    } else {
      flush();
      wait_for(lows + r, NL);
      const int sub = tid / kHighThreads;
      high_body<K, TO, SCALE, true>(
          workspace(), out + row,
          (int64_t)(item * F::TILES + sub) << (12 - K), S, scale,
          tid % kHighThreads, sm + sub * kHighTile);
      if (kRing) pending = rows + r;
    }
    if (tid == 0) s_next[nb] = next;   // last read before the last barrier
    __syncthreads();   // shared memory is free, s_next[nb] written
    t = s_next[nb];
    nb ^= 1;
  }
  flush();

  // the last block to finish sets the counters back to 0
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_word = atomicAdd(sync + 1, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (s_word)
    for (int j = tid; j < 2 + 2 * rows; j += F::THREADS) sync[j] = 0;
}

template <int K, typename TO, bool LAST>
int launch_high(const float* in, void* out, int64_t n, int b0, float scale,
                cudaStream_t stream) {
  const size_t smem = K > 4 ? sizeof(float) * kHighTile : 0;
  fwht_high_kernel<K, TO, LAST><<<(unsigned)(n / kHighTile), kHighThreads,
                                  smem, stream>>>(
      in, static_cast<TO*>(out), n, b0, scale);
  return (int)cudaGetLastError();
}

template <typename TO, bool LAST>
int launch_high_k(const float* in, void* out, int64_t n, int b0, int k,
                  float scale, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_high<1, TO, LAST>(in, out, n, b0, scale, stream);
    case 2: return launch_high<2, TO, LAST>(in, out, n, b0, scale, stream);
    case 3: return launch_high<3, TO, LAST>(in, out, n, b0, scale, stream);
    case 4: return launch_high<4, TO, LAST>(in, out, n, b0, scale, stream);
    case 5: return launch_high<5, TO, LAST>(in, out, n, b0, scale, stream);
    case 6: return launch_high<6, TO, LAST>(in, out, n, b0, scale, stream);
    case 7: return launch_high<7, TO, LAST>(in, out, n, b0, scale, stream);
    case 8: return launch_high<8, TO, LAST>(in, out, n, b0, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int L>
int launch_l(const void* x, void* out, int64_t rows, float scale, bool vec,
             cudaStream_t stream) {
  using G = Geo<L>;
  const int64_t n = rows << L;
  const int64_t blocks = (n + (int64_t(1) << G::TB) - 1) >> G::TB;
  const size_t smem = G::PASSES > 1 ? sizeof(float) << G::TB : 0;
  auto kernel = vec ? fwht_kernel<T, L, true> : fwht_kernel<T, L, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, scale);
  return (int)cudaGetLastError();
}

// Rows of 2^L, 19 <= L <= 22, in one launch of the fused kernel: T in, TO
// out, unscaled f32 where SCALE is false (segments of a longer row).
template <typename T, int L, typename TO, bool SCALE>
int launch_fused(const void* x, void* out, float* ring, unsigned* sync,
                 int64_t rows, int lag, int slots, float scale, bool vec,
                 cudaStream_t stream) {
  constexpr bool kRing = !std::is_same_v<TO, float>;
  using F = Fused<L>;
  const int64_t blocks = 2 * (rows << F::K);
  // a ring slot is reused only after lower tickets (slots >= lag + 1),
  // unless no slot is reused at all
  if (blocks > INT_MAX || lag < 0 || !sync
      || (kRing && (!ring || slots < 1 || (slots < lag + 1 && slots < rows))))
    return (int)cudaErrorInvalidValue;
  auto kernel = vec ? fwht_fused_kernel<T, L, true, TO, SCALE>
                    : fwht_fused_kernel<T, L, false, TO, SCALE>;
  const size_t smem = sizeof(float) << F::S;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // as many blocks as run at once, each looping over tickets
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      F::THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = std::min<int64_t>(blocks,
                                         (int64_t)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)grid, F::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<TO*>(out), ring, sync, (int)rows,
      lag, slots, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_l(const void* x, void* out, float* ring, unsigned* sync,
                   int64_t rows, int log2d, int lag, int slots, float scale,
                   bool vec, cudaStream_t st) {
  switch (log2d) {
    case 19: return launch_fused<T, 19, T, true>(x, out, ring, sync, rows,
                                                 lag, slots, scale, vec, st);
    case 20: return launch_fused<T, 20, T, true>(x, out, ring, sync, rows,
                                                 lag, slots, scale, vec, st);
    case 21: return launch_fused<T, 21, T, true>(x, out, ring, sync, rows,
                                                 lag, slots, scale, vec, st);
    case 22: return launch_fused<T, 22, T, true>(x, out, ring, sync, rows,
                                                 lag, slots, scale, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Segments of 2^L (20 <= L <= 22) of longer rows: f32 out, unscaled.
template <typename T>
int launch_segments(const void* x, void* out, unsigned* sync, int64_t rows,
                    int log2d, int lag, bool vec, cudaStream_t st) {
  switch (log2d) {
    case 20: return launch_fused<T, 20, float, false>(x, out, nullptr, sync,
                                                      rows, lag, 0, 1.0f, vec,
                                                      st);
    case 21: return launch_fused<T, 21, float, false>(x, out, nullptr, sync,
                                                      rows, lag, 0, 1.0f, vec,
                                                      st);
    case 22: return launch_fused<T, 22, float, false>(x, out, nullptr, sync,
                                                      rows, lag, 0, 1.0f, vec,
                                                      st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rows of 2^L, 15 <= L <= 18: C = 2^(L - 14) blocks a row in clusters of C
// (16 is past the portable 8: allowed on the kernel first).
template <typename T, int L>
int launch_cluster(const void* x, void* out, int64_t rows, float scale,
                   bool vec, cudaStream_t stream) {
  constexpr int C = 1 << (L - kChunkLog2);
  const int64_t blocks = rows * C;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = vec ? fwht_cluster_kernel<T, L, true>
                    : fwht_cluster_kernel<T, L, false>;
  const size_t smem = sizeof(float) * kChunk;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                         static_cast<T*>(out), scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, int64_t rows, int log2d, float scale,
           cudaStream_t stream) {
  // 16-byte runs need both pointers on 16-byte boundaries
  const bool vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  switch (log2d) {
    case 0: return launch_l<T, 0>(x, out, rows, scale, vec, stream);
    case 1: return launch_l<T, 1>(x, out, rows, scale, vec, stream);
    case 2: return launch_l<T, 2>(x, out, rows, scale, vec, stream);
    case 3: return launch_l<T, 3>(x, out, rows, scale, vec, stream);
    case 4: return launch_l<T, 4>(x, out, rows, scale, vec, stream);
    case 5: return launch_l<T, 5>(x, out, rows, scale, vec, stream);
    case 6: return launch_l<T, 6>(x, out, rows, scale, vec, stream);
    case 7: return launch_l<T, 7>(x, out, rows, scale, vec, stream);
    case 8: return launch_l<T, 8>(x, out, rows, scale, vec, stream);
    case 9: return launch_l<T, 9>(x, out, rows, scale, vec, stream);
    case 10: return launch_l<T, 10>(x, out, rows, scale, vec, stream);
    case 11: return launch_l<T, 11>(x, out, rows, scale, vec, stream);
    case 12: return launch_l<T, 12>(x, out, rows, scale, vec, stream);
    case 13: return launch_l<T, 13>(x, out, rows, scale, vec, stream);
    case 14: return launch_l<T, 14>(x, out, rows, scale, vec, stream);
    case 15: return launch_cluster<T, 15>(x, out, rows, scale, vec, stream);
    case 16: return launch_cluster<T, 16>(x, out, rows, scale, vec, stream);
    case 17: return launch_cluster<T, 17>(x, out, rows, scale, vec, stream);
    case 18: return launch_cluster<T, 18>(x, out, rows, scale, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each launcher returns the CUDA error code of its launch (0 = launched).
// Any stale error is cleared first so that the code reports this launch
// alone.  dtype: 0 = f32, 1 = bf16.

// Rows of d = 2^log2d <= 2^22, whole (past 16,384 in clusters, past 2^18
// in the fused kernel).  partial != 0 (log2d 20 to 22): the first launch
// of a longer row, over segments of 2^log2d, which writes f32 to out,
// unscaled.  The fused kernel (log2d >= 19) takes `sync`, 2 + 2 rows
// zeroed words that it leaves zeroed, the lag of its high items behind its
// low ones in rows, and for bf16 output (not partial) a ring of `slots`
// f32 rows of d; the other kernels ignore the four.
extern "C" int fwht_launch(const void* x, void* out, int64_t rows, int log2d,
                           float scale, int dtype, int partial, float* ring,
                           unsigned* sync, int lag, int slots,
                           void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  if (log2d < 0 || log2d > 22 || (partial && log2d < 20) || dtype < 0
      || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte runs need both pointers on 16-byte boundaries
  const bool vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  if (partial && dtype == 0)
    return launch_segments<float>(x, out, sync, rows, log2d, lag, vec, st);
  if (partial)
    return launch_segments<__nv_bfloat16>(x, out, sync, rows, log2d, lag, vec,
                                          st);
  if (log2d > 18 && dtype == 0)
    return launch_fused_l<float>(x, out, ring, sync, rows, log2d, lag, slots,
                                 scale, vec, st);
  if (log2d > 18)
    return launch_fused_l<__nv_bfloat16>(x, out, ring, sync, rows, log2d, lag,
                                         slots, scale, vec, st);
  if (dtype == 0) return launch<float>(x, out, rows, log2d, scale, st);
  return launch<__nv_bfloat16>(x, out, rows, log2d, scale, st);
}

// A further launch of rows longer than 2^22: the stages of index bits
// b0 .. b0 + k - 1 (b0 >= 14, 1 <= k <= 8) of the f32 tensor `in` of n
// elements (rows times d), in place.  out_dtype -1: not the last launch
// (out is in); 0 or 1: the last, which scales and writes f32 or bf16 to
// out.
extern "C" int fwht_pass_launch(const float* in, void* out, int64_t n, int b0,
                                int k, float scale, int out_dtype,
                                void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (b0 < 14 || k < 1 || k > 8 || n % kHighTile
      || (n >> (b0 + k)) << (b0 + k) != n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == -1)
    return launch_high_k<float, false>(in, out, n, b0, k, scale, st);
  if (out_dtype == 0)
    return launch_high_k<float, true>(in, out, n, b0, k, scale, st);
  if (out_dtype == 1)
    return launch_high_k<__nv_bfloat16, true>(in, out, n, b0, k, scale, st);
  return (int)cudaErrorInvalidValue;
}
