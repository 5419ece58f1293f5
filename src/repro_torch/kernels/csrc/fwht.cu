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
// Rows longer than 2^18, d = 2^L with L > 18, take several launches
// (fwht_pass_launch).  The first is the tile kernel over index bits 0-13
// of each row (rows of 16384), unscaled, writing f32 (into the output for
// f32, into a scratch tensor the wrapper allocates for bf16).  Each further
// launch (fwht_high_kernel) runs the stages of K <= 8 of the high index
// bits, b0 .. b0 + K - 1, in place on that f32 tensor: a block takes a
// tile of 2^K rows of those bits (2^b0 elements apart) by 4096 / 2^K
// consecutive columns, the same column across a warp so that every load
// and store is a coalesced run; a thread holds 16 values, 4 bits of
// stages in registers at a time, the next 4 through shared memory.  Only
// the last launch scales and rounds to the output type.  Intermediates
// stay f32 between launches, so the sums are the plain version's.  Each
// launch reads and writes the row once more: 1 + ceil((L - 14) / 8)
// passes over the data in all.
//
// A pointer that is not on a 16-byte boundary (a view that starts inside a
// row of a small bf16 tensor) takes the same kernel with one-element loads
// and stores.  No allocation; the launch goes on the caller's stream.
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

// T in, TO out; SCALE false (the first launch of a longer row) leaves the
// scale to the last launch.
template <typename T, int L, bool VEC_IO, typename TO = T, bool SCALE = true>
__global__ void __launch_bounds__(Geo<L>::THREADS, Geo<L>::MIN_BLOCKS)
fwht_kernel(const T* __restrict__ x, TO* __restrict__ out, int64_t n, float scale) {
  constexpr int TB = Geo<L>::TB, P = Geo<L>::PASSES, VI = Io<T>::VEC;
  constexpr int VEC = Io<TO>::VEC;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int64_t g0 = (int64_t)blockIdx.x << TB;
  float v[kRegs];

  // pass 0: the thread's 16 consecutive coordinates
#pragma unroll
  for (int k = 0; k < kRegs / VI; ++k)
    load_run<T, VEC_IO>(x, g0 + (tid << 4) + k * VI, n, v + k * VI);
  stages<L, 0>(v);
  if constexpr (P > 1) { transpose<L, 0>(v, sm, tid); stages<L, 1>(v); }
  if constexpr (P > 2) { transpose<L, 1>(v, sm, tid); stages<L, 2>(v); }
  if constexpr (P > 3) { transpose<L, 2>(v, sm, tid); stages<L, 3>(v); }
  if constexpr (SCALE) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) v[r] = __fmul_rn(v[r], scale);
  }

  if constexpr (P == 1) {
#pragma unroll
    for (int k = 0; k < kRegs / VEC; ++k)
      store_run<TO, VEC_IO>(out, g0 + (tid << 4) + k * VEC, n, v + k * VEC);
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
      store_run<TO, VEC_IO>(out, g0 + (base | (k << (lo + E))), n, v + k * VEC);
  }
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

// Tile of a further launch of a row of 2^L > 2^14: 4096 elements, 2^K rows
// of index bits b0 .. b0 + K - 1 by C = 4096 / 2^K consecutive columns.
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

// One further launch: stages over index bits b0 .. b0 + K - 1 (b0 >= 14)
// of f32 rows, in place; the last one (LAST) scales and writes TO to out.
// n is a multiple of the tile.  A thread's 16 values are 16 >> K0 items
// (columns, in steps of 256 threads) of 2^K0 rows each: first the rows of
// bits 0 .. K0 - 1 of the tile's row index (K0 = min(K, 4)), then, through
// shared memory, of bits 4 .. K - 1.  Not restrict: in and out may be one
// tensor, each tile read whole before it is written.
template <int K, typename TO, bool LAST>
__global__ void __launch_bounds__(kHighThreads)
fwht_high_kernel(const float* in, TO* out, int64_t n, int b0, float scale) {
  constexpr int C = kHighTile >> K, LC = 12 - K;   // columns, their bits
  constexpr int K0 = K < 4 ? K : 4, K1 = K - K0;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  // tile -> (column block, everything above the tile's bits)
  const int cbits = b0 - LC;
  const int64_t t = blockIdx.x;
  const int64_t base = ((t >> cbits) << (b0 + K))
                       + ((t & ((int64_t(1) << cbits) - 1)) << LC);
  float v[kRegs];

  // round 0: item i = tid + 256 j is column i % C of rows i / C << K0 | r
  constexpr int N0 = 1 << K0;
#pragma unroll
  for (int j = 0; j < kRegs / N0; ++j) {
    const int i = tid + kHighThreads * j;
    const int c = i & (C - 1), rr = i >> LC;
#pragma unroll
    for (int r = 0; r < N0; ++r)
      v[j * N0 + r] = in[base + ((int64_t)(r | (rr << K0)) << b0) + c];
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
        if constexpr (std::is_same_v<TO, float>) out[at] = z;
        else out[at] = __float2bfloat16_rn(z);
      } else {
        out[at] = v[j * NL + r];
      }
    }
  }
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

template <typename T, int L, typename TO = T, bool SCALE = true>
int launch_l(const void* x, void* out, int64_t rows, float scale, bool vec,
             cudaStream_t stream) {
  using G = Geo<L>;
  const int64_t n = rows << L;
  const int64_t blocks = (n + (int64_t(1) << G::TB) - 1) >> G::TB;
  const size_t smem = G::PASSES > 1 ? sizeof(float) << G::TB : 0;
  const T* xp = static_cast<const T*>(x);
  TO* op = static_cast<TO*>(out);
  auto kernel = vec ? fwht_kernel<T, L, true, TO, SCALE>
                    : fwht_kernel<T, L, false, TO, SCALE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, G::THREADS, smem, stream>>>(xp, op, n, scale);
  return (int)cudaGetLastError();
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

// Rows of d = 2^log2d <= 2^18, whole (past 16,384 in clusters).  partial
// != 0 (log2d = 14 only): the first launch of a longer row, over its low 14
// index bits, which writes f32 to out, unscaled.
extern "C" int fwht_launch(const void* x, void* out, int64_t rows, int log2d,
                           float scale, int dtype, int partial,
                           void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  if (log2d < 0 || log2d > 18 || (partial && log2d != 14))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  if (partial && dtype == 0)
    return launch_l<float, 14, float, false>(x, out, rows, scale, vec, st);
  if (partial && dtype == 1)
    return launch_l<__nv_bfloat16, 14, float, false>(x, out, rows, scale, vec,
                                                     st);
  if (dtype == 0) return launch<float>(x, out, rows, log2d, scale, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, rows, log2d, scale, st);
  return (int)cudaErrorInvalidValue;
}

// A further launch of rows longer than 2^18: the stages of index bits
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
