// Flash attention forward (online softmax), for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel).  For each (batch*head, query row) it computes
//   out = softmax(scale * q . K^T, masked) . V,   scale = float32(1/sqrt(D)),
// with q scaled before the product, scores, exponentials, the running max,
// sum and accumulator all in f32, and out = acc / max(l, 1e-30) cast to the
// input type.  Where causal, keys past the query's position (both counted
// from 0) take no part; the reference writes -1e30 there, whose exponential
// is exactly 0, so skipping them gives the same function.  Inputs are f32,
// or bf16 widened with __bfloat162float (output through
// __float2bfloat16_rn).  D is 64 or 128.
//
// Bound on this card: operations.  Per query row and visible key it does
// 2 D multiply-adds (q.k and p.v) and reads q, K, V, out once: at the
// sequence lengths attention runs at, thousands of operations per byte.
//
// Design (simple first): one block of 256 threads per (bh, 64-row query
// tile).  The scaled query tile stays in shared memory; the key loop stages
// one 64-key K tile, then the V tile in the same buffer, in shared memory
// (rows padded by one float so that the column reads do not conflict).
// Thread (ty, tx) of the 16 x 16 grid owns query rows ty + 16 i (i < 4):
// it computes the 4 x 4 scores of those rows and keys tx + 16 j with f32
// FMAs, the row max and sum reduce over the 16 lanes of the row with warp
// shuffles, and the probabilities go through a shared 64 x 80 tile to the
// P.V product, whose accumulator (4 rows x D/16 columns) and running max and
// sum stay in registers.  Key tiles wholly above the diagonal are not
// visited.  All products are f32 FMAs on the CUDA cores, so the kernel is
// held to the card's f32 rate, about 1/15 of bf16 on the tensor cores.
// A later redesign moves q.K^T and P.V to bf16 wgmma (scale folded in
// after the product), feeds K/V tiles by TMA into a ring of shared-memory
// stages, and keeps P in registers.  No allocation; the launch goes on the
// caller's stream.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int TX = 16, TY = 16;    // thread grid
constexpr int THREADS = TX * TY;
constexpr int RM = BQ / TY;        // query rows per thread
constexpr int RN = BK / TX;        // keys per thread in a tile
constexpr int LP = BK + TX;        // row stride of the P tile (rows ty and
                                   // ty + 1 fall on opposite half-banks)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * (D + 1) + BK * (D + 1) + BQ * LP) * sizeof(float);
}

// rows x D of src (row stride D, rows from `row0`, `limit` rows valid) into
// dst (row stride D + 1) as f32 times `mul` (exact for mul = 1); rows past
// `limit` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int limit, int rows, float mul) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < limit
            ? __fmul_rn(to_f32(src[(int64_t)(row0 + r) * D + c]), mul)
            : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
                 float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int RD = D / TX;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // BQ x LD
  float* kv = qs + BQ * LD;        // BK x LD: K, then V
  float* ps = kv + BK * LD;        // BQ x LP

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int64_t bh = blockIdx.y;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  load_tile<T, D>(qs, q + bh * sq * D, q0, sq, BQ, scale);

  float m[RM], l[RM], acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  // keys past the tile's last query row are masked for all of its rows
  const int kend = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();               // the last tile's P.V is done with kv, ps
    load_tile<T, D>(kv, kb, k0, sk, BK, 1.f);
    __syncthreads();

    float sc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qs[(ty + TY * i) * LD + c];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = kv[(tx + TX * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) sc[i][j] = __fmaf_rn(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + TY * i;
      bool vis[RN];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int key = k0 + tx + TX * j;
        vis[j] = key < sk && (!causal || key <= row);
        if (vis[j]) mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = vis[j] ? expf(__fsub_rn(sc[i][j], m_new)) : 0.f;
        ps[(ty + TY * i) * LP + tx + TX * j] = p;
        rs = __fadd_rn(rs, p);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }

    __syncthreads();               // K read and P written by every thread
    load_tile<T, D>(kv, vb, k0, sk, BK, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ps[(ty + TY * i) * LP + j];
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const float vv = kv[j * LD + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = __fmaf_rn(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < RD; ++c)
      o[tx + TX * c] = from_f32<T>(__fdiv_rn(acc[i][c], den));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)bh);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous.
// dtype: 0 = f32, 1 = bf16; d: 64 or 128.  Returns the CUDA error code of
// the launch (0 = launched); any stale error is cleared first so that the
// code reports this launch alone.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int sq, int sk, int d, int causal,
                                      float scale, int dtype, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, bh, sq, sk, causal, scale, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, bh, sq, sk, causal, scale, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, bh, sq, sk, causal, scale, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, bh, sq, sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
