// Flash attention forward (online softmax) for head dims past 256, in f32
// on the CUDA cores, for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), for head dims D > 256, which the Pallas kernel takes and
// the port's other two kernels (flash_attention.cu, f32, and
// flash_attention_wgmma.cu, bf16 and f16, built for D <= 256) do not.  For
// each (batch*head, query row) it computes
//   out = softmax(scale * q . K^T, masked) . V,   scale = float32(1/sqrt(D)),
// with q scaled before the product (here by scale * log2(e), the
// exponentials being base 2), and the scores, exponentials, running max,
// sum, P and the accumulator in f32; out = acc / max(l, 1e-30), rounded
// once to the input type.  Where causal, keys past the query's position
// (both counted from 0) take no part, as the reference's -1e30 gives them
// p = 0.  Inputs are f32, bf16 or f16 (converted to f32 as they are read);
// D, BH, Sq and Sk are any sizes >= 1, and a ragged tile of queries, keys
// or columns is masked.  P stays f32, so bf16 outputs hold the limit of the
// plain version (which keeps P in f32) without the split P of the wgmma
// kernel.
//
// Bound on this card: operations.  Per query row and visible key, 2 D
// multiply-adds; this kernel does the scores once for each slice of
// DV = 128 output columns, so ceil(D / 128) + 1 multiply-adds of D per
// pair instead of 2 (2.5x the useful work at D = 512).
//
// Design, a simple kernel first (its speed is later work): one block of
// 256 threads per (bh, 64 query rows, 128 output columns), the column
// slice innermost in the grid so that the blocks of one query tile, which
// read the same Q and K, run together.  Thread (ty, tx) of the 32 x 8 grid
// owns rows ty and ty + 32, keys tx + 8 j (j < 8) of each 64-key tile and
// output columns 4 tx + 32 c .. + 3 of the slice.  For each key tile the
// scores accumulate over D in chunks of 32: the chunk of Q (scaled) and of
// K is converted to f32 into shared tiles padded by 4 floats, and each
// thread reads them as 16-byte loads.  Then the online softmax (as in
// flash_attention.cu: row max and sum over the 8 lanes of a row by
// shuffles), P into shared memory, the V tile's slice converted to f32
// into shared memory, and P.V into the accumulator.  All products are
// explicit f32 FMAs.  Loads are one element a thread at a time (coalesced
// across the warp); those of the next chunk of Q and K are issued into
// registers before the current chunk's products, so their latency hides
// behind them (one block an SM: nothing else would hide it; loading the V
// slice the same way did not help).  No
// allocation; the launch goes on the caller's stream.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;             // keys per tile
constexpr int TX = 8, TY = 32;     // thread grid
constexpr int THREADS = TX * TY;
constexpr int RM = 2;              // query rows per thread
constexpr int BQ = TY * RM;        // query rows per block
constexpr int DC = 32;             // head-dim chunk of the scores
constexpr int DV = 128;            // output columns per block
constexpr int NC = DV / 32;        // float4 output columns per thread
constexpr int LDC = DC + 4;        // row stride of the Q and K chunks
constexpr int LDV = DV + 4;        // row stride of the V slice
constexpr int LP = BK + 8;         // row stride of P
constexpr float NEG = -1e30f;
constexpr size_t kSmemBytes =
    (size_t)(BQ * LDC + BK * LDC + BK * LDV + BQ * LP) * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The online-softmax step of one key tile for a thread's RM rows (row0 +
// 32 i) and 8 keys (key0 + 8 j), as in flash_attention.cu: P goes to the
// thread's places in `ps`; the running max, sum and accumulator are
// updated.  MASK: some keys of the tile may be past Sk or, where causal,
// past a row's position, and get p = 0.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[RM][8], float* m,
                                             float* l, float (&acc)[RM][4 * NC],
                                             float* ps, int row0, int key0,
                                             int sk, int causal, int ps_off) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + TY * i;
    bool vis[8];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = key0 + TX * j;
      vis[j] = !MASK || (key < sk && (!causal || key <= row));
      if (vis[j]) mx = fmaxf(mx, sc[i][j]);
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = vis[j] ? exp2f(__fsub_rn(sc[i][j], m_new)) : 0.f;
      ps[ps_off + TY * i * LP + TX * j] = p;
      rs = __fadd_rn(rs, p);
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
    const float alpha = exp2f(__fsub_rn(m[i], m_new));
    l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rs);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
  }
}

// one block an SM: at two (<= 128 registers) ptxas spilled 16 bytes
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int sq,
                  int sk, int d, int n_dv, float scale_log2, int causal) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x LDC, scaled q
  float* ks = qs + BQ * LDC;                     // BK x LDC
  float* vs = ks + BK * LDC;                     // BK x LDV
  float* ps = vs + BK * LDV;                     // BQ x LP

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int n_bh = gridDim.x / (n_qt * n_dv);
  const int dvc = blockIdx.x % n_dv;
  const int rest = blockIdx.x / n_dv;
  const int64_t bh = rest % n_bh;
  const int t_idx = rest / n_bh;
  // in causal mode the query tiles with the most key tiles start first
  const int qt = causal ? n_qt - 1 - t_idx : t_idx;
  const int q0 = qt * BQ, cv0 = dvc * DV;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  // keys past the tile's last query row are masked for all of its rows
  const int kend = causal ? min(sk, q0 + BQ) : sk;
  const int n_kt = (kend + BK - 1) / BK;
  const int ps_off = ty * LP + tx;   // this thread's first place in P

  float m[RM], l[RM], acc[RM][4 * NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // this thread's elements of a chunk of Q and of K: row tid / DC + 8 e,
  // column tid % DC (BQ == BK); the next chunk is loaded into registers
  // while the current one computes
  constexpr int PER = BQ * DC / THREADS;
  static_assert(BQ == BK && PER * THREADS == BQ * DC, "chunk layout");
  const int cr = tid / DC, cc = tid % DC;
  float nq[PER], nk[PER];
  auto fetch = [&](int k0, int c0) {
    const bool in_d = c0 + cc < d;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int r = cr + (THREADS / DC) * e;
      nq[e] = in_d && q0 + r < sq
                  ? to_f32(qb[(int64_t)(q0 + r) * d + c0 + cc]) : 0.f;
      nk[e] = in_d && k0 + r < sk
                  ? to_f32(kb[(int64_t)(k0 + r) * d + c0 + cc]) : 0.f;
    }
  };
  fetch(0, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float sc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;

    for (int c0 = 0; c0 < d; c0 += DC) {
      __syncthreads();             // every thread is done with the chunks
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int r = cr + (THREADS / DC) * e;
        qs[r * LDC + cc] = __fmul_rn(nq[e], scale_log2);
        ks[r * LDC + cc] = nk[e];
      }
      __syncthreads();
      if (c0 + DC < d) fetch(k0, c0 + DC);
      else if (kt + 1 < n_kt) fetch(k0 + BK, 0);
#pragma unroll
      for (int c = 0; c < DC; c += 4) {
        float4 a[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + TY * i) * LDC + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(ks + (tx + TX * j) * LDC + c);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            sc[i][j] = __fmaf_rn(a[i].x, b.x, sc[i][j]);
            sc[i][j] = __fmaf_rn(a[i].y, b.y, sc[i][j]);
            sc[i][j] = __fmaf_rn(a[i].z, b.z, sc[i][j]);
            sc[i][j] = __fmaf_rn(a[i].w, b.w, sc[i][j]);
          }
        }
      }
    }

    // only a tile at the diagonal or at the ragged end of K masks keys
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > sk)
      softmax_tile<true>(sc, m, l, acc, ps, q0 + ty, k0 + tx, sk, causal,
                         ps_off);
    else
      softmax_tile<false>(sc, m, l, acc, ps, q0 + ty, k0 + tx, sk, causal,
                          ps_off);

    __syncthreads();               // P is written, the last V is read
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i % DV;
      vs[r * LDV + c] = k0 + r < sk && cv0 + c < d
                            ? to_f32(vb[(int64_t)(k0 + r) * d + cv0 + c])
                            : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        p[i] = *reinterpret_cast<const float4*>(ps + (ty + TY * i) * LP + j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 w = *reinterpret_cast<const float4*>(
              vs + (j + e) * LDV + 4 * tx + 32 * c);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float pe = get(p[i], e);
            acc[i][4 * c + 0] = __fmaf_rn(pe, w.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = __fmaf_rn(pe, w.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = __fmaf_rn(pe, w.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = __fmaf_rn(pe, w.w, acc[i][4 * c + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cv0 + 4 * tx + 32 * c + e;
        if (col < d) o[col] = from_f32<T>(__fdiv_rn(acc[i][4 * c + e], den));
      }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int d, int causal, float scale_log2,
           void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_dv = (d + DV - 1) / DV;
  const int64_t blocks = (int64_t)bh * ((sq + BQ - 1) / BQ) * n_dv;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  flash_wide_kernel<T><<<(unsigned)blocks, THREADS, kSmemBytes,
                         (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, d, n_dv,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous, of
// one type; bh, sq, sk, d >= 1 (bh times the query tiles times the column
// slices at most INT_MAX); scale_log2 = f32(1/sqrt(d)) * log2(e).  Each
// returns the CUDA error code of the launch (0 = launched); any stale
// error is cleared first so that the code reports this launch alone.
extern "C" int flash_attention_wide_launch(const void* q, const void* k,
                                           const void* v, void* out, int bh,
                                           int sq, int sk, int d, int causal,
                                           float scale_log2, void* stream) {
  return launch<float>(q, k, v, out, bh, sq, sk, d, causal, scale_log2,
                       stream);
}

extern "C" int flash_attention_wide_bf16_launch(
    const void* q, const void* k, const void* v, void* out, int bh, int sq,
    int sk, int d, int causal, float scale_log2, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, causal,
                               scale_log2, stream);
}

extern "C" int flash_attention_wide_f16_launch(
    const void* q, const void* k, const void* v, void* out, int bh, int sq,
    int sk, int d, int causal, float scale_log2, void* stream) {
  return launch<__half>(q, k, v, out, bh, sq, sk, d, causal, scale_log2,
                        stream);
}
