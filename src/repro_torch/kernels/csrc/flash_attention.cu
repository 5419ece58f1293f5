// Flash attention forward (online softmax) in f32 on the CUDA cores, for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), for f32 inputs (bf16 and f16 inputs take
// flash_attention_wgmma.cu).  For each (batch*head, query row) it computes
//   out = softmax(scale * q . K^T, masked) . V,   scale = float32(1/sqrt(D)),
// with q scaled before the product, as the reference does (here by
// scale * log2(e), the exponentials being base 2), and the scores,
// exponentials, running max, sum and accumulator in f32; out = acc /
// max(l, 1e-30).  Where causal, keys past the query's position (both
// counted from 0) take no part; the reference writes -1e30 there, whose
// exponential is exactly 0, so p = 0 gives the same function.  D is 64,
// 128, 192 or 256 (the wrapper pads any other D <= 256 with zero columns
// and passes the scale of the unpadded D); BH, Sq and Sk are any sizes
// >= 1: the grid is one-dimensional over (query tile, bh), and a ragged
// tile of queries or keys is masked.
//
// Bound on this card: operations, at the f32 rate (TF32 would not hold the
// f32 tolerance).  Per query row and visible key it does 2 D multiply-adds.
//
// Design: one block of 256 threads per (bh, BQ = 32 RM query rows), RM = 4
// at D <= 128 and 2 above; thread (ty, tx) of the 32 x 8 grid owns rows
// ty + 32 i (i < RM), keys tx + 8 j (j < 8) of each 64-key tile and output
// columns 4 tx + 32 c .. + 3.  It reads its operands as 16-byte loads from
// row-major shared tiles padded by 4 floats (Q scaled, K, V, P), so each
// load feeds 6 to 13 FMAs: RM
// rows x 8 keys from RM + 8 loads per 4 columns of D for the scores, RM
// rows x D/8 columns from RM + 4 D/32 loads per 4 keys for P.V.  The row
// max and sum reduce over the 8 lanes of a row with shuffles; a warp
// writes and reads only its own rows of P.  K and V have a buffer each and
// arrive by cp.async: V of a tile loads while its scores are computed, K
// of the next tile while P.V runs.  Key tiles wholly above the diagonal
// are not visited; in causal mode the block with the most key tiles starts
// first; only tiles at the diagonal or the ragged end of K test masks.
// All products are explicit f32 FMAs.  No allocation; the launch
// goes on the caller's stream.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;             // keys per tile
constexpr int TX = 8, TY = 32;     // thread grid
constexpr int THREADS = TX * TY;
constexpr int LP = BK + 8;         // row stride of P: the 4 rows of a warp
                                   // fall 8 banks apart
constexpr float NEG = -1e30f;

// query rows per thread: fewer at D = 192 and 256, whose accumulator and
// tiles would not fit otherwise (at 256: 218,112 bytes of shared memory and
// 64 accumulator registers a thread)
template <int D> __host__ __device__ constexpr int rows_per_thread() {
  return D > 128 ? 2 : 4;
}

template <int D>
constexpr size_t smem_bytes() {
  constexpr int LD = D + 4, BQ = TY * rows_per_thread<D>();
  return (size_t)(BQ * LD + 2 * BK * LD + BQ * LP) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group done
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// BK rows of src (row stride D) from row `row0` into dst (row stride
// D + 4); rows at or past `limit` are zero
template <int D>
__device__ __forceinline__ void load_kv(float* dst, const float* src,
                                        int row0, int limit) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < BK * C4; i += THREADS) {
    const int r = i / C4, c = 4 * (i % C4);
    const bool valid = row0 + r < limit;
    cp_async16(dst + r * (D + 4) + c,
               src + (int64_t)(valid ? row0 + r : 0) * D + c, valid);
  }
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The online-softmax step of one key tile for a thread's RM rows (row0 +
// 32 i) and 8 keys (key0 + 8 j): scores in the log2 domain (q was scaled by
// scale * log2(e)); P goes to the thread's places in `ps`, the running
// max, sum and accumulator are updated.  MASK: some keys of the tile may be
// past Sk or, where causal, past a row's position, and get p = 0.
template <bool MASK, int RM, int NC>
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

template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int sq,
                 int sk, float scale_log2, int causal) {
  constexpr int RM = rows_per_thread<D>();
  constexpr int BQ = TY * RM;
  constexpr int LD = D + 4;
  constexpr int NC = D / 32;       // float4 output columns per thread
  constexpr int QK_UNROLL = D == 64 ? 1 : 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x LD, scaled q
  float* ks = qs + BQ * LD;                      // BK x LD
  float* vs = ks + BK * LD;                      // BK x LD
  float* ps = vs + BK * LD;                      // BQ x LP

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_qt;
  const int64_t bh = blockIdx.x % n_bh;
  const int t_idx = blockIdx.x / n_bh;
  const int qt = causal ? n_qt - 1 - t_idx : t_idx;
  const int q0 = qt * BQ;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  // keys past the tile's last query row are masked for all of its rows
  const int kend = causal ? min(sk, q0 + BQ) : sk;
  const int n_kt = (kend + BK - 1) / BK;
  const int ps_off = ty * LP + tx;  // this thread's first place in P

  load_kv<D>(ks, kb, 0, sk);
  cp_async_commit();
  load_kv<D>(vs, vb, 0, sk);
  cp_async_commit();
  {
    const float* qb = q + (bh * sq + q0) * D;
    for (int i = threadIdx.x; i < BQ * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq) {
        x = *reinterpret_cast<const float4*>(qb + (int64_t)r * D + c);
        x.x = __fmul_rn(x.x, scale_log2);
        x.y = __fmul_rn(x.y, scale_log2);
        x.z = __fmul_rn(x.z, scale_log2);
        x.w = __fmul_rn(x.w, scale_log2);
      }
      *reinterpret_cast<float4*>(qs + r * LD + c) = x;
    }
  }

  float m[RM], l[RM], acc[RM][4 * NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_one();           // this tile's K
    __syncthreads();

    float sc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    // at D = 64 (two blocks an SM, 128 registers a thread) an unrolled
    // loop spills
#pragma unroll(QK_UNROLL)
    for (int c = 0; c < D; c += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + TY * i) * LD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(ks + (tx + TX * j) * LD + c);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          sc[i][j] = __fmaf_rn(a[i].x, b.x, sc[i][j]);
          sc[i][j] = __fmaf_rn(a[i].y, b.y, sc[i][j]);
          sc[i][j] = __fmaf_rn(a[i].z, b.z, sc[i][j]);
          sc[i][j] = __fmaf_rn(a[i].w, b.w, sc[i][j]);
        }
      }
    }

    // only a tile at the diagonal or at the ragged end of K masks keys
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > sk)
      softmax_tile<true, RM, NC>(sc, m, l, acc, ps, q0 + ty, k0 + tx, sk,
                                 causal, ps_off);
    else
      softmax_tile<false, RM, NC>(sc, m, l, acc, ps, q0 + ty, k0 + tx, sk,
                                  causal, ps_off);
    __syncwarp();                  // this warp's rows of P are written

    __syncthreads();               // every thread is done with K
    if (kt + 1 < n_kt) load_kv<D>(ks, kb, k0 + BK, sk);
    cp_async_commit();
    cp_async_wait_one();           // this tile's V
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
              vs + (j + e) * LD + 4 * tx + 32 * c);
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

    __syncthreads();               // every thread is done with V
    if (kt + 1 < n_kt) load_kv<D>(vs, vb, k0 + BK, sk);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (bh * sq + row) * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(o + 32 * c) = make_float4(
          __fdiv_rn(acc[i][4 * c + 0], den), __fdiv_rn(acc[i][4 * c + 1], den),
          __fdiv_rn(acc[i][4 * c + 2], den), __fdiv_rn(acc[i][4 * c + 3], den));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int BQ = TY * rows_per_thread<D>();
  const int64_t blocks = (int64_t)bh * ((sq + BQ - 1) / BQ);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, scale_log2,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous f32
// on 16-byte boundaries; d: 64, 128, 192 or 256; bh, sq, sk >= 1 (bh times
// the query tiles at most INT_MAX); scale_log2 = f32(1/sqrt(D)) * log2(e),
// D the head dim before any padding.  Returns the CUDA error code of the
// launch (0 = launched); any stale error is cleared first so that the code
// reports this launch alone.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int sq, int sk, int d, int causal,
                                      float scale_log2, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return launch<64>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
  if (d == 128)
    return launch<128>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
  if (d == 192)
    return launch<192>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
  if (d == 256)
    return launch<256>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}
