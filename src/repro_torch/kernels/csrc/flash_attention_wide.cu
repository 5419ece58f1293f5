// Flash attention forward (online softmax) in f32 past head dim 64, and
// in bf16 and f16 past 512, for Hopper (sm_90a): the products on the
// tensor cores in three TF32 passes (mma.sync).
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), for f32 inputs with D > 64 and bf16 and f16 inputs with
// D > 512 (f32 up to 64 takes flash_attention.cu, wgmma in three TF32
// passes; bf16 and f16 up to 256 flash_attention_wgmma.cu, up to 512
// flash_attention_wgmma_wide.cu).  For each (batch*head, query row) it
// computes
//   out = softmax(scale * q . K^T, masked) . V,   scale = float32(1/sqrt(D)),
// with the scores, exponentials (base 2, of scores scaled by scale *
// log2(e) after the product), running max, sum, P and the accumulator in
// f32; out = acc / max(l, 1e-30), rounded once to the input type.  Where
// causal, keys past the query's position (both counted from 0) take no
// part, as the reference's -1e30 gives them p = 0.  D is 128, 192, 256 or
// 384 (f32 only) or a multiple of 512 (the wrapper pads any other D
// with zero columns and passes the scale of the unpadded D); BH, Sq and
// Sk are any sizes >= 1, and a ragged tile of queries or keys is masked.
//
// Numerics.  Each operand x of both products (q, k, p, v) is split into
// x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a . b is summed in f32 as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (mma.sync m16n8k8 TF32 with f32
// accumulators): each product within about 2^-21 of its f32 value, where
// one TF32 pass would be off by 2^-11 and miss the f32 tolerance.  bf16 and
// f16 values are exact in TF32 (their lo is 0), so for them the scores
// take one product (q_hi.k_hi) and P.V two (p_lo.v + p_hi.v), with the
// same sums as the three.  The tf32 wgmma reads B only K-major, and P.V's
// B = V is stored with the columns contiguous; mma.sync takes its
// fragments from registers, loaded from padded rows, so V needs no
// transpose.
//
// Bound on this card: operations.  Per query row and visible key, 2 D
// multiply-adds; the tensor cores issue three of them for each in TF32
// (bf16 and f16: 1.5).
//
// Design: one block of 384 threads (12 warps) per (bh, BQ query rows,
// group of DG output columns), DG = D up to 512 and 512 past it, BQ = 96
// for f32 up to D 256 and 48 otherwise.  Each block computes every score
// of its rows once over all of D (past 512, once for each group) and keeps
// its rows' whole accumulator in registers: 48 x 512 f32 is 64 a thread,
// 96 x 256 too.  Q, K and V stream through a ring of shared-memory stages
// (3; 2 with 96 rows) by TMA (one thread issues the boxes of a chunk; an
// mbarrier counts their bytes; one block barrier a chunk frees the stage
// the next load takes): for each 128-key tile, D / 64 score chunks (64
// columns of the Q rows and of the 128 K rows), then V chunks of VK keys
// x DG columns, VK = 64 up to D 128, 32 up to 256 and 16 past it, so that
// a V chunk holds about as much as a score chunk and a narrow head dim
// pays few barriers a tile.  Warp (wr, wx) of the 3 x 4 warp grid
// computes rows 16 wr .. + 15 (with 96 rows also 16 (wr + 3) .. + 15) of
// both products: keys 32 wx .. + 31 of the scores (4 m16n8 tiles), then
// columns DG / 4 wx .. of P.V (DG / 32 tiles), loading each fragment
// element from rows padded so that a warp's loads fall in distinct banks;
// a warp with two row tiles splits each K and V element once for both,
// which halves the splits an f32 product takes.  The raw scores go to
// shared memory, where 8 (with 96 rows 4) threads a row take the tile's
// online-softmax step (row max and sum by shuffles over those lanes, P
// written back in place, alpha for the accumulator beside it).  Key tiles
// wholly above a block's rows are not visited; in causal mode the blocks
// with the most key tiles start first.  No allocation; the launch goes on
// the caller's stream.
#include <climits>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int THREADS = 384;       // 12 warps: a 3 x 4 grid
constexpr int DC = 64;             // columns of a score chunk
constexpr int GROUP = 512;         // output columns of a block past 512
constexpr int BK = 128;            // keys per tile
constexpr int LP = BK + 4;         // row stride of the scores and P: the
                                   // 8 rows of an A fragment fall 4 banks
                                   // apart
constexpr float NEG = -1e30f;

// Tiles and shared memory of one instance.  A warp computes MT m16 tiles
// of rows: 2 for f32 up to D 256 (each K and V fragment split once for
// both; the accumulator of 2 x 16 rows x D / 4 columns fits), 1 past it;
// a block holds BQ = 48 MT rows, which the softmax step takes 8 / MT
// threads a row.  Shared memory, in bytes: the stages, their mbarriers,
// then the scores / P and the rows' alpha and l (f32).  A stage holds a
// score chunk (the Q rows, then the K rows, each LDC elements long) or a V
// chunk (four quarters of VK rows, each LDV elements long, one for each
// warp column).  TMA writes each as one box whose rows run past the
// chunk's columns by 16 bytes (in a V quarter 32), so the rows keep a
// stride at which a warp's fragment loads fall in distinct banks (in f32:
// the 8 rows of an A or B fragment 4 banks apart in a score chunk, the 4
// rows of a V fragment 8 apart); the extra columns are the next chunk's,
// or zeros past D, and go unread.  Every box starts on 128 bytes.  VK is
// the keys of a V chunk, NV the V chunks of a tile; 3 stages, 2 where the
// block's 96 rows leave no room for a third.
template <typename T, int DG>
struct Smem {
  static constexpr int MT = std::is_same<T, float>::value && DG <= 256 ? 2
                                                                       : 1;
  static constexpr int BQ = 48 * MT;
  static constexpr int STAGES = MT == 2 ? 2 : 3;
  static constexpr int VK = DG <= 128 ? 64 : DG <= 256 ? 32 : 16;
  static constexpr int NV = BK / VK;
  static constexpr int E = 16 / sizeof(T);     // elements of 16 bytes
  static constexpr int LDC = DC + E;
  static constexpr int LDV = DG / 4 + 2 * E;
  static constexpr uint32_t Q_BYTES = BQ * LDC * sizeof(T);
  static constexpr uint32_t K_BYTES = BK * LDC * sizeof(T);
  static constexpr uint32_t VQ_BYTES = VK * LDV * sizeof(T);
  static constexpr uint32_t S_BYTES = Q_BYTES + K_BYTES;
  static constexpr uint32_t V_BYTES = 4 * VQ_BYTES;
  static constexpr uint32_t STAGE = S_BYTES > V_BYTES ? S_BYTES : V_BYTES;
  static constexpr uint32_t BAR_OFF = STAGES * STAGE;
  static constexpr uint32_t PS_OFF = (BAR_OFF + 8 * STAGES + 127) / 128 * 128;
  // the dynamic shared memory's start is aligned up to 128 bytes
  static constexpr size_t BYTES =
      PS_OFF + (size_t)(BQ * LP + 2 * BQ) * sizeof(float) + 128;
  static_assert(Q_BYTES % 128 == 0 && K_BYTES % 128 == 0 &&
                VQ_BYTES % 128 == 0, "boxes start on 128 bytes");
};

// one element of shared memory as f32
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ldf(const __half* p) {
  return __half2float(*p);
}

// two f32 values rounded to T, at two consecutive elements of device memory
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// an element of shared memory that is exact in TF32 (bf16, f16), as TF32
template <typename T>
__device__ __forceinline__ uint32_t exact_tf32(const T* p) {
  return __float_as_uint(ldf(p));
}

// q, k, v: 3-d tensor maps over (bh, S, dp) of T (boxes of LDC columns by
// BQ or BK rows, of LDV columns by VK rows); out (bh, sq, dp) of T.  A
// block's group of output columns is DG wide.  Grid: groups x query tiles
// x bh blocks, the group fastest, then bh.
template <typename T, int DG>
__global__ void __launch_bounds__(THREADS, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  T* __restrict__ out, int sq, int sk, int dp,
                  float scale_log2, int causal) {
  using L = Smem<T, DG>;
  constexpr int LDC = L::LDC, LDV = L::LDV, VK = L::VK, NV = L::NV;
  constexpr int MT = L::MT, BQ = L::BQ, STAGES = L::STAGES;
  constexpr int NS = BK / 32;        // a warp's m16n8 tiles of the scores
  constexpr int TPR = 8 / MT;        // threads a row in the softmax step
  constexpr int KS = BK / TPR;       // a thread's keys in the softmax step
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR_OFF;          // a stage's mbarrier
  float* ps = reinterpret_cast<float*>(smem + L::PS_OFF);   // BQ x LP
  float* als = ps + BQ * LP;                                // alpha, BQ
  float* lsum = als + BQ;                                   // l, BQ

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 4, wx = warp % 4;
  const int n_g = dp / DG;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int n_bh = gridDim.x / (n_qt * n_g);
  const int g = blockIdx.x % n_g;
  const int rest = blockIdx.x / n_g;
  const int64_t bh = rest % n_bh;
  const int t_idx = rest / n_bh;
  // in causal mode the query tiles with the most key tiles start first
  const int qt = causal ? n_qt - 1 - t_idx : t_idx;
  const int q0 = qt * BQ, g0 = g * DG;
  // keys past the tile's last query row are masked for all of its rows
  const int kend = causal ? min(sk, q0 + BQ) : sk;
  const int n_kt = (kend + BK - 1) / BK;
  const int ns = dp / DC;            // score chunks a tile
  const int nch = ns + NV;           // chunks a tile
  const int total = n_kt * nch;

  // chunk n of the block's stream into its stage, by TMA from one
  // thread: of key tile n / nch, score chunk r < ns (columns r DC of the Q
  // rows and of the tile's K rows) or V chunk r - ns (VK keys, the group's
  // columns); rows past Sq or Sk and columns past D arrive as zeros
  auto load_chunk = [&](int n) {
    const int s = n % STAGES, kt = n / nch, r = n % nch;
    const uint32_t dst = base + s * L::STAGE, bar = full + 8 * s;
    if (r < ns) {
      mbar_expect_tx(bar, L::S_BYTES);
      tma_load(dst, &tq, bar, r * DC, q0, (int)bh);
      tma_load(dst + L::Q_BYTES, &tk, bar, r * DC, kt * BK, (int)bh);
    } else {
      mbar_expect_tx(bar, L::V_BYTES);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        tma_load(dst + w * L::VQ_BYTES, &tv, bar, g0 + w * (DG / 4),
                 kt * BK + (r - ns) * VK, (int)bh);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int next = 0, idx = 0;
  for (; next < STAGES - 1; ++next)
    if (tid == 0 && next < total) load_chunk(next);
  // the next chunk of the stream, landed; the stage of the chunk before it
  // (every thread is done with it, after the barrier) takes the chunk
  // STAGES - 1 ahead
  auto acquire = [&]() -> const T* {
    __syncthreads();
    if (tid == 0 && next < total) load_chunk(next);
    ++next;
    const int s = idx % STAGES;
    mbar_wait(full + 8 * s, (idx / STAGES) & 1);
    ++idx;
    return reinterpret_cast<const T*>(smem + s * L::STAGE);
  };

  // the thread's places in the mma fragments of warp (wr, wx): rows
  // row0[i] (+ 8) of the block, row0[i] = 16 (wr + 3 i) + r8 for its MT
  // row tiles i; in the scores keys BK / 4 wx + 8 n + 2 c4 (+ 1) of NS key
  // groups n, in P.V columns DG / 4 wx + 8 n + 2 c4 (+ 1) of NT column
  // groups n; A fragments at columns c4 (+ 4), B fragments at rows c4 (+
  // 4) of the reduction
  constexpr int NT = DG / 32;
  const int r8 = lane / 4, c4 = lane % 4;
  int row0[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) row0[i] = 16 * (wr + 3 * i) + r8;
  // its row and KS keys in the softmax step
  const int srow = tid / TPR, seg = tid % TPR;

  float o[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  float m = NEG, l = 0.f;           // srow's running max and sum

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float sc[MT][NS][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][n][e] = 0.f;
    for (int r = 0; r < ns; ++r) {
      const T* qs = acquire();
      const T* kb_ = qs + (BQ + (BK / 4) * wx + r8) * LDC + c4;
#pragma unroll
      for (int kk = 0; kk < DC; kk += 8) {
        if constexpr (std::is_same<T, float>::value) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const T* qa = qs + row0[i] * LDC + c4 + kk;
            split_tf32(ldf(qa), ah[i][0], al[i][0]);
            split_tf32(ldf(qa + 8 * LDC), ah[i][1], al[i][1]);
            split_tf32(ldf(qa + 4), ah[i][2], al[i][2]);
            split_tf32(ldf(qa + 8 * LDC + 4), ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            uint32_t bh[2], bl[2];
            split_tf32(ldf(kb_ + 8 * n * LDC + kk), bh[0], bl[0]);
            split_tf32(ldf(kb_ + 8 * n * LDC + kk + 4), bh[1], bl[1]);
#pragma unroll
            for (int i = 0; i < MT; ++i)
              mma_3xtf32(sc[i][n], ah[i], al[i], bh, bl);
          }
        } else {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const T* qa = qs + row0[i] * LDC + c4 + kk;
            a[i][0] = exact_tf32(qa);
            a[i][1] = exact_tf32(qa + 8 * LDC);
            a[i][2] = exact_tf32(qa + 4);
            a[i][3] = exact_tf32(qa + 8 * LDC + 4);
          }
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const uint32_t b[2] = {exact_tf32(kb_ + 8 * n * LDC + kk),
                                   exact_tf32(kb_ + 8 * n * LDC + kk + 4)};
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_tf32(sc[i][n], a[i], b);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float* p0 = ps + row0[i] * LP + (BK / 4) * wx + 8 * n + 2 * c4;
        *reinterpret_cast<float2*>(p0) = make_float2(sc[i][n][0],
                                                     sc[i][n][1]);
        *reinterpret_cast<float2*>(p0 + 8 * LP) =
            make_float2(sc[i][n][2], sc[i][n][3]);
      }
    __syncthreads();

    // the online-softmax step of row srow over keys KS seg .. + KS - 1: the
    // max over the raw scores (scale_log2 > 0 keeps their order), p =
    // exp2(s scale_log2 - m); a masked key (past Sk or, where causal, past
    // the row's position) gets p = 0
    {
      float* prow = ps + srow * LP + KS * seg;
      const int row = q0 + srow, key = k0 + KS * seg;
      const float ninf = __int_as_float(0xff800000);
      float s[KS];
#pragma unroll
      for (int e = 0; e < KS / 4; ++e) {
        const float4 x = *reinterpret_cast<const float4*>(prow + 4 * e);
        s[4 * e] = x.x;
        s[4 * e + 1] = x.y;
        s[4 * e + 2] = x.z;
        s[4 * e + 3] = x.w;
      }
      float mx = ninf;
#pragma unroll
      for (int e = 0; e < KS; ++e) {
        if (!(key + e < sk && (!causal || key + e <= row))) s[e] = ninf;
        mx = fmaxf(mx, s[e]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, __fmul_rn(mx, scale_log2));
      const float alpha = exp2f(__fsub_rn(m, m_new));
      m = m_new;
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < KS; ++e) {
        s[e] = exp2f(__fmaf_rn(s[e], scale_log2, -m_new));
        rs = __fadd_rn(rs, s[e]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l = __fadd_rn(__fmul_rn(l, alpha), rs);
#pragma unroll
      for (int e = 0; e < KS / 4; ++e)
        *reinterpret_cast<float4*>(prow + 4 * e) =
            make_float4(s[4 * e], s[4 * e + 1], s[4 * e + 2], s[4 * e + 3]);
      if (seg == 0) als[srow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float a0 = als[row0[i]], a1 = als[row0[i] + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[i][n][0] = __fmul_rn(o[i][n][0], a0);
        o[i][n][1] = __fmul_rn(o[i][n][1], a0);
        o[i][n][2] = __fmul_rn(o[i][n][2], a1);
        o[i][n][3] = __fmul_rn(o[i][n][3], a1);
      }
    }
    for (int r = 0; r < NV; ++r) {
      const T* vs = acquire();
      const T* vb_ = vs + (wx * VK + c4) * LDV + r8;
#pragma unroll
      for (int kk = 0; kk < VK; kk += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* pa = ps + row0[i] * LP + r * VK + c4 + kk;
          split_tf32(pa[0], ah[i][0], al[i][0]);
          split_tf32(pa[8 * LP], ah[i][1], al[i][1]);
          split_tf32(pa[4], ah[i][2], al[i][2]);
          split_tf32(pa[8 * LP + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if constexpr (std::is_same<T, float>::value) {
            uint32_t bh[2], bl[2];
            split_tf32(ldf(vb_ + kk * LDV + 8 * n), bh[0], bl[0]);
            split_tf32(ldf(vb_ + (kk + 4) * LDV + 8 * n), bh[1], bl[1]);
#pragma unroll
            for (int i = 0; i < MT; ++i)
              mma_3xtf32(o[i][n], ah[i], al[i], bh, bl);
          } else {
            const uint32_t b[2] = {exact_tf32(vb_ + kk * LDV + 8 * n),
                                   exact_tf32(vb_ + (kk + 4) * LDV + 8 * n)};
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_tf32(o[i][n], al[i], b);
              mma_tf32(o[i][n], ah[i], b);
            }
          }
        }
      }
    }
  }

  if (seg == 0) lsum[srow] = l;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + row0[i] + 8 * h;
      if (row >= sq) continue;
      const float den = fmaxf(lsum[row0[i] + 8 * h], 1e-30f);
      T* orow = out + (bh * sq + row) * dp + g0 + (DG / 4) * wx + 2 * c4;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        st2(orow + 8 * n, __fdiv_rn(o[i][n][2 * h], den),
            __fdiv_rn(o[i][n][2 * h + 1], den));
    }
}

template <typename T> struct MapType;
template <> struct MapType<float> {
  static constexpr CUtensorMapDataType V = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType V = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct MapType<__half> {
  static constexpr CUtensorMapDataType V = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// a (bh, s, d) tensor of T as a 3-d map with boxes of `cols` x `rows`,
// no swizzle, zeros past the edges
template <typename T>
CUresult make_box_map(EncodeTiled enc, CUtensorMap* map, const void* p,
                      int bh, int s, int d, int cols, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T),
                                 (cuuint64_t)s * d * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, MapType<T>::V, 3, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int DG>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int d, int causal, float scale_log2,
           cudaStream_t stream) {
  using L = Smem<T, DG>;
  const int64_t blocks = (int64_t)bh * ((sq + L::BQ - 1) / L::BQ) * (d / DG);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = make_box_map<T>(enc, &tq, q, bh, sq, d, L::LDC, L::BQ);
  if (r == CUDA_SUCCESS)
    r = make_box_map<T>(enc, &tk, k, bh, sk, d, L::LDC, BK);
  if (r == CUDA_SUCCESS)
    r = make_box_map<T>(enc, &tv, v, bh, sk, d, L::LDV, L::VK);
  if (r != CUDA_SUCCESS) return -(int)r;
  const size_t smem = L::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wide_kernel<T, DG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_wide_kernel<T, DG><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), sq, sk, d, scale_log2, causal);
  return (int)cudaGetLastError();
}

// f32 takes D 128, 192, 256 and 384 (one group of D columns) and any
// multiple of 512 (up to 64 it takes flash_attention.cu); bf16 and f16 any
// multiple of 512 (up to 512 they take the wgmma kernels)
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, int causal, float scale_log2,
             void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 128:
        return launch<T, 128>(q, k, v, out, bh, sq, sk, d, causal,
                              scale_log2, st);
      case 192:
        return launch<T, 192>(q, k, v, out, bh, sq, sk, d, causal,
                              scale_log2, st);
      case 256:
        return launch<T, 256>(q, k, v, out, bh, sq, sk, d, causal,
                              scale_log2, st);
      case 384:
        return launch<T, 384>(q, k, v, out, bh, sq, sk, d, causal,
                              scale_log2, st);
      default:
        break;
    }
  }
  if (d % GROUP == 0)
    return launch<T, GROUP>(q, k, v, out, bh, sq, sk, d, causal, scale_log2,
                            st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous, of
// one type, on 16-byte boundaries; d: 128, 192, 256 or 384 (f32) or a
// multiple of 512; bh, sq, sk >= 1 (bh times the query tiles of 48 or 96
// rows times the column groups at most INT_MAX); scale_log2 =
// f32(1/sqrt(D)) * log2(e), D the head dim before any padding.  Each
// returns the CUDA error code of the launch (0 = launched), or minus the
// driver's code where a tensor map could not be made; any stale error is
// cleared first so that the code reports this launch alone.
extern "C" int flash_attention_wide_launch(const void* q, const void* k,
                                           const void* v, void* out, int bh,
                                           int sq, int sk, int d, int causal,
                                           float scale_log2, void* stream) {
  return dispatch<float>(q, k, v, out, bh, sq, sk, d, causal, scale_log2,
                         stream);
}

extern "C" int flash_attention_wide_bf16_launch(
    const void* q, const void* k, const void* v, void* out, int bh, int sq,
    int sk, int d, int causal, float scale_log2, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, causal,
                                 scale_log2, stream);
}

extern "C" int flash_attention_wide_f16_launch(
    const void* q, const void* k, const void* v, void* out, int bh, int sq,
    int sk, int d, int causal, float scale_log2, void* stream) {
  return dispatch<__half>(q, k, v, out, bh, sq, sk, d, causal, scale_log2,
                          stream);
}
