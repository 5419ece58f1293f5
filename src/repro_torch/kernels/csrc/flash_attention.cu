// Flash attention forward (online softmax) in f32 at head dims up to 64,
// for Hopper (sm_90a): wgmma on the tensor cores, each f32 product as
// three TF32 ones, K/V tiles by TMA.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), for f32 inputs with D <= 64 (the wrapper pads D < 64
// to 64; wider f32 takes flash_attention_wide.cu, bf16 and f16
// flash_attention_wgmma.cu).  For each (batch*head, query row) it computes
//   out = softmax(scale * q . K^T, masked) . V,   scale = float32(1/sqrt(D)),
// with the scores, exponentials (base 2, of scores scaled by scale *
// log2(e) after the product), running max, sum and accumulator in f32;
// out = acc / max(l, 1e-30).  Where causal, keys past the query's position
// (both counted from 0) take no part, as the reference's -1e30 gives them
// p = 0, and neither do keys at or past Sk.  BH, Sq and Sk are any sizes
// >= 1: the grid is one-dimensional over (query tile, bh), and a ragged
// tile of queries or keys is masked.
//
// Numerics, as flash_attention_wide.cu's: each operand x of both products
// (q, k, p, v) is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi)
// (cvt.rna), and a . b is summed in f32 as a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi: each product within about 2^-21 of its f32 value, where one
// TF32 pass would be off by 2^-11 and miss the f32 tolerance.
//
// Bound on this card: operations.  Per query row and visible key, 2 D
// multiply-adds; the tensor cores issue three TF32 ones for each, at half
// the bf16 rate.
//
// Design.  One block per (bh, 128 query rows), 384 threads: warpgroups 1
// and 2 are consumers of 64 rows each, as in flash_attention_wgmma.cu, and
// warpgroup 0 the producer: one thread issues the TMA loads, and all 128
// split K and V for the tensor cores.  TF32 wgmma reads both operands
// K-major only.  Q and K arrive K-major (D contiguous) with the 128-byte
// swizzle, in blocks of 32 columns: Q once (each consumer splits its rows
// in place into hi, lo beside it), K tiles of 64 keys into STAGES stages
// (the producer splits each in place).  V arrives row-major (keys x D)
// into one buffer of padded rows; the producer writes it transposed, split
// into hi and lo, into V^T stages (D rows of 64 keys, K-major, swizzled).
// The keys of V^T are permuted within each group of 8, key 2c at position
// c and key 2c + 1 at c + 4: S's accumulator holds a thread's keys 2c, 2c
// + 1 of each group, and the TF32 A fragment of P.V wants k-positions c, c
// + 4, so P's registers go to the tensor cores as they lie, split into hi
// and lo.  The stages are signalled by mbarriers: the TMA's bytes landed
// (full), split and ready for the tensor cores (ready, 128 producer
// arrivals after a proxy fence), released by all 8 consumer warps
// (empty; K after S, V^T after P.V).  Per key tile a consumer warpgroup
// runs S = Q.K^T (3 x 8 m64n64k8 from shared memory), the online softmax
// on the accumulator fragments (row max and sum over the lane quad; a
// masked key gets p = 0, the running max starts at -1e30), then O =
// O.alpha + P.V (3 x 8 m64n64k8, A = P in registers); S of tile t and P.V
// of tile t - 1 are issued together, so the softmax of tile t runs while
// the tensor cores do P.V, and a warp whose rows' maxima all stayed
// (alpha exactly 1) leaves O as it is.  Key tiles wholly above a block's
// rows are not loaded, and those above a warpgroup's rows not computed; in
// causal mode the blocks with the most key tiles start first.  No
// allocation; the launch goes on the caller's stream.
#include <climits>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int D = 64;              // head dim (columns of q, k, v)
constexpr int BQ = 128;            // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 384;       // producer warpgroup + 2 consumers
constexpr int STAGES = 2;
constexpr int LDV = D + 4;         // row stride of the raw V tile: the 4
                                   // keys a transposing warp reads fall 8
                                   // banks apart
constexpr float NEG = -1e30f;

// Shared memory from a 1024-byte boundary: Q (hi, then lo), STAGES K
// stages (hi, then lo), STAGES V^T stages (hi, then lo), the raw V tile,
// then the mbarriers.  Q, K and V^T are column blocks of 32 f32 (128-byte
// rows, the 128-byte swizzle): Q and K 2 blocks of their rows; V^T 2
// blocks of 32 keys, D rows each.
constexpr uint32_t Q_BYTES = BQ * D * 4;
constexpr uint32_t TILE = BK * D * 4;             // K, V^T: hi or lo
constexpr uint32_t K_OFF = 2 * Q_BYTES;
constexpr uint32_t VT_OFF = K_OFF + STAGES * 2 * TILE;
constexpr uint32_t VR_OFF = VT_OFF + STAGES * 2 * TILE;
constexpr uint32_t VR_BYTES = BK * LDV * 4;
constexpr uint32_t BAR_OFF = VR_OFF + VR_BYTES;
// Q's and the raw V's, then full, ready and empty of the K stages, ready
// and empty of the V^T stages
constexpr uint32_t BYTES = BAR_OFF + 8 * (2 + 5 * STAGES);
constexpr size_t SMEM = BYTES + 1024;

// the n floats (a multiple of 512) at src split in place: hi there, lo at
// the same offset from dst; 128 threads, t their index
__device__ __forceinline__ void split_in_place(uint32_t src, uint32_t dst,
                                               int n, int t) {
  for (int i = 4 * t; i < n; i += 512) {
    float x[4];
    uint32_t hi[4], lo[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                 : "r"(src + 4 * i));
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(src + 4 * i), "r"(hi[0]), "r"(hi[1]), "r"(hi[2]),
                    "r"(hi[3]) : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(dst + 4 * i), "r"(lo[0]), "r"(lo[1]), "r"(lo[2]),
                    "r"(lo[3]) : "memory");
  }
}

// generic-proxy writes to shared memory, made visible to the tensor cores
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// q, k: 3-d tensor maps over (bh, S, D) f32 in boxes of 32 columns by BQ
// (q) or BK (k) rows, 128-byte swizzle; v: boxes of LDV columns by BK rows,
// no swizzle; out (bh, sq, D) f32.  Grid: query tiles x bh blocks, bh the
// faster index.
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ out, int sq, int sk, float scale_log2,
                  int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_hi = base, q_lo = base + Q_BYTES;
  const uint32_t k_st = base + K_OFF, vt_st = base + VT_OFF,
                 vr = base + VR_OFF;
  const uint32_t bar_q = base + BAR_OFF, full_v = bar_q + 8;
  const uint32_t full_k = full_v + 8, ready_k = full_k + 8 * STAGES,
                 empty_k = ready_k + 8 * STAGES,
                 ready_v = empty_k + 8 * STAGES,
                 empty_v = ready_v + 8 * STAGES;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh, t_idx = blockIdx.x / n_bh;
  const int qt = causal ? n_qt - 1 - t_idx : t_idx;
  const int q0 = qt * BQ;
  // keys past the tile's last query row are masked for all of its rows
  const int kend = causal ? min(sk, q0 + BQ) : sk;
  const int n_kt = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(full_v, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(ready_k + 8 * s, 128);
      mbar_init(empty_k + 8 * s, 8);
      mbar_init(ready_v + 8 * s, 128);
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pt = threadIdx.x, warp = pt / 32, lane = pt % 32;
    // K tile kt into its stage (raw, to be split in place), once the stage's
    // last tile is done with
    auto load_k = [&](int kt) {
      const int s = kt % STAGES;
      mbar_wait(empty_k + 8 * s, ((kt / STAGES) & 1) ^ 1);
      mbar_expect_tx(full_k + 8 * s, TILE);
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        tma_load(k_st + s * 2 * TILE + c * BK * 128, &tk, full_k + 8 * s,
                 c * 32, kt * BK, bh);
    };
    auto load_v = [&](int kt) {
      mbar_expect_tx(full_v, VR_BYTES);
      tma_load(vr, &tv, full_v, 0, kt * BK, bh);
    };
    if (pt == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        tma_load(q_hi + c * BQ * 128, &tq, bar_q, c * 32, q0, bh);
      load_k(0);
      load_v(0);
    }
    // this lane's part of the V transpose: of 4 keys 2c + h (c = lane / 8)
    // of a group of 8, D column n = 8 nb + lane % 8
    const int c = lane / 8, nl = lane % 8;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t ph = (kt / STAGES) & 1;
      if (pt == 0 && kt + 1 < n_kt) load_k(kt + 1);
      const uint32_t kh = k_st + s * 2 * TILE;
      mbar_wait(full_k + 8 * s, ph);
      split_in_place(kh, kh + TILE, BK * D, pt);
      fence_proxy_async();
      mbar_arrive(ready_k + 8 * s);

      // V^T of tile kt: (D rows, 64 key positions); key 8 j + 2 c + h at
      // position 8 j + c + 4 h, in 32-position blocks of D x 128 bytes
      const uint32_t vh = vt_st + s * 2 * TILE;
      mbar_wait(full_v, kt & 1);
      mbar_wait(empty_v + 8 * s, ph ^ 1);
#pragma unroll 4
      for (int it = 0; it < BK * D / 128; ++it) {
        const int combo = warp + 4 * it;
        const int j = combo >> 4, h = (combo >> 3) & 1, nb = combo & 7;
        const int key = 8 * j + 2 * c + h, n = 8 * nb + nl;
        const int pos = 8 * j + c + 4 * h;
        float x;
        asm volatile("ld.shared.f32 %0, [%1];\n"
                     : "=f"(x) : "r"(vr + 4 * (key * LDV + n)));
        uint32_t hi, lo;
        split_tf32(x, hi, lo);
        const uint32_t off = (pos >> 5) * (D * 128) + n * 128 +
                             ((((pos & 31) >> 2) ^ (n & 7)) << 4) +
                             ((pos & 3) << 2);
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(vh + off), "r"(hi)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(vh + TILE + off), "r"(lo) : "memory");
      }
      fence_proxy_async();
      mbar_arrive(ready_v + 8 * s);
      named_sync(1, 128);          // every producer thread read the raw V
      if (pt == 0 && kt + 1 < n_kt) load_v(kt + 1);
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // this thread's rows in the accumulators: r0 and r0 + 8; its columns
    // in each 8-column group: c0 and c0 + 1
    const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int wg_first = q0 + 64 * cw, wg_last = wg_first + 63;
    const uint32_t qh = q_hi + cw * 64 * 128, ql = q_lo + cw * 64 * 128;

    // this warpgroup's Q rows split in place (64 rows of each block)
    mbar_wait(bar_q, 0);
#pragma unroll
    for (int b = 0; b < D / 32; ++b)
      split_in_place(qh + b * BQ * 128, ql + b * BQ * 128, 64 * 32, t);
    fence_proxy_async();
    named_sync(2 + cw, 128);

    float o[D / 2], sc[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t phi[32], plo[32];

    // S = Q . K^T of key tile kt, issued and committed: 8 k8 steps, 32
    // bytes of a 128-byte row each, three products a step
    auto issue_qk = [&](int kt) {
      const uint32_t kh = k_st + (kt % STAGES) * 2 * TILE, kl = kh + TILE;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qo = (kk / 4) * BQ * 128 + (kk % 4) * 32,
                       ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_tf32_ss_n64(sc, desc_k_major(ql + qo), desc_k_major(kh + ko),
                          kk > 0);
        wgmma_tf32_ss_n64(sc, desc_k_major(qh + qo), desc_k_major(kl + ko),
                          1);
        wgmma_tf32_ss_n64(sc, desc_k_major(qh + qo), desc_k_major(kh + ko),
                          1);
      }
      wgmma_commit();
    };
    // O += P . V of key tile kt (P_lo.V_hi + P_hi.V_lo + P_hi.V_hi),
    // issued and committed
    auto issue_pv = [&](int kt) {
      const uint32_t vh = vt_st + (kt % STAGES) * 2 * TILE, vl = vh + TILE;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t vo = (kk / 4) * D * 128 + (kk % 4) * 32;
        wgmma_tf32_rs_n64(o, plo + 4 * kk, desc_k_major(vh + vo));
        wgmma_tf32_rs_n64(o, phi + 4 * kk, desc_k_major(vl + vo));
        wgmma_tf32_rs_n64(o, phi + 4 * kk, desc_k_major(vh + vo));
      }
      wgmma_commit();
    };
    auto softmax = [&](int kt) {
      const int k0 = kt * BK;
      // only a tile at the diagonal or at the ragged end of K masks keys
      if ((causal && k0 + BK - 1 > wg_first) || k0 + BK > sk)
        softmax_tile<true>(sc, m, l, alpha, r0, k0 + c0, sk, causal,
                           scale_log2);
      else
        softmax_tile<false>(sc, m, l, alpha, r0, k0 + c0, sk, causal,
                            scale_log2);
    };
    // O scaled by alpha (where a row of the warp's has a new max), then P
    // as TF32 A fragments: for keys 8 j .. 8 j + 7, k-positions c and c + 4
    // of rows r0 and r0 + 8 are keys 2 c and 2 c + 1, which the S
    // accumulator holds at 4 j + {0, 2} and 4 j + {1, 3}
    auto rescale_and_split = [&]() {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 0] = __fmul_rn(o[4 * j + 0], alpha[0]);
          o[4 * j + 1] = __fmul_rn(o[4 * j + 1], alpha[0]);
          o[4 * j + 2] = __fmul_rn(o[4 * j + 2], alpha[1]);
          o[4 * j + 3] = __fmul_rn(o[4 * j + 3], alpha[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        split_tf32(sc[4 * j + 0], phi[4 * j + 0], plo[4 * j + 0]);
        split_tf32(sc[4 * j + 2], phi[4 * j + 1], plo[4 * j + 1]);
        split_tf32(sc[4 * j + 1], phi[4 * j + 2], plo[4 * j + 2]);
        split_tf32(sc[4 * j + 3], phi[4 * j + 3], plo[4 * j + 3]);
      }
    };
    // tiles 0 .. n_live - 1 are computed; a tile wholly above this
    // warpgroup's rows (in causal order, every later one too) is waited for
    // and released only
    const int n_live = causal ? min(n_kt, wg_last / BK + 1) : n_kt;

    // Per tile kt: S_kt = Q.K_kt^T and O += P_{kt-1}.V_{kt-1} go to the
    // tensor cores together; the softmax of S_kt runs while P.V does.  No
    // wgmma is issued under a branch, so that ptxas keeps them pipelined.
    mbar_wait(ready_k, 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k);
    softmax(0);
    rescale_and_split();
    for (int kt = 1; kt < n_live; ++kt) {
      const int s = kt % STAGES, sp = (kt - 1) % STAGES;
      mbar_wait(ready_k + 8 * s, (kt / STAGES) & 1);
      mbar_wait(ready_v + 8 * sp, ((kt - 1) / STAGES) & 1);
      issue_qk(kt);
      issue_pv(kt - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      softmax(kt);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(phi);             // read by P.V until here
      fence_regs(plo);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      rescale_and_split();
    }
    {
      const int sp = (n_live - 1) % STAGES;
      mbar_wait(ready_v + 8 * sp, ((n_live - 1) / STAGES) & 1);
      issue_pv(n_live - 1);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
    }
    for (int kt = n_live; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t ph = (kt / STAGES) & 1;
      mbar_wait(ready_k + 8 * s, ph);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      mbar_wait(ready_v + 8 * s, ph);
      if (lane == 0) mbar_arrive(empty_v + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      if (row >= sq) continue;
      const float den = fmaxf(l[rr], 1e-30f);
      float* orow = out + ((int64_t)bh * sq + row) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(__fdiv_rn(o[4 * j + 2 * rr], den),
                        __fdiv_rn(o[4 * j + 2 * rr + 1], den));
    }
  }
}

// a (bh, s, D) f32 tensor as a 3-d map with boxes of `cols` x `rows`
CUresult make_f32_map(EncodeTiled enc, CUtensorMap* map, const void* p,
                      int bh, int s, int cols, int rows,
                      CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)s * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous f32
// on 16-byte boundaries; d: 64; bh, sq, sk >= 1 (bh times the query tiles
// of 128 rows at most INT_MAX); scale_log2 = f32(1/sqrt(D)) * log2(e), D
// the head dim before any padding.  Returns the CUDA error code of the
// launch (0 = launched), or minus the driver's code where a tensor map
// could not be made; any stale error is cleared first so that the code
// reports this launch alone.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int sq, int sk, int d, int causal,
                                      float scale_log2, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sk <= 0 || d != D)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)bh * ((sq + BQ - 1) / BQ);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = make_f32_map(enc, &tq, q, bh, sq, 32, BQ,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = make_f32_map(enc, &tk, k, bh, sk, 32, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = make_f32_map(enc, &tv, v, bh, sk, LDV, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_tf32_kernel<<<(unsigned)blocks, THREADS, SMEM,
                      (cudaStream_t)stream>>>(
      tq, tk, tv, static_cast<float*>(out), sq, sk, scale_log2, causal);
  return (int)cudaGetLastError();
}
