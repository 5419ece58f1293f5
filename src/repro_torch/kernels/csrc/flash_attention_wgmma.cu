// Flash attention forward (online softmax) in bf16 or f16 on Hopper's
// tensor cores (sm_90a): wgmma for both products, K/V tiles by TMA.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), for bf16 and f16 inputs up to head dim 256 (f32 inputs
// take flash_attention_wide.cu).  For each (batch*head, query row) it
// computes
//   out = softmax(scale * q . K^T, masked) . V,   scale = float32(1/sqrt(D)),
// with the products, the scores, the running max and sum and the
// accumulator in f32 and out = acc / max(l, 1e-30) rounded to the input
// type.  Where causal, keys past the query's position (both counted from
// 0) take no part, and neither do keys at or past Sk.  D is 16, 32, 64,
// 128, 192 or 256 (the wrapper pads any other D <= 256 with zero columns
// and passes the scale of the unpadded D); BH, Sq and Sk are any sizes
// >= 1: the grid is one-dimensional over (query tile, bh), and a ragged
// tile of queries or keys is masked.
//
// Bound on this card: operations.  Per query row and visible key it does
// 2 D multiply-adds (q.k and p.v), thousands per byte read at the sequence
// lengths attention runs at.
//
// Numerics.  q.K^T is exact bf16 (or f16) products summed in f32 (wgmma),
// scaled after the product.  The plain version keeps P in f32, and
// rounding P once to bf16 moves a few percent of the outputs by more than
// one bf16 step at long sequences.  So P is split, P_hi = T(p) and
// P_lo = T(p - P_hi), and O += P_hi . V + P_lo . V: two wgmmas, P good
// to about 2^-16 of its value in bf16 (2^-22 in f16, down to f16's
// smallest subnormal, 2^-24), the tensor cores issuing 1.5x the useful
// operations.  Exponentials are exp2 of scores scaled by log2(e).
//
// Design.  One block per (bh, 128 query rows), 384 threads: warpgroup 0
// is the producer (one thread issues every TMA load; setmaxnreg drops it
// to 24 registers), warpgroups 1 and 2 are consumers of 64 rows each
// (setmaxnreg 240).  Q (128 x D) is loaded once; K and V tiles of BK keys
// (128 up to D 64, where a tile's fixed costs (barrier waits, the wgmma
// fence, commit and wait, the row max's shuffles) weigh most against its
// work, 64 above) go through a ring of STAGES shared-memory stages each,
// signalled by mbarriers (full: the TMA's bytes arrived; empty: all 8
// consumer warps are done with it).  Tiles are stored as column blocks of
// min(D, 64) columns, rows of RB = 32, 64 or 128 bytes with the swizzle of
// that width, one TMA box each (a box's inner extent is at most 128
// bytes), and the wgmma descriptors walk the same blocks.  Per key tile a
// consumer warpgroup runs S = Q.K^T (m64nBKk16, A and B K-major from
// shared memory), the online softmax on the accumulator fragments (row max
// and sum over the quad of lanes that shares a row; a masked key gets
// p = 0, the running max starts at -1e30), then O = O.alpha + P_hi.V +
// P_lo.V (m64nDk16, A = P in registers, taken from the S fragments as they
// lie, B = V MN-major from shared memory); a warp whose rows' maxima all
// stayed (alpha exactly 1) leaves O as it is.  S of tile t and P.V of tile
// t - 1 are issued together, so the softmax of tile t runs while the
// tensor cores do P.V; the two consumer warpgroups overlap each other too,
// and up to D 64 take turns to issue (ping-pong).  At D = 256 that keeps
// O (128 registers a thread), S of one tile and P_hi, P_lo of the other
// live at once, and ptxas still fits them in the 240 without spilling.
// TMA zero-fills rows past S, and those keys are masked (only tiles at
// the diagonal or the ragged end test masks).  Key tiles wholly above a
// block's rows are not loaded, and those above a warpgroup's rows not
// computed; in causal mode the blocks with the most key tiles start
// first.  No allocation; the launch goes on the caller's stream.
#include <climits>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int BQ = 128;            // query rows per block
constexpr int THREADS = 384;       // producer warpgroup + 2 consumers
constexpr float NEG = -1e30f;

template <int D>
struct Layout {
  static constexpr int BK = D <= 64 ? 128 : 64;       // keys per tile
  static constexpr int RB = D < 64 ? 2 * D : 128;     // bytes of a row
  static constexpr int CB = D < 64 ? 1 : D / 64;      // column blocks
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t TILE_BYTES = BK * D * 2;   // one K or V stage
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  // Q's barrier, then full and empty barriers of the K and V stages
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 4 * STAGES);
  // dynamic shared memory: the tiles must start on 1024 bytes (the swizzle
  // atom), which the launch does not promise
  static constexpr size_t SMEM = BYTES + 1024;
};

// q, k, v: 3-d tensor maps over (bh, S, D) of T, boxes of 64 columns by
// BQ (q) or BK (k, v) rows; out (bh, sq, D) of T.  Grid: query tiles x bh
// blocks, bh the faster index.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   T* __restrict__ out, int sq, int sk, float scale_log2,
                   int causal) {
  using L = Layout<D>;
  constexpr int S = L::STAGES, BK = L::BK, RB = L::RB, CB = L::CB;
  constexpr int KPB = RB / 32;     // k16 steps in a row of a block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_tile = base, sk_tile = base + L::K_OFF,
                 sv_tile = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t full_k = bar_q + 8, empty_k = full_k + 8 * S,
                 full_v = empty_k + 8 * S, empty_v = full_v + 8 * S;

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
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        tma_load(sq_tile + c * BQ * RB, &tq, bar_q, c * 64, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        const uint32_t ph = (kt / S) & 1;
        const uint32_t kdst = sk_tile + s * L::TILE_BYTES,
                       vdst = sv_tile + s * L::TILE_BYTES;
        mbar_wait(empty_k + 8 * s, ph ^ 1);
        mbar_expect_tx(full_k + 8 * s, L::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(kdst + c * BK * RB, &tk, full_k + 8 * s, c * 64, kt * BK,
                   bh);
        mbar_wait(empty_v + 8 * s, ph ^ 1);
        mbar_expect_tx(full_v + 8 * s, L::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(vdst + c * BK * RB, &tv, full_v + 8 * s, c * 64, kt * BK,
                   bh);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // this thread's rows in the accumulators: r0 and r0 + 8; its columns
    // in each 8-column group: c0 and c0 + 1
    const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int wg_first = q0 + 64 * cw, wg_last = wg_first + 63;
    const uint32_t qa = sq_tile + cw * 64 * RB;

    float o[D / 2], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t phi[BK / 4], plo[BK / 4];

    // S = Q . K^T of key tile kt, issued and committed
    auto issue_qk = [&](int kt) {
      const uint32_t kb = sk_tile + (kt % S) * L::TILE_BYTES;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % KPB) * 32;   // 16 columns of a block
        const uint64_t a = desc_k_major<RB>(qa + (kk / KPB) * BQ * RB + off),
                       b = desc_k_major<RB>(kb + (kk / KPB) * BK * RB + off);
        if constexpr (BK == 128)
          wgmma_ss_n128<T>(sc, a, b, kk > 0);
        else
          wgmma_ss_n64<T>(sc, a, b, kk > 0);
      }
      wgmma_commit();
    };
    // O += P_hi . V + P_lo . V of key tile kt, issued and committed
    auto issue_pv = [&](int kt) {
      const uint32_t vb = sv_tile + (kt % S) * L::TILE_BYTES;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b = desc_mn_major<RB>(vb + kk * 16 * RB, BK * RB);
        wgmma_pv<T, D>(o, phi + 4 * kk, b);
        wgmma_pv<T, D>(o, plo + 4 * kk, b);
      }
      wgmma_commit();
    };
    // the softmax step of the scores in sc (key tile kt): p into sc, the
    // running max and sum, and alpha for O
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
    // O scaled by alpha (where a row of the warp's has a new max: alpha 1
    // would leave every bit as it is), then P (in sc) as wgmma A
    // fragments: for keys 16 kk .. 16 kk + 15 the registers are (rows r0,
    // r0 + 8) x (S column groups 2 kk, 2 kk + 1), which is where the S
    // accumulator holds them
    auto rescale_and_pack = [&]() {
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
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = 4 * (2 * kk + h) + 2 * rr;
            Elem<T>::split(sc[i], sc[i + 1], phi[4 * kk + 2 * h + rr],
                           plo[4 * kk + 2 * h + rr]);
          }
    };
    // tiles 0 .. n_live - 1 are computed; a tile wholly above this
    // warpgroup's rows (in causal order, every later one too) is waited for
    // and released only
    const int n_live = causal ? min(n_kt, wg_last / BK + 1) : n_kt;
    // Ping-pong where a tile is as long as the block (BK = BQ, D <= 64:
    // both warpgroups have the same live tiles): the two take turns to
    // issue their products, so that one's softmax runs while the other's
    // products hold the tensor cores.  Warpgroup c's turn is named barrier
    // 4 + c over both; warpgroup 0 goes first, and takes one turn more at
    // the end, so that every arrival is waited for.  (With 64-key tiles the
    // turns measured no faster.)
    constexpr bool PP = BK == BQ;
    auto my_turn = [&]() {
      if constexpr (PP) named_sync(4 + cw, 256);
    };
    auto pass_turn = [&]() {
      if constexpr (PP) named_arrive(5 - cw, 256);
    };
    if (PP && cw == 1) named_arrive(4, 256);

    // Per tile kt: S_kt = Q.K_kt^T and O += P_{kt-1}.V_{kt-1} go to the
    // tensor cores together; the softmax of S_kt runs while P.V does.  No
    // wgmma is issued under a branch, so that ptxas keeps them pipelined.
    mbar_wait(bar_q, 0);
    mbar_wait(full_k, 0);
    my_turn();
    issue_qk(0);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k);
    softmax(0);
    rescale_and_pack();
    for (int kt = 1; kt < n_live; ++kt) {
      const int s = kt % S, sp = (kt - 1) % S;
      mbar_wait(full_k + 8 * s, (kt / S) & 1);
      mbar_wait(full_v + 8 * sp, ((kt - 1) / S) & 1);
      my_turn();
      issue_qk(kt);
      issue_pv(kt - 1);
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      softmax(kt);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(phi);             // read by P.V until here
      fence_regs(plo);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      rescale_and_pack();
    }
    {
      const int sp = (n_live - 1) % S;
      mbar_wait(full_v + 8 * sp, ((n_live - 1) / S) & 1);
      my_turn();
      issue_pv(n_live - 1);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
    }
    if (PP && cw == 0) named_sync(4, 256);
    for (int kt = n_live; kt < n_kt; ++kt) {
      const int s = kt % S;
      const uint32_t ph = (kt / S) & 1;
      mbar_wait(full_k + 8 * s, ph);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      mbar_wait(full_v + 8 * s, ph);
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
      T* orow = out + ((int64_t)bh * sq + row) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            Elem<T>::pack(__fdiv_rn(o[4 * j + 2 * rr], den),
                          __fdiv_rn(o[4 * j + 2 * rr + 1], den));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, float scale_log2, cudaStream_t stream) {
  const int64_t blocks = (int64_t)bh * ((sq + BQ - 1) / BQ);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map<T>(enc, &tq, q, bh, sq, D, BQ);
  if (r == CUDA_SUCCESS)
    r = make_map<T>(enc, &tk, k, bh, sk, D, Layout<D>::BK);
  if (r == CUDA_SUCCESS)
    r = make_map<T>(enc, &tv, v, bh, sk, D, Layout<D>::BK);
  if (r != CUDA_SUCCESS) return -(int)r;
  const size_t smem = Layout<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_wgmma_kernel<T, D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), sq, sk, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, int causal, float scale_log2,
             void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    case 32:
      return launch<T, 32>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    case 64:
      return launch<T, 64>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    case 128:
      return launch<T, 128>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    case 192:
      return launch<T, 192>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    case 256:
      return launch<T, 256>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous bf16
// (f16 for the _f16 launcher) on 16-byte boundaries; d: 16, 32, 64, 128,
// 192 or 256; bh, sq, sk >= 1 (bh times the query tiles of 128 rows at most
// INT_MAX); scale_log2 = f32(1/sqrt(D)) * log2(e), D the head dim before
// any padding.  Returns the CUDA error code of the launch (0 = launched),
// or minus the driver's code where a tensor map could not be made; any
// stale error is cleared first so that the code reports this launch alone.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int bh,
                                            int sq, int sk, int d, int causal,
                                            float scale_log2, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, causal,
                                 scale_log2, stream);
}

extern "C" int flash_attention_wgmma_f16_launch(const void* q, const void* k,
                                                const void* v, void* out,
                                                int bh, int sq, int sk, int d,
                                                int causal, float scale_log2,
                                                void* stream) {
  return dispatch<__half>(q, k, v, out, bh, sq, sk, d, causal, scale_log2,
                          stream);
}
