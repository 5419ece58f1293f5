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
// operations.  Exponentials are exp2 of scores scaled by log2(e) (up to
// D 64 by MUFU.EX2 alone: values below 2^-126 flush to zero).
//
// Design, head dims 128, 192 and 256 (flash_wgmma_kernel).  One block per
// (bh, 128 query rows), 384 threads: warpgroup 0 is the producer (one
// thread issues every TMA load; setmaxnreg drops it to 24 registers),
// warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg 240).  Q
// (128 x D) is loaded once; K and V tiles of 64 keys go through a ring of
// STAGES shared-memory stages each, signalled by mbarriers (full: the
// TMA's bytes arrived; empty: all 8 consumer warps are done with it).
// Tiles are stored as column blocks of 64 columns, rows of 128 bytes with
// the 128-byte swizzle, one TMA box each (a box's inner extent is at most
// 128 bytes), and the wgmma descriptors walk the same blocks.  Per key
// tile a consumer warpgroup runs S = Q.K^T (m64n64k16, A and B K-major
// from shared memory), the online softmax on the accumulator fragments
// (row max and sum over the quad of lanes that shares a row; a masked key
// gets p = 0, the running max starts at -1e30), then O = O.alpha + P_hi.V
// + P_lo.V (m64nDk16, A = P in registers, taken from the S fragments as
// they lie, B = V MN-major from shared memory); a warp whose rows' maxima
// all stayed (alpha exactly 1) leaves O as it is.  S of tile t and P.V of
// tile t - 1 are issued together, so the softmax of tile t runs while the
// tensor cores do P.V, and the two consumer warpgroups overlap each other.
// At D = 256 that keeps O (128 registers a thread), S of one tile and
// P_hi, P_lo of the other live at once, and ptxas still fits them in the
// 240 without spilling.
//
// Design, head dims 16, 32 and 64 (flash_wgmma_small_kernel).  There the
// products are small and a tile's work is mostly the softmax and the P
// split on the CUDA cores, and timing with parts left out shows those
// instructions and the products taking turns rather than overlapping:
// the time is the instructions a score over the warps an SM keeps in
// flight.  So a block holds NC consumer warpgroups of 64 query
// rows each (BQ = 64 NC rows): four up to D 32, with a producer warpgroup
// whose registers setmaxnreg gives to them (112 a thread; with a producer
// warp they would get 96 and spill), and three at D 64 (four spill there
// even at 112), with a producer warp (128 registers a thread, no
// setmaxnreg).  Key tiles of BK = 64 keys keep S (32 registers a thread),
// P_hi and P_lo (16 each) and O (D / 2) in that budget.  Q is one TMA box
// of BQ rows of 2 D bytes (the 32-, 64- or 128-byte swizzle), K and V one
// box of BK rows a stage; the empty barriers count the 4 NC consumer
// warps.  Each score costs few instructions: the exponential is MUFU.EX2
// alone (exp2_ftz), the bf16 split a shift and a mask to bring P_hi back
// to f32, the wgmma descriptors a 32-bit add to the first stage's, the
// stage and phase of a tile unsigned shifts; up to D 32 the tile loop is
// unrolled by the stages, so that each tile's descriptors are constants
// (at D 64 the unrolled loop spills).  The schedule of a warpgroup
// is the one above (S of tile t beside P.V of tile t - 1, the softmax
// under P.V); the other warpgroups fill its waits.
//
// Both: TMA zero-fills rows past S, and those keys are masked (only tiles
// at the diagonal or the ragged end test masks).  Key tiles wholly above a
// block's rows are not loaded, and those above a warpgroup's rows not
// computed; in causal mode the blocks with the most key tiles start
// first.  No allocation; the launch goes on the caller's stream.
#include <climits>
#include <type_traits>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int BQ = 128;            // query rows per block, D >= 128
constexpr int THREADS = 384;       // producer warpgroup + 2 consumers
constexpr float NEG = -1e30f;

template <int D>
struct Layout {
  static_assert(D % 64 == 0, "head dims 128, 192 and 256");
  static constexpr int BK = 64;                        // keys per tile
  static constexpr int RB = 128;                       // bytes of a row
  static constexpr int CB = D / 64;                    // column blocks
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

template <int D>
struct Small {
  static_assert(D == 16 || D == 32 || D == 64, "head dims 16, 32 and 64");
  // four consumer warpgroups up to D 32; three at D 64, where four spill
  // in the 112 registers a thread they can have
  static constexpr int NC = D <= 32 ? 4 : 3;
  static constexpr int BQ = 64 * NC;                   // query rows a block
  static constexpr int BK = 64;                        // keys a tile
  // the producer: one warp, or (PWG, with four consumers, which would get
  // 96 registers a thread beside a warp) a warpgroup that gives its
  // registers to the consumers by setmaxnreg: REGS a consumer thread, of
  // the pool of the registers a thread at launch (65,536 over the
  // threads, in 8s)
  static constexpr bool PWG = NC >= 4;
  static constexpr int THREADS = 128 * NC + (PWG ? 128 : 32);
  static constexpr int REGS =
      (((65536 / THREADS) & ~7) * THREADS - 24 * 128) / (128 * NC) & ~7;
  static_assert(REGS <= 255, "setmaxnreg takes at most 255");
  static constexpr int STAGES = 4;
  // the tile loop unrolled by STAGES (each tile's stage known at compile
  // time): at D 64 the unrolled loop spills in 128 registers
  static constexpr bool UNROLL = D <= 32;
  static constexpr int RB = 2 * D;                     // bytes of a row
  static constexpr uint32_t Q_BYTES = BQ * RB;
  static constexpr uint32_t TILE_BYTES = BK * RB;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 4 * STAGES);
  static constexpr size_t SMEM = BYTES + 1024;
  static_assert(BQ <= 256 && BK <= 256, "a TMA box has at most 256 rows");
  static_assert(TILE_BYTES % 1024 == 0 && Q_BYTES % 1024 == 0,
                "stages on the swizzle atom");
};

// O scaled by alpha (where a row of the warp's has a new max: alpha 1
// would leave every bit as it is), then P (in sc, a tile of BK keys) as
// wgmma A fragments: for keys 16 kk .. 16 kk + 15 the registers are (rows
// r0, r0 + 8) x (S column groups 2 kk, 2 kk + 1), which is where the S
// accumulator holds them
template <typename T, int D, int BK>
__device__ __forceinline__ void rescale_and_split(
    float (&o)[D / 2], const float (&sc)[BK / 2], const float (&alpha)[2],
    uint32_t (&phi)[BK / 4], uint32_t (&plo)[BK / 4]) {
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
}

// out rows r0 and r0 + 8 (those below sq) = O / l, the row sums l first
// summed over the quad of lanes that shares a row
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 2],
                                           float (&l)[2], T* out, int bh,
                                           int sq, int r0, int c0) {
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
    // tiles 0 .. n_live - 1 are computed; a tile wholly above this
    // warpgroup's rows (in causal order, every later one too) is waited for
    // and released only
    const int n_live = causal ? min(n_kt, wg_last / BK + 1) : n_kt;

    // Per tile kt: S_kt = Q.K_kt^T and O += P_{kt-1}.V_{kt-1} go to the
    // tensor cores together; the softmax of S_kt runs while P.V does.  No
    // wgmma is issued under a branch, so that ptxas keeps them pipelined.
    mbar_wait(bar_q, 0);
    mbar_wait(full_k, 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k);
    softmax(0);
    rescale_and_split<T, D, BK>(o, sc, alpha, phi, plo);
    for (int kt = 1; kt < n_live; ++kt) {
      const int s = kt % S, sp = (kt - 1) % S;
      mbar_wait(full_k + 8 * s, (kt / S) & 1);
      mbar_wait(full_v + 8 * sp, ((kt - 1) / S) & 1);
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
      rescale_and_split<T, D, BK>(o, sc, alpha, phi, plo);
    }
    {
      const int sp = (n_live - 1) % S;
      mbar_wait(full_v + 8 * sp, ((n_live - 1) / S) & 1);
      issue_pv(n_live - 1);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
    }
    for (int kt = n_live; kt < n_kt; ++kt) {
      const int s = kt % S;
      const uint32_t ph = (kt / S) & 1;
      mbar_wait(full_k + 8 * s, ph);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      mbar_wait(full_v + 8 * s, ph);
      if (lane == 0) mbar_arrive(empty_v + 8 * s);
    }
    store_rows<T, D>(o, l, out, bh, sq, r0, c0);
  }
}

// The same function at head dims 16, 32 and 64 (Small<D>; see Design).
// Grid as above, BQ = 64 NC query rows a block.
template <typename T, int D>
__global__ void __launch_bounds__(Small<D>::THREADS, 1)
flash_wgmma_small_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         T* __restrict__ out, int sq, int sk,
                         float scale_log2, int causal) {
  using L = Small<D>;
  constexpr int S = L::STAGES, BK = L::BK, RB = L::RB, NC = L::NC,
                BQS = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_tile = base, sk_tile = base + L::K_OFF,
                 sv_tile = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t full_k = bar_q + 8, empty_k = full_k + 8 * S,
                 full_v = empty_k + 8 * S, empty_v = full_v + 8 * S;

  const int n_qt = (sq + BQS - 1) / BQS;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh, t_idx = blockIdx.x / n_bh;
  const int qt = causal ? n_qt - 1 - t_idx : t_idx;
  const int q0 = qt * BQS;
  const int kend = causal ? min(sk, q0 + BQS) : sk;
  const int n_kt = (kend + BK - 1) / BK;
  // stage and phase of key tile kt (kt >= 0)
  auto stage = [](int kt) { return (uint32_t)kt % S; };
  auto phase = [](int kt) { return ((uint32_t)kt / S) & 1u; };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 4 * NC);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {
    // ---- producer: one thread of the last warp (or warpgroup) ----
    if constexpr (L::PWG)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      tma_load(sq_tile, &tq, bar_q, 0, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const uint32_t s = stage(kt), ph = phase(kt);
        mbar_wait(empty_k + 8 * s, ph ^ 1);
        mbar_expect_tx(full_k + 8 * s, L::TILE_BYTES);
        tma_load(sk_tile + s * L::TILE_BYTES, &tk, full_k + 8 * s, 0,
                 kt * BK, bh);
        mbar_wait(empty_v + 8 * s, ph ^ 1);
        mbar_expect_tx(full_v + 8 * s, L::TILE_BYTES);
        tma_load(sv_tile + s * L::TILE_BYTES, &tv, full_v + 8 * s, 0,
                 kt * BK, bh);
      }
    }
    return;
  }
  // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
  if constexpr (L::PWG)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(L::REGS));
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int wg_first = q0 + 64 * cw, wg_last = wg_first + 63;

  float o[D / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t phi[BK / 4], plo[BK / 4];

  // the wgmma descriptors of this warpgroup's Q rows and of stage 0's K
  // and V: a descriptor's low bits are its address over 16, and every
  // address here is below 2^18, so a later one is the first plus its
  // offset over 16 (added to the low word alone: no carry to propagate)
  const uint64_t dq = desc_k_major<RB>(sq_tile + cw * 64 * RB),
                 dk = desc_k_major<RB>(sk_tile),
                 dv = desc_mn_major<RB>(sv_tile, BK * RB);
  auto desc_at = [](uint64_t d, uint32_t off) {
    return (d & 0xffffffff00000000ull) | (uint32_t)((uint32_t)d + off);
  };
  // S = Q . K^T of the key tile in stage st, issued and committed
  auto issue_qk = [&](uint32_t st) {
    const uint32_t kb = st * (L::TILE_BYTES >> 4);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)           // 16 columns: 32 bytes
      wgmma_ss_n64<T>(sc, desc_at(dq, kk * 2), desc_at(dk, kb + kk * 2),
                      kk > 0);
    wgmma_commit();
  };
  // O += P_hi . V + P_lo . V of the key tile in stage st, issued and
  // committed
  auto issue_pv = [&](uint32_t st) {
    const uint32_t vb = st * (L::TILE_BYTES >> 4);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t b = desc_at(dv, vb + kk * RB);   // 16 rows further
      wgmma_pv<T, D>(o, phi + 4 * kk, b);
      wgmma_pv<T, D>(o, plo + 4 * kk, b);
    }
    wgmma_commit();
  };
  // the softmax step of tile kt's scores in sc: p into sc, the running
  // max and sum, and alpha for O
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    // only a tile at the diagonal or at the ragged end of K masks keys
    if ((causal && k0 + BK - 1 > wg_first) || k0 + BK > sk)
      softmax_tile<true, BK / 2, true>(sc, m, l, alpha, r0, k0 + c0, sk,
                                       causal, scale_log2);
    else
      softmax_tile<false, BK / 2, true>(sc, m, l, alpha, r0, k0 + c0, sk,
                                        causal, scale_log2);
  };
  // P.V of the tile in stage st has completed: its V stage released
  auto release_v = [&](uint32_t st) {
    fence_regs(o);
    fence_regs(phi);               // read by P.V until here
    fence_regs(plo);
    if (lane == 0) mbar_arrive(empty_v + 8 * st);
  };
  // tile kt >= 1 in stage st (the tile before in stage sp): S_kt and
  // P_{kt-1}.V go to the tensor cores together; the softmax of S_kt runs
  // while P.V does, and the other warpgroups' work fills the waits
  auto tile = [&](int kt, uint32_t st, uint32_t sp) {
    mbar_wait(full_k + 8 * st, phase(kt));
    mbar_wait(full_v + 8 * sp, phase(kt - 1));
    issue_qk(st);
    issue_pv(sp);
    wgmma_wait<1>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k + 8 * st);
    softmax(kt);
    wgmma_wait<0>();
    release_v(sp);
    rescale_and_split<T, D, BK>(o, sc, alpha, phi, plo);
  };
  // tiles 0 .. n_live - 1 are computed; a tile wholly above this
  // warpgroup's rows (in causal order, every later one too) is waited for
  // and released only
  const int n_live = causal ? min(n_kt, wg_last / BK + 1) : n_kt;

  // No wgmma is issued under a branch, so that ptxas keeps them
  // pipelined.  With UNROLL the loop takes S tiles a turn, so that each
  // tile's stage, and with it its descriptors, is known at compile time.
  mbar_wait(bar_q, 0);
  mbar_wait(full_k, 0);
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(sc);
  if (lane == 0) mbar_arrive(empty_k);
  softmax(0);
  rescale_and_split<T, D, BK>(o, sc, alpha, phi, plo);
  int kt = 1;
  if constexpr (L::UNROLL) {
    for (; kt + S - 1 < n_live; kt += S) {
#pragma unroll
      for (int u = 0; u < S; ++u) tile(kt + u, (u + 1) % S, u);
    }
  }
  for (; kt < n_live; ++kt) tile(kt, stage(kt), stage(kt - 1));
  {
    const uint32_t sp = stage(n_live - 1);
    mbar_wait(full_v + 8 * sp, phase(n_live - 1));
    issue_pv(sp);
    wgmma_wait<0>();
    release_v(sp);
  }
  for (kt = n_live; kt < n_kt; ++kt) {
    mbar_wait(full_k + 8 * stage(kt), phase(kt));
    if (lane == 0) mbar_arrive(empty_k + 8 * stage(kt));
    mbar_wait(full_v + 8 * stage(kt), phase(kt));
    if (lane == 0) mbar_arrive(empty_v + 8 * stage(kt));
  }
  store_rows<T, D>(o, l, out, bh, sq, r0, c0);
}

// the instance of head dim D and its launch shape: query rows a block,
// keys a tile, threads, consumer warpgroups a block, dynamic shared memory
struct Shape {
  int rows, keys, threads, consumers;
  size_t smem;
};
template <int D>
constexpr Shape shape_of() {
  if constexpr (D <= 64)
    return {Small<D>::BQ, Small<D>::BK, Small<D>::THREADS, Small<D>::NC,
            Small<D>::SMEM};
  else
    return {BQ, Layout<D>::BK, THREADS, 2, Layout<D>::SMEM};
}
// the instance's dynamic shared memory allowed
template <typename T, int D>
cudaError_t set_smem() {
  constexpr int smem = (int)shape_of<D>().smem;
  if constexpr (D <= 64)
    return cudaFuncSetAttribute(flash_wgmma_small_kernel<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  else
    return cudaFuncSetAttribute(flash_wgmma_kernel<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, float scale_log2, cudaStream_t stream) {
  constexpr Shape sh = shape_of<D>();
  const int64_t blocks = (int64_t)bh * ((sq + sh.rows - 1) / sh.rows);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map<T>(enc, &tq, q, bh, sq, D, sh.rows);
  if (r == CUDA_SUCCESS) r = make_map<T>(enc, &tk, k, bh, sk, D, sh.keys);
  if (r == CUDA_SUCCESS) r = make_map<T>(enc, &tv, v, bh, sk, D, sh.keys);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t e = set_smem<T, D>();
  if (e != cudaSuccess) return (int)e;
  if constexpr (D <= 64)
    flash_wgmma_small_kernel<T, D>
        <<<(unsigned)blocks, sh.threads, sh.smem, stream>>>(
            tq, tk, tv, static_cast<T*>(out), sq, sk, scale_log2, causal);
  else
    flash_wgmma_kernel<T, D>
        <<<(unsigned)blocks, sh.threads, sh.smem, stream>>>(
            tq, tk, tv, static_cast<T*>(out), sq, sk, scale_log2, causal);
  return (int)cudaGetLastError();
}

// blocks of the instance resident on one SM, its consumer warpgroups a
// block and its registers a thread (at launch)
template <typename T, int D>
int residency(int* blocks, int* consumers, int* regs) {
  constexpr Shape sh = shape_of<D>();
  cudaFuncAttributes a;
  cudaError_t e = set_smem<T, D>();
  if constexpr (D <= 64) {
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, flash_wgmma_small_kernel<T, D>, sh.threads, sh.smem);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&a, flash_wgmma_small_kernel<T, D>);
  } else {
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, flash_wgmma_kernel<T, D>, sh.threads, sh.smem);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&a, flash_wgmma_kernel<T, D>);
  }
  if (e == cudaSuccess) {
    *consumers = sh.consumers;
    *regs = a.numRegs;
  }
  return (int)e;
}

// F(integral_constant<D>) at the built head dims
template <typename F>
int with_head_dim(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 192: return f(std::integral_constant<int, 192>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, int causal, float scale_log2,
             void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  return with_head_dim(d, [&](auto dd) {
    return launch<T, decltype(dd)::value>(q, k, v, out, bh, sq, sk, causal,
                                          scale_log2,
                                          (cudaStream_t)stream);
  });
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous bf16
// (f16 for the _f16 launcher) on 16-byte boundaries; d: 16, 32, 64, 128,
// 192 or 256; bh, sq, sk >= 1 (bh times the query tiles of the instance's
// rows, 64 to 256, at most INT_MAX); scale_log2 = f32(1/sqrt(D)) *
// log2(e), D the head dim before any padding.  Returns the CUDA error code
// of the launch (0 = launched), or minus the driver's code where a tensor
// map could not be made; any stale error is cleared first so that the
// code reports this launch alone.
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

// The residency of the instance at (f16 ? f16 : bf16, head dim d) on the
// current card: its blocks resident on one SM (with its dynamic shared
// memory), its consumer warpgroups a block and its registers a thread.
// Returns the CUDA error code (0 = done).
extern "C" int flash_attention_wgmma_residency(int f16, int d, int* blocks,
                                               int* consumers, int* regs) {
  return with_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    return f16 ? residency<__half, D>(blocks, consumers, regs)
               : residency<__nv_bfloat16, D>(blocks, consumers, regs);
  });
}
