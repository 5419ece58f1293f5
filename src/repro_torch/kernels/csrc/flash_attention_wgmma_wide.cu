// Flash attention forward (online softmax) in bf16 or f16 at head dims 384
// and 512, on Hopper's tensor cores (sm_90a): wgmma for both products, Q,
// K and V by TMA, each score computed once.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), for bf16 and f16 inputs with 256 < D <= 512 (D up to
// 256 takes flash_attention_wgmma.cu; f32 inputs, and D past 512,
// flash_attention_wide.cu).  It computes the same function as
// flash_attention_wgmma.cu:
//   out = softmax(scale * q . K^T, masked) . V,   scale = float32(1/sqrt(D)),
// products, scores, running max and sum and the accumulator in f32, P
// split into P_hi = T(p) and P_lo = T(p - P_hi) for P.V (the tensor cores
// issue 1.5x the useful operations), out = acc / max(l, 1e-30) rounded to
// the input type.  D is 384 or 512 (the wrapper pads any other D in (256,
// 512] with zero columns and passes the scale of the unpadded D); BH, Sq
// and Sk are any sizes >= 1, a ragged tile of queries or keys masked.
//
// Bound on this card: operations.  Per query row and visible key, 2 D
// multiply-adds: at D 512 and S 4,096, 64 per byte this kernel reads.
//
// Design.  An m64 accumulator of 64 rows x D columns in f32 is D / 2
// registers a thread, too many for one warpgroup past D 256, so the D
// columns are split between two consumer warpgroups and the scores are
// shared through shared memory instead of computed by each.  One block per
// (bh, 64 query rows), 384 threads: warpgroup 0 is the producer (one
// thread issues every TMA load; setmaxnreg drops it to 24 registers),
// warpgroups 1 and 2 are consumers (setmaxnreg 240); consumer w owns
// columns [w DH, (w + 1) DH) of Q, K, V and O, DH = D / 2 (192 or 256).
// Q (64 x D) is loaded once; 32-key K and V tiles go through two stages
// each, signalled by mbarriers as in flash_attention_wgmma.cu, all as
// 64-column blocks of 128-byte rows with the 128-byte swizzle.  Per key
// tile each consumer computes its partial S_w = Q_w . K_w^T over its DH
// columns (m64n32k16, A and B K-major from shared memory), writes it to an
// exchange buffer in shared memory (each thread its 16 fragments, at the
// same place as the other warpgroup's thread of the same index, so no bank
// conflicts), meets the other consumer at a named barrier (256 threads)
// and adds the other's partial: both hold S = S_0 + S_1 bit for bit (f32
// addition commutes), so both take the same running max, sum and P.  Then
// the online softmax on the fragments and O_w = O_w . alpha + P_hi . V_w +
// P_lo . V_w (m64nDHk16, A = P in registers, B = V MN-major from shared
// memory).  S of tile t and P.V of tile t - 1 are issued together, so the
// exchange and the softmax of tile t run while the tensor cores do P.V.
// The exchange buffer has two halves, taken by tile parity, so one barrier
// a tile suffices: a consumer writes a half again only after the other has
// passed the next tile's barrier, and so has read it.  Shared memory at D
// 512: Q 64 KB, K and V 2 x 32 KB each, exchange 32 KB, 225 KB in all; O
// is 128 registers a thread at DH 256, as in flash_attention_wgmma.cu at
// D 256.  TMA zero-fills rows past S, and those keys are masked (only tiles
// at the diagonal or the ragged end test masks); key tiles wholly above a
// block's rows are not loaded, and in causal mode the blocks with the most
// key tiles start first.  No allocation; the launch goes on the caller's
// stream.
#include <climits>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per tile
constexpr int STAGES = 2;          // K and V stages
constexpr int THREADS = 384;       // producer warpgroup + 2 consumers
constexpr int XF = 16;             // S fragments a consumer thread holds
constexpr float NEG = -1e30f;

template <int DH>
struct WideLayout {
  static constexpr int D = 2 * DH;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t TILE_BYTES = BK * D * 2;   // one K or V stage
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * TILE_BYTES;
  // the exchange: 2 halves x 2 consumers x XF fragments x 128 threads, f32
  static constexpr uint32_t X_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr uint32_t X_BYTES = 2 * 2 * XF * 128 * 4;
  static constexpr uint32_t BAR_OFF = X_OFF + X_BYTES;
  // Q's barrier, then full and empty barriers of the K and V stages
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 4 * STAGES);
  // the tiles must start on 1024 bytes (the swizzle atom)
  static constexpr size_t SMEM = BYTES + 1024;
};
static_assert(WideLayout<256>::SMEM <= 232448, "D 512 fits an SM");

// q, k, v: 3-d tensor maps over (bh, S, D) of T, boxes of 64 columns by
// BQ (q) or BK (k, v) rows; out (bh, sq, D) of T.  Grid: query tiles x bh
// blocks, bh the faster index.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        T* __restrict__ out, int sq, int sk, float scale_log2,
                        int causal) {
  using L = WideLayout<DH>;
  constexpr int D = L::D;
  constexpr int CB = D / 64;       // 64-column blocks of a row
  constexpr int CBW = DH / 64;     // a consumer's blocks
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq_tile = base, sk_tile = base + L::K_OFF,
                 sv_tile = base + L::V_OFF;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + L::X_OFF);
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t full_k = bar_q + 8, empty_k = full_k + 8 * STAGES,
                 full_v = empty_k + 8 * STAGES, empty_v = full_v + 8 * STAGES;

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
    for (int s = 0; s < STAGES; ++s) {
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
        tma_load(sq_tile + c * BQ * 128, &tq, bar_q, c * 64, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        const uint32_t kdst = sk_tile + s * L::TILE_BYTES,
                       vdst = sv_tile + s * L::TILE_BYTES;
        mbar_wait(empty_k + 8 * s, ph ^ 1);
        mbar_expect_tx(full_k + 8 * s, L::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(kdst + c * BK * 128, &tk, full_k + 8 * s, c * 64, kt * BK,
                   bh);
        mbar_wait(empty_v + 8 * s, ph ^ 1);
        mbar_expect_tx(full_v + 8 * s, L::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(vdst + c * BK * 128, &tv, full_v + 8 * s, c * 64, kt * BK,
                   bh);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns columns cw DH .. cw DH + DH - 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // this thread's rows in the accumulators: r0 and r0 + 8 (the same in
    // both consumers); its columns in each 8-column group: c0 and c0 + 1
    const int r0 = q0 + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    // this consumer's first column block in Q and in a K or V stage
    const uint32_t qa = sq_tile + cw * CBW * BQ * 128;
    const uint32_t kv_off = cw * CBW * BK * 128;
    // fragment i of this thread in exchange half h: [h][cw][i][t]
    float* x_mine = xch + cw * XF * 128 + t;
    const float* x_other = xch + (1 - cw) * XF * 128 + t;

    float o[DH / 2], sc[XF];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < XF; ++i) sc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t phi[8], plo[8];

    // this consumer's partial S = Q_w . K_w^T of key tile kt, issued and
    // committed
    auto issue_qk = [&](int kt) {
      const uint32_t kb = sk_tile + (kt % STAGES) * L::TILE_BYTES + kv_off;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns of a block
        wgmma_ss_n32<T>(sc, desc_k_major(qa + (kk / 4) * BQ * 128 + off),
                        desc_k_major(kb + (kk / 4) * BK * 128 + off), kk > 0);
      }
      wgmma_commit();
    };
    // O_w += P_hi . V_w + P_lo . V_w of key tile kt, issued and committed
    auto issue_pv = [&](int kt) {
      const uint32_t vb = sv_tile + (kt % STAGES) * L::TILE_BYTES + kv_off;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b = desc_mn_major(vb + kk * 16 * 128, BK * 128);
        wgmma_pv<T, DH>(o, phi + 4 * kk, b);
        wgmma_pv<T, DH>(o, plo + 4 * kk, b);
      }
      wgmma_commit();
    };
    // the whole S of tile kt: this consumer's partial plus the other's
    auto exchange = [&](int kt) {
      const int h = (kt & 1) * 2 * XF * 128;
#pragma unroll
      for (int i = 0; i < XF; ++i) x_mine[h + i * 128] = sc[i];
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < XF; ++i)
        sc[i] = __fadd_rn(sc[i], x_other[h + i * 128]);
    };
    // the softmax step of the scores in sc (key tile kt): p into sc, the
    // running max and sum, and alpha for O
    auto softmax = [&](int kt) {
      const int k0 = kt * BK;
      // only a tile at the diagonal or at the ragged end of K masks keys
      if ((causal && k0 + BK - 1 > q0) || k0 + BK > sk)
        softmax_tile<true>(sc, m, l, alpha, r0, k0 + c0, sk, causal,
                           scale_log2);
      else
        softmax_tile<false>(sc, m, l, alpha, r0, k0 + c0, sk, causal,
                            scale_log2);
    };
    // O scaled by alpha, then P (in sc) as wgmma A fragments: for keys
    // 16 kk .. 16 kk + 15 the registers are (rows r0, r0 + 8) x (S column
    // groups 2 kk, 2 kk + 1), which is where the S accumulator holds them
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 0] = __fmul_rn(o[4 * j + 0], alpha[0]);
        o[4 * j + 1] = __fmul_rn(o[4 * j + 1], alpha[0]);
        o[4 * j + 2] = __fmul_rn(o[4 * j + 2], alpha[1]);
        o[4 * j + 3] = __fmul_rn(o[4 * j + 3], alpha[1]);
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

    // Per tile kt: S_kt = Q.K_kt^T and O += P_{kt-1}.V_{kt-1} go to the
    // tensor cores together; the exchange and the softmax of S_kt run
    // while P.V does.  No wgmma is issued under a branch, so that ptxas
    // keeps them pipelined.
    mbar_wait(bar_q, 0);
    mbar_wait(full_k, 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k);
    exchange(0);
    softmax(0);
    rescale_and_pack();
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % STAGES, sp = (kt - 1) % STAGES;
      mbar_wait(full_k + 8 * s, (kt / STAGES) & 1);
      issue_qk(kt);
      mbar_wait(full_v + 8 * sp, ((kt - 1) / STAGES) & 1);
      issue_pv(kt - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k + 8 * s);
      exchange(kt);
      softmax(kt);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(phi);             // read by P.V until here
      fence_regs(plo);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
      rescale_and_pack();
    }
    {
      const int sp = (n_kt - 1) % STAGES;
      mbar_wait(full_v + 8 * sp, ((n_kt - 1) / STAGES) & 1);
      issue_pv(n_kt - 1);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v + 8 * sp);
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
      T* orow = out + ((int64_t)bh * sq + row) * D + cw * DH + c0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            Elem<T>::pack(__fdiv_rn(o[4 * j + 2 * rr], den),
                          __fdiv_rn(o[4 * j + 2 * rr + 1], den));
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int D = 2 * DH;
  const int64_t blocks = (int64_t)bh * ((sq + BQ - 1) / BQ);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map<T>(enc, &tq, q, bh, sq, D, BQ);
  if (r == CUDA_SUCCESS) r = make_map<T>(enc, &tk, k, bh, sk, D, BK);
  if (r == CUDA_SUCCESS) r = make_map<T>(enc, &tv, v, bh, sk, D, BK);
  if (r != CUDA_SUCCESS) return -(int)r;
  const size_t smem = WideLayout<DH>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_wide_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_wgmma_wide_kernel<T, DH><<<(unsigned)blocks, THREADS, smem, stream>>>(
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
    case 384:
      return launch<T, 192>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    case 512:
      return launch<T, 256>(q, k, v, out, bh, sq, sk, causal, scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous bf16
// (f16 for the _f16 launcher) on 16-byte boundaries; d: 384 or 512; bh,
// sq, sk >= 1 (bh times the query tiles of 64 rows at most INT_MAX);
// scale_log2 = f32(1/sqrt(D)) * log2(e), D the head dim before any
// padding.  Returns the CUDA error code of the launch (0 = launched), or
// minus the driver's code where a tensor map could not be made; any stale
// error is cleared first so that the code reports this launch alone.
extern "C" int flash_attention_wgmma_wide_launch(
    const void* q, const void* k, const void* v, void* out, int bh, int sq,
    int sk, int d, int causal, float scale_log2, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, causal,
                                 scale_log2, stream);
}

extern "C" int flash_attention_wgmma_wide_f16_launch(
    const void* q, const void* k, const void* v, void* out, int bh, int sq,
    int sk, int d, int causal, float scale_log2, void* stream) {
  return dispatch<__half>(q, k, v, out, bh, sq, sk, d, causal, scale_log2,
                          stream);
}
