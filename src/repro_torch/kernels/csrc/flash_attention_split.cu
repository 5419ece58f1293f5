// Flash attention forward for few queries over many keys, split over the
// keys, for Hopper (sm_90a): Sq <= 16, not causal, head dims up to 256.
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), for the calls with at most 16 query rows and no causal
// mask (the reference sends Sq < 16 to its plain version, which computes
// the same function).  For each (batch*head, query row) it computes
//   out = softmax(scale * q . K^T) . V,   scale = float32(1/sqrt(D)),
// with the scores, exponentials (base 2, of scores scaled by scale *
// log2(e) after the product), running max, sum, P and the accumulator in
// f32; out = acc / max(l, 1e-30), rounded once to the input type.  D is 16,
// 32, 64, 128, 192 or 256 for bf16 and f16, 64 to 256 for f32 (the wrapper
// pads any other D with zero columns and passes the scale of the unpadded
// D); BH, Sq <= 16 and Sk are any sizes >= 1.
//
// Numerics, as the other kernels': bf16 and f16 scores take one product
// (mma.sync m16n8k16, f32 accumulators) and P.V two (P split into hi =
// T(p) and lo = T(p - hi), lo first); f32 takes three TF32 products for
// each f32 one (mma.sync m16n8k8: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi), each
// within about 2^-21 of its f32 value.
//
// Bound on this card: HBM.  K and V are read once, 2 Sk D elements a
// (batch*head) row, against 4 Sq D multiply-adds a key: with Sq <= 16 the
// tensor cores are far from their rate.  What the kernels built for long
// query tiles lose here is parallelism: one block per (bh) walks all Sk
// keys alone with 8 of its 64 or 128 rows in use.
//
// Design, in the spirit of flash-decoding.  The grid is (bh, key split):
// the wrapper picks the splits for about one block an SM in all (f32 two;
// never more than fit at once; bh 64, Sk 4,096: 2 splits of 2,048 keys, 128
// blocks) and passes the keys a split takes (a multiple of a tile for each
// warp), within the limits flash_attention_split_limits reports.  A block of four warps holds the 16 query rows
// (rows past Sq as zeros; in f32 split once into TF32 hi and lo) in shared
// memory, loaded while its first tiles are; its split's keys go in tiles of
// KT keys (16; f32 8) to the warps in turn, warp w tiles w, w + 4, ..., and
// each warp streams its own tiles through its own ring of shared-memory
// stages by cp.async (16-byte runs, keys past the split zero-filled and
// masked), so the loop has no block barrier.  For each tile a warp computes
// the 16 x KT scores, the online-softmax step on their fragments (row max
// and sum over the 4 lanes of a row), rescales its 16 x D accumulator and
// adds P.V: in bf16 and f16 P's fragments are the scores' accumulators as
// they lie and V's come by ldmatrix.trans; in f32 the K rows of a tile are
// taken in the order 0, 4, 1, 5, 2, 6, 3, 7, so that each thread's scores
// are its P.V A fragment as they lie.  K and V rows are padded by 16 (f32
// K: 16, V: 32) bytes so that the fragment loads fall in distinct banks.
// At the end the four warps' (m, l, acc) are merged in warp order through
// shared memory.  With one split the block writes the output.  Otherwise it
// writes its (acc, m, l) for rows < Sq to a scratch the wrapper allocates
// (bh x splits x Sq x (D + 2) f32), fences, and counts itself in its (bh)'s
// counter; the last block of a (bh) sets the counter back to 0 (the wrapper
// zeroes a stream's counters once and keeps them), merges every split's
// partials in split order (the factors exp2(m_s - m) first, one warp a row;
// every split's values of a thread's elements loaded at once) and writes
// the output.  The merge order is fixed, so a call gives the same bits on
// every run.  One launch, no allocation; the launch goes on the caller's
// stream.
#include <climits>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int kRows = 16;            // query rows of a block: one m16 tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 64;       // splits of a (bh)
constexpr float kNeg = -1e30f;

// Shared memory of one instance, in bytes: the query rows (f32: their TF32
// hi and lo), then either the warps' rings or, after the loop, the merge
// area (the warps' accumulators, maxima and sums; in the last block of a
// (bh), the splits' factors and sums and the rows' sums).  A stage holds KT rows of
// K then KT rows of V.  A warp's ring holds about 12 KB (2 to 8 stages):
// more blocks an SM rather than deeper rings.
template <typename T, int D>
struct Split {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int KT = F32 ? 8 : 16;
  static constexpr int LDQ = D + (F32 ? 4 : 8);      // row strides, elements
  static constexpr int LDK = D + (F32 ? 4 : 8);
  static constexpr int LDV = D + 8;
  static constexpr uint32_t Q_BYTES =
      F32 ? 2 * kRows * LDQ * 4 : kRows * LDQ * sizeof(T);
  static constexpr uint32_t K_BYTES = KT * LDK * sizeof(T);
  static constexpr uint32_t STAGE = K_BYTES + KT * LDV * sizeof(T);
  static constexpr int STAGES_FIT = 12288 / STAGE;
  static constexpr int STAGES =
      STAGES_FIT < 2 ? 2 : STAGES_FIT > 8 ? 8 : STAGES_FIT;
  static constexpr uint32_t RING = STAGES * STAGE;
  static constexpr uint32_t BODY_OFF = (Q_BYTES + 127) / 128 * 128;
  static constexpr uint32_t MERGE = kWarps * kRows * (D + 2) * 4;
  static constexpr uint32_t FACTORS = kRows * (2 * kMaxSplits + 1) * 4;
  static constexpr uint32_t BODY_A = kWarps * RING > MERGE ? kWarps * RING
                                                            : MERGE;
  static constexpr uint32_t BODY = BODY_A > FACTORS ? BODY_A : FACTORS;
  // the dynamic shared memory's start is aligned up to 128 bytes
  static constexpr size_t BYTES = BODY_OFF + BODY + 128;
  static_assert(K_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte runs");
};

// 16 bytes from global to shared memory, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two consecutive 16-bit elements of shared memory as one register
template <typename T>
__device__ __forceinline__ uint32_t ld2(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8 x 8 matrices of 16-bit elements, transposed: lane l gives the
// row address of matrix l / 8, row l % 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, row-major) . b (16 x 8, col-major), T the
// input type (bf16 or f16)
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (kF16<T>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __half to_out(float x, __half*) {
  return __float2half_rn(x);
}

// q (bh, sq, D), k and v (bh, sk, D), out (bh, sq, D) of T; with splits >
// 1, part (bh, splits, sq, D + 2) f32 and counter (bh) int32, zeroed.  A
// split takes kps keys (the last one what is left).  Grid: bh * splits
// blocks, the split fastest.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ counter,
                   int sq, int sk, int splits, int kps, float scale_log2) {
  using L = Split<T, D>;
  constexpr int KT = L::KT, LDQ = L::LDQ, LDK = L::LDK, LDV = L::LDV;
  constexpr int STAGES = L::STAGES, NT = D / 8;
  constexpr int RUNS = D * (int)sizeof(T) / 16;      // 16-byte runs a row
  constexpr int E16 = 16 / (int)sizeof(T);           // elements of a run
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  uint8_t* body = smem + L::BODY_OFF;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r8 = lane / 4, c4 = lane % 4;
  const int64_t bh = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int k0 = split * kps, kend = min(sk, k0 + kps);
  const int n_tiles = (kend - k0 + KT - 1) / KT;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  // the warp's tiles: i-th is tile warp + kWarps i of the split, into
  // stage i % STAGES of the warp's ring
  uint8_t* ring = body + warp * L::RING;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                  : 0;
  auto load = [&](int i) {
    const int key0 = k0 + (warp + kWarps * i) * KT;
    uint8_t* st = ring + (i % STAGES) * L::STAGE;
#pragma unroll
    for (int j = 0; j < KT * RUNS / 32; ++j) {
      const int e = lane + 32 * j, r = e / RUNS, c = e % RUNS;
      const bool ok = key0 + r < kend;
      const int64_t off = (int64_t)(ok ? key0 + r : k0) * D + c * E16;
      cp_async16(st + (r * LDK) * sizeof(T) + 16 * c, kb + off, ok);
      cp_async16(st + L::K_BYTES + (r * LDV) * sizeof(T) + 16 * c, vb + off,
                 ok);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }

  // the query rows, zeros past Sq, while the first tiles load
  if constexpr (L::F32) {
    uint32_t* qh = reinterpret_cast<uint32_t*>(smem);
    uint32_t* ql = qh + kRows * LDQ;
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const float x = r < sq ? q[(bh * sq + r) * D + c] : 0.f;
      split_tf32(x, qh[r * LDQ + c], ql[r * LDQ + c]);
    }
  } else {
    T* qs = reinterpret_cast<T*>(smem);
    for (int e = tid; e < kRows * RUNS; e += kThreads) {
      const int r = e / RUNS, c = e % RUNS * E16;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < sq)
        x = *reinterpret_cast<const uint4*>(q + (bh * sq + r) * D + c);
      *reinterpret_cast<uint4*>(qs + r * LDQ + c) = x;
    }
  }
  __syncthreads();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int i = 0; i < mine; ++i) {
    if (i + STAGES - 1 < mine) load(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const T* ks = reinterpret_cast<const T*>(ring + (i % STAGES) * L::STAGE);
    const T* vs = reinterpret_cast<const T*>(
        reinterpret_cast<const uint8_t*>(ks) + L::K_BYTES);
    const int key0 = k0 + (warp + kWarps * i) * KT;
    float sc[KT / 2];                 // KT / 8 m16n8 tiles of scores
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) sc[e] = 0.f;
    float alpha[2];
    if constexpr (L::F32) {
      // S column r8 holds key (r8 >> 1) | (r8 & 1) << 2 of the tile, so
      // that a thread's scores are keys c4 (+ 4)
      const uint32_t* qh = reinterpret_cast<const uint32_t*>(smem);
      const uint32_t* ql = qh + kRows * LDQ;
      const float* kr = ks + ((r8 >> 1) | ((r8 & 1) << 2)) * LDK + c4;
#pragma unroll 8
      for (int kk = 0; kk < D; kk += 8) {
        const int qo = r8 * LDQ + kk + c4;
        const uint32_t ah[4] = {qh[qo], qh[qo + 8 * LDQ], qh[qo + 4],
                                qh[qo + 8 * LDQ + 4]};
        const uint32_t al[4] = {ql[qo], ql[qo + 8 * LDQ], ql[qo + 4],
                                ql[qo + 8 * LDQ + 4]};
        uint32_t bh_[2], bl[2];
        split_tf32(kr[kk], bh_[0], bl[0]);
        split_tf32(kr[kk + 4], bh_[1], bl[1]);
        mma_3xtf32(sc, ah, al, bh_, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + c4 + 4 * (e & 1) >= kend)
          sc[e] = __int_as_float(0xff800000);
      softmax_tile<false, 4>(sc, m, l, alpha, 0, 0, 0, 0, scale_log2);
    } else {
      const T* qs = reinterpret_cast<const T*>(smem);
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        const T* qa = qs + r8 * LDQ + kk + 2 * c4;
        const uint32_t a[4] = {ld2(qa), ld2(qa + 8 * LDQ), ld2(qa + 8),
                               ld2(qa + 8 * LDQ + 8)};
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
          const T* kr = ks + (8 * n + r8) * LDK + kk + 2 * c4;
          mma_16816<T>(*reinterpret_cast<float(*)[4]>(sc + 4 * n), a,
                       ld2(kr), ld2(kr + 8));
        }
      }
      softmax_tile<true, KT / 2>(sc, m, l, alpha, 0, key0 + 2 * c4, kend, 0,
                                 scale_log2);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] = __fmul_rn(o[n][0], alpha[0]);
      o[n][1] = __fmul_rn(o[n][1], alpha[0]);
      o[n][2] = __fmul_rn(o[n][2], alpha[1]);
      o[n][3] = __fmul_rn(o[n][3], alpha[1]);
    }
    if constexpr (L::F32) {
      // A fragment: P[r8][c4], P[r8 + 8][c4], P[r8][c4 + 4], P[r8 + 8][c4 + 4]
      uint32_t ph[4], pl[4];
      split_tf32(sc[0], ph[0], pl[0]);
      split_tf32(sc[2], ph[1], pl[1]);
      split_tf32(sc[1], ph[2], pl[2]);
      split_tf32(sc[3], ph[3], pl[3]);
      const float* vr = vs + c4 * LDV + r8;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh_[2], bl[2];
        split_tf32(vr[8 * n], bh_[0], bl[0]);
        split_tf32(vr[4 * LDV + 8 * n], bh_[1], bl[1]);
        mma_3xtf32(o[n], ph, pl, bh_, bl);
      }
    } else {
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        // keys 16 j .. + 15: the scores of tiles 2 j and 2 j + 1
        uint32_t ph[4], pl[4];
        Elem<T>::split(sc[8 * j], sc[8 * j + 1], ph[0], pl[0]);
        Elem<T>::split(sc[8 * j + 2], sc[8 * j + 3], ph[1], pl[1]);
        Elem<T>::split(sc[8 * j + 4], sc[8 * j + 5], ph[2], pl[2]);
        Elem<T>::split(sc[8 * j + 6], sc[8 * j + 7], ph[3], pl[3]);
        const T* vr = vs + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV
                      + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vr + 16 * np);
          mma_16816<T>(o[2 * np], pl, b[0], b[1]);
          mma_16816<T>(o[2 * np], ph, b[0], b[1]);
          mma_16816<T>(o[2 * np + 1], pl, b[2], b[3]);
          mma_16816<T>(o[2 * np + 1], ph, b[2], b[3]);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }
  __syncthreads();                    // every ring is done with

  // the warps' (acc, m, l), merged in warp order
  float* macc = reinterpret_cast<float*>(body);       // kWarps x kRows x D
  float* mm = macc + kWarps * kRows * D;              // kWarps x kRows
  float* ml = mm + kWarps * kRows;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* p0 = macc + (warp * kRows + r8) * D + 8 * n + 2 * c4;
    *reinterpret_cast<float2*>(p0) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(p0 + 8 * D) = make_float2(o[n][2], o[n][3]);
  }
  if (c4 == 0) {
    mm[warp * kRows + r8] = m[0];
    mm[warp * kRows + r8 + 8] = m[1];
    ml[warp * kRows + r8] = l[0];
    ml[warp * kRows + r8 + 8] = l[1];
  }
  __syncthreads();
  float* prow = splits == 1 ? nullptr
                            : part + (bh * splits + split) * sq * (D + 2);
  for (int e = tid; e < sq * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float mb = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, mm[w * kRows + r]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(__fsub_rn(mm[w * kRows + r], mb));
      lb = __fadd_rn(lb, __fmul_rn(ml[w * kRows + r], f));
      ab = __fadd_rn(ab, __fmul_rn(macc[(w * kRows + r) * D + c], f));
    }
    if (splits == 1) {
      out[(bh * sq + r) * D + c] =
          to_out(__fdiv_rn(ab, fmaxf(lb, 1e-30f)), out);
    } else {
      prow[r * (D + 2) + c] = ab;
      if (c == 0) {
        prow[r * (D + 2) + D] = mb;
        prow[r * (D + 2) + D + 1] = lb;
      }
    }
  }
  if (splits == 1) return;

  // the last block of the (bh) to arrive merges every split
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counter + bh, 1) == splits - 1;
    if (last) counter[bh] = 0;        // every other block has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = part + bh * splits * sq * (D + 2);
  const int stride = sq * (D + 2);                    // a split's
  float* fac = reinterpret_cast<float*>(body);        // kRows x splits
  float* ls = fac + kRows * kMaxSplits;               // kRows x splits
  float* lt = ls + kRows * kMaxSplits;                // kRows
  // every split's (m, l) of every row at once into shared memory
  for (int e = tid; e < sq * splits; e += kThreads) {
    const int r = e / splits, s = e % splits;
    const float2 x = __ldcg(reinterpret_cast<const float2*>(
        p0 + s * stride + r * (D + 2) + D));
    fac[r * kMaxSplits + s] = x.x;
    ls[r * kMaxSplits + s] = x.y;
  }
  __syncthreads();
  // a warp a row: the max, the factors exp2(m_s - m), the sum in order
  for (int r = warp; r < sq; r += kWarps) {
    float* fr = fac + r * kMaxSplits;
    float mt = kNeg;
    for (int s = lane; s < splits; s += 32) mt = fmaxf(mt, fr[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    for (int s = lane; s < splits; s += 32)
      fr[s] = exp2f(__fsub_rn(fr[s], mt));
    __syncwarp();
    if (lane == 0) {
      float sum = 0.f;
      for (int s = 0; s < splits; ++s)
        sum = __fadd_rn(sum, __fmul_rn(ls[r * kMaxSplits + s], fr[s]));
      lt[r] = sum;
    }
  }
  __syncthreads();
  // every split's accumulator in split order; a thread's elements are tid +
  // kThreads j, and SU splits of them are loaded at once (up to 32 loads in
  // flight), so the merge waits on few round trips to L2
  constexpr int EP = kRows * D / kThreads;            // elements a thread
  constexpr int SU = EP >= 32 ? 1 : 32 / EP > 8 ? 8 : 32 / EP;
  float a[EP];
#pragma unroll
  for (int j = 0; j < EP; ++j) a[j] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += SU) {
    float t[SU][EP];
#pragma unroll
    for (int u = 0; u < SU; ++u)
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        const int e = tid + kThreads * j;
        t[u][j] = s0 + u < splits && e < sq * D
                      ? __ldcg(p0 + (s0 + u) * stride + e / D * (D + 2)
                               + e % D)
                      : 0.f;
      }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      if (s0 + u >= splits) break;
#pragma unroll
      for (int j = 0; j < EP; ++j)
        a[j] = __fadd_rn(a[j], __fmul_rn(
            t[u][j], fac[(tid + kThreads * j) / D * kMaxSplits + s0 + u]));
    }
  }
#pragma unroll
  for (int j = 0; j < EP; ++j) {
    const int e = tid + kThreads * j, r = e / D;
    if (e < sq * D)
      out[(bh * sq + r) * D + e % D] =
          to_out(__fdiv_rn(a[j], fmaxf(lt[r], 1e-30f)), out);
  }
}

template <typename T, int D>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_split_kernel<T, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Split<T, D>::BYTES);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, int* counter, int bh, int sq, int sk, int splits,
           int kps, float scale_log2, cudaStream_t stream) {
  using L = Split<T, D>;
  const int64_t blocks = (int64_t)bh * splits;
  if (blocks > INT_MAX || (splits > 1 && (part == nullptr ||
                                          counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = L::BYTES;
  cudaError_t e = prepare<T, D>();
  if (e != cudaSuccess) return (int)e;
  flash_split_kernel<T, D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part, counter, sq, sk,
      splits, kps, scale_log2);
  return (int)cudaGetLastError();
}

// blocks of the instance that fit on one SM, the most splits it takes and
// the keys of one tile for each warp
template <typename T, int D>
int limits(int* blocks, int* max_splits, int* key_align) {
  *max_splits = kMaxSplits;
  *key_align = kWarps * Split<T, D>::KT;
  cudaError_t e = prepare<T, D>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_split_kernel<T, D>, kThreads, Split<T, D>::BYTES);
  return (int)e;
}

// F(T, D) for the built head dims: bf16 and f16 at D 16, 32, 64, 128, 192,
// 256; f32 at 64 to 256
template <typename T, typename F>
int with_head_dim(int d, F&& f) {
  if constexpr (!std::is_same<T, float>::value) {
    if (d == 16) return f(std::integral_constant<int, 16>());
    if (d == 32) return f(std::integral_constant<int, 32>());
  }
  if (d == 64) return f(std::integral_constant<int, 64>());
  if (d == 128) return f(std::integral_constant<int, 128>());
  if (d == 192) return f(std::integral_constant<int, 192>());
  if (d == 256) return f(std::integral_constant<int, 256>());
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             void* part, void* counter, int bh, int sq, int sk, int d,
             int splits, int kps, float scale_log2, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0 || sq > kRows || sk <= 0 || splits < 1 ||
      splits > kMaxSplits || kps < 1 || (int64_t)kps * (splits - 1) >= sk ||
      (int64_t)kps * splits < sk)
    return (int)cudaErrorInvalidValue;
  return with_head_dim<T>(d, [&](auto dd) {
    return launch<T, decltype(dd)::value>(
        q, k, v, out, static_cast<float*>(part), static_cast<int*>(counter),
        bh, sq, sk, splits, kps, scale_log2, (cudaStream_t)stream);
  });
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); out: (bh, sq, d), all contiguous, of
// one type, on 16-byte boundaries; 1 <= sq <= 16, not causal; d one of the
// built head dims; splits in [1, 64] with kps keys each (the last split
// ends at sk: kps (splits - 1) < sk <= kps splits); with splits > 1, part
// (bh x splits x sq x (d + 2) f32) and counter (bh int32, zeros, left
// zeros); scale_log2 = f32(1/sqrt(D)) * log2(e), D the head dim before any
// padding.  Each returns the CUDA error code of the launch (0 = launched);
// any stale error is cleared first so that the code reports this launch
// alone.
extern "C" int flash_attention_split_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    void* counter, int bh, int sq, int sk, int d, int splits, int kps,
    float scale_log2, void* stream) {
  return dispatch<float>(q, k, v, out, part, counter, bh, sq, sk, d, splits,
                         kps, scale_log2, stream);
}

extern "C" int flash_attention_split_bf16_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    void* counter, int bh, int sq, int sk, int d, int splits, int kps,
    float scale_log2, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, part, counter, bh, sq, sk, d,
                                 splits, kps, scale_log2, stream);
}

extern "C" int flash_attention_split_f16_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    void* counter, int bh, int sq, int sk, int d, int splits, int kps,
    float scale_log2, void* stream) {
  return dispatch<__half>(q, k, v, out, part, counter, bh, sq, sk, d, splits,
                          kps, scale_log2, stream);
}

// The limits of the split plan for the instance of dtype (0 f32, 1 bf16, 2
// f16) and head dim d: into *blocks the blocks that fit on one SM of the
// current device, into *max_splits the most splits a launch takes, into
// *key_align the keys of one tile for each warp (a split's keys are best a
// multiple of it); returns the CUDA error code
extern "C" int flash_attention_split_limits(int dtype, int d, int* blocks,
                                            int* max_splits, int* key_align) {
  cudaGetLastError();
  if (dtype == 0)
    return with_head_dim<float>(d, [&](auto dd) {
      return limits<float, decltype(dd)::value>(blocks, max_splits, key_align);
    });
  if (dtype == 1)
    return with_head_dim<__nv_bfloat16>(d, [&](auto dd) {
      return limits<__nv_bfloat16, decltype(dd)::value>(blocks, max_splits,
                                                         key_align);
    });
  if (dtype == 2)
    return with_head_dim<__half>(d, [&](auto dd) {
      return limits<__half, decltype(dd)::value>(blocks, max_splits,
                                                 key_align);
    });
  return (int)cudaErrorInvalidValue;
}
