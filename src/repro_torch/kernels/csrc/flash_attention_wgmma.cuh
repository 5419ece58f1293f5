// Pieces shared by the flash-attention kernels on Hopper (sm_90a): the
// wgmma kernels flash_attention_wgmma.cu (head dims up to 256),
// flash_attention_wgmma_wide.cu (384 and 512) and flash_attention.cu (f32
// in TF32, up to 64) take all of it, the mma.sync kernel
// flash_attention_wide.cu the mbarriers, the TMA loads, the TF32 split and
// products and the driver's tensor-map encoder, the split kernel
// flash_attention_split.cu the TF32 split and products, the input type's
// conversions and the online-softmax step.  mbarriers, TMA loads and the tensor maps
// they read, wgmma shared-memory descriptors (rows of 32, 64 or 128 bytes,
// each with the swizzle of its width), the wgmma instructions in bf16 and
// f16, the input type's conversions (Elem<T>) and the online-softmax step
// on S fragments.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

template <typename T>
constexpr bool kF16 = std::is_same<T, __half>::value;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 3-d tensor map (column, row, bh) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
         "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of rows of RB bytes (128, 64 or 32) with
// the swizzle of that width (layout type 1, 2 or 3): start address,
// leading and stride byte offsets (all in 16-byte units)
template <int RB>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  static_assert(RB == 128 || RB == 64 || RB == 32, "rows of 32 to 128 bytes");
  constexpr uint64_t layout = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}
// K-major (the reduction dim contiguous): 8-row groups 8 RB bytes apart;
// the leading offset is not used with these swizzles
template <int RB = 128>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc<RB>(addr, 16, 8 * RB);
}
// MN-major B of a key tile: 8-key groups 8 RB bytes apart, blocks of RB
// bytes of columns one tile's block (its keys x RB bytes) apart
template <int RB = 128>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t block_bytes) {
  return smem_desc<RB>(addr, block_bytes, 8 * RB);
}

// named barrier `id` (1 to 15) of `count` threads: wait there, or arrive
// without waiting
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accesses of wgmma registers across the
// fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the accumulator operands d[i] .. d[i + 7] / d[i] .. d[i + 31] of an asm
#define FA_D8(d, i) "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define FA_D32(d, i) FA_D8(d, i), FA_D8(d, (i) + 8), FA_D8(d, (i) + 16), FA_D8(d, (i) + 24)
#define FA_A4(a) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// the wgmma instructions, TY the input type ("bf16" or "f16")
#define FA_SS_N64(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
#define FA_SS_N32(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
#define FA_RS_N16(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7" \
  "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
#define FA_RS_N32(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
#define FA_RS_N64(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define FA_RS_N128(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define FA_RS_N192(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
  "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
#define FA_RS_N256(TY) "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"

// TF32 (f32 in, the low 13 mantissa bits zero): D (64 x 64, f32) += A (64 x
// 8) . B (8 x 64, shared, K-major), A from shared memory (K-major) or from
// registers; tf32 takes no transpose, so both operands are K-major
#define FA_TF32_SS_N64 "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1;\n}\n"
#define FA_TF32_RS_N64 "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(FA_TF32_SS_N64 : FA_D32(d, 0)
               : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t* a,
                                                  uint64_t b) {
  asm volatile(FA_TF32_RS_N64 : FA_D32(d, 0) : FA_A4(a), "l"(b), "r"(1));
}

// The wgmma products, T the input type (__nv_bfloat16 or __half).
// S (64 x 64, f32) = A (64 x 16, shared) . B (16 x 64, shared), both K-major
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kF16<T>)
    asm volatile(FA_SS_N64("f16") : FA_D32(d, 0)
                 : "l"(a), "l"(b), "r"(accumulate));
  else
    asm volatile(FA_SS_N64("bf16") : FA_D32(d, 0)
                 : "l"(a), "l"(b), "r"(accumulate));
}

// S (64 x 32, f32) = A (64 x 16, shared) . B (16 x 32, shared), both K-major
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kF16<T>)
    asm volatile(FA_SS_N32("f16") : FA_D8(d, 0), FA_D8(d, 8)
                 : "l"(a), "l"(b), "r"(accumulate));
  else
    asm volatile(FA_SS_N32("bf16") : FA_D8(d, 0), FA_D8(d, 8)
                 : "l"(a), "l"(b), "r"(accumulate));
}

// O (64 x D, f32) += A (64 x 16, registers) . B (16 x D, shared, MN-major)
template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t* a,
                                         uint64_t b) {
  if constexpr (D == 16) {
    if constexpr (kF16<T>)
      asm volatile(FA_RS_N16("f16") : FA_D8(d, 0)
                   : FA_A4(a), "l"(b), "r"(1));
    else
      asm volatile(FA_RS_N16("bf16") : FA_D8(d, 0)
                   : FA_A4(a), "l"(b), "r"(1));
  } else if constexpr (D == 32) {
    if constexpr (kF16<T>)
      asm volatile(FA_RS_N32("f16") : FA_D8(d, 0), FA_D8(d, 8)
                   : FA_A4(a), "l"(b), "r"(1));
    else
      asm volatile(FA_RS_N32("bf16") : FA_D8(d, 0), FA_D8(d, 8)
                   : FA_A4(a), "l"(b), "r"(1));
  } else if constexpr (D == 64) {
    if constexpr (kF16<T>)
      asm volatile(FA_RS_N64("f16") : FA_D32(d, 0)
                   : FA_A4(a), "l"(b), "r"(1));
    else
      asm volatile(FA_RS_N64("bf16") : FA_D32(d, 0)
                   : FA_A4(a), "l"(b), "r"(1));
  } else if constexpr (D == 128) {
    if constexpr (kF16<T>)
      asm volatile(FA_RS_N128("f16") : FA_D32(d, 0), FA_D32(d, 32)
                   : FA_A4(a), "l"(b), "r"(1));
    else
      asm volatile(FA_RS_N128("bf16") : FA_D32(d, 0), FA_D32(d, 32)
                   : FA_A4(a), "l"(b), "r"(1));
  } else if constexpr (D == 192) {
    if constexpr (kF16<T>)
      asm volatile(FA_RS_N192("f16")
                   : FA_D32(d, 0), FA_D32(d, 32), FA_D32(d, 64)
                   : FA_A4(a), "l"(b), "r"(1));
    else
      asm volatile(FA_RS_N192("bf16")
                   : FA_D32(d, 0), FA_D32(d, 32), FA_D32(d, 64)
                   : FA_A4(a), "l"(b), "r"(1));
  } else {
    static_assert(D == 256, "head dims 16, 32, 64, 128, 192 and 256 are "
                  "built");
    if constexpr (kF16<T>)
      asm volatile(FA_RS_N256("f16")
                   : FA_D32(d, 0), FA_D32(d, 32), FA_D32(d, 64), FA_D32(d, 96)
                   : FA_A4(a), "l"(b), "r"(1));
    else
      asm volatile(FA_RS_N256("bf16")
                   : FA_D32(d, 0), FA_D32(d, 32), FA_D32(d, 64), FA_D32(d, 96)
                   : FA_A4(a), "l"(b), "r"(1));
  }
}

// The input type's conversions: pairs packed as one 32-bit register, and
// (p0, p1) split into pairs hi = T(p) and lo = T(p - hi)
template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // a bf16 is the top half of the f32 of the same value, so hi's two
  // values come back as f32 by a shift and a mask
  static __device__ __forceinline__ void split(float p0, float p1,
                                               uint32_t& hi, uint32_t& lo) {
    hi = pack(p0, p1);
    lo = pack(__fsub_rn(p0, __uint_as_float(hi << 16)),
              __fsub_rn(p1, __uint_as_float(hi & 0xffff0000u)));
  }
};
template <> struct Elem<__half> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void split(float p0, float p1,
                                               uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(p0, p1);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack(__fsub_rn(p0, __low2float(h)), __fsub_rn(p1, __high2float(h)));
  }
};

// x = hi + lo + (an error below 2^-22 |x|): hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in f32), both rounded to nearest, ties away from zero
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in three tf32 products, the small terms first: a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi (a_lo.b_lo, below 2^-22 of the product, is left
// out)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// exp2(x) on the special-function unit alone (one MUFU.EX2; exp2f adds a
// range test and two multiplies for results below 2^-126): relative error
// about 2^-22, results below 2^-126 flushed to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one key tile on a thread's N S fragments
// (rows r0, r0 + 8; keys key0 + 8 j + {0, 1}, j < N / 4; N = 64 for a
// 128-key tile, 32 for a 64-key one, 16 for a 32-key one): p = exp2(s *
// scale_log2 -
// m) into sc, the running max m (log2 domain) and this thread's part of
// the row sums l updated, and alpha = exp2(m_old - m) for O.  The max is
// taken over the raw scores, which scale_log2 > 0 leaves in order.  MASK:
// keys past Sk or, where causal, past a row's position get p = 0.  FTZ:
// the exponentials by exp2_ftz (the p and alpha below 2^-126 that it
// flushes are below 2^-126 of a row sum of at least 1).
template <bool MASK, int N, bool FTZ = false>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int r0, int key0, int sk,
                                             int causal, float scale_log2) {
  const float ninf = __int_as_float(0xff800000);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int key = key0 + 8 * j + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        if (!(key < sk && (!causal || key <= row))) sc[4 * j + e] = ninf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  float rs[2] = {0.f, 0.f}, neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], __fmul_rn(mx[r], scale_log2));
    const float dm = __fsub_rn(m[r], m_new);
    alpha[r] = FTZ ? exp2_ftz(dm) : exp2f(dm);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __fmaf_rn(sc[4 * j + e], scale_log2, neg_m[e >> 1]);
      const float p = FTZ ? exp2_ftz(x) : exp2f(x);
      sc[4 * j + e] = p;
      rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), rs[r]);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (so the library links against the runtime alone)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (bh, s, d) tensor of T as a 3-d map with boxes of `rows` rows and
// min(d, 64) columns (d 16, 32 or a multiple of 64), each row of the box
// (32, 64 or 128 bytes) with the swizzle of its width, zeros past the
// edges
template <typename T>
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* p, int bh,
                  int s, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const int cols = d < 64 ? d : 64;
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, Elem<T>::MAP, 3, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
