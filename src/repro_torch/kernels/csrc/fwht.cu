// Normalized fast Walsh-Hadamard transform over rows, for Hopper (sm_90a).
//
// Replaces: repro/kernels/fwht.py, fwht_pallas -> _fwht_2d (_fwht_kernel).
// The TPU kernel multiplies each row by H_a (x) H_b on the matrix unit; on
// this card the transform is the textbook in-place butterfly: log2(d)
// stages of (a, b) -> (a + b, a - b) at stride h = 1, 2, 4, ..., then a
// scale by float32(1/sqrt(d)).  This is the stage order of the plain
// version (fwht_torch / fwht_jnp), so in f32 the kernel and the plain
// version agree bit for bit; against the TPU kernel's matmul sums they
// agree to rounding.
//
// Input and output are f32, or bf16 with f32 inside (rounded to nearest
// even on the way out).  d is a power of two in [4, 16384], the reference
// kernel's range.
//
// Bound on this card: memory.  Each row is read once and written once
// (8 B per f32 coordinate); the log2(d) adds per coordinate run from
// shared memory and are far below the compute roof.
//
// Design: one block per row.  The row is loaded into dynamic shared memory
// with coalesced reads, each stage maps thread p to the butterfly pair
// (j, j + h) with j = (p / h) * 2h + p % h, stages are separated by
// __syncthreads(), and the scaled row is stored with coalesced writes.
// A row of 16384 f32 (64 KB) is above the default 48 KB of dynamic shared
// memory and needs the opt-in attribute, which the launcher sets.  No allocation; the launch goes on the caller's
// stream.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void fwht_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int log2d, float scale) {
  extern __shared__ float row[];
  const int d = 1 << log2d;
  const int64_t base = (int64_t)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) row[i] = to_f32(x[base + i]);
  __syncthreads();
  const int pairs = d >> 1;
  for (int lh = 0; lh < log2d; ++lh) {
    const int h = 1 << lh;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int j = ((p >> lh) << (lh + 1)) | (p & (h - 1));
      const float a = row[j], b = row[j + h];
      row[j] = __fadd_rn(a, b);
      row[j + h] = __fsub_rn(a, b);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    out[base + i] = from_f32<T>(__fmul_rn(row[i], scale));
}

template <typename T>
int launch(const void* x, void* out, int64_t rows, int log2d, float scale,
           cudaStream_t stream) {
  const int d = 1 << log2d;
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fwht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = d / 2;
  if (threads > 512) threads = 512;
  if (threads < 32) threads = 32;
  fwht_kernel<T><<<(unsigned)rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), log2d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns the CUDA error code of the launch
// (0 = launched).  Any stale error is cleared first so that the code
// reports this launch alone.
extern "C" int fwht_launch(const void* x, void* out, int64_t rows, int log2d,
                           float scale, int dtype, void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  if (log2d < 2 || log2d > 14) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, out, rows, log2d, scale, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, rows, log2d, scale, st);
  return (int)cudaErrorInvalidValue;
}
