// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm/kernel.py rmsnorm_fused (the Pallas TPU
// kernel): out = (x * rsqrt(mean(x^2) + eps) * w) cast back to x's dtype,
// with the mean square, the rsqrt and the product in f32 and the weight f32.
//
// What bounds it: one multiply-add a byte or less, far below the card's 295
// bf16 flops a byte, so it is bound by the bytes it moves. The design reads
// each element of x once and writes it once: one block a row copies the
// row into shared memory as f32 while it sums the squares (warp shuffles,
// then one value a warp), and scales from shared memory. The TPU kernel's
// rows % block_rows contract is gone: the grid is one block a row, so any
// row count works. The rsqrt is 1 / sqrtf (IEEE rounded), not the
// approximate rsqrtf. The C entry point returns cudaGetLastError() after the
// launch; the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* x, const float* w, T* out, int d, float eps) {
  extern __shared__ float row[];             // d floats
  __shared__ float part[kThreads / 32];
  const long base = long(blockIdx.x) * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float ss = 0.f;
  for (int i = tid; i < d; i += kThreads) {
    const float v = load_f(x, base + i);
    row[i] = v;
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = 1.0f / sqrtf(part[0] / float(d) + eps);
  for (int i = tid; i < d; i += kThreads) store_f(out, base + i, row[i] * r * w[i]);
}

template <typename T>
int launch(const void* x, const float* w, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(d);
  auto kern = rmsnorm_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kern<<<rows, kThreads, smem, stream>>>(static_cast<const T*>(x), w,
                                         static_cast<T*>(out), d, eps);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (rows, d) f32/bf16 contiguous; w (d,) f32; out like x.
int rmsnorm_fwd(const void* x, int dtype, const float* w, void* out, int rows,
                int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, w, out, rows, d, eps, s);
    case kBF16: return launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
