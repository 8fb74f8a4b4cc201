// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm/kernel.py rmsnorm_fused (the Pallas TPU
// kernel): out = (x * rsqrt(mean(x^2) + eps) * w) cast back to x's dtype,
// with the mean square, the rsqrt and the product in f32 and the weight f32.
// The rsqrt is 1 / sqrtf (IEEE rounded), not the approximate rsqrtf.
//
// What bounds it: one multiply-add a byte or less, far below the card's 295
// bf16 flops a byte, so its floor is the bytes it moves (each element of x
// read once and written once). Most calls on the serve paths are decode's:
// 1-8 rows of 2048 or 4096, a few hundred KB, where the floor is tens of
// nanoseconds and what a call costs is memory latency: a block a row, and
// each round of loads that waits on the last adds one. Two kernels, one
// block a row each (any row count; the TPU kernel's rows % block_rows
// contract is gone), chosen by the wrapper by D:
//
// - rmsnorm_reg_kernel, D up to 1024 16-byte vectors (8192 bf16, 4096
//   f32): the block is sized to D (D/8 threads for bf16, D/4 for f32,
//   rounded up to a warp) and each thread issues its one 16-byte load of x
//   and its loads of w at once, before the reduction, so a row waits out
//   one memory latency; the row stays in registers through one warp-shuffle
//   and one shared-memory exchange (every warp sums the warps' partials
//   itself: one barrier), then one 16-byte store a thread. A ragged D (not
//   a multiple of the vector, or a misaligned row) takes the same kernel
//   with scalar loads and stores, still all issued before the reduction.
// - rmsnorm_smem_kernel, larger D (to 32768): 256 threads a row copy the
//   row into shared memory as f32 while they sum the squares, and scale
//   from shared memory.
//
// On an H100 (700 W, chip_smoke.py) the register kernel takes 0.0027 ms
// at 8 x 4096 bf16 (F.rms_norm 0.0052) and 0.0060 ms at 2048 x 2048, where
// the shared-memory kernel takes 0.0080, so D alone picks the kernel.
//
// Backward (the port's own kernel: the JAX package differentiates its jnp
// rmsnorm with XLA and has no backward kernel). With r = rsqrt(mean(x^2) +
// eps), out = x r w gives
//
//   dx = r (g w) - x r^3 mean((g w) x),    dw = sum over rows of g x r.
//
// Like the forward it moves a few bytes an operation, so bytes bound it: x
// and g read once, dx written once, and the dw partials. r is recomputed
// from x, so the forward kernels stay as they are. Two kernels, chosen by D
// as the forward's are (the wrapper's rmsnorm_path), then a second launch
// that sums the blocks' dw partials:
//
// - rmsnorm_bwd_reg_kernel, D up to 1024 16-byte vectors (8192 bf16, 4096
//   f32): the block is sized to D (a small fixed group of warps a row, one
//   16-byte vector of x, g and w a thread) and walks rows blockIdx.x,
//   blockIdx.x + gridDim.x, ...; the row's x and g stay in registers from
//   the two row sums through the dx write, the next row's loads are issued
//   before this row's reduction (so a row waits out no memory latency of
//   its own), w is loaded once, and each thread keeps its columns' dw
//   partial in registers across its rows. The two sums cross the warps in
//   one shared-memory exchange, double-buffered by row parity: one barrier
//   a row. A ragged D (not a multiple of the vector, or a misaligned row)
//   takes the same kernel with scalar loads and stores.
// - rmsnorm_bwd_kernel, larger D: 256 threads a row, one pass over x and g
//   for the two row sums, a second for dx, which also adds g x r into the
//   block's f32 dw partial in shared memory.
//
// rmsnorm_dw_reduce_kernel sums the blocks' partials of a column: 32
// slices of the partials a 32-column block, each in block order, then the
// slices in order. Every sum runs in a fixed order, so the gradients are
// the same bits on every run.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // the shared-memory kernel
constexpr int kMaxThreads = 1024;       // the register kernel

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

// 16 bytes of T as E floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
  }
  __device__ static void load(const float* p, float (&v)[4]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& q, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One row a block, E elements a thread in registers: one 16-byte vector
// (VEC) or E scalars (a ragged or misaligned row).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int d, float eps) {
  constexpr int E = Vec<T>::E;
  __shared__ float part[kMaxThreads / 32];
  const long base = long(blockIdx.x) * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = tid * E;
  float v[E], wv[E];
  if (VEC) {
    if (e0 < d) {
      Vec<T>::load(x + base + e0, v);
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 q = *reinterpret_cast<const float4*>(w + e0 + e);
        wv[e] = q.x; wv[e + 1] = q.y; wv[e + 2] = q.z; wv[e + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = wv[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = e0 + e < d;
      v[e] = in ? load_f(x, base + e0 + e) : 0.f;
      wv[e] = in ? w[e0 + e] : 0.f;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) ss = fmaf(v[e], v[e], ss);
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  const float tot = warp_sum(lane < int(blockDim.x >> 5) ? part[lane] : 0.f);
  const float r = 1.0f / sqrtf(tot / float(d) + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = v[e] * r * wv[e];
  if (VEC) {
    if (e0 < d) Vec<T>::store(out + base + e0, v);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e0 + e < d) store_f(out, base + e0 + e, v[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_smem_kernel(const T* x, const float* w, T* out, int d, float eps) {
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
int launch_reg(const void* x, const float* w, void* out, int rows, int d,
               float eps, cudaStream_t stream) {
  constexpr int E = Vec<T>::E;
  const int nvec = (d + E - 1) / E;
  if (nvec > kMaxThreads) return int(cudaErrorInvalidValue);
  const int threads = (nvec + 31) / 32 * 32;
  const bool vec = d % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kern = vec ? rmsnorm_reg_kernel<T, true> : rmsnorm_reg_kernel<T, false>;
  kern<<<rows, threads, 0, stream>>>(static_cast<const T*>(x), w,
                                     static_cast<T*>(out), d, eps);
  return int(cudaGetLastError());
}

template <typename T>
int launch_smem(const void* x, const float* w, void* out, int rows, int d,
                float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(d);
  auto kern = rmsnorm_smem_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kern<<<rows, kThreads, smem, stream>>>(static_cast<const T*>(x), w,
                                         static_cast<T*>(out), d, eps);
  return int(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int d, float eps) {
  extern __shared__ float acc[];             // d floats: this block's dw
  __shared__ float red[2][kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < d; i += kThreads) acc[i] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const long base = long(row) * d;
    float ss = 0.f, sgx = 0.f;
    for (int i = tid; i < d; i += kThreads) {
      const float xv = load_f(x, base + i);
      ss = fmaf(xv, xv, ss);
      sgx = fmaf(load_f(g, base + i) * w[i], xv, sgx);
    }
    ss = warp_sum(ss);
    sgx = warp_sum(sgx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sgx;
    }
    __syncthreads();
    float tss = 0.f, tsg = 0.f;              // every thread, in warp order
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      tss += red[0][i];
      tsg += red[1][i];
    }
    __syncthreads();                         // red is reused by the next row
    const float r = 1.0f / sqrtf(tss / float(d) + eps);
    const float c = r * r * r * (tsg / float(d));
    for (int i = tid; i < d; i += kThreads) {
      const float xv = load_f(x, base + i), gv = load_f(g, base + i);
      store_f(dx, base + i, r * (gv * w[i]) - xv * c);
      acc[i] = fmaf(gv * xv, r, acc[i]);
    }
  }
  for (int i = tid; i < d; i += kThreads) part[long(blockIdx.x) * d + i] = acc[i];
}

// A thread's E elements of a row as their 16 raw bytes: one 16-byte load
// (VEC) or E scalar loads (a ragged or misaligned row); zeros past d.
// Held raw while in flight, they take half the registers of floats (bf16).
__device__ __forceinline__ uint32_t raw_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t raw_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ p, long base,
                                          int e0, int d) {
  if (VEC)
    return e0 < d ? *reinterpret_cast<const uint4*>(p + base + e0)
                  : make_uint4(0u, 0u, 0u, 0u);
  constexpr int PER = 4 / sizeof(T);        // elements a 32-bit word
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < Vec<T>::E; ++e)
    if (e0 + e < d) w[e / PER] |= raw_bits(p[base + e0 + e]) << (32 / PER * (e % PER));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int d, float eps) {
  constexpr int E = Vec<T>::E;
  __shared__ float2 red[2][kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int e0 = tid * E;
  float wv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    wv[e] = e0 + e < d ? w[e0 + e] : 0.f;
    acc[e] = 0.f;
  }
  int row = blockIdx.x;
  uint4 xr = load_raw<T, VEC>(x, long(row) * d, e0, d);
  uint4 gr = load_raw<T, VEC>(g, long(row) * d, e0, d);
  for (int n = 0; row < rows; ++n, row += gridDim.x) {
    float xv[E], gv[E];
    Vec<T>::unpack(xr, xv);
    Vec<T>::unpack(gr, gv);
    const int next = row + gridDim.x;         // the next row, in flight
    if (next < rows) {
      xr = load_raw<T, VEC>(x, long(next) * d, e0, d);
      gr = load_raw<T, VEC>(g, long(next) * d, e0, d);
    }
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ss = fmaf(xv[e], xv[e], ss);
      sgx = fmaf(gv[e] * wv[e], xv[e], sgx);
    }
    ss = warp_sum(ss);
    sgx = warp_sum(sgx);
    if (lane == 0) red[n & 1][warp] = make_float2(ss, sgx);
    __syncthreads();
    const float2 pr = lane < nwarps ? red[n & 1][lane] : make_float2(0.f, 0.f);
    const float tss = warp_sum(pr.x), tsg = warp_sum(pr.y);
    const float r = 1.0f / sqrtf(tss / float(d) + eps);
    const float c = r * r * r * (tsg / float(d));
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[e] = fmaf(gv[e] * xv[e], r, acc[e]);
      xv[e] = r * (gv[e] * wv[e]) - xv[e] * c;   // dx
    }
    const long base = long(row) * d;
    if (VEC) {
      if (e0 < d) Vec<T>::store(dx + base + e0, xv);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e0 + e < d) store_f(dx, base + e0 + e, xv[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e0 + e < d) part[long(blockIdx.x) * d + e0 + e] = acc[e];
}

// dw[i] = the sum of the partials' column i: a block of 32 columns x 32
// slices, slice s summing partials s, s + 32, ... in order, then the
// slices summed in order.
__global__ void __launch_bounds__(1024)
rmsnorm_dw_reduce_kernel(const float* __restrict__ part, int nparts, int d,
                         float* __restrict__ dw) {
  __shared__ float sl[32][33];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31), s = threadIdx.x >> 5;
  float acc = 0.f;
  if (col < d)
    for (int p = s; p < nparts; p += 32) acc += part[long(p) * d + col];
  sl[s][threadIdx.x & 31] = acc;
  __syncthreads();
  if (s == 0 && col < d) {
    float t = 0.f;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) t += sl[i][threadIdx.x];
    dw[col] = t;
  }
}

int launch_reduce(const float* part, int nparts, int d, float* dw,
                  cudaStream_t stream) {
  rmsnorm_dw_reduce_kernel<<<(d + 31) / 32, 1024, 0, stream>>>(part, nparts, d, dw);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd_reg(const void* x, const float* w, const void* g, void* dx,
                   float* part, int nparts, float* dw, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int E = Vec<T>::E;
  const int nvec = (d + E - 1) / E;
  if (nvec > kMaxThreads) return int(cudaErrorInvalidValue);
  const int threads = (nvec + 31) / 32 * 32;
  const bool vec = d % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  auto kern = vec ? rmsnorm_bwd_reg_kernel<T, true> : rmsnorm_bwd_reg_kernel<T, false>;
  // Persistent blocks, no more than are resident at once: a block waiting
  // for a slot would start its rows only after a resident one ends.
  int occ = 0, dev = 0, sms = 0;
  cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, 0);
  if (ce == cudaSuccess) ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return int(ce);
  nparts = min(nparts, max(occ, 1) * sms);
  kern<<<nparts, threads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(g), static_cast<T*>(dx),
      part, rows, d, eps);
  int e = int(cudaGetLastError());
  if (e) return e;
  return launch_reduce(part, nparts, d, dw, stream);
}

template <typename T>
int launch_bwd(const void* x, const float* w, const void* g, void* dx,
               float* part, int nparts, float* dw, int rows, int d, float eps,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * size_t(d);
  auto kern = rmsnorm_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kern<<<nparts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(g), static_cast<T*>(dx),
      part, rows, d, eps);
  int e = int(cudaGetLastError());
  if (e) return e;
  return launch_reduce(part, nparts, d, dw, stream);
}

}  // namespace

extern "C" {

// x (rows, d) f32/bf16 contiguous; w (d,) f32; out like x. The register
// kernel: d <= 1024 vectors of 16 bytes (8192 bf16, 4096 f32).
int rmsnorm_reg_fwd(const void* x, int dtype, const float* w, void* out,
                    int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_reg<float>(x, w, out, rows, d, eps, s);
    case kBF16: return launch_reg<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  }
  return int(cudaErrorInvalidValue);
}

// The same arguments; the shared-memory kernel, any d whose f32 row fits
// in shared memory.
int rmsnorm_smem_fwd(const void* x, int dtype, const float* w, void* out,
                     int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_smem<float>(x, w, out, rows, d, eps, s);
    case kBF16: return launch_smem<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  }
  return int(cudaErrorInvalidValue);
}

// Backward. x and g (rows, d) f32/bf16 contiguous, w (d,) f32; dx like x;
// part (nparts, d) f32 scratch, 1 <= nparts <= rows blocks (the register
// kernel may use fewer: no more than are resident); dw (d,) f32.
// rmsnorm_bwd_reg: d <= 1024 vectors of 16 bytes, as rmsnorm_reg_fwd;
// rmsnorm_bwd_smem: any d whose f32 row fits in shared memory.
#define RMSNORM_BWD_ENTRY(NAME, LAUNCH)                                          \
  int NAME(const void* x, int dtype, const float* w, const void* g, void* dx,   \
           float* part, int nparts, float* dw, int rows, int d, float eps,      \
           void* stream) {                                                      \
    if (rows < 1 || d < 1 || nparts < 1 || nparts > rows)                       \
      return int(cudaErrorInvalidValue);                                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                         \
    switch (dtype) {                                                            \
      case kF32:                                                                \
        return LAUNCH<float>(x, w, g, dx, part, nparts, dw, rows, d, eps, s);   \
      case kBF16:                                                               \
        return LAUNCH<__nv_bfloat16>(x, w, g, dx, part, nparts, dw, rows, d,    \
                                     eps, s);                                   \
    }                                                                           \
    return int(cudaErrorInvalidValue);                                          \
  }

RMSNORM_BWD_ENTRY(rmsnorm_bwd_reg, launch_bwd_reg)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_smem, launch_bwd)

#undef RMSNORM_BWD_ENTRY

}  // extern "C"
