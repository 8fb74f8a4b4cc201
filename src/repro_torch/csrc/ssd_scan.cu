// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces repro/kernels/mamba_scan/kernel.py ssd_scan (the Pallas TPU
// kernel). Inputs x (B,S,H,P), dt (B,S,H) f32, a_log (H,) f32, B and C
// (B,S,N) shared across heads; the state starts at zero. Outputs y (B,S,H,P) in x's dtype and, unlike the TPU kernel, the final
// state h (B,H,N,P) f32, which the serve engine keeps as the decode cache.
// With a = -exp(a_log[h]) and, within a chunk of L steps, la the inclusive
// cumulative sum of dt * a:
//   y[l]  = exp(la_l) C_l . h + sum_{m<=l} (C_l . B_m) exp(la_l - la_m) dt_m x_m
//   h    <- exp(la_last) h + sum_l exp(la_last - la_l) dt_l B_l x_l^T
// The D-skip and the gate stay outside, as in the reference.
//
// The TPU kernel runs the chunk axis as the sequential innermost grid axis
// and keeps the state in VMEM scratch across grid steps. Hopper blocks run
// in no order, so here one block owns one (batch, head) and walks its
// chunks in order itself, with the (N,P) f32 state in shared memory for the
// whole walk (16 KB at N = P = 64). Per chunk it stages x, B, C (as f32)
// and dt in shared memory, takes the cumulative log-decay with a warp scan,
// forms W = (C B^T) . exp(segsum) . dt (L x L, lower triangle, never
// evaluating exp above the diagonal), writes y = exp(la) (C h) + W x cast
// to x's dtype, and then updates the state. Each phase is a register tile:
// lane = output column (two columns a thread, 64 a warp), warp = a stride
// of output rows, the row operand a broadcast shared-memory read.
//
// What bounds it: at the serve path's shapes (B 8, S 256, H 64, L 128,
// N = P = 64) a chunk does ~2 M multiply-adds a (batch, head), ~4 GFLOP a
// call against ~43 MB moved (x, dt, B, C and y once, the final state):
// ~100 flops a byte, below the card's 295 bf16 flops a byte, so the floor
// is bytes.
// This first version runs on CUDA cores in f32 (no wgmma, no TMA), one
// block of 8 warps an SM (~180 KB of shared memory at L = 128), and
// recomputes C B^T for every head though it is shared across heads: it is
// bound by FMA and shared-memory throughput well above that floor.
//
// Contract: 1 <= chunk <= 128, S % chunk == 0, N <= 128, and the staged
// chunk must fit in 227 KB of shared memory (true at L = 128 for
// N, P <= 64). The C entry point returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape outside the contract); the
// Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int NW = NT / 32;      // warps
constexpr int MAXR = 16;         // rows a warp: L/NW and N/NW <= 16
constexpr int MAX_SMEM = 232448; // bytes a block may use on Hopper

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

struct Args {
  const void* x;        // (B, S, H, P)
  const void* bm;       // (B, S, N)
  const void* cm;       // (B, S, N)
  const float* dt;      // (B, S, H)
  const float* a_log;   // (H,)
  void* y;              // (B, S, H, P), x's dtype
  float* h_final;       // (B, H, N, P)
  int B, S, H, P, N, L;
};

// Shared memory, in floats: state N x P, B chunk L x (N+1) (the pad keeps
// the W loop's column reads of B free of bank conflicts), C chunk L x N,
// x chunk L x P, W L x L, then la, dt and the state weights (L each).
size_t smem_bytes(int L, int N, int P) {
  return sizeof(float) * (size_t(N) * P + size_t(L) * (N + 1) + size_t(L) * N +
                          size_t(L) * P + size_t(L) * L + 3 * size_t(L));
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(Args a) {
  extern __shared__ float smem[];
  const int L = a.L, N = a.N, P = a.P;
  float* hS = smem;                    // N x P
  float* bS = hS + N * P;              // L x (N+1)
  float* cS = bS + L * (N + 1);        // L x N
  float* xS = cS + L * N;              // L x P
  float* wS = xS + L * P;              // L x L
  float* laS = wS + L * L;             // L
  float* dtS = laS + L;                // L
  float* sS = dtS + L;                 // L

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* x = static_cast<const T*>(a.x);
  const T* bm = static_cast<const T*>(a.bm);
  const T* cm = static_cast<const T*>(a.cm);
  T* y = static_cast<T*>(a.y);
  const float A = -expf(a.a_log[h]);
  const long st_base = (long(b) * a.H + h) * N * P;

  for (int i = tid; i < N * P; i += NT) hS[i] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += L) {
    __syncthreads();                   // previous chunk fully used
    for (int i = tid; i < L * P; i += NT) {
      const int l = i / P, p = i % P;
      xS[i] = load_f(x, ((long(b) * a.S + c0 + l) * a.H + h) * P + p);
    }
    for (int i = tid; i < L * N; i += NT) {
      const int l = i / N, n = i % N;
      const long off = (long(b) * a.S + c0 + l) * N + n;
      bS[l * (N + 1) + n] = load_f(bm, off);
      cS[i] = load_f(cm, off);
    }
    for (int l = tid; l < L; l += NT) dtS[l] = a.dt[(long(b) * a.S + c0 + l) * a.H + h];
    __syncthreads();
    // la = inclusive cumsum of dt * A: warp 0, a run of ceil(L/32) steps a
    // lane, then a shuffle scan over the lanes' totals.
    if (warp == 0) {
      const int per = (L + 31) / 32, lo = min(L, lane * per), hi = min(L, lo + per);
      float run = 0.f;
      for (int l = lo; l < hi; ++l) run += dtS[l] * A;
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      float acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) acc = 0.f;
      for (int l = lo; l < hi; ++l) {
        acc += dtS[l] * A;
        laS[l] = acc;
      }
    }
    __syncthreads();
    const float la_last = laS[L - 1];
    for (int l = tid; l < L; l += NT) sS[l] = expf(la_last - laS[l]) * dtS[l];

    // W[l][m] = (C_l . B_m) exp(la_l - la_m) dt_m for m <= l, else 0.
    for (int m0 = 0; m0 < L; m0 += 64) {
      const int ma = m0 + lane, mb = ma + 32;
      float acc0[MAXR], acc1[MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
      for (int n = 0; n < N; ++n) {
        const float b0 = ma < L ? bS[ma * (N + 1) + n] : 0.f;
        const float b1 = mb < L ? bS[mb * (N + 1) + n] : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
          const int l = warp + NW * i;
          if (l < L && l >= m0) {
            const float c = cS[l * N + n];
            acc0[i] = fmaf(c, b0, acc0[i]);
            acc1[i] = fmaf(c, b1, acc1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int l = warp + NW * i;
        if (l >= L) break;
        if (ma < L)
          wS[l * L + ma] = ma <= l ? acc0[i] * expf(laS[l] - laS[ma]) * dtS[ma] : 0.f;
        if (mb < L)
          wS[l * L + mb] = mb <= l ? acc1[i] * expf(laS[l] - laS[mb]) * dtS[mb] : 0.f;
      }
    }
    __syncthreads();

    // y[l][p] = exp(la_l) (C_l . h[:, p]) + sum_{m<=l} W[l][m] x[m][p].
    for (int p0 = 0; p0 < P; p0 += 64) {
      const int pa = p0 + lane, pb = pa + 32;
      float acc0[MAXR], acc1[MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
      for (int n = 0; n < N; ++n) {
        const float h0 = pa < P ? hS[n * P + pa] : 0.f;
        const float h1 = pb < P ? hS[n * P + pb] : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
          const int l = warp + NW * i;
          if (l < L) {
            const float c = cS[l * N + n];
            acc0[i] = fmaf(c, h0, acc0[i]);
            acc1[i] = fmaf(c, h1, acc1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int l = warp + NW * i;
        if (l < L) {
          const float e = expf(laS[l]);
          acc0[i] *= e;
          acc1[i] *= e;
        }
      }
      for (int m = 0; m < L; ++m) {
        const float x0 = pa < P ? xS[m * P + pa] : 0.f;
        const float x1 = pb < P ? xS[m * P + pb] : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
          const int l = warp + NW * i;
          if (l < L && m <= l) {
            const float w = wS[l * L + m];
            acc0[i] = fmaf(w, x0, acc0[i]);
            acc1[i] = fmaf(w, x1, acc1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int l = warp + NW * i;
        if (l >= L) break;
        const long row = ((long(b) * a.S + c0 + l) * a.H + h) * P;
        if (pa < P) store_f(y, row + pa, acc0[i]);
        if (pb < P) store_f(y, row + pb, acc1[i]);
      }
    }
    __syncthreads();                   // every read of the old state done

    // h[n][p] = exp(la_last) h[n][p] + sum_l B[l][n] (sS[l] x[l][p]).
    const float decay = expf(la_last);
    for (int p0 = 0; p0 < P; p0 += 64) {
      const int pa = p0 + lane, pb = pa + 32;
      float acc0[MAXR], acc1[MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
      for (int l = 0; l < L; ++l) {
        const float w = sS[l];
        const float x0 = pa < P ? xS[l * P + pa] * w : 0.f;
        const float x1 = pb < P ? xS[l * P + pb] * w : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
          const int n = warp + NW * i;
          if (n < N) {
            const float bv = bS[l * (N + 1) + n];
            acc0[i] = fmaf(bv, x0, acc0[i]);
            acc1[i] = fmaf(bv, x1, acc1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int n = warp + NW * i;
        if (n >= N) break;
        if (pa < P) hS[n * P + pa] = decay * hS[n * P + pa] + acc0[i];
        if (pb < P) hS[n * P + pb] = decay * hS[n * P + pb] + acc1[i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += NT) a.h_final[st_base + i] = hS[i];
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L, a.N, a.P);
  auto kern = ssd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kern<<<dim3(a.H, a.B), NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, bm, cm in one dtype (f32 or bf16); dt, a_log, h_final f32; all
// contiguous.
int ssd_scan_fwd(const void* x, const void* bm, const void* cm, int dtype,
                 const float* dt, const float* a_log, void* y, float* h_final,
                 int B, int S, int H, int P, int N, int chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || chunk < 1 ||
      chunk > NW * MAXR || N > NW * MAXR || S % chunk != 0 || B > 65535 ||
      smem_bytes(chunk, N, P) > size_t(MAX_SMEM))
    return int(cudaErrorInvalidValue);
  Args a{x, bm, cm, dt, a_log, y, h_final, B, S, H, P, N, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(a, s);
    case kBF16: return launch<__nv_bfloat16>(a, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
