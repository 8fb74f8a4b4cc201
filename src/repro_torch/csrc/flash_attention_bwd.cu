// Dense causal GQA flash-attention backward for Hopper (sm_90a), f32, on
// CUDA cores.
//
// The port's own kernel: the JAX package has no backward kernel (its
// training differentiates the jnp chunked_attention with XLA), so this
// computes what autodiff of softmax(q k^T / sqrt(hd)) v gives, from the
// forward's output O and its row log-sum-exp lse (flash_attention.cu). The
// FA2 algorithm: P = exp(S / sqrt(hd) - lse) is recomputed a tile at a
// time and never stored, so memory stays O(S) and not O(S^2).
//
//   delta = rowsum(dO * O)                       flash_bwd_delta_kernel
//   dP = dO V^T, dS = P * (dP - delta)
//   dV = P^T dO, dK = dS^T Q / sqrt(hd)          flash_bwd_dkdv_kernel
//   dQ = dS K / sqrt(hd)                         flash_bwd_dq_kernel
//
// q (B,Sq,H,hd), k/v (B,Skv,KV,hd), f32; key j is visible to query i when
// j <= i (causal; positions aligned at 0) or always. Any B, Sq, Skv, H, KV
// with H % KV == 0 (any G); hd % 32 == 0, 32 <= hd <= 256, or hd 80
// (HuBERT: 1280 / 16), instantiated at its own width: a thread's slice of
// the accumulators is every 16th column, so hd % 16 == 0 is all the loops
// need. bf16 takes the tensor-core kernels of flash_attention_bwd_sm90.cu;
// f32 stays here because wgmma has no full-f32 mode (TF32 keeps ~3 decimal
// digits and could not meet the f32 checks at 1e-4).
//
// Deterministic, with no atomics: the dK/dV kernel's block owns one tile of
// M keys of one KV head and loops over the G query heads of its group and
// every query tile that sees its keys, so the GQA sum happens inside the
// block in a fixed order; the dQ kernel's block owns one tile of M query
// rows of one head and loops over the key tiles up to the diagonal. Two
// runs on the same inputs give the same bits, which the trainer's
// revocation check (a restart bit for bit equal to an uninterrupted run)
// relies on.
//
// What bounds it: seven S-sized products a visible (query, key) pair (S and
// dP twice, dV, dK and dQ) against a few bytes a pair, so operations. They
// run as f32 FMAs: a block of 256 threads stages its tiles in shared
// memory, rows padded by one float so that every loop's reads are free of
// bank conflicts, and each thread keeps a 4 x 4 (hd <= 128; M = 64) or
// 2 x 2 (hd > 128; M = 32) micro-tile of S and dP and its slice of the
// dK/dV or dQ accumulators in registers.
//
// The C entry point returns the first nonzero cudaGetLastError() of its
// three launches; the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads a block: 16 x 16
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const float *q, *k, *v, *o, *dout;
  const float* lse;      // (B, H, Sq) natural log-sum-exp of the scaled scores
  float* delta;          // (B, H, Sq) scratch: rowsum(dO * O)
  float *dq, *dk, *dv;
  int B, Sq, Skv, H, KV, hd, causal;
  float scale;           // 1 / sqrt(hd)
  float scale_log2;      // log2(e) / sqrt(hd)
};

// Rows (q) and keys a tile: 64 up to hd 128, 32 above (shared memory).
template <int HD>
struct Tile {
  static constexpr int M = HD <= 128 ? 64 : 32;
  static constexpr int LD = HD + 1;     // padded row of a q/k/v/dO tile
  static constexpr int LP = M + 1;      // padded row of a P or dS tile
  static constexpr int MI = M / 16;     // rows (keys) of a thread's micro-tile
  static constexpr int DJ = HD / 16;    // dims of a thread's accumulator slice
};

template <int HD>
constexpr size_t dkdv_smem() {
  using T = Tile<HD>;
  return sizeof(float) * (4 * size_t(T::M) * T::LD + 2 * size_t(T::M) * T::LP +
                          2 * T::M);
}
template <int HD>
constexpr size_t dq_smem() {
  using T = Tile<HD>;
  return sizeof(float) * (4 * size_t(T::M) * T::LD + size_t(T::M) * T::LP +
                          2 * T::M);
}

// One warp a (b, i, h) row: delta[b,h,i] = sum_d dO * O in f32.
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(Args a) {
  const long row = long(blockIdx.x) * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= long(a.B) * a.Sq * a.H) return;     // the whole warp
  float s = 0.f;
  for (int d = lane; d < a.hd; d += 32)
    s = fmaf(a.o[row * a.hd + d], a.dout[row * a.hd + d], s);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = int(row % a.H);
    const long bi = row / a.H;
    const int i = int(bi % a.Sq), b = int(bi / a.Sq);
    a.delta[(long(b) * a.H + h) * a.Sq + i] = s;
  }
}

// Stage rows r0 .. r0+M of head `head` of x (B, S, heads, HD), rows past S
// zero.
template <int HD, int M>
__device__ __forceinline__ void load_tile(float* dst, const float* x, int b, int r0,
                                          int S, int heads, int head) {
  for (int i = threadIdx.x; i < M * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    dst[r * (HD + 1) + d] =
        row < S ? x[((long(b) * S + row) * heads + head) * HD + d] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T on a thread's micro-tile (rows ty + 16 i, keys
// tx + 16 j), then P = exp(S / sqrt(hd) - lse) masked and dS = P (dP -
// delta), both written to shared memory (P only when pS is not null).
template <int HD>
__device__ __forceinline__ void p_and_ds(const float* qS, const float* doS,
                                         const float* kS, const float* vS,
                                         const float* lseS, const float* dlS,
                                         float* pS, float* dsS, int q0, int k0,
                                         const Args& a) {
  using TL = Tile<HD>;
  constexpr int MI = TL::MI, LD = TL::LD, LP = TL::LP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[MI][MI], dp[MI][MI];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[MI], gv[MI], kv[MI], vv[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      qv[i] = qS[(ty + 16 * i) * LD + d];
      gv[i] = doS[(ty + 16 * i) * LD + d];
      kv[i] = kS[(tx + 16 * i) * LD + d];
      vv[i] = vS[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      const int c = tx + 16 * j, key = k0 + c;
      const bool ok = row < a.Sq && key < a.Skv && (!a.causal || key <= row);
      const float p = ok ? exp2f(s[i][j] * a.scale_log2 - lseS[r]) : 0.f;
      if (pS != nullptr) pS[r * LP + c] = p;
      dsS[r * LP + c] = p * (dp[i][j] - dlS[r]);
    }
  }
}

template <int M>
__device__ __forceinline__ void load_row_stats(float* lseS, float* dlS,
                                               const Args& a, int b, int h,
                                               int q0) {
  if (threadIdx.x < M) {
    const int row = q0 + threadIdx.x;
    const bool in = row < a.Sq;
    const long li = (long(b) * a.H + h) * a.Sq + row;
    lseS[threadIdx.x] = in ? a.lse[li] * kLog2e : 0.f;
    dlS[threadIdx.x] = in ? a.delta[li] : 0.f;
  }
}

// Grid (key tiles, KV, B). The block's thread owns keys ty + 16 i and dims
// tx + 16 j of dK and dV.
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(Args a) {
  using TL = Tile<HD>;
  constexpr int M = TL::M, LD = TL::LD, LP = TL::LP, MI = TL::MI, DJ = TL::DJ;
  extern __shared__ float smem[];
  float* kS = smem;
  float* vS = kS + M * LD;
  float* qS = vS + M * LD;
  float* doS = qS + M * LD;
  float* pS = doS + M * LD;
  float* dsS = pS + M * LP;
  float* lseS = dsS + M * LP;
  float* dlS = lseS + M;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * M;
  load_tile<HD, M>(kS, a.k, b, k0, a.Skv, a.KV, kvh);
  load_tile<HD, M>(vS, a.v, b, k0, a.Skv, a.KV, kvh);

  float dk[MI][DJ], dv[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // Causal: query rows below k0 see none of these keys.
  const int qt0 = a.causal ? k0 / M : 0;
  const int nqt = (a.Sq + M - 1) / M;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * M;
      __syncthreads();                   // the last tile's reads are done
      load_tile<HD, M>(qS, a.q, b, q0, a.Sq, a.H, h);
      load_tile<HD, M>(doS, a.dout, b, q0, a.Sq, a.H, h);
      load_row_stats<M>(lseS, dlS, a, b, h, q0);
      __syncthreads();
      p_and_ds<HD>(qS, doS, kS, vS, lseS, dlS, pS, dsS, q0, k0, a);
      __syncthreads();
      // dV[c][d] += P[r][c] dO[r][d]; dK[c][d] += dS[r][c] Q[r][d].
#pragma unroll 2
      for (int r = 0; r < M; ++r) {
        float pv[MI], dsv[MI], gv[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          pv[i] = pS[r * LP + ty + 16 * i];
          dsv[i] = dsS[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gv[j] = doS[r * LD + tx + 16 * j];
          qv[j] = qS[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Skv) continue;
    const long base = ((long(b) * a.Skv + key) * a.KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      a.dk[base + tx + 16 * j] = dk[i][j] * a.scale;
      a.dv[base + tx + 16 * j] = dv[i][j];
    }
  }
}

// Grid (query tiles, H, B), longest causal rows first. The block's thread
// owns rows ty + 16 i and dims tx + 16 j of dQ.
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
  using TL = Tile<HD>;
  constexpr int M = TL::M, LD = TL::LD, LP = TL::LP, MI = TL::MI, DJ = TL::DJ;
  extern __shared__ float smem[];
  float* qS = smem;
  float* doS = qS + M * LD;
  float* kS = doS + M * LD;
  float* vS = kS + M * LD;
  float* dsS = vS + M * LD;
  float* lseS = dsS + M * LP;
  float* dlS = lseS + M;

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * M;
  load_tile<HD, M>(qS, a.q, b, q0, a.Sq, a.H, h);
  load_tile<HD, M>(doS, a.dout, b, q0, a.Sq, a.H, h);
  load_row_stats<M>(lseS, dlS, a, b, h, q0);

  float dq[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  // Causal: keys past the tile's last row are never visible.
  const int kv_end = a.causal ? min(a.Skv, q0 + M) : a.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += M) {
    __syncthreads();                     // the last tile's reads are done
    load_tile<HD, M>(kS, a.k, b, k0, a.Skv, a.KV, kvh);
    load_tile<HD, M>(vS, a.v, b, k0, a.Skv, a.KV, kvh);
    __syncthreads();
    p_and_ds<HD>(qS, doS, kS, vS, lseS, dlS, nullptr, dsS, q0, k0, a);
    __syncthreads();
    // dQ[r][d] += dS[r][c] K[c][d].
#pragma unroll 2
    for (int c = 0; c < M; ++c) {
      float dsv[MI], kv[DJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) dsv[i] = dsS[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = kS[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const long base = ((long(b) * a.Sq + row) * a.H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) a.dq[base + tx + 16 * j] = dq[i][j] * a.scale;
  }
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

template <int HD>
int launch_hd(const Args& a, cudaStream_t stream) {
  constexpr int M = Tile<HD>::M;
  const long rows = long(a.B) * a.Sq * a.H;
  flash_bwd_delta_kernel<<<unsigned((rows + NT / 32 - 1) / (NT / 32)), NT,
                            0, stream>>>(a);
  int e = int(cudaGetLastError());
  if (e) return e;
  auto dkdv = flash_bwd_dkdv_kernel<HD>;
  if ((e = set_smem(dkdv, dkdv_smem<HD>()))) return e;
  dkdv<<<dim3((a.Skv + M - 1) / M, a.KV, a.B), NT, dkdv_smem<HD>(), stream>>>(a);
  if ((e = int(cudaGetLastError()))) return e;
  auto dq = flash_bwd_dq_kernel<HD>;
  if ((e = set_smem(dq, dq_smem<HD>()))) return e;
  dq<<<dim3((a.Sq + M - 1) / M, a.H, a.B), NT, dq_smem<HD>(), stream>>>(a);
  return int(cudaGetLastError());
}

int launch(const Args& a, cudaStream_t s) {
  switch (a.hd) {
    case 32: return launch_hd<32>(a, s);
    case 64: return launch_hd<64>(a, s);
    case 80: return launch_hd<80>(a, s);
    case 96: return launch_hd<96>(a, s);
    case 128: return launch_hd<128>(a, s);
    case 160: return launch_hd<160>(a, s);
    case 192: return launch_hd<192>(a, s);
    case 224: return launch_hd<224>(a, s);
    case 256: return launch_hd<256>(a, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Skv,KV,hd), o and dout like q, contiguous f32; lse
// (B,H,Sq) f32 from the forward; delta (B,H,Sq) f32 scratch; dq like q and
// dk/dv like k, written whole. hd % 32 == 0, 32 <= hd <= 256, or hd 80.
int flash_attention_f32_bwd(const float* q, const float* k, const float* v,
                            const float* o, const float* dout, const float* lse,
                            float* delta, float* dq, float* dk, float* dv,
                            int B, int Sq, int Skv, int H, int KV, int hd,
                            int causal, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(hd));
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, hd,
         causal ? 1 : 0, scale, scale * kLog2e};
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
