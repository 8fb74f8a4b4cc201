// Dense causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py flash_attention_fwd (the
// Pallas TPU kernel). q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> out (B,Sq,H,hd):
// softmax(q k^T / sqrt(hd)) v per head, head h reading KV head h / G, with
// key j visible to query i when j <= i (causal; positions aligned at 0) or
// always (not causal). Masked scores are -1e30, as in the reference.
//
// The TPU kernel walks the KV blocks of a (head, q block) as the sequential
// innermost grid axis and keeps the online softmax (m, l, acc) in VMEM
// scratch across grid steps. Hopper blocks run in no order, so here one
// block owns a (q tile of 32 rows, head, batch) and loops over the KV tiles
// of 32 keys itself, stopping at the diagonal when causal (the TPU kernel's
// skipped blocks above it are never visited). Per KV tile: the K and V tile
// go to shared memory as f32; each warp scores 8 rows against the tile's 32
// keys (lane = key, the q row a broadcast read), keeps its rows' m and l in
// registers and folds the tile in with warp shuffles; then each thread
// updates its share of the f32 output accumulator (hd/4 values, in
// registers) with p @ V. The output is normalised once, with l floored at
// 1e-20. q is scaled by 1/sqrt(hd) in f32 before the dot, as the TPU kernel
// does. p stays f32 (the reference's chunked_attention rounds it to v's
// dtype before the PV product; compare at bf16 tolerance).
//
// What bounds it: at the serve path's shapes (S 256, hd 64, G 1) it does
// ~64 flops a byte of q, k, v and out, below the card's 295 bf16 flops a
// byte, so the floor is bytes; but this first version runs on CUDA cores in
// f32 (no wgmma, no TMA) and re-reads K/V once per q tile (from L2), so it
// is bound by shared-memory and FMA throughput well above that floor.
//
// Tile contract: hd a multiple of 32 with 32 <= hd <= 256; any B, Sq, Skv,
// H, KV with H % KV == 0 (any G). The ragged edges of Sq and Skv are masked
// in the kernel. The C entry point returns cudaGetLastError() after the
// launch; the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int BQ = 32;           // query rows a block
constexpr int BK = 32;           // keys a tile (= lanes)
constexpr int NT = 128;          // threads a block
constexpr int NW = NT / 32;      // warps
constexpr int RPW = BQ / NW;     // score rows a warp

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;   // (B, Sq, H, hd)
  const void* k;   // (B, Skv, KV, hd)
  const void* v;
  void* out;       // (B, Sq, H, hd), q's dtype
  int B, Sq, Skv, H, KV, causal;
  float scale;
};

// Shared memory: q tile (BQ x HD), K tile (BK x HD+1), V tile (BK x HD),
// p tile (BQ x BK+1), alpha and l (BQ each). The +1 pads keep the score
// loop's key-row reads and the p reads free of bank conflicts.
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * HD + size_t(BK) * (HD + 1) +
                          size_t(BK) * HD + size_t(BQ) * (BK + 1) + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* qS = smem;                    // BQ x HD
  float* kS = qS + BQ * HD;            // BK x (HD+1)
  float* vS = kS + BK * (HD + 1);      // BK x HD
  float* pS = vS + BK * HD;            // BQ x (BK+1)
  float* aS = pS + BQ * (BK + 1);      // BQ
  float* lS = aS + BQ;                 // BQ

  constexpr int NPT = BQ * HD / NT;    // accumulator values a thread
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * BQ;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    float x = 0.f;
    if (row < a.Sq) x = load_f(q, ((long(b) * a.Sq + row) * a.H + h) * HD + d) * a.scale;
    qS[i] = x;
  }
  float m[RPW], l[RPW], acc[NPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i) { m[i] = kNeg; l[i] = 0.f; }
#pragma unroll
  for (int i = 0; i < NPT; ++i) acc[i] = 0.f;

  // Causal: keys past the tile's last row are never visible.
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                   // previous tile fully used
    for (int i = tid; i < BK * HD; i += NT) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < a.Skv) {
        const long off = ((long(b) * a.Skv + key) * a.KV + kvh) * HD + d;
        kx = load_f(kp, off);
        vx = load_f(vp, off);
      }
      kS[j * (HD + 1) + d] = kx;
      vS[j * HD + d] = vx;
    }
    __syncthreads();
    // Scores: lane = key, this warp's rows warp + NW*i.
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float* kr = kS + lane * (HD + 1);
    for (int d = 0; d < HD; ++d) {
      const float kx = kr[d];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i] = fmaf(qS[(warp + NW * i) * HD + d], kx, s[i]);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i;
      const bool ok = key < a.Skv && (!a.causal || key <= q0 + r);
      const float sc = ok ? s[i] : kNeg;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = expf(sc - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      pS[r * (BK + 1) + lane] = p;
      if (lane == 0) aS[r] = alpha;
    }
    __syncthreads();
    // acc = acc * alpha + p @ V; output value i of this thread is
    // o = tid + NT*i: row o / HD, column o % HD (a warp shares its row).
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int o = tid + NT * i, r = o / HD, d = o % HD;
      const float* pr = pS + r * (BK + 1);
      float x = acc[i] * aS[r];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) x = fmaf(pr[j], vS[j * HD + d], x);
      acc[i] = x;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) lS[warp + NW * i] = l[i];
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int o = tid + NT * i, r = o / HD, d = o % HD, row = q0 + r;
    if (row < a.Sq)
      store_f(out, ((long(b) * a.Sq + row) * a.H + h) * HD + d,
              acc[i] / fmaxf(lS[r], 1e-20f));
  }
}

template <typename T, int HD>
int launch_hd(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_t(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(a, stream);
    case 64: return launch_hd<T, 64>(a, stream);
    case 96: return launch_hd<T, 96>(a, stream);
    case 128: return launch_hd<T, 128>(a, stream);
    case 160: return launch_hd<T, 160>(a, stream);
    case 192: return launch_hd<T, 192>(a, stream);
    case 224: return launch_hd<T, 224>(a, stream);
    case 256: return launch_hd<T, 256>(a, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Skv,KV,hd), one dtype (f32 or bf16), contiguous;
// out (B,Sq,H,hd) in that dtype.
int flash_attention_fwd(const void* q, const void* k, const void* v, int dtype,
                        void* out, int B, int Sq, int Skv, int H, int KV,
                        int hd, int causal, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return int(cudaErrorInvalidValue);
  Args a{q, k, v, out, B, Sq, Skv, H, KV, causal ? 1 : 0,
         1.0f / sqrtf(float(hd))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_t<float>(a, hd, s);
    case kBF16: return launch_t<__nv_bfloat16>(a, hd, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
