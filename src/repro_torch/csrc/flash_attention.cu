// Dense causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py flash_attention_fwd (the
// Pallas TPU kernel). q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> out (B,Sq,H,hd):
// softmax(q k^T / sqrt(hd)) v per head, head h reading KV head h / G, with
// key j visible to query i when j <= i (causal; positions aligned at 0) or
// always (not causal). Masked scores are -1e30, as in the reference.
//
// Two kernels, chosen by dtype (the wrapper's route; no fallback between
// them):
//
// bf16 -> flash_sm90_kernel (wgmma + TMA). What bounds it: at the Zamba2
// serve shape (B 8, S 256, H 32, hd 64, causal) the work is ~64 flops a
// byte of q, k, v and out, under the card's ~295 bf16 flops a byte, so the
// floor is bytes (0.010 ms); what held the first version back was issue
// rate, not bytes (f32 FMAs out of shared memory, scalar 2-byte loads, no
// overlap of loads with compute). The design: one block of one warpgroup
// (128 threads) a (64-row q tile, head, batch), the longest causal tiles
// launched first. TMA brings the Q tile once and K/V tiles of 64 keys
// through a ring of two stages, each completing on an mbarrier, 128-byte
// swizzled, from 3-D tensor maps over (B, S, heads*hd) that zero-fill rows
// past S; the next tile's load is in flight while this one computes, and
// tiles above the diagonal are never loaded. S = Q K^T is wgmma
// m64n64k16 from shared memory (HD/16 k-steps), scaled by 1/sqrt(hd) in f32
// after the product; the causal and ragged masks run on edge tiles only.
// The online softmax stays in registers (a row's max and sum over the 4
// lanes of a quad; exp2 with log2(e) folded into the scale). P is rounded
// to bf16 into wgmma A-fragments in registers (as the reference's
// chunked_attention rounds p to v's dtype before PV) and O += P V runs
// with V MN-major (transpose bit) from the same stage; O stays f32 in
// registers (hd/2 values a thread). The epilogue normalises once (l
// floored at 1e-20), writes bf16 into the swizzled Q tile and stores it by
// TMA, which clips rows past Sq. The tensor maps are 4-D, (hd, heads, S,
// B), so a head's columns are their own dimension: the kernel computes at
// HD, the next multiple of 64 at or above the tensor's hd, and TMA
// zero-fills the columns hd .. HD-1 of every Q, K and V tile and clips
// them from the stored output. Zero columns add nothing to a score and
// give zero output columns, so hd 80 (HuBERT: 1280 / 16) runs the HD-128
// instantiation with no padded copy in memory, at 128/80 = 1.6x the
// tensor-core work of its true width; the scale is 1/sqrt(hd), passed in.
// hd in {64, 80, 128, 192, 256}.
//
// f32 -> flash_f32_kernel (CUDA cores). wgmma has no full-f32 mode: TF32
// keeps ~3 decimal digits and could not meet the f32 checks at 1e-4, so
// f32 keeps this first version: one block of 128 threads a (32-row q tile,
// head, batch) looping over 32-key KV tiles to the diagonal, scores a warp
// 8 rows (lane = key), (m, l) in registers, the f32 accumulator spread over
// the block (hd/4 values a thread), q pre-scaled by 1/sqrt(hd) in f32. hd a
// multiple of 32 up to 256, or 80 (instantiated at its own width).
//
// Both: any B, Sq, Skv, H, KV with H % KV == 0 (any G); the ragged edges
// of Sq and Skv are masked in the kernel. Both write each row's natural
// log-sum-exp of the scaled scores, lse (B,H,Sq) f32, when given a non-null
// `lse` (training: the backward kernels, flash_attention_bwd_sm90.cu for
// bf16 and flash_attention_bwd.cu for f32, recompute P = exp(S / sqrt(hd) -
// lse) from it); the serve paths pass null. The C
// entry points return cudaGetLastError() after the launch; the Python
// wrapper raises on it.

#include "sm90_attention.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int BQ = 32;           // query rows a block
constexpr int BK = 32;           // keys a tile (= lanes)
constexpr int NT = 128;          // threads a block
constexpr int NW = NT / 32;      // warps
constexpr int RPW = BQ / NW;     // score rows a warp


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
  void* out;       // (B, Sq, H, hd)
  float* lse;      // (B, H, Sq) or null
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

template <int HD>
__global__ void __launch_bounds__(NT) flash_f32_kernel(Args a) {
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
  const float* q = static_cast<const float*>(a.q);
  const float* kp = static_cast<const float*>(a.k);
  const float* vp = static_cast<const float*>(a.v);

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    float x = 0.f;
    if (row < a.Sq) x = q[((long(b) * a.Sq + row) * a.H + h) * HD + d] * a.scale;
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
        kx = kp[off];
        vx = vp[off];
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
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i;
      lS[r] = l[i];
      // m is the max of the pre-scaled scores: lse = m + log(l).
      if (a.lse != nullptr && q0 + r < a.Sq)
        a.lse[(long(b) * a.H + h) * a.Sq + q0 + r] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int o = tid + NT * i, r = o / HD, d = o % HD, row = q0 + r;
    if (row < a.Sq)
      out[((long(b) * a.Sq + row) * a.H + h) * HD + d] =
          acc[i] / fmaxf(lS[r], 1e-20f);
  }
}

template <int HD>
int launch_f32_hd(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_f32_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

struct Sm90Args {
  int Sq, Skv, H, KV, causal;
  float scale_log2;      // 1/sqrt(hd) * log2(e): scores in the exp2 domain
  float* lse;            // (B, H, Sq) natural log-sum-exp, or null
};

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() { return uint32_t(HD / 64) * sm90::kSub; }

// Q tile, two K stages, two V stages, and 1 KB to align the first to 1 KB.
template <int HD>
constexpr size_t sm90_smem_bytes() { return 5 * size_t(tile_bytes<HD>()) + 1024; }

// hd 64 (the Zamba2 path) is held to 102 registers so that five blocks
// share an SM instead of four: 0.0170 against 0.0176 ms at the serve shape.
template <int HD>
__global__ void __launch_bounds__(128, HD == 64 ? 5 : 1) flash_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    Sm90Args a) {
  using namespace sm90;
  constexpr int NC = HD / 64;                 // 64-column sub-tiles
  constexpr uint32_t TB = tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];                // Q, KV stage 0, KV stage 1
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qS = smem;                         // also the output tile
  uint8_t* kS = qS + TB;                      // 2 stages
  uint8_t* vS = kS + 2 * TB;                  // 2 stages

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kTile;
  const int kv_end = a.causal ? min(a.Skv, q0 + kTile) : a.Skv;
  const int ntiles = (kv_end + kTile - 1) / kTile;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], TB);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_4d(qS + c * kSub, &tq, &bars[0], c * 64, h, q0, b);
    load_tile_pair_4d<NC>(kS, vS, &tk, &tv, &bars[1], kvh, 0, b);
  }

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  const float neg = kNeg * kLog2e;
  float m[2] = {neg, neg}, l[2] = {0.f, 0.f};   // l: this thread's partial
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const uint32_t qs = smem_u32(qS);
  mbar_wait(&bars[0], 0);

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      __syncthreads();                        // tile t-1 (same stage) used
      if (tid == 0)
        load_tile_pair_4d<NC>(kS + ((t + 1) & 1) * TB,
                              vS + ((t + 1) & 1) * TB, &tk, &tv,
                              &bars[1 + ((t + 1) & 1)], kvh, (t + 1) * kTile,
                              b);
    }
    mbar_wait(&bars[1 + (t & 1)], (t >> 1) & 1);
    const uint32_t ks = smem_u32(kS + (t & 1) * TB);
    const uint32_t vs = smem_u32(vS + (t & 1) * TB);

    // S = Q K^T over hd/16 k-steps (32 bytes each inside a 128-byte row).
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSub + (kk & 3) * 32;
      wgmma_ss(s, desc_sw128(qs + off, 16, 1024), desc_sw128(ks + off, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // Online softmax in the exp2 domain; masks only on edge tiles.
    const int k0 = t * kTile;
    const bool edge = (a.causal && k0 + kTile - 1 > q0) || k0 + kTile > a.Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * a.scale_log2;
      if (edge) {
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        const bool ok = key < a.Skv && (!a.causal || key <= row);
        x = ok ? x : neg;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = quad_max(mx[hh]);
      alpha[hh] = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // O += P V: P rounded to bf16 in registers, V MN-major (16 keys of
    // 128-byte rows a k-step).
    uint32_t pa[4][4];                        // all of P's A-fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) p_fragment(s, kk, pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs_t(o[c], pa[kk], desc_sw128(vs + c * kSub + kk * 2048, kSub, 1024));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
  }

  // Epilogue: normalise, bf16 into the swizzled Q tile, one TMA store a
  // sub-tile (rows past Sq are clipped by the tensor map).
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lsum = quad_sum(l[hh]);
    inv[hh] = 1.f / fmaxf(lsum, 1e-20f);
    // m and lsum are in the exp2 domain: lse = (m + log2(l)) * ln(2).
    const int row = q0 + r0 + 8 * hh;
    if (a.lse != nullptr && (lane & 3) == 0 && row < a.Sq)
      a.lse[(long(b) * a.H + h) * a.Sq + row] =
          (m[hh] + log2f(lsum)) * 0.6931471805599453f;
  }
  __syncthreads();                            // every wgmma read of Q done
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = c * 64 + 8 * (i >> 2) + cq;
      const float w = inv[(i >> 1) & 1];
      *reinterpret_cast<uint32_t*>(qS + swz_offset(row, col, kTile)) =
          pack_bf16(o[c][i] * w, o[c][i + 1] * w);
    }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_store_4d(&to, qS + c * kSub, c * 64, h, q0, b);
    tma_store_wait();
  }
}

// HD is the compute width, hd (<= HD) the tensors' own.
template <int HD>
int launch_sm90_hd(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int KV, int hd,
                   int causal, cudaStream_t stream) {
  // (B, S, heads, hd) bf16 as 4-D maps, innermost first; boxes of 64
  // columns x 1 head x 64 rows, zero-filled past hd and past S.
  CUtensorMap tq, tk, tv, to;
  const cuuint64_t row = cuuint64_t(hd) * 2;
  const cuuint64_t qdim[4] = {cuuint64_t(hd), cuuint64_t(H), cuuint64_t(Sq),
                              cuuint64_t(B)};
  const cuuint64_t qstr[3] = {row, row * H, row * H * Sq};
  const cuuint64_t kdim[4] = {cuuint64_t(hd), cuuint64_t(KV), cuuint64_t(Skv),
                              cuuint64_t(B)};
  const cuuint64_t kstr[3] = {row, row * KV, row * KV * Skv};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::encode_map(&tq, bf, 4, q, qdim, qstr, box, sw) ||
      !sm90::encode_map(&tk, bf, 4, k, kdim, kstr, box, sw) ||
      !sm90::encode_map(&tv, bf, 4, v, kdim, kstr, box, sw) ||
      !sm90::encode_map(&to, bf, 4, out, qdim, qstr, box, sw))
    return int(cudaErrorInvalidValue);
  constexpr size_t smem = sm90_smem_bytes<HD>();
  auto kern = flash_sm90_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const float scale_log2 = sm90::kLog2e / sqrtf(float(hd));
  Sm90Args a{Sq, Skv, H, KV, causal, scale_log2, lse};
  dim3 grid((Sq + sm90::kTile - 1) / sm90::kTile, H, B);
  kern<<<grid, 128, smem, stream>>>(tq, tk, tv, to, a);
  return int(cudaGetLastError());
}

bool bad_shape(int B, int Sq, int Skv, int H, int KV) {
  return B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
         H > 65535;
}

}  // namespace

extern "C" {

// f32 on CUDA cores. q (B,Sq,H,hd), k/v (B,Skv,KV,hd), out (B,Sq,H,hd),
// contiguous f32; hd % 32 == 0, 32 <= hd <= 256, or hd 80. lse (B,H,Sq) f32
// or null.
int flash_attention_f32_fwd(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Skv, int H, int KV,
                            int hd, int causal, float* lse, void* stream) {
  if (bad_shape(B, Sq, Skv, H, KV)) return int(cudaErrorInvalidValue);
  Args a{q, k, v, out, lse, B, Sq, Skv, H, KV, causal ? 1 : 0,
         1.0f / sqrtf(float(hd))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_f32_hd<32>(a, s);
    case 64: return launch_f32_hd<64>(a, s);
    case 80: return launch_f32_hd<80>(a, s);
    case 96: return launch_f32_hd<96>(a, s);
    case 128: return launch_f32_hd<128>(a, s);
    case 160: return launch_f32_hd<160>(a, s);
    case 192: return launch_f32_hd<192>(a, s);
    case 224: return launch_f32_hd<224>(a, s);
    case 256: return launch_f32_hd<256>(a, s);
  }
  return int(cudaErrorInvalidValue);
}

// bf16 on tensor cores, the same layout, 16-byte aligned; hd in {64, 80,
// 128, 192, 256} (hd 80 computed at 128 over zero-filled columns).
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Skv, int H, int KV,
                             int hd, int causal, float* lse, void* stream) {
  if (bad_shape(B, Sq, Skv, H, KV)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal ? 1 : 0;
  switch (hd) {
    case 64: return launch_sm90_hd<64>(q, k, v, out, lse, B, Sq, Skv, H, KV, hd, c, s);
    case 80:
    case 128: return launch_sm90_hd<128>(q, k, v, out, lse, B, Sq, Skv, H, KV, hd, c, s);
    case 192: return launch_sm90_hd<192>(q, k, v, out, lse, B, Sq, Skv, H, KV, hd, c, s);
    case 256: return launch_sm90_hd<256>(q, k, v, out, lse, B, Sq, Skv, H, KV, hd, c, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
