// Dense causal GQA flash-attention backward for Hopper (sm_90a), bf16, on
// tensor cores (wgmma + TMA).
//
// The port's own kernel: the JAX package has no backward kernel (its
// training differentiates the jnp chunked_attention, models/layers.py, with
// XLA); the forward's TPU kernel is repro/kernels/flash_attention/kernel.py
// flash_attention_fwd. From the forward's bf16 output O and its row
// log-sum-exp lse (flash_attention.cu), with P recomputed a tile at a time
// (FA2; memory O(S)):
//
//   delta = rowsum(dO * O)                         flash_bwd_delta_sm90_kernel
//   S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T / sqrt(hd) - lse),
//   dS^T = P^T (dP^T - delta), dV += P^T dO, dK += dS^T Q
//                                                  flash_bwd_dkdv_sm90_kernel
//   S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K
//                                                  flash_bwd_dq_sm90_kernel
//
// with dK and dQ scaled by 1/sqrt(hd) in the epilogue. q (B,Sq,H,hd), k/v
// (B,Skv,KV,hd), o and dout like q, bf16; hd 64 or 128; any B, Sq, Skv, H,
// KV with H % KV == 0 (any G); key j visible to query i when j <= i (causal;
// positions aligned at 0) or always.
//
// What bounds it: at internlm2-1.8b's training shape (B 8, S 1024, H 16,
// KV 8, hd 128, causal) the five products a visible (query, key) pair
// needs are ~8.6e10 flops against ~50 MB of inputs and gradients, ~1,700
// flops a byte: operations bound it. The first version ran them as f32
// FMAs on CUDA cores (flash_attention_bwd.cu, now f32 only). Here every
// product is a wgmma m64n64k16 bf16 -> f32:
//
// - dK/dV kernel: a block of one warpgroup (128 threads) a (64-key tile,
//   KV head, batch). The K and V tiles arrive once by TMA; the Q and dO
//   tiles of each (query head of the group, query tile at or below the
//   diagonal) stream through a two-stage TMA + mbarrier ring, the next
//   tile's copy in flight while this one computes. S^T and dP^T come from
//   shared memory with both operands K-major (as S = Q K^T in the
//   forward). P^T and dS^T are formed in registers (the accumulator
//   layout: a row is a key, a column a query; the query's lse and delta go
//   through shared memory a tile), rounded to bf16 A-fragments, and dV +=
//   P^T dO, dK += dS^T Q take dO and Q MN-major from the same stage, as the
//   forward's O += P V takes V. dK and dV stay f32 in registers (hd/2 each
//   a thread). The block loops over the G heads of its group itself in a
//   fixed order, so the GQA sum needs no atomics.
// - dQ kernel: a block a (64-row query tile, head, batch), longest causal
//   rows first; Q and dO arrive once, K and V stream through the ring
//   (the forward's pattern); dQ += dS K with K MN-major.
// - The delta pass: a thread a 16-byte vector of O and dO, hd/8 lanes a
//   row, summed with shuffles.
//
// Masks: the causal mask runs on the diagonal tile only, and tiles past it
// are never loaded. Rows and keys past a ragged S are zero-filled by TMA,
// and their P is forced to 0 besides: a row past Sq gets lse = +inf (P =
// exp2(-inf) = 0), delta 0; keys past Skv are masked on the edge tile. TMA
// stores clip rows past S.
//
// Deterministic: no atomics, every sum in a fixed order, so two runs give
// the same bits (the trainer's revocation check compares a restart with an
// uninterrupted run bit for bit). The price is seven products a pair, not
// FA3's five: dQ is recomputed by its own kernel rather than accumulated
// across the dK/dV blocks with atomics.
//
// The C entry point returns the first nonzero cudaGetLastError() of its
// three launches; the Python wrapper raises on it.

#include "sm90_attention.cuh"

namespace {

using sm90::kTile;
using sm90::kSub;

struct BwdArgs {
  const float* lse;      // (B, H, Sq) natural log-sum-exp of the scaled scores
  const float* delta;    // (B, H, Sq) rowsum(dO * O)
  int Sq, Skv, H, KV, causal;
  float scale;           // 1 / sqrt(hd)
  float scale_log2;      // log2(e) / sqrt(hd)
};

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() { return uint32_t(HD / 64) * kSub; }

// Two resident tiles, two ring stages of two tiles, 1 KB to align to 1 KB.
template <int HD>
constexpr size_t smem_bytes() { return 6 * size_t(tile_bytes<HD>()) + 1024; }

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// d = A B^T over hd: A and B 64-row tiles, both K-major (hd contiguous).
template <int HD>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kSub + (kk & 3) * 32;
    sm90::wgmma_ss(d, sm90::desc_sw128(a + off, 16, 1024),
                   sm90::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc[c] += F B over 64 k-rows: F the bf16 A-fragments of a 64x64 tile, B a
// 64-row tile MN-major (hd contiguous), one m64n64 product a 64-column
// sub-tile of hd.
template <int NC>
__device__ __forceinline__ void product_rs(float (&acc)[NC][32],
                                           const uint32_t (&f)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      sm90::wgmma_rs_t(acc[c], f[kk],
                       sm90::desc_sw128(b + c * kSub + kk * 2048, kSub, 1024));
}

// acc * scale as bf16 into a swizzled tile (the accumulator layout).
template <int NC>
__device__ __forceinline__ void store_tile(uint8_t* dst, const float (&acc)[NC][32],
                                           float scale, int r0, int cq) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = c * 64 + 8 * (i >> 2) + cq;
      *reinterpret_cast<uint32_t*>(dst + sm90::swz_offset(row, col, kTile)) =
          sm90::pack_bf16(acc[c][i] * scale, acc[c][i + 1] * scale);
    }
}

// delta[b,h,i] = sum_d dO * O in f32: hd/8 lanes a (b, i, h) row, a 16-byte
// vector of each a lane.
template <int HD>
__global__ void __launch_bounds__(256) flash_bwd_delta_sm90_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ g,
    float* __restrict__ delta, long rows, int Sq, int H) {
  constexpr int L = HD / 8;
  const long t = long(blockIdx.x) * blockDim.x + threadIdx.x;
  const long row = t / L;
  const int c = int(t % L);
  float s = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * HD + c * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(g + row * HD + c * 8);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(ah[i]), y = __bfloat1622float2(bh[i]);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) {
    const int h = int(row % H);
    const long bi = row / H;
    delta[(bi / Sq * H + h) * Sq + bi % Sq] = s;
  }
}

template <int HD>
__global__ void __launch_bounds__(128, 1) flash_bwd_dkdv_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
    BwdArgs a) {
  using namespace sm90;
  constexpr int NC = HD / 64;
  constexpr uint32_t TB = tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];                // K/V, ring stage 0, stage 1
  __shared__ float stats[2][2][kTile];        // [stage][lse * log2(e), delta]
  uint8_t* kS = align_1k(smem_raw);           // also the dK tile out
  uint8_t* vS = kS + TB;                      // also the dV tile out
  uint8_t* qS = vS + TB;                      // 2 stages
  uint8_t* gS = qS + 2 * TB;                  // dO, 2 stages

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = kt * kTile;
  // Causal: query tiles below the key tile see none of its keys.
  const int qt0 = a.causal ? kt : 0;
  const int nq = max((a.Sq + kTile - 1) / kTile - qt0, 0);
  const int ntiles = G * nq;                  // (head of the group, query tile)

  // Tile t of the stream: head kvh*G + t / nq, query rows from q_row(t).
  auto head = [&](int t) { return kvh * G + t / nq; };
  auto q_row = [&](int t) { return (qt0 + t % nq) * kTile; };
  auto load_stats = [&](int t, int stage) {   // every thread: one value
    const int r = tid & (kTile - 1), row = q_row(t) + r;
    const long li = (long(b) * a.H + head(t)) * a.Sq + row;
    if (tid < kTile)
      stats[stage][0][r] = row < a.Sq ? a.lse[li] * kLog2e : __int_as_float(0x7f800000);
    else
      stats[stage][1][r] = row < a.Sq ? a.delta[li] : 0.f;
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_tile_pair<NC>(kS, vS, &tk, &tv, &bars[0], kvh * HD, k0, b);
    if (ntiles > 0)
      load_tile_pair<NC>(qS, gS, &tq, &tdo, &bars[1], head(0) * HD, q_row(0), b);
  }
  if (ntiles > 0) load_stats(0, 0);

  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const uint32_t ks = smem_u32(kS), vs = smem_u32(vS);
  mbar_wait(&bars[0], 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    // Stage st^1 is free (tile t-1's products are done) and tile t's
    // stats, written last iteration, are visible.
    __syncthreads();
    if (t + 1 < ntiles) {
      if (tid == 0)
        load_tile_pair<NC>(qS + (st ^ 1) * TB, gS + (st ^ 1) * TB, &tq, &tdo,
                           &bars[1 + (st ^ 1)], head(t + 1) * HD, q_row(t + 1),
                           b);
      load_stats(t + 1, st ^ 1);
    }
    mbar_wait(&bars[1 + st], (t >> 1) & 1);
    const uint32_t qs = smem_u32(qS + st * TB), gs = smem_u32(gS + st * TB);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    product_ss<HD>(s, ks, qs);
    product_ss<HD>(dp, vs, gs);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp2(S^T scale log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta);
    // the masks on the diagonal tile and the ragged key tile only.
    const int q0 = q_row(t);
    const bool edge = (a.causal && k0 + kTile - 1 > q0) || k0 + kTile > a.Skv;
    const float* lse2 = stats[st][0];
    const float* dl = stats[st][1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2f(s[i] * a.scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (edge) {
          const int key = k0 + r0 + 8 * ((e >> 1) & 1);
          const int row = q0 + 8 * j + cq + (e & 1);
          p = (key < a.Skv && (!a.causal || key <= row)) ? p : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T dO, dK += dS^T Q: the A-fragments in bf16, dO and Q
    // MN-major from the stage.
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p_fragment(s, kk, pa[kk]);
      p_fragment(dp, kk, da[kk]);
    }
    wgmma_fence();
    product_rs<NC>(dv, pa, gs);
    product_rs<NC>(dk, da, qs);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
  }

  // Epilogue: dK / sqrt(hd) and dV in bf16 into the K and V tiles, one TMA
  // store a sub-tile (rows past Skv clipped by the map).
  __syncthreads();                            // every wgmma read of K, V done
  store_tile<NC>(kS, dk, a.scale, r0, cq);
  store_tile<NC>(vS, dv, 1.f, r0, cq);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_store_3d(&tdk, kS + c * kSub, kvh * HD + c * 64, k0, b);
      tma_store_3d(&tdv, vS + c * kSub, kvh * HD + c * 64, k0, b);
    }
    tma_store_wait();
  }
}

template <int HD>
__global__ void __launch_bounds__(128, 1) flash_bwd_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdq, BwdArgs a) {
  using namespace sm90;
  constexpr int NC = HD / 64;
  constexpr uint32_t TB = tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];                // Q/dO, ring stage 0, stage 1
  uint8_t* qS = align_1k(smem_raw);           // also the dQ tile out
  uint8_t* gS = qS + TB;                      // dO
  uint8_t* kS = gS + TB;                      // 2 stages
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
    load_tile_pair<NC>(qS, gS, &tq, &tdo, &bars[0], h * HD, q0, b);
    if (ntiles > 0) load_tile_pair<NC>(kS, vS, &tk, &tv, &bars[1], kvh * HD, 0, b);
  }

  // This thread's two rows' stats; a row past Sq gets P = 0.
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const long li = (long(b) * a.H + h) * a.Sq + row;
    lse2[hh] = row < a.Sq ? a.lse[li] * kLog2e : __int_as_float(0x7f800000);
    dl[hh] = row < a.Sq ? a.delta[li] : 0.f;
  }
  float dq[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  const uint32_t qs = smem_u32(qS), gs = smem_u32(gS);
  mbar_wait(&bars[0], 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      __syncthreads();                        // tile t-1 (same stage) used
      if (tid == 0)
        load_tile_pair<NC>(kS + (st ^ 1) * TB, vS + (st ^ 1) * TB, &tk, &tv,
                           &bars[1 + (st ^ 1)], kvh * HD, (t + 1) * kTile, b);
    }
    mbar_wait(&bars[1 + st], (t >> 1) & 1);
    const uint32_t ks = smem_u32(kS + st * TB), vs = smem_u32(vS + st * TB);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    product_ss<HD>(s, qs, ks);
    product_ss<HD>(dp, gs, vs);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    const int k0 = t * kTile;
    const bool edge = (a.causal && k0 + kTile - 1 > q0) || k0 + kTile > a.Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float p = exp2f(s[i] * a.scale_log2 - lse2[hh]);
      if (edge) {
        const int row = q0 + r0 + 8 * hh;
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        p = (key < a.Skv && (!a.causal || key <= row)) ? p : 0.f;
      }
      dp[i] = p * (dp[i] - dl[hh]);
    }

    // dQ += dS K: dS in bf16 A-fragments, K MN-major from the stage.
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) p_fragment(dp, kk, da[kk]);
    wgmma_fence();
    product_rs<NC>(dq, da, ks);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(dq[c]);
  }

  __syncthreads();                            // every wgmma read of Q done
  store_tile<NC>(qS, dq, a.scale, r0, cq);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_store_3d(&tdq, qS + c * kSub, h * HD + c * 64, q0, b);
    tma_store_wait();
  }
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return int(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
              int causal, cudaStream_t stream) {
  // (B, S, heads*hd) bf16 as 3-D maps, innermost first; 64 x 64 boxes.
  CUtensorMap tq, tdo, tdq, tk, tv, tdk, tdv;
  const cuuint64_t qdim[3] = {cuuint64_t(H) * HD, cuuint64_t(Sq), cuuint64_t(B)};
  const cuuint64_t qstr[2] = {cuuint64_t(H) * HD * 2, cuuint64_t(Sq) * H * HD * 2};
  const cuuint64_t kdim[3] = {cuuint64_t(KV) * HD, cuuint64_t(Skv), cuuint64_t(B)};
  const cuuint64_t kstr[2] = {cuuint64_t(KV) * HD * 2, cuuint64_t(Skv) * KV * HD * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::encode_map(&tq, bf, 3, q, qdim, qstr, box, sw) ||
      !sm90::encode_map(&tdo, bf, 3, dout, qdim, qstr, box, sw) ||
      !sm90::encode_map(&tdq, bf, 3, dq, qdim, qstr, box, sw) ||
      !sm90::encode_map(&tk, bf, 3, k, kdim, kstr, box, sw) ||
      !sm90::encode_map(&tv, bf, 3, v, kdim, kstr, box, sw) ||
      !sm90::encode_map(&tdk, bf, 3, dk, kdim, kstr, box, sw) ||
      !sm90::encode_map(&tdv, bf, 3, dv, kdim, kstr, box, sw))
    return int(cudaErrorInvalidValue);

  const long rows = long(B) * Sq * H;
  const long threads = rows * (HD / 8);
  flash_bwd_delta_sm90_kernel<HD><<<unsigned((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      delta, rows, Sq, H);
  int e = int(cudaGetLastError());
  if (e) return e;

  const float scale = 1.0f / sqrtf(float(HD));
  BwdArgs a{lse, delta, Sq, Skv, H, KV, causal, scale, scale * sm90::kLog2e};
  constexpr size_t smem = smem_bytes<HD>();
  auto dkdv = flash_bwd_dkdv_sm90_kernel<HD>;
  if ((e = set_smem(dkdv, smem))) return e;
  dkdv<<<dim3((Skv + kTile - 1) / kTile, KV, B), 128, smem, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, a);
  if ((e = int(cudaGetLastError()))) return e;
  auto dqk = flash_bwd_dq_sm90_kernel<HD>;
  if ((e = set_smem(dqk, smem))) return e;
  dqk<<<dim3((Sq + kTile - 1) / kTile, H, B), 128, smem, stream>>>(
      tq, tdo, tk, tv, tdq, a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Skv,KV,hd), o and dout like q, contiguous bf16,
// 16-byte aligned; lse (B,H,Sq) f32 from the forward; delta (B,H,Sq) f32
// scratch; dq like q and dk/dv like k, written whole. hd 64 or 128.
int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             float* delta, void* dq, void* dk, void* dv, int B,
                             int Sq, int Skv, int H, int KV, int hd, int causal,
                             void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal ? 1 : 0;
  switch (hd) {
    case 64:
      return launch_hd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                           H, KV, c, s);
    case 128:
      return launch_hd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                            H, KV, c, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
