// Paged GQA attention for Hopper (sm_90a) on CUDA cores: decode, chunked
// prefill and speculative verify over the block-paged KV pool, f32.
//
// Replaces the three Pallas TPU kernels of the reference package:
//   decode  -> repro/kernels/decode_attention/kernel.py  flash_decode_fwd
//   prefill -> repro/kernels/prefill_attention/kernel.py flash_prefill_fwd
//   verify  -> repro/kernels/verify_attention/kernel.py  flash_verify_fwd
//
// All three compute the same thing for a block of query rows: row r of
// request b, KV head kv, is query c = r / G, head kv*G + r % G, and may see
// the keys at positions <= qpos = base[b] + shift + c. Decode passes
// base = lengths, shift = -1 (C = 1); prefill passes q_start and verify pos,
// shift = 0. One block serves (row tile, split, kv, b); the TPU's
// sequential page axis becomes a loop over the split's pages inside the
// block, which keeps the f32 online softmax (m, l, acc) on chip.
//
// What bounds it: decode and verify stream the request's K/V pages once per
// (kv head, row tile) and do G or T*G rows of work per row read, far below
// the card's 295 bf16 flops per byte, so they are bound by bytes. The
// design reads each page once per block as a contiguous ps x hd tile
// (4 KB in bf16 at 16 x 128), dequantizes int8 rows with their f32 scale at
// load, and skips pages wholly past the tile's last visible position.
// Prefill tiles its rows over the grid, at most 32 rows a block, so each
// tile skips the pages past its own last position. This version uses CUDA
// cores and shared memory only, and now serves f32 only: every call with
// bf16 q over a bf16 or int8 pool -- decode, prefill and verify alike --
// runs on the tensor cores in paged_attention_sm90.cu (wgmma + TMA, split-KV
// for decode and verify), and this kernel takes f32 q or an f32 pool, since
// wgmma has no full-f32 mode (TF32 could not meet the f32 checks at 1e-4).
//
// Split-KV (decode, verify): each split writes an unnormalised partial
// (acc, m, l) and a second small kernel combines them (FlashDecoding). With
// one split the block normalises itself, with l floored at 1e-20, which is
// what the prefill kernel always does.
//
// Masking follows the reference bit for bit where it matters: masked scores
// are -1e30 (not -inf), page-table entries are clamped to [0, P-1], and q is
// scaled by 1/sqrt(hd) before the dot.
//
// Tile contract: hd a multiple of 32, 32 <= hd <= 256 (one thread per hd
// column); any page_size up to 64; any G, C. The C entry points return
// cudaGetLastError() after the launches; the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const int8_t* p, long i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

struct Args {
  const void* q;            // (B, C, H, hd)
  const void* k;            // (KV, P, ps, hd)
  const void* v;
  const float* k_scale;     // (KV, P, ps), int8 pools only
  const float* v_scale;
  const int* page_table;    // (B, npages)
  const int* base;          // (B,)
  void* out;                // (B, C, H, hd), q's dtype
  float* part_o;            // (B, KV, S, R, hd)  split partials
  float* part_m;            // (B, KV, S, R)
  float* part_l;            // (B, KV, S, R)
  int shift;
  int B, C, H, KV, P, ps, hd, npages, num_splits;
  float scale;
};

// Shared memory: q tile (R_TILE x hd+1), K page (ps x hd+1), V page
// (ps x hd), scores (R_TILE x ps+1), then m, l, alpha (R_TILE each). The +1
// pads keep the score loop's column reads free of bank conflicts.
template <int R_TILE>
size_t smem_bytes(int ps, int hd) {
  return sizeof(float) * (size_t(R_TILE) * (hd + 1) + size_t(ps) * (hd + 1) +
                          size_t(ps) * hd + size_t(R_TILE) * (ps + 1) +
                          3 * R_TILE);
}

template <typename QT, typename KT, int R_TILE>
__global__ void paged_attn_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ps = a.ps, G = a.H / a.KV, R = a.C * G;
  const int row_tiles = (R + R_TILE - 1) / R_TILE;
  const int tile = blockIdx.x % row_tiles;
  const int split = blockIdx.x / row_tiles;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;               // == hd column
  const int row0 = tile * R_TILE;

  float* qS = smem;                               // R_TILE x (hd+1)
  float* kS = qS + R_TILE * (hd + 1);             // ps x (hd+1)
  float* vS = kS + ps * (hd + 1);                 // ps x hd
  float* sS = vS + ps * hd;                       // R_TILE x (ps+1)
  float* mS = sS + R_TILE * (ps + 1);
  float* lS = mS + R_TILE;
  float* aS = lS + R_TILE;

  const QT* q = static_cast<const QT*>(a.q);
  const KT* kp = static_cast<const KT*>(a.k);
  const KT* vp = static_cast<const KT*>(a.v);
  const int base = a.base[b] + a.shift;

  // Query tile, pre-scaled by 1/sqrt(hd) in f32 like the reference.
  for (int r = 0; r < R_TILE; ++r) {
    const int row = row0 + r;
    float x = 0.f;
    if (row < R) {
      const int c = row / G, head = kv * G + row % G;
      x = load_f(q, ((long(b) * a.C + c) * a.H + head) * hd + tid) * a.scale;
    }
    qS[r * (hd + 1) + tid] = x;
  }
  if (tid < R_TILE) {
    mS[tid] = kNeg;
    lS[tid] = 0.f;
  }
  float acc[R_TILE];
#pragma unroll
  for (int r = 0; r < R_TILE; ++r) acc[r] = 0.f;

  // Last position any row of this tile may see: pages past it are skipped.
  const int last_row = min(row0 + R_TILE, R) - 1;
  const int tile_max_pos = base + last_row / G;
  const int pps = a.npages / a.num_splits;
  const long page_elems = long(ps) * hd;

  for (int pi = 0; pi < pps; ++pi) {
    const int pg = split * pps + pi;
    const int start = pg * ps;
    if (start > tile_max_pos) break;          // uniform across the block
    int phys = a.page_table[long(b) * a.npages + pg];
    phys = min(max(phys, 0), a.P - 1);
    const long page_off = (long(kv) * a.P + phys) * page_elems;
    __syncthreads();                           // previous page fully used
    for (int j = 0; j < ps; ++j) {
      float kx = load_f(kp, page_off + long(j) * hd + tid);
      float vx = load_f(vp, page_off + long(j) * hd + tid);
      if (a.k_scale != nullptr) {
        const long srow = (long(kv) * a.P + phys) * ps + j;
        kx *= a.k_scale[srow];
        vx *= a.v_scale[srow];
      }
      kS[j * (hd + 1) + tid] = kx;
      vS[j * hd + tid] = vx;
    }
    __syncthreads();
    // Scores: one (row, key) pair per thread at a time.
    for (int idx = tid; idx < R_TILE * ps; idx += blockDim.x) {
      const int r = idx / ps, j = idx % ps;
      const float* qr = qS + r * (hd + 1);
      const float* kj = kS + j * (hd + 1);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kj[d], s);
      const int qpos = base + (row0 + r) / G;
      sS[r * (ps + 1) + j] = (start + j <= qpos) ? s : kNeg;
    }
    __syncthreads();
    // Online softmax statistics, one thread per row.
    if (tid < R_TILE) {
      float* sr = sS + tid * (ps + 1);
      const float m_prev = mS[tid];
      float mx = sr[0];
      for (int j = 1; j < ps; ++j) mx = fmaxf(mx, sr[j]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      lS[tid] = lS[tid] * alpha + sum;
      mS[tid] = m_new;
      aS[tid] = alpha;
    }
    __syncthreads();
    // P @ V: this thread's hd column for every row of the tile.
#pragma unroll
    for (int r = 0; r < R_TILE; ++r) {
      const float* pr = sS + r * (ps + 1);
      float x = acc[r] * aS[r];
      for (int j = 0; j < ps; ++j) x = fmaf(pr[j], vS[j * hd + tid], x);
      acc[r] = x;
    }
  }
  __syncthreads();

  if (a.num_splits == 1) {
    QT* out = static_cast<QT*>(a.out);
#pragma unroll
    for (int r = 0; r < R_TILE; ++r) {
      const int row = row0 + r;
      if (row >= R) break;
      const int c = row / G, head = kv * G + row % G;
      store_f(out, ((long(b) * a.C + c) * a.H + head) * hd + tid,
              acc[r] / fmaxf(lS[r], 1e-20f));
    }
  } else {
    const long pbase = ((long(b) * a.KV + kv) * a.num_splits + split) * R;
#pragma unroll
    for (int r = 0; r < R_TILE; ++r) {
      const int row = row0 + r;
      if (row >= R) break;
      a.part_o[(pbase + row) * hd + tid] = acc[r];
      if (tid == 0) {
        a.part_m[pbase + row] = mS[r];
        a.part_l[pbase + row] = lS[r];
      }
    }
  }
}

// Associative split combine: one block per (row, kv, b), one thread per hd
// column. out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-20), w_s = e^(m_s-m*).
template <typename QT>
__global__ void combine_kernel(Args a) {
  const int G = a.H / a.KV, R = a.C * G, S = a.num_splits;
  const int row = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long pbase = (long(b) * a.KV + kv) * S * R + row;
  float m_star = kNeg;
  for (int s = 0; s < S; ++s) m_star = fmaxf(m_star, a.part_m[pbase + long(s) * R]);
  float l_tot = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const long i = pbase + long(s) * R;
    const float w = expf(a.part_m[i] - m_star);
    l_tot += w * a.part_l[i];
    acc += w * a.part_o[i * a.hd + tid];
  }
  const int c = row / G, head = kv * G + row % G;
  store_f(static_cast<QT*>(a.out), ((long(b) * a.C + c) * a.H + head) * a.hd + tid,
          acc / fmaxf(l_tot, 1e-20f));
}

template <typename QT, typename KT, int R_TILE>
int launch_tile(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KV, R = a.C * G;
  const int row_tiles = (R + R_TILE - 1) / R_TILE;
  const size_t smem = smem_bytes<R_TILE>(a.ps, a.hd);
  auto kern = paged_attn_kernel<QT, KT, R_TILE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  dim3 grid(row_tiles * a.num_splits, a.KV, a.B);
  kern<<<grid, a.hd, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.num_splits == 1) return int(e);
  combine_kernel<QT><<<dim3(R, a.KV, a.B), a.hd, 0, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_kv(const Args& a, cudaStream_t stream) {
  const int R = a.C * (a.H / a.KV);
  if (R <= 8) return launch_tile<QT, KT, 8>(a, stream);
  if (R <= 16) return launch_tile<QT, KT, 16>(a, stream);
  return launch_tile<QT, KT, 32>(a, stream);
}

template <typename QT>
int launch_q(const Args& a, int kv_dtype, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch_kv<QT, float>(a, stream);
    case kBF16: return launch_kv<QT, __nv_bfloat16>(a, stream);
    case kI8: return launch_kv<QT, int8_t>(a, stream);
  }
  return int(cudaErrorInvalidValue);
}

int launch(const void* q, int q_dtype, const void* k, const void* v,
           int kv_dtype, const float* k_scale, const float* v_scale,
           const int* page_table, const int* base, int shift, int B, int C,
           int H, int KV, int P, int ps, int hd, int npages, int num_splits,
           void* out, float* part_o, float* part_m, float* part_l,
           void* stream) {
  if (hd % 32 != 0 || hd < 32 || hd > 256 || ps < 1 || ps > 64 ||
      KV < 1 || H % KV != 0 || num_splits < 1 || npages % num_splits != 0)
    return int(cudaErrorInvalidValue);
  Args a{q, k, v, k_scale, v_scale, page_table, base, out, part_o, part_m,
         part_l, shift, B, C, H, KV, P, ps, hd, npages, num_splits,
         1.0f / sqrtf(float(hd))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return launch_q<float>(a, kv_dtype, s);
    case kBF16: return launch_q<__nv_bfloat16>(a, kv_dtype, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B,H,hd); lengths (B,): keys at positions < length are visible.
int paged_decode_fwd(const void* q, int q_dtype, const void* k, const void* v,
                     int kv_dtype, const float* k_scale, const float* v_scale,
                     const int* page_table, const int* lengths, int B, int H,
                     int KV, int P, int ps, int hd, int npages, int num_splits,
                     void* out, float* part_o, float* part_m, float* part_l,
                     void* stream) {
  return launch(q, q_dtype, k, v, kv_dtype, k_scale, v_scale, page_table,
                lengths, -1, B, 1, H, KV, P, ps, hd, npages, num_splits, out,
                part_o, part_m, part_l, stream);
}

// q (B,C,H,hd); q_start (B,): query c sees keys at positions <= q_start + c.
int paged_prefill_fwd(const void* q, int q_dtype, const void* k, const void* v,
                      int kv_dtype, const float* k_scale, const float* v_scale,
                      const int* page_table, const int* q_start, int B, int C,
                      int H, int KV, int P, int ps, int hd, int npages,
                      void* out, void* stream) {
  return launch(q, q_dtype, k, v, kv_dtype, k_scale, v_scale, page_table,
                q_start, 0, B, C, H, KV, P, ps, hd, npages, 1, out, nullptr,
                nullptr, nullptr, stream);
}

// q (B,T,H,hd); pos (B,): window query t sees keys at positions <= pos + t.
int paged_verify_fwd(const void* q, int q_dtype, const void* k, const void* v,
                     int kv_dtype, const float* k_scale, const float* v_scale,
                     const int* page_table, const int* pos, int B, int T,
                     int H, int KV, int P, int ps, int hd, int npages,
                     int num_splits, void* out, float* part_o, float* part_m,
                     float* part_l, void* stream) {
  return launch(q, q_dtype, k, v, kv_dtype, k_scale, v_scale, page_table, pos,
                0, B, T, H, KV, P, ps, hd, npages, num_splits, out, part_o,
                part_m, part_l, stream);
}

}  // extern "C"
