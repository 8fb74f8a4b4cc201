// Paged GQA attention on Hopper tensor cores (sm_90a): bf16 queries over a
// bf16 or int8 block-paged KV pool, for all three paged functions.
//
// Replaces, for bf16 queries, the Pallas TPU kernels
//   decode  -> repro/kernels/decode_attention/kernel.py  flash_decode_fwd
//   prefill -> repro/kernels/prefill_attention/kernel.py flash_prefill_fwd
//   verify  -> repro/kernels/verify_attention/kernel.py  flash_verify_fwd
// f32 queries, and f32 pools, keep the CUDA-core kernel in
// paged_attention.cu (the wrappers' route, by dtype; no fallback between
// them). wgmma has no full-f32 mode: TF32 keeps ~3 decimal digits and could
// not meet the f32 checks at 1e-4.
//
// The three are one function. Row r of (b, kv) is query c = r / G, head
// kv*G + r % G, at position base[b] + shift + c; it sees the pooled keys at
// positions <= its own:
//   prefill: C the chunk, base = q_start, shift 0, one split;
//   decode:  C = 1, base = lengths, shift -1 (the new token at length - 1);
//   verify:  C = T, base = pos, shift 0 (window query t at pos + t).
// Page-table entries are clamped to [0, P-1]; masked scores are -1e30; l is
// floored at 1e-20, as in the reference.
//
// What bounds it: at yi-6b's serve shapes (B 8, H 32, KV 4, hd 128, ps 16,
// 32 pages) the work is a few hundred flops a byte of the pages a request
// needs or fewer (decode: 2 G = 16 flops a K/V byte), so the floor is bytes
// (0.0015-0.0025 ms). The design: one block of one warpgroup a 64-row tile
// of a (b, kv) -- 64/G queries x G heads, which for a fixed query are
// contiguous, so the Q tile is one 5-D TMA box; queries past C are zero
// filled and never stored. Decode (8 live rows at G 8) and verify (T G =
// 40) fit one tile, which wastes wgmma rows but not bytes: each page is
// read once per (b, kv, split). K/V tiles of 64 keys are gathered page by
// page (one TMA copy a page over the pool viewed as (KV*P*ps, hd), at row
// (kv*P + phys)*ps) into a ring of two stages behind mbarriers; the next
// tile's pages are in flight while this one computes; pages wholly past the
// tile's last visible position are never loaded. bf16 pages land 128-byte
// swizzled (a page of ps rows, ps a multiple of 8, keeps the swizzle atoms
// 1,024-byte aligned). int8 pages land unswizzled in a staging ring; the
// warpgroup converts them to bf16 (exact: |x| <= 127) into the swizzled
// layout, and the row scales fold into the arithmetic: s_ij *= k_scale_j
// (f32, after the wgmma, before 1/sqrt(hd) and the mask) and p_ij *
// v_scale_j is what is rounded into the bf16 P fragment, while l sums the
// unscaled p -- the reference's k * scale and v * scale reordered, with no
// error beyond P's rounding. Scores, softmax and PV as in
// flash_attention.cu: wgmma m64n64k16 for S = Q K^T and O += P V (V
// MN-major), the online softmax in registers, in the exp2 domain (scores
// times log2(e) / sqrt(hd)).
//
// Split-KV (decode, verify; FlashDecoding): the grid is (row tiles x
// splits, KV, B) and split s owns the pages [s*pps, (s+1)*pps), pps =
// npages / splits. Its tile walk starts at the split's first key; a split
// may be narrower than a tile (batch 1 at a split budget of 32: 32 splits
// of one page), and keys past the split's end are masked like a ragged
// edge. With one split the block normalises itself (l floored at 1e-20)
// and stores bf16 by TMA through the Q tile. With more, each block writes
// its live rows' unnormalised f32 partials (o, m, l), m in the exp2 domain;
// a split with no visible key writes m = -1e30 log2(e), l = 0, o = 0. A
// second small kernel combines them in the same domain:
//   out = sum_s w_s o_s / max(sum_s w_s l_s, 1e-20),  w_s = 2^(m_s - m*).
// A row that sees no key of a split its tile visits keeps m = -1e30
// log2(e) there too, so its partial gets weight 0 beside split 0 (which
// holds position 0).
//
// Contract: hd in {64, 128, 192, 256}; ps in {8, 16, 32, 64}; G = H/KV up
// to 64; npages % splits == 0. The C entry point returns
// cudaGetLastError() after the launches; the Python wrapper raises on it.

#include <mutex>

#include "sm90_attention.cuh"

namespace {

constexpr float kNeg = -1e30f;

struct Args {
  const int* page_table;    // (B, npages)
  const int* base;          // (B,): query c sits at base + shift + c
  const float* k_scale;     // (KV, P, ps), int8 pools only
  const float* v_scale;
  float* part_o;            // (B, KV, S, C*G, hd) f32, splits > 1 only
  float* part_m;            // (B, KV, S, C*G), exp2 domain
  float* part_l;            // (B, KV, S, C*G)
  int shift, C, KV, P, ps, npages, G, qpt;   // qpt: queries a 64-row tile
  int row_tiles, num_splits;
  float scale_log2;         // 1/sqrt(hd) * log2(e)
};

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() { return uint32_t(HD / 64) * sm90::kSub; }

// bf16 pool: Q, 2 K stages, 2 V stages. int8 pool: Q, 2 K and 2 V staging
// stages of int8 (half a tile each), one converted K and V tile. Plus 1 KB
// to align the first tile to 1 KB.
template <int HD>
constexpr size_t smem_bytes() {
  return 5 * size_t(tile_bytes<HD>()) + 1024;
}

// One thread: the pages [pg0, pg0 + 64/ps) of (b, kv) that lie before the
// split's end page and at or before last_pos into one ring stage,
// completing on `bar`. Every page it skips is masked.
template <int HD, bool I8>
__device__ __forceinline__ void load_pages(const Args& a, const CUtensorMap* tk,
                                           const CUtensorMap* tv, uint8_t* kdst,
                                           uint8_t* vdst, uint64_t* bar, int pg0,
                                           int pg_end, int b, int kv,
                                           int last_pos) {
  constexpr int NC = HD / 64;
  const int ppt = sm90::kTile / a.ps;
  int n = 0;
  while (n < ppt) {
    const int pg = pg0 + n;
    if (pg >= pg_end || pg * a.ps > last_pos) break;
    ++n;
  }
  const uint32_t page_bytes = I8 ? uint32_t(a.ps) * HD : uint32_t(a.ps) * 128 * NC;
  sm90::mbar_expect_tx(bar, 2 * n * page_bytes);
  for (int i = 0; i < n; ++i) {
    int phys = a.page_table[long(b) * a.npages + pg0 + i];
    phys = min(max(phys, 0), a.P - 1);
    const int row = (kv * a.P + phys) * a.ps;
    if (I8) {
      sm90::tma_load_2d(kdst + i * a.ps * HD, tk, bar, 0, row);
      sm90::tma_load_2d(vdst + i * a.ps * HD, tv, bar, 0, row);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        sm90::tma_load_2d(kdst + c * sm90::kSub + i * a.ps * 128, tk, bar, c * 64, row);
        sm90::tma_load_2d(vdst + c * sm90::kSub + i * a.ps * 128, tv, bar, c * 64, row);
      }
    }
  }
}

// int8 rows (64 x HD, row-major) -> bf16 in the swizzled tile layout.
template <int HD>
__device__ __forceinline__ void convert_i8(const uint8_t* src, uint8_t* dst,
                                           int tid) {
  constexpr int CPR = HD / 16;               // 16-byte int8 chunks a row
  for (int idx = tid; idx < sm90::kTile * CPR; idx += 128) {
    const int j = idx / CPR, d0 = (idx % CPR) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + j * HD + d0);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = sm90::pack_bf16(float(x[2 * e]), float(x[2 * e + 1]));
    *reinterpret_cast<uint4*>(dst + sm90::swz_offset(j, d0, sm90::kTile)) =
        make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(dst + sm90::swz_offset(j, d0 + 8, sm90::kTile)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// SPLIT: write f32 partials of the live rows (splits > 1) instead of the
// normalised bf16 tile.
template <int HD, bool I8, bool SPLIT>
__global__ void __launch_bounds__(128) paged_attn_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    Args a) {
  using namespace sm90;
  constexpr int NC = HD / 64;
  constexpr uint32_t TB = tile_bytes<HD>();
  constexpr uint32_t SB = I8 ? TB / 2 : TB;   // bytes of a ring stage's tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];                // Q, stage 0, stage 1
  __shared__ float ksc[kTile], vsc[kTile];    // int8: this tile's row scales
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qS = smem;                         // also the output tile
  uint8_t* kR = qS + TB;                      // ring: 2 K stages
  uint8_t* vR = kR + 2 * SB;                  // ring: 2 V stages
  uint8_t* kB = vR + 2 * SB;                  // int8: converted K tile
  uint8_t* vB = kB + TB;                      // int8: converted V tile

  const int tile = blockIdx.x % a.row_tiles, split = blockIdx.x / a.row_tiles;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, c0 = tile * a.qpt, ppt = kTile / a.ps;
  const int base = a.base[b] + a.shift;
  const int last_pos = base + min(c0 + a.qpt, a.C) - 1;
  const int pps = a.npages / a.num_splits;
  const int pg_beg = split * pps, pg_end = pg_beg + pps;
  const int k_beg = pg_beg * a.ps, k_end = pg_end * a.ps;
  const int n_keys = min(last_pos + 1, k_end) - k_beg;   // <= 0: empty split
  const int ntiles = n_keys > 0 ? (n_keys + kTile - 1) / kTile : 0;

  if (!I8) {
    // Pages a tile skips leave their V rows unwritten; zero both stages
    // once so that p = 0 never meets a stale NaN.
    for (uint32_t i = tid * 16; i < 2 * SB; i += 128 * 16)
      *reinterpret_cast<uint4*>(vR + i) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && ntiles > 0) {
    mbar_expect_tx(&bars[0], NC * 128 * G * a.qpt);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_5d(qS + c * kSub, &tq, &bars[0], c * 64, 0, kv, c0, b);
    load_pages<HD, I8>(a, &tk, &tv, kR, vR, &bars[1], pg_beg, pg_end, b, kv,
                       last_pos);
  }

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  const float neg = kNeg * kLog2e;
  float m[2] = {neg, neg}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int rowpos[2] = {base + c0 + r0 / G, base + c0 + (r0 + 8) / G};
  const uint32_t qs = smem_u32(qS);
  if (ntiles > 0) mbar_wait(&bars[0], 0);

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();                          // tile t-1 fully used
    if (tid == 0 && t + 1 < ntiles) {
      const int st = (t + 1) & 1;
      load_pages<HD, I8>(a, &tk, &tv, kR + st * SB, vR + st * SB,
                         &bars[1 + st], pg_beg + (t + 1) * ppt, pg_end, b, kv,
                         last_pos);
    }
    const int st = t & 1, k0 = k_beg + t * kTile;
    if (I8 && tid < kTile) {                  // this tile's row scales
      const int pg = pg_beg + t * ppt + tid / a.ps;
      float ks = 0.f, vs = 0.f;
      if (pg < pg_end && pg * a.ps <= last_pos) {
        int phys = a.page_table[long(b) * a.npages + pg];
        phys = min(max(phys, 0), a.P - 1);
        const long srow = (long(kv) * a.P + phys) * a.ps + tid % a.ps;
        ks = a.k_scale[srow];
        vs = a.v_scale[srow];
      }
      ksc[tid] = ks;
      vsc[tid] = vs;
    }
    mbar_wait(&bars[1 + st], (t >> 1) & 1);
    uint32_t ks, vs;
    if (I8) {
      convert_i8<HD>(kR + st * SB, kB, tid);
      convert_i8<HD>(vR + st * SB, vB, tid);
      fence_proxy_async();
      __syncthreads();
      ks = smem_u32(kB);
      vs = smem_u32(vB);
    } else {
      ks = smem_u32(kR + st * SB);
      vs = smem_u32(vR + st * SB);
    }

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

    // Keys past the first row's position, or past the split's end (pages
    // that were not loaded), are masked.
    const bool edge = k0 + kTile - 1 > base + c0 || k0 + kTile > k_end;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + cq + (i & 1);
      float x = s[i];
      if (I8) x *= ksc[col];
      x *= a.scale_log2;
      if (edge) {
        const int key = k0 + col;
        x = (key <= rowpos[(i >> 1) & 1] && key < k_end) ? x : neg;
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
      const float p = exp2f(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;
      s[i] = I8 ? p * vsc[8 * (i >> 2) + cq + (i & 1)] : p;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

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

  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  if (SPLIT) {
    // Row r of the tile is row c0*G + r of (b, kv). Rows past C*G are
    // queries past C, and rows past G*qpt (G not dividing 64) belong to no
    // query of this tile: neither is written.
    const int R = a.C * G;
    const long pb = ((long(b) * a.KV + kv) * a.num_splits + split) * R + c0 * G;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= G * a.qpt || c0 * G + row >= R) continue;
      float* po = a.part_o + (pb + row) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * hh;
          *reinterpret_cast<float2*>(po + c * 64 + 8 * j + cq) =
              make_float2(o[c][i], o[c][i + 1]);
        }
      if ((lane & 3) == 0) {
        a.part_m[pb + row] = m[hh];
        a.part_l[pb + row] = lsum[hh];
      }
    }
    return;
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / fmaxf(lsum[hh], 1e-20f);
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
    for (int c = 0; c < NC; ++c) tma_store_5d(&to, qS + c * kSub, c * 64, 0, kv, c0, b);
    tma_store_wait();
  }
}

// The split combine: one block per (row, kv, b) of the output, two hd
// columns a thread, in the partials' exp2 domain:
// out = sum_s w_s o_s / max(sum_s w_s l_s, 1e-20), w_s = 2^(m_s - m*).
template <int HD>
__global__ void __launch_bounds__(HD / 2) paged_attn_sm90_combine(
    Args a, __nv_bfloat16* out) {
  const int R = a.C * a.G, S = a.num_splits;
  const int row = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int d = 2 * threadIdx.x;
  const long pb = (long(b) * a.KV + kv) * S * R + row;
  float m_star = kNeg * sm90::kLog2e;
  for (int s = 0; s < S; ++s) m_star = fmaxf(m_star, a.part_m[pb + long(s) * R]);
  float l_tot = 0.f, o0 = 0.f, o1 = 0.f;
  for (int s = 0; s < S; ++s) {
    const long i = pb + long(s) * R;
    const float w = exp2f(a.part_m[i] - m_star);
    const float2 x = *reinterpret_cast<const float2*>(a.part_o + i * HD + d);
    l_tot += w * a.part_l[i];
    o0 += w * x.x;
    o1 += w * x.y;
  }
  const float inv = 1.f / fmaxf(l_tot, 1e-20f);
  const int c = row / a.G, head = kv * a.G + row % a.G;
  const long h = long(a.KV) * a.G;
  *reinterpret_cast<uint32_t*>(out + ((long(b) * a.C + c) * h + head) * HD + d) =
      sm90::pack_bf16(o0 * inv, o1 * inv);
}

template <int HD, bool I8, bool SPLIT>
cudaError_t launch_attn(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, const CUtensorMap& to,
                        const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = paged_attn_sm90_kernel<HD, I8, SPLIT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(a.row_tiles * a.num_splits, a.KV, B);
  kern<<<grid, 128, smem, stream>>>(tq, tk, tv, to, a);
  return cudaGetLastError();
}

// The tensor map of a pool (KV, P, ps, hd) viewed as (KV*P*ps rows, hd), a
// box one page. A map holds only the pool's address, row count, element
// type, hd and page size, so those are its exact key; the serve path reuses
// the same pools (a K and a V a layer) every call, and a hit saves the
// host an encoding. Filled round-robin; a mutex, since ctypes calls run
// without the interpreter lock.
struct PoolMapKey {
  const void* base;
  uint64_t rows;
  int hd, ps;
  bool i8;
  bool operator==(const PoolMapKey& o) const {
    return base == o.base && rows == o.rows && hd == o.hd && ps == o.ps &&
           i8 == o.i8;
  }
};

bool pool_map(CUtensorMap* map, const PoolMapKey& key) {
  constexpr int kSlots = 256;
  static std::mutex mu;
  static PoolMapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  const cuuint64_t dim[2] = {cuuint64_t(key.hd), key.rows};
  const cuuint64_t str[1] = {cuuint64_t(key.hd) * (key.i8 ? 1 : 2)};
  const cuuint32_t box[2] = {key.i8 ? cuuint32_t(key.hd) : 64u,
                             cuuint32_t(key.ps)};
  if (!sm90::encode_map(map,
                        key.i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, key.base, dim, str, box,
                        key.i8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                               : CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  const int slot = used < kSlots ? used++ : next++ % kSlots;
  keys[slot] = key;
  maps[slot] = *map;
  return true;
}

template <int HD, bool I8>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              const Args& a, int B, int H, cudaStream_t stream) {
  using namespace sm90;
  CUtensorMap tq, tk, tv, to;
  // q/out (B, C, H, hd) as (hd, G, KV, C, B): a 64-row tile of (b, kv) is
  // one box of qpt queries x G heads.
  const cuuint64_t qdim[5] = {HD, cuuint64_t(a.G), cuuint64_t(a.KV),
                              cuuint64_t(a.C), cuuint64_t(B)};
  const cuuint64_t qstr[4] = {cuuint64_t(HD) * 2, cuuint64_t(a.G) * HD * 2,
                              cuuint64_t(H) * HD * 2, cuuint64_t(a.C) * H * HD * 2};
  const cuuint32_t qbox[5] = {64, cuuint32_t(a.G), 1, cuuint32_t(a.qpt), 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t rows = uint64_t(a.KV) * a.P * a.ps;
  const bool split = a.num_splits > 1;        // partials: no output map
  if (!encode_map(&tq, bf, 5, q, qdim, qstr, qbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (!split && !encode_map(&to, bf, 5, out, qdim, qstr, qbox,
                             CU_TENSOR_MAP_SWIZZLE_128B)) ||
      !pool_map(&tk, PoolMapKey{k, rows, HD, a.ps, I8}) ||
      !pool_map(&tv, PoolMapKey{v, rows, HD, a.ps, I8}))
    return int(cudaErrorInvalidValue);
  if (!split) return int(launch_attn<HD, I8, false>(tq, tk, tv, to, a, B, stream));
  cudaError_t e = launch_attn<HD, I8, true>(tq, tk, tv, tq, a, B, stream);
  if (e != cudaSuccess) return int(e);
  paged_attn_sm90_combine<HD><<<dim3(a.C * a.G, a.KV, B), HD / 2, 0, stream>>>(
      a, static_cast<__nv_bfloat16*>(out));
  return int(cudaGetLastError());
}

template <bool I8>
int launch_kv(const void* q, const void* k, const void* v, void* out,
              const Args& a, int B, int H, int hd, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_hd<64, I8>(q, k, v, out, a, B, H, s);
    case 128: return launch_hd<128, I8>(q, k, v, out, a, B, H, s);
    case 192: return launch_hd<192, I8>(q, k, v, out, a, B, H, s);
    case 256: return launch_hd<256, I8>(q, k, v, out, a, B, H, s);
  }
  return int(cudaErrorInvalidValue);
}

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

}  // namespace

extern "C" {

// q (B,C,H,hd) bf16; k/v (KV,P,ps,hd) bf16, or int8 with (KV,P,ps) f32
// scales; page_table (B,npages) int32; base (B,) int32: query c sees keys at
// positions <= base + shift + c. out (B,C,H,hd) bf16. With num_splits > 1,
// part_o (B,KV,S,C*G,hd), part_m and part_l (B,KV,S,C*G) f32 scratch.
int paged_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             int kv_dtype, const float* k_scale,
                             const float* v_scale, const int* page_table,
                             const int* base, int shift, int B, int C, int H,
                             int KV, int P, int ps, int hd, int npages,
                             int num_splits, void* out, float* part_o,
                             float* part_m, float* part_l, void* stream) {
  if (B < 1 || C < 1 || KV < 1 || H % KV != 0 || H / KV > 64 || P < 1 ||
      npages < 1 || (ps != 8 && ps != 16 && ps != 32 && ps != 64) ||
      B > 65535 || KV > 65535 || num_splits < 1 || npages % num_splits != 0 ||
      (num_splits > 1 && (part_o == nullptr || part_m == nullptr ||
                          part_l == nullptr)))
    return int(cudaErrorInvalidValue);
  const int G = H / KV, qpt = sm90::kTile / G;
  Args a{page_table, base, k_scale, v_scale, part_o, part_m, part_l,
         shift, C, KV, P, ps, npages, G, qpt, (C + qpt - 1) / qpt, num_splits,
         sm90::kLog2e / sqrtf(float(hd))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kBF16: return launch_kv<false>(q, k, v, out, a, B, H, hd, s);
    case kI8:
      if (k_scale == nullptr || v_scale == nullptr) break;
      return launch_kv<true>(q, k, v, out, a, B, H, hd, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
