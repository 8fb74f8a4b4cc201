// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), bf16, on
// tensor cores (wgmma + TMA).
//
// The port's own kernel: the TPU package has no backward Pallas kernel
// (repro/models/ssm.py differentiates its jnp chunked scan with XLA). It is
// the backward of csrc/ssd_scan.cu's bf16 route (ssd_sm90_kernel, which
// replaces repro/kernels/mamba_scan/kernel.py ssd_scan) from a zero initial
// state; the f32 route keeps csrc/ssd_scan_bwd.cu (CUDA cores: wgmma has no
// full-f32 mode). It computes the function that file's header sets out,
// per (batch, head), with la the chunk's inclusive cumulative sum of dt a,
// G[l][m] = exp(la_l - la_m) on and below the diagonal (exp taken only
// there), CBG = (C_l . B_m) G, XDY[l][m] = dy_l . x_m, Q = XDY G dt_m, R =
// CBG XDY, s_m = exp(la_last - la_m) dt_m, h the state entering a chunk and
// dh' the gradient of the state leaving it:
//   dx_m = dt_m [ (CBG^T dy)_m + exp(la_last - la_m) (B dh')_m ]
//   dC_l = exp(la_l) (dy h^T)_l + (Q B)_l
//   dB_m = dt_m [ (XDY^T G^T C)_m + exp(la_last - la_m) (x dh'^T)_m ]
//   rowS_l = sum_{m<l} R[l][m] dt_m, colS_m = sum_{l>m} R[l][m], diag_m =
//   R[m][m], U_m = exp(la_last - la_m) x_m . (B dh')_m, V_l = C_l . dC's
//   state term; dla and ddt as in ssd_scan_bwd.cu (R's diagonal and
//   dt_last U_last left out of dla, not added and taken away).
//
// What bounds it: at Zamba2's training shape (B 8, S 1024, H 64, N = P =
// 64, chunk 128) a call must move ~210 MB (0.063 ms at 3.35 TB/s) and do
// ~39 GFLOP (0.039 ms on bf16 tensor cores): bytes. The CUDA-core walk took
// 3.9 ms there, held by issue: f32 FMAs fed by broadcast shared-memory
// reads, one 218 KB block an SM walking a (batch, head)'s chunks in order,
// C B^T recomputed for every head, thread 0 alone on the dla loop. Here
// everything but the state and its gradient is local to a chunk, so the
// backward is three launches, none with atomics (two calls give equal
// bits):
//
// 1. ssd_bwd_walk_sm90_kernel, one warpgroup a (head, batch, direction):
//    direction 0 carries h across the chunks in order, direction 1 dh
//    across them in reverse (from dh_final or zero), each update on wgmma
//    with the state as the accumulator: h <- exp(la_last) h + B^T (s x).
//    The f32 row scales are folded into B (or C), which go in as
//    A-fragments from registers, each value as two bf16 parts (hi =
//    bf16(v), lo = bf16(v - hi), one wgmma each, ~2^-18 relative); x (or
//    dy), exact in bf16, is the shared-memory operand. Each chunk's state
//    is written as such a hi/lo pair, (B, H, NC, 4, N, P) bf16, for the
//    body's TMA. The tiles arrive by TMA through a three-stage ring, two
//    chunks ahead; 1,024 blocks at the training shape, two an SM.
// 2. ssd_bwd_body_sm90_kernel, a block of two warpgroups a (group of HB
//    heads, chunk, batch): 512 blocks at the training shape with HB 8.
//    B and C arrive once by TMA; each head's x, dy and h, dh' pairs (64
//    KB) through a two-stage mbarrier ring, 128-byte swizzled (the layout
//    of sm90_attention.cuh), the next head's copy in flight during this
//    one's products. Warpgroup w owns chunk rows 64w..64w+63, first as the
//    rows l of dC (the "query" side: dy h^T, dy x^T, C B^T, Q B over key
//    tiles at or left of the diagonal), then as the rows m of dx and dB
//    (the "key" side: B dh', x dh'^T, x dy^T, B C^T, CBG^T dy, XDY^T G^T C
//    over tiles at or right of it), so each warpgroup runs three 64 x 64
//    tiles of the triangle and the column sums of R are row sums of R^T:
//    no cross-warp reduction. Every product is an m64n64k16 wgmma with f32
//    accumulators; independent products share a commit group. h and dh'
//    enter as their pairs (two wgmmas); Q, CBG^T and XDY^T G^T, which feed
//    only the bf16 outputs, are rounded once to bf16 A-fragments
//    (tests/test_torch_ssd_bwd_sm90.py holds the emulated rounding to 2e-2
//    of each gradient's max under strong decay and at gradients above 4);
//    R, U, V and <h, dh'>, which reach ddt and da_log, stay f32. dB (in
//    registers) and dC (f32 in shared memory, 32 values a thread) are
//    summed over the group's heads in head order, so the partials are (B,
//    S, H / HB, N) f32. After the heads, warp j takes head j's dla, its
//    reverse cumulative sum (a warp scan) and ddt, and a per-(batch,
//    chunk) da_log partial.
// 3. ssd_bwd_sums_kernel: dB and dC summed over head groups in order, and
//    da_log over (batch, chunk) in order.
//
// Where this departs from the plan of chunk-parallel states, one C B^T a
// chunk and more than one body block an SM: (1) the chunk-local states
// and a separate carry pass moved ~500 MB at the training shape (0.197 ms
// on an H100); the walk moves ~270 MB (0.19 ms, two chunks of TMA in
// flight a block). (2) C B^T and B C^T are recomputed for every head (8
// of a warpgroup's ~68 wgmmas a head): keeping the three tiles and their
// transposes across heads takes 96 registers a thread. (3) The body holds
// ~200 registers a thread in its phases (64 x 64 f32 tiles are 32
// registers each) and 222 KB of shared memory at HB 8: one block an SM;
// two would need 128 registers. It uses 255 registers and spills 12
// bytes. HB 8 took 0.28 ms of body time against HB 4's 0.30 (fewer
// partial bytes, B and C loaded once for 8 heads).
//
// Masks: a chunk's tile is 64 * ceil(L/64) rows from its start, so a
// shorter chunk's tile holds the next chunk's rows, and a ragged last
// chunk's rows past S are zero-filled by TMA. G is zero off m <= l < Lc
// (Lc the chunk's own rows), which zeroes every product over the other
// rows; the row scales are zero past Lc, and stores stop there. Tiles
// wholly past Lc are neither loaded nor multiplied.
//
// Contract: N = P = 64, 1 <= chunk <= 128, any S (a ragged last chunk of S
// - c0 rows), HB in 1, 2, 4, 8 dividing H. The C entry point returns the
// first nonzero cudaGetLastError() of its launches (cudaErrorInvalidValue
// for a shape outside the contract); the Python wrapper raises on it.

#include <algorithm>

#include "sm90_attention.cuh"

namespace {

using sm90::kSub;
constexpr int kT = 256;                 // threads: two warpgroups
constexpr int kRows = 128;              // rows of a chunk tile (L <= 128)
constexpr int kW = 64;                  // N = P = 64
constexpr int kState = kW * kW;         // elements of an N x P state
constexpr uint32_t kTileBytes = 2 * kSub;   // 128 rows x 128 bytes
constexpr uint32_t kStageBytes = 2 * kTileBytes + 4 * kSub;  // x, dy, pairs

struct BwdArgs {
  const float* dt;         // (B, S, H)
  const float* a_log;      // (H,)
  const float* dh_final;   // (B, H, N, P) or null (zero)
  __nv_bfloat16* pairs;    // (B, H, NC, 4, N, P): h hi, h lo, dh' hi, dh' lo
  float* db_part;          // (B, S, G, N)
  float* dc_part;          // (B, S, G, N)
  float* da_part;          // (B, NC, H)
  __nv_bfloat16* dx;       // (B, S, H, P)
  float* ddt;              // (B, S, H)
  float* da_log;           // (H,)
  __nv_bfloat16* db;       // (B, S, N)
  __nv_bfloat16* dc;       // (B, S, N)
  int B, S, H, L, NC, HB;  // L: the chunk; G = H / HB
};

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint64_t kmaj(uint32_t a) {    // K-major operand
  return sm90::desc_sw128(a, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmaj(uint32_t a) {   // MN-major operand
  return sm90::desc_sw128(a, kSub, 1024);
}

// 2^x by the SFU alone (relative error ~2^-22, results below 2^-126
// flushed to 0), for G's exponentials.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two bf16 values of a swizzled 64-row sub-tile (row r, columns col and
// col + 1) as floats.
__device__ __forceinline__ float2 tile_pair(const uint8_t* sub, int r, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(sub + sm90::swz_offset(r, col, 64)));
}

// One warp: head hw's dt over the chunk's Lc rows (zero past them) and la
// in the exp2 domain (flat past them): a run of ceil(Lc/32) rows a lane,
// then a shuffle scan over the lanes' totals.
__device__ __forceinline__ void head_scan(const BwdArgs& a, int b, int hw,
                                          int c0, int Lc, float* la,
                                          float* dtv, int lane) {
  const float A2 = -expf(a.a_log[hw]) * sm90::kLog2e;
  const int per = (Lc + 31) / 32, lo = min(Lc, lane * per), hi = min(Lc, lo + per);
  float run = 0.f;
  for (int l = lo; l < hi; ++l) {
    const float d = a.dt[(long(b) * a.S + c0 + l) * a.H + hw];
    dtv[l] = d;
    run += d * A2;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.f;
  for (int l = lo; l < hi; ++l) {
    acc += dtv[l] * A2;
    la[l] = acc;
  }
  __syncwarp();
  const float last = la[Lc - 1];
  for (int l = Lc + lane; l < kRows; l += 32) {
    la[l] = last;
    dtv[l] = 0.f;
  }
  __syncwarp();
}

// One thread: `nk` 64-row boxes at chunk row c0 of a 3-D (cols, S, B) map,
// column col, into consecutive sub-tiles of dst.
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int nk, int col,
                                          int c0, int b) {
  for (int s = 0; s < nk; ++s)
    sm90::tma_load_3d(dst + s * kSub, map, bar, col, c0 + 64 * s, b);
}

// v as its bf16 hi/lo pair: hi at plane, lo one state (kState) further.
__device__ __forceinline__ void put_pair(__nv_bfloat16* plane, float2 v) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(hi);
  reinterpret_cast<__nv_bfloat162*>(plane)[0] = hi;
  reinterpret_cast<__nv_bfloat162*>(plane + kState)[0] =
      __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
}

// ---------------------------------------------------------------------------
// 1. the states and state gradients at the chunk boundaries
// ---------------------------------------------------------------------------

constexpr int kWalkStages = 3;          // the walk's ring: two chunks ahead
constexpr int kWalkScan = 4;            // chunks whose la one scan round takes

// The ring's stages (a chunk's x or dy tile and its B or C tile each), la
// and dt of kWalkScan chunks; 1 KB to align.
constexpr size_t kWalkSmem =
    kWalkStages * 2 * size_t(kTileBytes) + kWalkScan * 2 * 4 * kRows + 1024;

// One warpgroup a (head, batch, direction): direction 0 walks the chunks in
// order carrying h (h <- exp(la_last) h + B^T (s x)), direction 1 walks
// them in reverse carrying dh (dh <- exp(la_last) dh + C^T (exp(la) dy),
// from dh_final or zero). The state is f32 in registers, in the
// accumulator layout (rows n, columns p), and is the wgmma accumulator of
// its own update; it is written as its bf16 hi/lo pair before the chunk's
// update. The row scales are folded into B (or C), which goes in as
// A-fragments, each value as a hi/lo pair. Each chunk's tiles arrive by
// TMA two chunks ahead; the warps take la for four chunks at a time.
__global__ void __launch_bounds__(128, 2) ssd_bwd_walk_sm90_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
    const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
    BwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[kWalkStages];
  uint8_t* ring = align_1k(smem_raw);          // stage s: x or dy, then B or C
  float* laS = reinterpret_cast<float*>(ring + kWalkStages * 2 * kTileBytes);
  float* dtS = laS + kWalkScan * kRows;        // kWalkScan x 128 each

  const int h = blockIdx.x, b = blockIdx.y, rev = blockIdx.z;
  const int NC = a.NC, L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const CUtensorMap* mw = rev ? &tc : &tb;
  const CUtensorMap* mv = rev ? &tdy : &tx;
  auto chunk0 = [&](int k) { return (rev ? NC - 1 - k : k) * L; };
  auto load = [&](int k) {                     // the walk's k-th chunk
    const int c0 = chunk0(k), nk = (min(L, a.S - c0) + 63) / 64;
    uint8_t* st = ring + (k % kWalkStages) * 2 * kTileBytes;
    uint64_t* bar = &bars[k % kWalkStages];
    mbar_expect_tx(bar, 2 * nk * kSub);
    load_rows(st, mv, bar, nk, h * kW, c0, b);
    load_rows(st + kTileBytes, mw, bar, nk, 0, c0, b);
  };
  if (tid == 0) {
    for (int i = 0; i < kWalkStages; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // the walk's last chunk is never loaded: its state is written, not updated
  if (tid == 0)
    for (int k = 0; k < min(kWalkStages - 1, NC - 1); ++k) load(k);

  float st[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = r0 + 8 * ((i >> 1) & 1), p = 8 * (i >> 2) + cq + (i & 1);
    st[i] = rev && a.dh_final
                ? a.dh_final[(long(b) * a.H + h) * kState + n * kW + p]
                : 0.f;
  }

  for (int k = 0; k < NC; ++k) {
    const int c0 = chunk0(k), c = c0 / L;
    const int Lc = min(L, a.S - c0), nk = (Lc + 63) / 64;
    __syncthreads();                           // chunk k-1's stage and la used
    if (k % kWalkScan == 0) {
      const int kw = k + warp;
      if (kw < NC) {
        const int w0 = chunk0(kw);
        head_scan(a, b, h, w0, min(L, a.S - w0), laS + warp * kRows,
                  dtS + warp * kRows, lane);
      }
      __syncthreads();
    }
    if (tid == 0 && k + kWalkStages - 1 < NC - 1) load(k + kWalkStages - 1);
    // the pair of h entering chunk c (or of dh leaving it)
    __nv_bfloat16* plane =
        a.pairs + (((long(b) * a.H + h) * NC + c) * 4 + 2 * rev) * kState;
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      put_pair(plane + (r0 + 8 * ((i >> 1) & 1)) * kW + 8 * (i >> 2) + cq,
               make_float2(st[i], st[i + 1]));
    if (rev ? c == 0 : c + 1 == NC) break;     // the last update is not needed
    const uint8_t* stage = ring + (k % kWalkStages) * 2 * kTileBytes;
    const uint8_t* src = stage + kTileBytes;
    const float* la = laS + (k % kWalkScan) * kRows;
    const float* dtv = dtS + (k % kWalkScan) * kRows;
    const float last = la[Lc - 1];
    mbar_wait(&bars[k % kWalkStages], (k / kWalkStages) & 1);
    // A-fragment entries of (B^T or C^T) diag(scale): rows n = r0, r0 + 8,
    // columns (time) l = 16 kk + 8 (jj >> 1) + cq + {0, 1}
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float sc[4];                             // time steps l0, +1, +8, +9
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = 16 * kk + cq + (e & 1) + 8 * (e >> 1);
        sc[e] = l < Lc ? (rev ? exp2f(la[l]) : exp2f(last - la[l]) * dtv[l]) : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = r0 + 8 * (jj & 1), l = 16 * kk + 8 * (jj >> 1) + cq;
        const uint8_t* sub = src + (l >> 6) * kSub;
        const float w0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                             sub + swz_offset(l & 63, n, 64))) * sc[2 * (jj >> 1)];
        const float w1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                             sub + swz_offset((l + 1) & 63, n, 64))) * sc[2 * (jj >> 1) + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(w0, w1);
        const float2 hf = __bfloat1622float2(h2);
        hi[kk][jj] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[kk][jj] = pack_bf16(w0 - hf.x, w1 - hf.y);
      }
    }
    const float decay = exp2f(last);
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] *= decay;
    const uint32_t op = smem_u32(stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < 4 * nk) {
        const uint64_t d = mnmaj(op + (kk >> 2) * kSub + (kk & 3) * 2048);
        wgmma_rs_t(st, hi[kk], d);
        wgmma_rs_t(st, lo[kk], d);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(st);
  }
}

// ---------------------------------------------------------------------------
// 3. the chunk body
// ---------------------------------------------------------------------------

// The per-head vectors, each HB x 128 floats: la (exp2 domain, flat past
// Lc), dt (zero past Lc), rowS, V, colS, diag, U.
enum Vec { kLa, kDt, kRow, kV, kCol, kDiag, kU, kVecs };

// B, C, two stages of (x, dy, four pair sub-tiles), dC's f32 accumulators
// (32 a thread), then per head la, dt, rowS, V, colS, diag, U (128 each)
// and 8 warp partials of <h, dh'>; 1 KB to align.
size_t body_smem_bytes(int hb) {
  return 2 * size_t(kTileBytes) + 2 * size_t(kStageBytes) + 32 * 4 * kT +
         size_t(hb) * (kVecs * 4 * kRows + 8 * 4) + 1024;
}

struct Head {                 // one head's stage and vectors
  uint32_t xs, ys, ps;        // x, dy and the pairs (shared addresses)
  const uint8_t* x;           // the x tile (generic, for U's dot)
  float* vec;                 // this head's la; vector k at vec + k * stride
  int stride;                 // HB * 128
  __device__ float* at(Vec k) const { return vec + int(k) * stride; }
};

// Rows l = 64 WG + r of dC (added to this thread's 32 accumulators in
// shared memory, dcs[i * kT]) over key tiles q <= WG, rowS and V: t =
// exp(la_l) dy h^T (V_l = C_l . t_l), then t += Q B a key tile at a time,
// Q = XDY . G . dt_m rounded to bf16 A-fragments. dy h^T goes in one
// commit group with the first tile's XDY and C B^T.
template <int WG>
__device__ __forceinline__ void rows_l(float* dcs, const Head& hd,
                                       uint32_t bs, uint32_t cs,
                                       const uint8_t* cgen, int Lc, int r0,
                                       int cq, int lane) {
  using namespace sm90;
  const int rA = 64 * WG + r0, rB = rA + 8;
  const float laA = hd.at(kLa)[rA], laB = hd.at(kLa)[rB];
  float t[32], vA = 0.f, vB = 0.f, rowA = 0.f, rowB = 0.f;
#pragma unroll
  for (int q = 0; q <= WG; ++q) {
    float xdy[32], cb[32];
    wgmma_fence();
    if (q == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(t, kmaj(hd.ys + WG * kSub + kk * 32), kmaj(hd.ps + kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(t, kmaj(hd.ys + WG * kSub + kk * 32), kmaj(hd.ps + kSub + kk * 32), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss(xdy, kmaj(hd.ys + WG * kSub + kk * 32), kmaj(hd.xs + q * kSub + kk * 32), kk > 0);
      wgmma_ss(cb, kmaj(cs + WG * kSub + kk * 32), kmaj(bs + q * kSub + kk * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(t);
    fence_regs(xdy);
    fence_regs(cb);
    if (q == 0) {
      const float eA = rA < Lc ? exp2f(laA) : 0.f, eB = rB < Lc ? exp2f(laB) : 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hi = (i >> 1) & 1;
        const float2 cv = tile_pair(cgen + WG * kSub, r0 + 8 * hi, 8 * (i >> 2) + cq);
        const float e = hi ? eB : eA;
        t[i] *= e;
        t[i + 1] *= e;
        const float p = fmaf(t[i + 1], cv.y, t[i] * cv.x);
        if (hi) vB += p; else vA += p;
      }
    }
    uint32_t qf[4][4];
#pragma unroll
    for (int u = 0; u < 8; ++u) {              // keys 64q + 8u + cq + {0, 1}
      const int col = 64 * q + 8 * u + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(hd.at(kLa) + col);
      const float2 d2 = *reinterpret_cast<const float2*>(hd.at(kDt) + col);
      const float lk[2] = {l2.x, l2.y}, dk[2] = {d2.x, d2.y};
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = 4 * u + 2 * hi, row = hi ? rB : rA;
        const float lr = hi ? laB : laA;
        float qv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = col + e;
          const float g = (m <= row && row < Lc) ? ex2_approx(lr - lk[e]) : 0.f;
          const float r = cb[i + e] * g * xdy[i + e];
          if (m < row) {
            if (hi) rowB = fmaf(r, dk[e], rowB);
            else rowA = fmaf(r, dk[e], rowA);
          }
          qv[e] = xdy[i + e] * g * dk[e];
        }
        qf[u >> 1][(i >> 1) & 3] = pack_bf16(qv[0], qv[1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t(t, qf[kk], mnmaj(bs + q * kSub + kk * 2048));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(t);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dcs[i * kT] += t[i];
  vA = quad_sum(vA);
  vB = quad_sum(vB);
  rowA = quad_sum(rowA);
  rowB = quad_sum(rowB);
  if ((lane & 3) == 0) {
    hd.at(kV)[rA] = vA; hd.at(kV)[rB] = vB;
    hd.at(kRow)[rA] = rowA; hd.at(kRow)[rB] = rowB;
  }
}

// Rows m = 64 WG + r of dx (stored) and dB (added to dba) over tiles q >=
// WG, colS, diag and U. First dx: tx = exp(la_last - la_m) B dh' (U_m =
// exp(la_last - la_m) x_m . (B dh')_m; B dh' goes in one commit group with
// the first tile's x dy^T and B C^T), then tx += CBG^T dy a tile at a
// time, dx = dt_m tx; the tiles' XDY^T G^T are kept as bf16 A-fragments.
// Then dB: tb = exp(la_last - la_m) x dh'^T, tb += (XDY^T G^T) C over the
// tiles, dB += dt_m tb.
template <int WG>
__device__ __forceinline__ void rows_m(float (&dba)[32], const Head& hd,
                                       uint32_t bs, uint32_t cs, int Lc,
                                       int r0, int cq, int lane,
                                       __nv_bfloat16* dxrow, long dxstride) {
  using namespace sm90;
  const int rA = 64 * WG + r0, rB = rA + 8;
  const float laA = hd.at(kLa)[rA], laB = hd.at(kLa)[rB], last = hd.at(kLa)[Lc - 1];
  const float emA = rA < Lc ? exp2f(last - laA) : 0.f;
  const float emB = rB < Lc ? exp2f(last - laB) : 0.f;
  float tx[32], uA = 0.f, uB = 0.f, colA = 0.f, colB = 0.f, dgA = 0.f, dgB = 0.f;
  uint32_t xf[2][4][4];                        // XDY^T G^T of tile q
#pragma unroll
  for (int q = WG; q < 2; ++q) {
    if (64 * q >= Lc) break;
    float xt[32], cbt[32];
    wgmma_fence();
    if (q == WG) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_tb(tx, kmaj(bs + WG * kSub + kk * 32), mnmaj(hd.ps + 2 * kSub + kk * 2048), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_tb(tx, kmaj(bs + WG * kSub + kk * 32), mnmaj(hd.ps + 3 * kSub + kk * 2048), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss(xt, kmaj(hd.xs + WG * kSub + kk * 32), kmaj(hd.ys + q * kSub + kk * 32), kk > 0);
      wgmma_ss(cbt, kmaj(bs + WG * kSub + kk * 32), kmaj(cs + q * kSub + kk * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(tx);
    fence_regs(xt);
    fence_regs(cbt);
    if (q == WG) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hi = (i >> 1) & 1;
        const float2 xv = tile_pair(hd.x + WG * kSub, r0 + 8 * hi, 8 * (i >> 2) + cq);
        const float p = fmaf(tx[i + 1], xv.y, tx[i] * xv.x);
        if (hi) uB += p; else uA += p;
        const float em = hi ? emB : emA;
        tx[i] *= em;
        tx[i + 1] *= em;
      }
    }
    uint32_t cf[4][4];
#pragma unroll
    for (int u = 0; u < 8; ++u) {              // time steps 64q + 8u + cq + {0, 1}
      const int col = 64 * q + 8 * u + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(hd.at(kLa) + col);
      const float lk[2] = {l2.x, l2.y};
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = 4 * u + 2 * hi, row = hi ? rB : rA;
        const float lm = hi ? laB : laA;
        float cv[2], xv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int l = col + e;
          const float g = (row <= l && l < Lc) ? ex2_approx(lk[e] - lm) : 0.f;
          const float cbg = cbt[i + e] * g;
          const float r = cbg * xt[i + e];
          if (l > row) {
            if (hi) colB += r; else colA += r;
          } else if (l == row) {
            if (hi) dgB += r; else dgA += r;
          }
          cv[e] = cbg;
          xv[e] = xt[i + e] * g;
        }
        cf[u >> 1][(i >> 1) & 3] = pack_bf16(cv[0], cv[1]);
        xf[q][u >> 1][(i >> 1) & 3] = pack_bf16(xv[0], xv[1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t(tx, cf[kk], mnmaj(hd.ys + q * kSub + kk * 2048));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(tx);
  }
  const float dtA = hd.at(kDt)[rA], dtB = hd.at(kDt)[rB];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = (i >> 1) & 1 ? rB : rA;
    const float d = (i >> 1) & 1 ? dtB : dtA;
    if (row < Lc)
      *reinterpret_cast<uint32_t*>(dxrow + row * dxstride + 8 * (i >> 2) + cq) =
          pack_bf16(d * tx[i], d * tx[i + 1]);
  }
  float tb[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(tb, kmaj(hd.xs + WG * kSub + kk * 32), kmaj(hd.ps + 2 * kSub + kk * 32), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(tb, kmaj(hd.xs + WG * kSub + kk * 32), kmaj(hd.ps + 3 * kSub + kk * 32), 1);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(tb);
#pragma unroll
  for (int i = 0; i < 32; ++i) tb[i] *= (i >> 1) & 1 ? emB : emA;
  wgmma_fence();
#pragma unroll
  for (int q = WG; q < 2; ++q) {
    if (64 * q >= Lc) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t(tb, xf[q][kk], mnmaj(cs + q * kSub + kk * 2048));
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(tb);
#pragma unroll
  for (int i = 0; i < 32; ++i) dba[i] = fmaf((i >> 1) & 1 ? dtB : dtA, tb[i], dba[i]);
  uA = emA * quad_sum(uA);
  uB = emB * quad_sum(uB);
  colA = quad_sum(colA);
  colB = quad_sum(colB);
  dgA = quad_sum(dgA);
  dgB = quad_sum(dgB);
  if ((lane & 3) == 0) {
    hd.at(kU)[rA] = uA; hd.at(kU)[rB] = uB;
    hd.at(kCol)[rA] = colA; hd.at(kCol)[rB] = colB;
    hd.at(kDiag)[rA] = dgA; hd.at(kDiag)[rB] = dgB;
  }
}

__global__ void __launch_bounds__(kT, 1) ssd_bwd_body_sm90_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
    const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tp, BwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];                 // B/C, ring stage 0, stage 1
  uint8_t* bS = align_1k(smem_raw);
  uint8_t* cS = bS + kTileBytes;
  uint8_t* stS = cS + kTileBytes;              // 2 stages: x, dy, 4 pair tiles
  const int HB = a.HB, vs = HB * kRows;
  float* dcS = reinterpret_cast<float*>(stS + 2 * kStageBytes);  // 32 x kT
  float* laS = dcS + 32 * kT;                  // kVecs vectors of HB x 128
  float* dtS = laS + kDt * vs;
  float* hdhS = laS + kVecs * vs;              // HB x 8 warp partials

  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = g * HB, NC = a.NC, S = a.S, H = a.H, G = H / HB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int c0 = c * a.L, Lc = min(a.L, S - c0), nk = (Lc + 63) / 64;
  const int r0 = (warp & 3) * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const bool has_rows = 64 * wg < Lc;          // warpgroup 1 idles if Lc <= 64

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const CUtensorMap *mx = &tx, *mdy = &tdy, *mp = &tp;
  auto load_head = [&](int j) {
    uint64_t* bar = &bars[1 + (j & 1)];
    uint8_t* st = stS + (j & 1) * kStageBytes;
    mbar_expect_tx(bar, (2 * nk + 4) * kSub);
    load_rows(st, mx, bar, nk, (h0 + j) * kW, c0, b);
    load_rows(st + kTileBytes, mdy, bar, nk, (h0 + j) * kW, c0, b);
    const int prow = int(((long(b) * H + h0 + j) * NC + c) * 4 * kW);
    for (int k = 0; k < 4; ++k)
      tma_load_2d(st + 2 * kTileBytes + k * kSub, mp, bar, 0, prow + k * kW);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * nk * kSub);
    load_rows(bS, &tb, &bars[0], nk, 0, c0, b);
    load_rows(cS, &tc, &bars[0], nk, 0, c0, b);
    load_head(0);
  }
  if (warp < HB)
    head_scan(a, b, h0 + warp, c0, Lc, laS + warp * kRows, dtS + warp * kRows, lane);
  __syncthreads();
  mbar_wait(&bars[0], 0);

  const uint32_t bs = smem_u32(bS), cs = smem_u32(cS);
  float* dcs = dcS + tid;                      // this thread's dC accumulators
  float dba[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dcs[i * kT] = 0.f;
    dba[i] = 0.f;
  }
  for (int j = 0; j < HB; ++j) {
    if (j > 0) __syncthreads();                // head j-1 done with its stage
    if (tid == 0 && j + 1 < HB) load_head(j + 1);
    mbar_wait(&bars[1 + (j & 1)], (j >> 1) & 1);
    const uint8_t* st = stS + (j & 1) * kStageBytes;
    const uint32_t sts = smem_u32(st);
    const Head hd{sts, sts + kTileBytes, sts + 2 * kTileBytes, st,
                  laS + j * kRows, vs};
    if (has_rows) {
      __nv_bfloat16* dxrow = a.dx + (long(b) * S + c0) * H * kW + long(h0 + j) * kW;
      if (wg == 0) {
        rows_l<0>(dcs, hd, bs, cs, cS, Lc, r0, cq, lane);
        rows_m<0>(dba, hd, bs, cs, Lc, r0, cq, lane, dxrow, long(H) * kW);
      } else {
        rows_l<1>(dcs, hd, bs, cs, cS, Lc, r0, cq, lane);
        rows_m<1>(dba, hd, bs, cs, Lc, r0, cq, lane, dxrow, long(H) * kW);
      }
    }
    // <h, dh'> over the pairs: 16 elements a thread (the tiles share one
    // swizzle, so equal offsets hold equal (n, p))
    {
      const uint8_t* pp = st + 2 * kTileBytes;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int off = (tid * 2 + k) * 16;
        const uint4 q[4] = {*reinterpret_cast<const uint4*>(pp + off),
                            *reinterpret_cast<const uint4*>(pp + kSub + off),
                            *reinterpret_cast<const uint4*>(pp + 2 * kSub + off),
                            *reinterpret_cast<const uint4*>(pp + 3 * kSub + off)};
        const __nv_bfloat162* v[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) v[w] = reinterpret_cast<const __nv_bfloat162*>(&q[w]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 hh = __bfloat1622float2(v[0][e]), hl = __bfloat1622float2(v[1][e]);
          const float2 dh = __bfloat1622float2(v[2][e]), dl = __bfloat1622float2(v[3][e]);
          s = fmaf(hh.x + hl.x, dh.x + dl.x, s);
          s = fmaf(hh.y + hl.y, dh.y + dl.y, s);
        }
      }
      s = warp_sum(s);
      if (lane == 0) hdhS[j * 8 + warp] = s;
    }
  }

  // the group's dC (rows l) and dB (rows m) partials, f32
  if (has_rows) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = 64 * wg + r0 + 8 * ((i >> 1) & 1);
      if (row < Lc) {
        const long o = ((long(b) * S + c0 + row) * G + g) * kW + 8 * (i >> 2) + cq;
        *reinterpret_cast<float2*>(a.dc_part + o) =
            make_float2(dcs[i * kT], dcs[(i + 1) * kT]);
        *reinterpret_cast<float2*>(a.db_part + o) = make_float2(dba[i], dba[i + 1]);
      }
    }
  }
  __syncthreads();

  // warp j: head j's dla, its reverse cumulative sum, ddt and da_log's
  // partial, each lane a run of ceil(Lc/32) rows
  if (warp < HB) {
    const int j = warp, hw = h0 + j;
    const float A = -expf(a.a_log[hw]);
    const float* la = laS + j * kRows;
    const float* dtv = la + kDt * vs;
    const float *row = la + kRow * vs, *v = la + kV * vs,
                *col = la + kCol * vs, *dg = la + kDiag * vs, *u = la + kU * vs;
    float hdh = 0.f;
    for (int w = 0; w < 8; ++w) hdh += hdhS[j * 8 + w];
    const int per = (Lc + 31) / 32, lo = min(Lc, lane * per), hi = min(Lc, lo + per);
    const int k = Lc - 1;
    float su = 0.f;                            // sum_{m<last} dt_m U_m
    for (int m = lo; m < min(hi, k); ++m) su = fmaf(dtv[m], u[m], su);
    su = warp_sum(su);
    auto dla = [&](int i) {
      float d = row[i] - dtv[i] * col[i] + v[i];
      return d + (i == k ? exp2f(la[k]) * hdh + su : -dtv[i] * u[i]);
    };
    float seg = 0.f;
    for (int i = lo; i < hi; ++i) seg += dla(i);
    float incl = seg;                          // sum over lanes >= this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    float run = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) run = 0.f;
    float da = 0.f;
    for (int i = hi - 1; i >= lo; --i) {
      run += dla(i);
      a.ddt[(long(b) * S + c0 + i) * H + hw] = col[i] + dg[i] + u[i] + A * run;
      da = fmaf(dtv[i], run, da);
    }
    da = warp_sum(da);
    if (lane == 0) a.da_part[(long(b) * NC + c) * H + hw] = A * da;
  }
}

// ---------------------------------------------------------------------------
// 4. the sums over head groups and over (batch, chunk)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) ssd_bwd_sums_kernel(BwdArgs a) {
  const long i = long(blockIdx.x) * 256 + threadIdx.x;
  const int G = a.H / a.HB;
  if (i < long(a.B) * a.S * kW) {
    const long bs = i / kW;
    const int n = int(i % kW);
    const float* pb = a.db_part + bs * G * kW + n;
    const float* pc = a.dc_part + bs * G * kW + n;
    float sb = 0.f, sc = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      sb += pb[long(gg) * kW];
      sc += pc[long(gg) * kW];
    }
    a.db[i] = __float2bfloat16(sb);
    a.dc[i] = __float2bfloat16(sc);
  }
  if (i < a.H) {
    float s = 0.f;
    for (long bc = 0; bc < long(a.B) * a.NC; ++bc) s += a.da_part[bc * a.H + i];
    a.da_log[i] = s;
  }
}

int launch(const void* x, const void* bm, const void* cm, const void* dy,
           const BwdArgs& a, cudaStream_t stream) {
  // x and dy as (B, S, H*P), B and C as (B, S, N), the pairs as rows of 64
  // (B*H*NC*4*N, P), bf16, innermost first; boxes of 64 rows x 64 columns.
  CUtensorMap tx, tdy, tb, tc, tp;
  const cuuint64_t xdim[3] = {cuuint64_t(a.H) * kW, cuuint64_t(a.S), cuuint64_t(a.B)};
  const cuuint64_t xstr[2] = {cuuint64_t(a.H) * kW * 2, cuuint64_t(a.S) * a.H * kW * 2};
  const cuuint64_t ndim[3] = {cuuint64_t(kW), cuuint64_t(a.S), cuuint64_t(a.B)};
  const cuuint64_t nstr[2] = {cuuint64_t(kW) * 2, cuuint64_t(a.S) * kW * 2};
  const cuuint64_t pdim[2] = {cuuint64_t(kW), cuuint64_t(a.B) * a.H * a.NC * 4 * kW};
  const cuuint64_t pstr[1] = {cuuint64_t(kW) * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::encode_map(&tx, bf, 3, x, xdim, xstr, box, sw) ||
      !sm90::encode_map(&tdy, bf, 3, dy, xdim, xstr, box, sw) ||
      !sm90::encode_map(&tb, bf, 3, bm, ndim, nstr, box, sw) ||
      !sm90::encode_map(&tc, bf, 3, cm, ndim, nstr, box, sw) ||
      !sm90::encode_map(&tp, bf, 2, a.pairs, pdim, pstr, box, sw))
    return int(cudaErrorInvalidValue);
  const size_t bsm = body_smem_bytes(a.HB);
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_walk_sm90_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(kWalkSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_body_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(bsm));
  if (e != cudaSuccess) return int(e);
  ssd_bwd_walk_sm90_kernel<<<dim3(a.H, a.B, 2), 128, kWalkSmem, stream>>>(
      tx, tdy, tb, tc, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  ssd_bwd_body_sm90_kernel<<<dim3(a.H / a.HB, a.NC, a.B), kT, bsm, stream>>>(
      tx, tdy, tb, tc, tp, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  const long outs = std::max(long(a.B) * a.S * kW, long(a.H));
  ssd_bwd_sums_kernel<<<unsigned((outs + 255) / 256), 256, 0, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, bm, cm, dy, dx, db, dc bf16 in the forward's layouts; dt, a_log,
// dh_final (null: zero), ddt, da_log f32; work an f32 scratch of
// B*H*NC*8193 + 128*B*S*(H/head_block) floats (NC = ceil(S / chunk)): the
// state pairs, the dB and dC partials, da_log's; all contiguous. N = P =
// 64, 1 <= chunk <= 128, any S, head_block in 1, 2, 4, 8 dividing H.
int ssd_scan_bwd_sm90(const void* x, const void* bm, const void* cm,
                      const float* dt, const float* a_log, const void* dy,
                      const float* dh_final, float* work, void* dx, float* ddt,
                      float* da_log, void* db, void* dc, int B, int S, int H,
                      int p, int n, int chunk, int head_block, void* stream) {
  if (B < 1 || S < 1 || H < 1 || p != kW || n != kW || chunk < 1 ||
      chunk > kRows || B > 65535 ||
      (head_block != 1 && head_block != 2 && head_block != 4 && head_block != 8) ||
      H % head_block != 0)
    return int(cudaErrorInvalidValue);
  const int NC = (S + chunk - 1) / chunk;
  if (NC > 65535 || long(B) * H * NC * 4 * kW > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  const long bhnc = long(B) * H * NC;
  const long part = long(B) * S * (H / head_block) * kW;
  float* db_part = work + bhnc * 2 * kState;   // after the bf16 pairs
  BwdArgs a{dt, a_log, dh_final, reinterpret_cast<__nv_bfloat16*>(work),
            db_part, db_part + part, db_part + 2 * part,
            static_cast<__nv_bfloat16*>(dx), ddt, da_log,
            static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc),
            B, S, H, chunk, NC, head_block};
  return launch(x, bm, cm, dy, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
