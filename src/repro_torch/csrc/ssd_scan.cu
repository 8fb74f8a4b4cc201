// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces repro/kernels/mamba_scan/kernel.py ssd_scan (the Pallas TPU
// kernel). Inputs x (B,S,H,P), dt (B,S,H) f32, a_log (H,) f32, B and C
// (B,S,N) shared across heads; the state starts at zero. Outputs y
// (B,S,H,P) in x's dtype and, unlike the TPU kernel, the final state h
// (B,H,N,P) f32, which the serve engine keeps as the decode cache.
// With a = -exp(a_log[h]) and, within a chunk of L steps, la the inclusive
// cumulative sum of dt * a:
//   y[l]  = exp(la_l) C_l . h + sum_{m<=l} (C_l . B_m) exp(la_l - la_m) dt_m x_m
//   h    <- exp(la_last) h + sum_l exp(la_last - la_l) dt_l B_l x_l^T
// The D-skip and the gate stay outside, as in the reference.
//
// The TPU kernel runs the chunk axis as the sequential innermost grid axis
// and keeps the state in VMEM scratch across grid steps. Hopper blocks run
// in no order, so here a block walks its chunks in order itself. Two
// kernels, chosen by dtype (the wrapper's route, ssd_route; no fallback
// between them):
//
// bf16 -> ssd_sm90_kernel (wgmma + TMA). What bounds it: at the serve
// path's shapes (B 8, S 256, H 64, L 128, N = P = 64) a call moves ~43 MB
// (x and y, the final state, dt, B and C once each: 0.0128 ms at 3.35
// TB/s) and, with C B^T formed once for the heads that share it, does ~4
// GFLOP (0.004 ms of tensor time): ~100 flops a byte, under the card's
// ~295, so the floor is bytes. What held the CUDA-core version (below) at
// 70x that floor was issue: f32 FMAs, each fed by a broadcast shared-memory
// read, and C B^T recomputed for every head. The design:
// - One block of two warpgroups (256 threads) a (batch, group of HB
//   heads); HB (1, 2 or 4, the wrapper's choice) makes B*H/HB blocks fill
//   the 132 SMs (HB 4 at B 8, H 64: 128 blocks). The block walks the
//   (chunk, head) steps in order: chunks outer, the group's heads inner.
// - TMA brings each step's x tile (L x P, one box a 64 rows of the
//   (P*H, S, B) view) and, on a chunk's first step, its C and B tiles
//   (L x N) through a ring of two stages, each completing on an mbarrier,
//   128-byte swizzled (the layout of sm90_attention.cuh); the next step's
//   load is in flight while this one computes. Rows past S are zero-filled.
// - Once a chunk, for all HB heads: C B^T on wgmma, C and B both K-major
//   from shared memory; warpgroup w owns rows 64w..64w+63 and only the key
//   tiles at or left of the diagonal (w = 0: one 64 x 64 tile, w = 1: two),
//   kept in f32 registers across the group's heads.
// - Once a chunk, for all HB heads: dt's column and la (a warp a head,
//   a warp scan), kept in shared memory in the exp2 domain.
// - Per head: W = C B^T . exp2(la_l - la_m) . dt_m in the accumulator
//   layout, the lower triangle only (exp is never taken above the
//   diagonal, where la_l - la_m > 0 can overflow) and rows and keys past L
//   masked; each thread's la and dt columns are read into registers first
//   and the exponentials run on the SFU's ex2.approx (2^-22). W goes into
//   W x as two bf16 A-fragments, hi = bf16(W) and lo = bf16(W - hi), one
//   wgmma each with x MN-major from the stage (as V in flash attention), a
//   64-key tile at a time. The pair keeps W to ~2^-16: W rounded once to
//   bf16 (2^-9, as P) moves outputs above 4, where a bf16 ulp is 0.031,
//   onto the neighbouring bf16 value often enough to break the 2e-2 the
//   checks hold bf16 outputs to (tests/test_torch_ssd_sm90.py holds the
//   emulated pair to it on outputs up to ~13). Before W x, the carried
//   term C h on wgmma (C K-major, h's bf16 copy MN-major), skipped on the
//   first chunk, scaled by exp2(la_l).
//   y goes to shared memory in bf16 and out as 16-byte stores of the rows
//   below L (a ragged chunk's tile overlaps the next chunk's rows, which a
//   TMA store would overwrite).
// - State update on wgmma: x is scaled in place by s_l = exp2(la_last -
//   la_l) dt_l and rounded to bf16 (rows past L zeroed), then h =
//   exp2(la_last) h + B^T (s x) with B^T read MN-major from the B tile
//   (both operands transposed). The warpgroup j % 2 owns head j's state:
//   f32 in shared memory in its accumulator order, plus the bf16 copy C h
//   reads (swizzled, state-row-major); the last chunk writes h_final in
//   f32 from registers.
// The other added roundings (h's copy for C h, s x) are each 2^-9
// relative, as P's in flash attention. Shared memory at HB 4: C, B and x
// in two buffers each (96 KB), y staging (16 KB), the states (HB x 24 KB),
// la, dt and s (HB x 1.5 KB): 215 KB, one block an SM. Contract: N = P =
// 64, any chunk 1 <= L <= 128, H % HB == 0, any S: a ragged last chunk
// (S % L rows) keeps the boxes of a full one, TMA zero-filling them past S,
// and takes its own row count Lc for every mask above, la's scan and its
// last value (the state decay exp2(la[Lc-1]) and s).
// On an H100 (700 W) it takes 0.0384 ms at the serve shape, 3.0x the byte
// floor (chip_smoke.py). Each step still runs its phases one after the
// other, two block barriers apart: W on CUDA cores (the larger share, on
// warpgroup 1, which owns two key tiles), the x scaling, and the state
// update on one warpgroup while the other waits.
//
// f32 -> ssd_kernel (CUDA cores). wgmma has no full-f32 mode (TF32 keeps
// ~3 decimal digits, short of the f32 checks at 1e-4), so f32 keeps the
// first version: one block of 8 warps a (batch, head) walks its chunks
// with the (N,P) f32 state in shared memory for the whole walk. Per chunk
// it stages x, B, C and dt in shared memory (L rows, fewer in a ragged last
// chunk), takes the cumulative log-decay with a warp scan, forms W = (C B^T) . exp(segsum) . dt (L x L,
// lower triangle), writes y = exp(la) (C h) + W x and then updates the
// state, each phase a register tile: lane = output column (two columns a
// thread, 64 a warp), warp = a stride of output rows, the row operand a
// broadcast shared-memory read. Contract: 1 <= chunk <= 128, any S, N <=
// 128, and the staged chunk must fit in 227 KB of shared memory (true at
// L = 128 for N, P <= 64).
//
// The C entry points return cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape outside the contract); the Python
// wrapper raises on it.

#include "sm90_attention.cuh"

namespace {

constexpr int NT = 256;          // threads a block
constexpr int NW = NT / 32;      // warps
constexpr int MAXR = 16;         // rows a warp: L/NW and N/NW <= 16
constexpr int MAX_SMEM = 232448; // bytes a block may use on Hopper

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ void store_f(float* p, long i, float x) { p[i] = x; }

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
  const int LC = a.L, N = a.N, P = a.P;  // LC: the chunk, the layout's rows
  float* hS = smem;                    // N x P
  float* bS = hS + N * P;              // LC x (N+1)
  float* cS = bS + LC * (N + 1);       // LC x N
  float* xS = cS + LC * N;             // LC x P
  float* wS = xS + LC * P;             // L x L of this chunk
  float* laS = wS + LC * LC;           // LC
  float* dtS = laS + LC;               // LC
  float* sS = dtS + LC;                // LC

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* x = static_cast<const T*>(a.x);
  const T* bm = static_cast<const T*>(a.bm);
  const T* cm = static_cast<const T*>(a.cm);
  T* y = static_cast<T*>(a.y);
  const float A = -expf(a.a_log[h]);
  const long st_base = (long(b) * a.H + h) * N * P;

  for (int i = tid; i < N * P; i += NT) hS[i] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += LC) {
    // This chunk's rows: LC, or fewer for a ragged last chunk (S % LC).
    const int L = min(LC, a.S - c0);
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

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kT = 256;                 // threads: two warpgroups
constexpr int kRows = 128;              // rows of a chunk tile (L <= 128)
constexpr int kState = 64;              // N = P = 64
constexpr uint32_t kTileBytes = 2 * sm90::kSub;   // 128 rows x 128 bytes
// The thread that issues the TMA loads: warpgroup 1's first, which waits
// at a chunk's start while warpgroup 0's warps take la.
constexpr int kIssuer = 128;

struct Sm90Args {
  __nv_bfloat16* y;     // (B, S, H, P)
  const float* dt;      // (B, S, H)
  const float* a_log;   // (H,)
  float* h_final;       // (B, H, N, P)
  int S, H, L, HB;
};

// C, B and x in two buffers each, y staging, then per head of the group
// the bf16 state copy, the f32 state and la, dt, s; plus 1 KB to align the
// first tile to 1 KB.
size_t sm90_smem_bytes(int hb) {
  return 7 * size_t(kTileBytes) +
         size_t(hb) * (sm90::kSub + 4 * kState * kState + 3 * 4 * kRows) + 1024;
}

// One thread: step (chunk c, head j)'s x tile (and on j == 0 the chunk's C
// and B tiles), `nsub` boxes of 64 rows each, into one ring stage.
__device__ __forceinline__ void load_step(uint8_t* xdst, uint8_t* cdst,
                                          uint8_t* bdst, const CUtensorMap* tx,
                                          const CUtensorMap* tc,
                                          const CUtensorMap* tb, uint64_t* bar,
                                          int nsub, int col, int row, int b,
                                          bool with_cb) {
  sm90::mbar_expect_tx(bar, uint32_t(nsub * (with_cb ? 3 : 1)) * sm90::kSub);
  for (int s = 0; s < nsub; ++s) {
    sm90::tma_load_3d(xdst + s * sm90::kSub, tx, bar, col, row + 64 * s, b);
    if (with_cb) {
      sm90::tma_load_3d(cdst + s * sm90::kSub, tc, bar, 0, row + 64 * s, b);
      sm90::tma_load_3d(bdst + s * sm90::kSub, tb, bar, 0, row + 64 * s, b);
    }
  }
}

// C B^T for warpgroup WG = NQ - 1's 64 rows over key tiles 0 .. NQ-1.
template <int NQ>
__device__ __forceinline__ void chunk_cb(float (&cb)[2][32], uint32_t cs,
                                         uint32_t bs) {
  using namespace sm90;
  constexpr int WG = NQ - 1;
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(cb[q], desc_sw128(cs + WG * kSub + kk * 32, 16, 1024),
               desc_sw128(bs + q * kSub + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int q = 0; q < NQ; ++q) fence_regs(cb[q]);
}

// 2^x by the SFU alone (relative error ~2^-22, results below 2^-126
// flushed to 0), for W's exponentials, the kernel's most frequent
// instruction chain: exp2f adds range handling W does not need, since W
// is rounded far coarser.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// y for one head over warpgroup WG = NQ - 1's rows: exp2(la) C h (if
// `carry`), plus W x with W = C B^T . exp2(la_l - la_m) . dt_m on the
// lower triangle of rows and keys below L. W goes into the product as two
// bf16 A-fragments, hi = bf16(W) and lo = bf16(W - hi), one wgmma each, a
// key tile at a time (so one tile's fragments are live at once). la (exp2
// domain) and dt: this head's L values in shared memory.
template <int NQ>
__device__ __forceinline__ void head_y(const float (&cb)[2][32],
                                       float (&acc)[32], uint32_t cs,
                                       uint32_t hs, uint32_t xs,
                                       const float* la, const float* dt,
                                       int L, bool carry, int r0, int cq) {
  using namespace sm90;
  constexpr int WG = NQ - 1;
  const int rA = 64 * WG + r0, rB = rA + 8;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (carry) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tb(acc, desc_sw128(cs + WG * kSub + kk * 32, 16, 1024),
                  desc_sw128(hs + kk * 2048, kSub, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    const float eA = rA < L ? exp2f(la[rA]) : 0.f;
    const float eB = rB < L ? exp2f(la[rB]) : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= ((i >> 1) & 1) ? eB : eA;
  }
  const float lA = rA < L ? la[rA] : 0.f, lB = rB < L ? la[rB] : 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    // this thread's 16 key columns 64q + 8u + cq + {0, 1}: la and dt in
    // registers before the 32 exponentials
    float lc[16], dc[16];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float2 l2 = *reinterpret_cast<const float2*>(la + 64 * q + 8 * u + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + 64 * q + 8 * u + cq);
      lc[2 * u] = l2.x; lc[2 * u + 1] = l2.y;
      dc[2 * u] = d2.x; dc[2 * u + 1] = d2.y;
    }
    uint32_t whi[4][4], wlo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool hi = (i >> 1) & 1;
      const int row = hi ? rB : rA;
      const float lr = hi ? lB : lA;
      const int u = i >> 2, col = 64 * q + 8 * u + cq;
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        w[e] = (col + e <= row && row < L)
                   ? cb[q][i + e] * ex2_approx(lr - lc[2 * u + e]) * dc[2 * u + e]
                   : 0.f;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(w[0], w[1]);
      const float2 hf = __bfloat1622float2(h2);
      whi[i >> 3][(i >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&h2);
      wlo[i >> 3][(i >> 1) & 3] = pack_bf16(w[0] - hf.x, w[1] - hf.y);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = desc_sw128(xs + q * kSub + kk * 2048, kSub, 1024);
      wgmma_rs_t(acc, whi[kk], dx);
      wgmma_rs_t(acc, wlo[kk], dx);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  }
}

// h (+)= B^T (s x) over NK k-steps of 16 time steps: B^T and s x both
// MN-major (time-major tiles).
template <int NK>
__device__ __forceinline__ void state_mma(float (&h)[32], uint32_t bs,
                                          uint32_t xs) {
  using namespace sm90;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_ss_tab(h, desc_sw128(bs + kk * 2048, kSub, 1024),
                 desc_sw128(xs + kk * 2048, kSub, 1024), 1);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(h);
}

__global__ void __launch_bounds__(kT, 1) ssd_sm90_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tc, Sm90Args a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int L = a.L, HB = a.HB, S = a.S, H = a.H;
  uint8_t* cS = smem;                          // 2 buffers (by chunk)
  uint8_t* bS = cS + 2 * kTileBytes;           // 2 buffers (by chunk)
  uint8_t* xS = bS + 2 * kTileBytes;           // 2 stages (by step)
  uint8_t* yS = xS + 2 * kTileBytes;           // a 64-row sub-tile a warpgroup
  uint8_t* hB = yS + kTileBytes;               // HB bf16 states, swizzled
  float* hF = reinterpret_cast<float*>(hB + HB * kSub);  // HB f32 states
  float* laS = hF + HB * kState * kState;      // HB x 128, exp2 domain
  float* dtS = laS + HB * kRows;
  float* sS = dtS + HB * kRows;

  const int g = blockIdx.x, b = blockIdx.y, h0 = g * HB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, t128 = tid & 127;
  const int r0 = (warp & 3) * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int nsub = (L + 63) / 64;              // 64-row boxes a tile
  const int nchunks = (S + L - 1) / L, steps = nchunks * HB;
  const bool has_rows = 64 * wg < L;           // warpgroup 1 idles if L <= 64

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == kIssuer)
    load_step(xS, cS, bS, &tx, &tc, &tb, &bars[0], nsub, h0 * kState, 0, b, true);

  float cb[2][32];
  for (int t = 0; t < steps; ++t) {
    const int c = t / HB, j = t - c * HB, h = h0 + j, c0 = c * L;
    // This chunk's rows: L, or S - c0 for a ragged last chunk. The boxes
    // stay nsub deep (TMA zero-fills rows past S); everything below masks,
    // and takes la's last value, at Lc.
    const int Lc = min(L, S - c0);
    __syncthreads();                           // step t-1 done with its buffers
    if (tid == kIssuer && t + 1 < steps) {
      const int c1 = (t + 1) / HB, j1 = t + 1 - c1 * HB;
      load_step(xS + ((t + 1) & 1) * kTileBytes, cS + (c1 & 1) * kTileBytes,
                bS + (c1 & 1) * kTileBytes, &tx, &tc, &tb, &bars[(t + 1) & 1],
                nsub, (h0 + j1) * kState, c1 * L, b, j1 == 0);
    }
    if (j == 0) {
      // la = inclusive cumsum of dt * A (exp2 domain), dt and the state
      // weights s for every head of the group: warp w < HB, head h0 + w.
      if (warp < HB) {
        const int hw = h0 + warp;
        const float A = -expf(a.a_log[hw]) * kLog2e;
        const int per = (Lc + 31) / 32, lo = min(Lc, lane * per),
                  hi = min(Lc, lo + per);
        float* la = laS + warp * kRows;
        float* dtw = dtS + warp * kRows;
        float run = 0.f;
        for (int l = lo; l < hi; ++l) {
          const float d = a.dt[(long(b) * S + c0 + l) * H + hw];
          dtw[l] = d;
          run += d * A;
        }
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        float acc = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) acc = 0.f;
        for (int l = lo; l < hi; ++l) {
          acc += dtw[l] * A;
          la[l] = acc;
        }
        __syncwarp();
        const float last = la[Lc - 1];
        for (int l = lo; l < hi; ++l)
          sS[warp * kRows + l] = exp2f(last - la[l]) * dtw[l];
      }
      __syncthreads();
    }
    mbar_wait(&bars[t & 1], (t >> 1) & 1);
    const uint32_t cs = smem_u32(cS + (c & 1) * kTileBytes);
    const uint32_t bs = smem_u32(bS + (c & 1) * kTileBytes);
    uint8_t* xstage = xS + (t & 1) * kTileBytes;
    const uint32_t xs = smem_u32(xstage);
    const float* la = laS + j * kRows;

    if (has_rows) {
      if (j == 0) {
        if (wg == 0) chunk_cb<1>(cb, cs, bs);
        else chunk_cb<2>(cb, cs, bs);
      }
      float acc[32];
      const uint32_t hs = smem_u32(hB + j * kSub);
      if (wg == 0) head_y<1>(cb, acc, cs, hs, xs, la, dtS + j * kRows, Lc, c > 0, r0, cq);
      else head_y<2>(cb, acc, cs, hs, xs, la, dtS + j * kRows, Lc, c > 0, r0, cq);
      // y in bf16: swizzled staging, then 16-byte stores of rows below Lc.
      uint8_t* ys = yS + wg * kSub;
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<uint32_t*>(
            ys + swz_offset(r0 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + cq, 64)) =
            pack_bf16(acc[i], acc[i + 1]);
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int idx = it * 128 + t128, r = idx >> 3, ch = idx & 7;
        const int l = 64 * wg + r;
        if (l < Lc)
          *reinterpret_cast<uint4*>(a.y + ((long(b) * S + c0 + l) * H + h) * kState +
                                    8 * ch) =
              *reinterpret_cast<const uint4*>(ys + r * 128 + ((ch ^ (r & 7)) << 4));
      }
    }
    __syncthreads();                           // every wgmma read of x done

    // x <- bf16(s x) in place, rows past Lc zeroed.
    const float* sj = sS + j * kRows;
    for (int k = tid; k < nsub * 512; k += kT) {
      const int row = k >> 3;
      const float sv = row < Lc ? sj[row] : 0.f;
      uint4* p4 = reinterpret_cast<uint4*>(xstage + 16 * k);
      uint4 v = *p4;
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
        w[e] = pack_bf16(f.x * sv, f.y * sv);
      }
      *p4 = v;
    }
    fence_proxy_async();
    __syncthreads();

    if (wg == (j & 1)) {
      // h = exp2(la_last) h + B^T (s x); the f32 state in this warpgroup's
      // accumulator order.
      float hacc[32];
      float* hf = hF + j * kState * kState;
      const float decay = exp2f(la[Lc - 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) hacc[i] = c > 0 ? decay * hf[i * 128 + t128] : 0.f;
      if (nsub == 2) state_mma<8>(hacc, bs, xs);
      else state_mma<4>(hacc, bs, xs);
      if (c + 1 < nchunks) {
        uint8_t* hb = hB + j * kSub;
#pragma unroll
        for (int i = 0; i < 32; ++i) hf[i * 128 + t128] = hacc[i];
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          *reinterpret_cast<uint32_t*>(
              hb + swz_offset(r0 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + cq, 64)) =
              pack_bf16(hacc[i], hacc[i + 1]);
        fence_proxy_async();
      } else {
        float* hg = a.h_final + (long(b) * H + h) * kState * kState;
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          *reinterpret_cast<float2*>(hg + (r0 + 8 * ((i >> 1) & 1)) * kState +
                                     8 * (i >> 2) + cq) =
              make_float2(hacc[i], hacc[i + 1]);
      }
    }
  }
}

int launch_sm90(const void* x, const void* bm, const void* cm, Sm90Args a,
                int B, cudaStream_t stream) {
  // x as (B, S, H*P), B and C as (B, S, N), bf16, innermost first; boxes of
  // 64 rows x 64 columns.
  CUtensorMap tx, tb, tc;
  const cuuint64_t xdim[3] = {cuuint64_t(a.H) * kState, cuuint64_t(a.S), cuuint64_t(B)};
  const cuuint64_t xstr[2] = {cuuint64_t(a.H) * kState * 2,
                              cuuint64_t(a.S) * a.H * kState * 2};
  const cuuint64_t ndim[3] = {cuuint64_t(kState), cuuint64_t(a.S), cuuint64_t(B)};
  const cuuint64_t nstr[2] = {cuuint64_t(kState) * 2, cuuint64_t(a.S) * kState * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::encode_map(&tx, bf, 3, x, xdim, xstr, box, sw) ||
      !sm90::encode_map(&tb, bf, 3, bm, ndim, nstr, box, sw) ||
      !sm90::encode_map(&tc, bf, 3, cm, ndim, nstr, box, sw))
    return int(cudaErrorInvalidValue);
  const size_t smem = sm90_smem_bytes(a.HB);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  ssd_sm90_kernel<<<dim3(a.H / a.HB, B), kT, smem, stream>>>(tx, tb, tc, a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// f32 on CUDA cores. x, bm, cm (B,S,H,P) / (B,S,N); dt, a_log, h_final;
// all f32 and contiguous. Any S: the last chunk has S - c0 rows.
int ssd_scan_f32_fwd(const void* x, const void* bm, const void* cm,
                     const float* dt, const float* a_log, void* y,
                     float* h_final, int B, int S, int H, int P, int N,
                     int chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || chunk < 1 ||
      chunk > NW * MAXR || N > NW * MAXR || B > 65535 ||
      smem_bytes(chunk, N, P) > size_t(MAX_SMEM))
    return int(cudaErrorInvalidValue);
  Args a{x, bm, cm, dt, a_log, y, h_final, B, S, H, P, N, chunk};
  return launch<float>(a, static_cast<cudaStream_t>(stream));
}

// bf16 on tensor cores, the same layout (x, bm, cm, y bf16; dt, a_log,
// h_final f32); N = P = 64, 1 <= chunk <= 128, any S (a ragged last chunk
// of S - c0 rows), a group of head_block (1, 2 or 4) heads a block,
// H % head_block == 0.
int ssd_scan_sm90_fwd(const void* x, const void* bm, const void* cm,
                      const float* dt, const float* a_log, void* y,
                      float* h_final, int B, int S, int H, int P, int N,
                      int chunk, int head_block, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P != kState || N != kState || chunk < 1 ||
      chunk > kRows || B > 65535 ||
      (head_block != 1 && head_block != 2 && head_block != 4) ||
      H % head_block != 0)
    return int(cudaErrorInvalidValue);
  Sm90Args a{static_cast<__nv_bfloat16*>(y), dt, a_log, h_final, S, H, chunk,
             head_block};
  return launch_sm90(x, bm, cm, a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
