// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), f32, on CUDA
// cores.
//
// The port's own kernel: the TPU package has no backward Pallas kernel
// (repro/models/ssm.py differentiates its jnp chunked scan with XLA, the
// chunk body under jax.checkpoint). It is the backward of
// csrc/ssd_scan.cu's f32 route (which replaces
// repro/kernels/mamba_scan/kernel.py ssd_scan) from a zero initial state;
// bf16 takes the tensor-core backward, csrc/ssd_scan_bwd_sm90.cu.
//
// Forward, per (batch, head), with a = -exp(a_log[h]), la the inclusive
// cumulative sum of dt * a within a chunk of L rows, h the state entering
// the chunk:
//   y[l]  = exp(la_l) C_l . h + sum_{m<=l} (C_l . B_m) exp(la_l - la_m) dt_m x_m
//   h'    = exp(la_last) h + sum_m exp(la_last - la_m) dt_m B_m x_m^T
// Backward, walking the chunks in reverse with dh' (the gradient of the
// state leaving the chunk; dh_final or zero for the last), G[l][m] =
// exp(la_l - la_m) on and below the diagonal (exp taken only there), CBG =
// (C_l . B_m) G, Q = (dy_l . x_m) G dt_m, R = CBG (dy_l . x_m), s_m =
// exp(la_last - la_m) dt_m:
//   dx_m  = dt_m sum_{l>=m} CBG[l][m] dy_l + s_m (B dh')_m
//   dC_l  = exp(la_l) h dy_l + sum_{m<=l} Q[l][m] B_m
//   dB_m  = sum_{l>=m} Q[l][m] C_l + s_m dh' x_m
//   ddt_m = sum_{l>=m} R[l][m] + U_m, U_m = exp(la_last - la_m) x_m . (B dh')_m
//   dla_k = sum_{m<k} R[k][m] dt_m - dt_k sum_{l>k} R[l][k]
//           + exp(la_k) C_k . (h dy_k) - dt_k U_k   (k < last)
//   dla_last = ... + exp(la_last) <h, dh'> + sum_{m<last} dt_m U_m
//   (R's diagonal and dt_last U_last enter dla twice with opposite signs:
//   they are left out, not added and taken away, which in f32 would leave
//   the rounding of terms scaled by dt, ~20 under strong decay)
//   ddt_k += a sum_{l>=k} dla_l;   da_log += a sum_k dt_k sum_{l>=k} dla_l
//   dh    = exp(la_last) dh' + sum_l exp(la_l) C_l dy_l^T
// dB and dC are summed over heads, da_log over batch and sequence.
//
// Three launches, none with atomics, so two calls give equal bits:
// 1. ssd_bwd_states_kernel: a block a (batch, head) walks the chunks
//    forward and writes the state entering each one (B, H, NC, N, P) f32
//    to the scratch (the forward keeps only h_final).
// 2. ssd_bwd_kernel: a block a (batch, head) walks the chunks in reverse
//    with dh in shared memory and writes dx, ddt, per-head dB and dC
//    partials (B, S, H, N) f32 and a per-(batch, head) da_log partial.
//    Each output a register tile (lane = output column, two a thread, 64
//    a warp; warp = a stride of output rows; the row operand a broadcast
//    shared-memory read), as the f32 forward kernel's; every reduction
//    over lanes is a xor butterfly, over warps and over a chunk's rows a
//    loop in a fixed order.
// 3. ssd_bwd_reduce_kernel: a thread an output element of dB and dC sums
//    the H partials in head order, and a thread a head sums da_log's B
//    partials in batch order.
//
// The widths are compile-time constants (N = P = 64, the tensor-core
// forward's contract) and every chunk is staged as LC = 128 rows, those
// past the chunk's L zero (dt too, so la stays flat there). So no
// register tile carries a row predicate: a zero row adds nothing, C B^T G
// and Q are zero above the diagonal, the triangular products run over
// whole rows, and only the reductions over rows stop at L. Row masks are
// applied where a result is stored. A predicate on each tile row keeps
// the compiler from batching the broadcast reads ahead of the
// multiply-adds: on an H100 at the training shape below, such a walk
// took 11.8 ms against this one's 3.5.
//
// Inputs and outputs f32, every product in f32 (wgmma has no full-f32
// mode, so f32 stays here; TF32 keeps ~3 decimal digits, short of the f32
// checks at 1e-4).
// What bounds it: at Zamba2's training shape (B 8, S 1024, H 64, N = P =
// 64, L 128) a call must move ~415 MB in f32 (0.124 ms at 3.35 TB/s) and
// do ~39 GFLOP (0.58 ms in f32 on CUDA cores): a CUDA-core kernel is held
// by issue, not bytes. This one also moves its scratch (the states, 67
// MB, and the dB/dC partials, 268 MB at that shape).
// Shared memory of kernel 2: dh and x (rows padded to P + 1), dy, B (rows
// padded to N + 1), C, one LC x LC buffer (h first, then CBG, then Q), 9
// vectors and the column partials: 218 KB, one block an SM (172
// registers a thread). Contract: N = P = 64, 1 <= chunk <= 128, any S (a
// ragged last chunk of S - c0 rows).
//
// The C entry point returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape outside the contract); the Python
// wrapper raises on it.

#include <algorithm>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int NW = NT / 32;      // warps
constexpr int N = 64, P = 64;    // state and head widths
constexpr int PP = P + 1;        // padded row of x and dh
constexpr int LC = 128;          // rows a chunk is staged as
constexpr int RL = LC / NW;      // tile rows a warp over a chunk's rows
constexpr int RN = N / NW;       // tile rows a warp over the state's rows
static_assert(N == 64 && P == 64, "a tile's 64 columns are one width");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const float* x;        // (B, S, H, P)
  const float* bm;       // (B, S, N)
  const float* cm;       // (B, S, N)
  const float* dt;       // (B, S, H)
  const float* a_log;    // (H,)
  const float* dy;       // (B, S, H, P)
  const float* dh_final; // (B, H, N, P) or null (zero)
  float* states;         // (B, H, NC, N, P) scratch
  float* db_part;        // (B, S, H, N) scratch
  float* dc_part;        // (B, S, H, N) scratch
  float* da_part;        // (B, H) scratch
  float* dx;             // (B, S, H, P)
  float* ddt;            // (B, S, H)
  float* da_log;         // (H,)
  float* db;             // (B, S, N)
  float* dc;             // (B, S, N)
  int B, S, H, L, NC;    // L: the chunk
};

// la = inclusive cumsum of dt * A over a chunk's L rows, by warp 0: a run
// of ceil(L/32) rows a lane, then a shuffle scan over the lanes' totals
// (the forward kernel's order).
__device__ __forceinline__ void chunk_scan(const float* dtS, float* laS,
                                           int L, float A, int lane) {
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

// ---------------------------------------------------------------------------
// 1. the chunk-start states
// ---------------------------------------------------------------------------

// Shared memory, in floats: state N x P, B chunk LC x (N+1), x chunk LC x
// P, then la, dt and the state weights (LC each).
constexpr size_t STATES_SMEM =
    sizeof(float) * (N * P + LC * (N + 1) + LC * P + 3 * LC);

__global__ void __launch_bounds__(NT) ssd_bwd_states_kernel(Args a) {
  extern __shared__ float smem[];
  float* hS = smem;                    // N x P
  float* bS = hS + N * P;              // LC x (N+1)
  float* xS = bS + LC * (N + 1);       // LC x P
  float* laS = xS + LC * P;            // LC
  float* dtS = laS + LC;               // LC
  float* sS = dtS + LC;                // LC

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float A = -expf(a.a_log[h]);
  float* states = a.states + (long(b) * a.H + h) * a.NC * N * P;

  for (int i = tid; i < N * P; i += NT) hS[i] = 0.f;
  for (int c = 0; c < a.NC; ++c) {
    const int c0 = c * a.L, L = min(a.L, a.S - c0);
    __syncthreads();                   // the previous update is done
    for (int i = tid; i < N * P; i += NT) states[long(c) * N * P + i] = hS[i];
    if (c == a.NC - 1) break;          // the last chunk's update is not needed
    for (int i = tid; i < L * P; i += NT) {
      const int l = i / P, p = i % P;
      xS[i] = a.x[((long(b) * a.S + c0 + l) * a.H + h) * P + p];
    }
    for (int i = tid; i < L * N; i += NT) {
      const int l = i / N, n = i % N;
      bS[l * (N + 1) + n] = a.bm[(long(b) * a.S + c0 + l) * N + n];
    }
    for (int l = tid; l < L; l += NT) dtS[l] = a.dt[(long(b) * a.S + c0 + l) * a.H + h];
    __syncthreads();
    if (warp == 0) chunk_scan(dtS, laS, L, A, lane);
    __syncthreads();
    const float la_last = laS[L - 1];
    for (int l = tid; l < L; l += NT) sS[l] = expf(la_last - laS[l]) * dtS[l];
    __syncthreads();

    // h[n][p] = exp(la_last) h[n][p] + sum_l B[l][n] (s_l x[l][p]) (rows
    // n, columns p).
    const float decay = expf(la_last);
    float acc0[RN], acc1[RN];
#pragma unroll
    for (int i = 0; i < RN; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
    for (int l = 0; l < L; ++l) {
      const float w = sS[l];
      const float x0 = xS[l * P + lane] * w, x1 = xS[l * P + lane + 32] * w;
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const float bv = bS[l * (N + 1) + warp + NW * i];
        acc0[i] = fmaf(bv, x0, acc0[i]);
        acc1[i] = fmaf(bv, x1, acc1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      float* hr = hS + (warp + NW * i) * P;
      hr[lane] = decay * hr[lane] + acc0[i];
      hr[lane + 32] = decay * hr[lane + 32] + acc1[i];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse walk
// ---------------------------------------------------------------------------

// Shared memory, in floats: dh N x PP, x LC x PP, dy LC x P, B LC x
// (N+1), C LC x N, the buffer LC x LC (h, N x PP, fits in it), 9 vectors
// of LC, the column partials NW x LC and NW warp sums.
constexpr size_t WALK_SMEM =
    sizeof(float) * (N * PP + LC * PP + LC * P + LC * (N + 1) + LC * N +
                     LC * LC + 9 * LC + NW * LC + NW);
static_assert(N * PP <= LC * LC, "h fits in the L x L buffer");
static_assert(WALK_SMEM <= 232448, "one block's staging fits an SM");

__global__ void __launch_bounds__(NT) ssd_bwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* dhS = smem;                   // N x PP: dh' of the current chunk
  float* xS = dhS + N * PP;            // LC x PP
  float* dyS = xS + LC * PP;           // LC x P
  float* bS = dyS + LC * P;            // LC x (N+1)
  float* cS = bS + LC * (N + 1);       // LC x N
  float* mS = cS + LC * N;             // h (N x PP), then CBG, then Q (LC x LC)
  float* laS = mS + LC * LC;
  float* dtS = laS + LC;
  float* elaS = dtS + LC;              // exp(la)
  float* svS = elaS + LC;              // s = exp(la_last - la) dt
  float* uS = svS + LC;                // U
  float* vS = uS + LC;                 // exp(la_l) C_l . (h dy_l)
  float* rowS = vS + LC;               // sum_{m<l} R[l][m] dt_m
  float* colS = rowS + LC;             // sum_{l>m} R[l][m]
  float* diagS = colS + LC;            // R[m][m]
  float* partS = diagS + LC;           // NW x LC: colS's partials by warp
  float* redS = partS + NW * LC;       // NW: <h, dh'>'s partials by warp

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float A = -expf(a.a_log[h]);
  const long bh = long(b) * a.H + h;

  for (int i = tid; i < N * P; i += NT)
    dhS[(i / P) * PP + i % P] = a.dh_final ? a.dh_final[bh * N * P + i] : 0.f;
  float da = 0.f;                      // thread 0: sum_k dt_k sum_{l>=k} dla_l

  for (int c = a.NC - 1; c >= 0; --c) {
    const int c0 = c * a.L, L = min(a.L, a.S - c0);
    __syncthreads();                   // the previous chunk fully used
    // rows L..LC-1 staged as zeros
    for (int i = tid; i < LC * P; i += NT) {
      const int l = i / P, p = i % P;
      float xv = 0.f, dv = 0.f;
      if (l < L) {
        const long off = ((long(b) * a.S + c0 + l) * a.H + h) * P + p;
        xv = a.x[off];
        dv = a.dy[off];
      }
      xS[l * PP + p] = xv;
      dyS[i] = dv;
    }
    for (int i = tid; i < LC * N; i += NT) {
      const int l = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (l < L) {
        const long off = (long(b) * a.S + c0 + l) * N + n;
        bv = a.bm[off];
        cv = a.cm[off];
      }
      bS[l * (N + 1) + n] = bv;
      cS[i] = cv;
    }
    for (int l = tid; l < LC; l += NT)
      dtS[l] = l < L ? a.dt[(long(b) * a.S + c0 + l) * a.H + h] : 0.f;
    const float* hin = a.states + (bh * a.NC + c) * N * P;
    for (int i = tid; i < N * P; i += NT) mS[(i / P) * PP + i % P] = hin[i];
    __syncthreads();
    if (warp == 0) chunk_scan(dtS, laS, L, A, lane);
    {
      // <h, dh'>: a partial a thread, then a butterfly a warp
      float s = 0.f;
      for (int i = tid; i < N * P; i += NT) {
        const int k = (i / P) * PP + i % P;
        s = fmaf(mS[k], dhS[k], s);
      }
      s = warp_sum(s);
      if (lane == 0) redS[warp] = s;
    }
    __syncthreads();
    const float la_last = laS[L - 1];
    for (int l = tid; l < LC; l += NT) {
      const float la = laS[min(l, L - 1)];
      if (l >= L) laS[l] = la;         // flat past the chunk's rows
      elaS[l] = expf(la);
      svS[l] = expf(la_last - la) * dtS[l];
    }
    __syncthreads();

    // dC's state term exp(la_l) sum_p dy[l][p] h[n][p] into dc_part (rows
    // l, columns n), and V_l = C_l . that.
    {
      float acc0[RL], acc1[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
      for (int p = 0; p < P; ++p) {
        const float h0 = mS[lane * PP + p], h1 = mS[(lane + 32) * PP + p];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float d = dyS[(warp + NW * i) * P + p];
          acc0[i] = fmaf(d, h0, acc0[i]);
          acc1[i] = fmaf(d, h1, acc1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int l = warp + NW * i;   // warp-uniform
        float v = 0.f;
        if (l < L) {
          const float e = elaS[l];
          const float v0 = acc0[i] * e, v1 = acc1[i] * e;
          const long row = ((long(b) * a.S + c0 + l) * a.H + h) * N;
          a.dc_part[row + lane] = v0;
          a.dc_part[row + lane + 32] = v1;
          v = fmaf(cS[l * N + lane + 32], v1, cS[l * N + lane] * v0);
        }
        v = warp_sum(v);
        if (l < L && lane == 0) vS[l] = v;
      }
    }
    __syncthreads();                   // h's reads done: mS becomes CBG

    // CBG[l][m] = (C_l . B_m) exp(la_l - la_m) for m <= l, else 0, over all
    // LC x LC (rows l, columns m; a column block skips the rows above it).
#pragma unroll
    for (int m0 = 0; m0 < LC; m0 += 64) {
      const int ma = m0 + lane, mb = ma + 32, i0 = m0 / NW;
      float acc0[RL], acc1[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
      for (int n = 0; n < N; ++n) {
        const float b0 = bS[ma * (N + 1) + n], b1 = bS[mb * (N + 1) + n];
#pragma unroll
        for (int i = i0; i < RL; ++i) {
          const float cv = cS[(warp + NW * i) * N + n];
          acc0[i] = fmaf(cv, b0, acc0[i]);
          acc1[i] = fmaf(cv, b1, acc1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int l = warp + NW * i;
        if (i < i0) {
          mS[l * LC + ma] = 0.f;
          mS[l * LC + mb] = 0.f;
        } else {
          mS[l * LC + ma] = ma <= l ? acc0[i] * expf(laS[l] - laS[ma]) : 0.f;
          mS[l * LC + mb] = mb <= l ? acc1[i] * expf(laS[l] - laS[mb]) : 0.f;
        }
      }
    }
    __syncthreads();

    // dx[m][p] = dt_m sum_{l>=m} CBG[l][m] dy[l][p] + s_m (B dh')[m][p]
    // (rows m, columns p), and U_m = exp(la_last - la_m) x_m . (B dh')_m.
    {
      float w0[RL], w1[RL], d0[RL], d1[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) { w0[i] = w1[i] = d0[i] = d1[i] = 0.f; }
      for (int n = 0; n < N; ++n) {
        const float h0 = dhS[n * PP + lane], h1 = dhS[n * PP + lane + 32];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float bv = bS[(warp + NW * i) * (N + 1) + n];
          d0[i] = fmaf(bv, h0, d0[i]);
          d1[i] = fmaf(bv, h1, d1[i]);
        }
      }
      for (int l = 0; l < L; ++l) {
        const float y0 = dyS[l * P + lane], y1 = dyS[l * P + lane + 32];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float g = mS[l * LC + warp + NW * i];
          w0[i] = fmaf(g, y0, w0[i]);
          w1[i] = fmaf(g, y1, w1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int m = warp + NW * i;   // warp-uniform
        float u = 0.f;
        if (m < L) {
          const long row = ((long(b) * a.S + c0 + m) * a.H + h) * P;
          const float dtm = dtS[m], svm = svS[m];
          a.dx[row + lane] = dtm * w0[i] + svm * d0[i];
          a.dx[row + lane + 32] = dtm * w1[i] + svm * d1[i];
          u = fmaf(xS[m * PP + lane + 32], d1[i], xS[m * PP + lane] * d0[i]);
        }
        u = warp_sum(u);
        if (m < L && lane == 0) uS[m] = expf(la_last - laS[m]) * u;
      }
    }
    __syncthreads();                   // CBG's reads done: mS becomes Q

    // XDY[l][m] = dy_l . x_m for m <= l (rows l, columns m); R = CBG XDY,
    // Q = XDY exp(la_l - la_m) dt_m written over CBG; below the diagonal,
    // the row sums of R dt_m and the column sums of R; R's diagonal. Q
    // stays zero above the diagonal and on the zero rows.
    {
      float racc[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) racc[i] = 0.f;
#pragma unroll
      for (int m0 = 0; m0 < LC; m0 += 64) {
        const int ma = m0 + lane, mb = ma + 32, i0 = m0 / NW;
        float acc0[RL], acc1[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
        for (int p = 0; p < P; ++p) {
          const float x0 = xS[ma * PP + p], x1 = xS[mb * PP + p];
#pragma unroll
          for (int i = i0; i < RL; ++i) {
            const float d = dyS[(warp + NW * i) * P + p];
            acc0[i] = fmaf(d, x0, acc0[i]);
            acc1[i] = fmaf(d, x1, acc1[i]);
          }
        }
        float col0 = 0.f, col1 = 0.f;
#pragma unroll
        for (int i = i0; i < RL; ++i) {
          const int l = warp + NW * i;
          if (ma <= l) {
            const float r = mS[l * LC + ma] * acc0[i];
            mS[l * LC + ma] = acc0[i] * expf(laS[l] - laS[ma]) * dtS[ma];
            if (ma < l) {
              col0 += r;
              racc[i] = fmaf(r, dtS[ma], racc[i]);
            } else {
              diagS[l] = r;
            }
          }
          if (mb <= l) {
            const float r = mS[l * LC + mb] * acc1[i];
            mS[l * LC + mb] = acc1[i] * expf(laS[l] - laS[mb]) * dtS[mb];
            if (mb < l) {
              col1 += r;
              racc[i] = fmaf(r, dtS[mb], racc[i]);
            } else {
              diagS[l] = r;
            }
          }
        }
        partS[warp * LC + ma] = col0;
        partS[warp * LC + mb] = col1;
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const float t = warp_sum(racc[i]);
        if (lane == 0) rowS[warp + NW * i] = t;
      }
    }
    __syncthreads();
    for (int m = tid; m < LC; m += NT) {
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += partS[w * LC + m];
      colS[m] = s;
    }

    // dC[l][n] += sum_{m<=l} Q[l][m] B[m][n] (the thread that wrote the
    // state term adds to it); dB[m][n] = s_m sum_p x[m][p] dh'[n][p] +
    // sum_{l>=m} Q[l][m] C[l][n].
    {
      float acc0[RL], acc1[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
      for (int m = 0; m < L; ++m) {
        const float b0 = bS[m * (N + 1) + lane], b1 = bS[m * (N + 1) + lane + 32];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float q = mS[(warp + NW * i) * LC + m];
          acc0[i] = fmaf(q, b0, acc0[i]);
          acc1[i] = fmaf(q, b1, acc1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int l = warp + NW * i;
        if (l >= L) break;
        const long row = ((long(b) * a.S + c0 + l) * a.H + h) * N;
        a.dc_part[row + lane] += acc0[i];
        a.dc_part[row + lane + 32] += acc1[i];
      }

#pragma unroll
      for (int i = 0; i < RL; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
      for (int p = 0; p < P; ++p) {
        const float h0 = dhS[lane * PP + p], h1 = dhS[(lane + 32) * PP + p];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float xv = xS[(warp + NW * i) * PP + p];
          acc0[i] = fmaf(xv, h0, acc0[i]);
          acc1[i] = fmaf(xv, h1, acc1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const float sv = svS[warp + NW * i];
        acc0[i] *= sv;
        acc1[i] *= sv;
      }
      for (int l = 0; l < L; ++l) {
        const float cv0 = cS[l * N + lane], cv1 = cS[l * N + lane + 32];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float q = mS[l * LC + warp + NW * i];
          acc0[i] = fmaf(q, cv0, acc0[i]);
          acc1[i] = fmaf(q, cv1, acc1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int m = warp + NW * i;
        if (m >= L) break;
        const long row = ((long(b) * a.S + c0 + m) * a.H + h) * N;
        a.db_part[row + lane] = acc0[i];
        a.db_part[row + lane + 32] = acc1[i];
      }
    }
    __syncthreads();                   // dh' read for the last time; colS ready

    // ddt and da_log: dla, then its reverse cumulative sum, in row order.
    if (tid == 0) {
      float hdh = 0.f, su = 0.f, cum = 0.f;
      for (int w = 0; w < NW; ++w) hdh += redS[w];
      for (int m = 0; m < L - 1; ++m) su = fmaf(dtS[m], uS[m], su);
      for (int k = L - 1; k >= 0; --k) {
        float dla = rowS[k] - dtS[k] * colS[k] + vS[k];
        dla += k == L - 1 ? elaS[k] * hdh + su : -dtS[k] * uS[k];
        cum += dla;
        a.ddt[(long(b) * a.S + c0 + k) * a.H + h] =
            colS[k] + diagS[k] + uS[k] + A * cum;
        da = fmaf(dtS[k], cum, da);
      }
    }

    // dh = exp(la_last) dh' + sum_l C[l][n] exp(la_l) dy[l][p] (rows n,
    // columns p): the state gradient entering the previous chunk.
    const float decay = expf(la_last);
    float acc0[RN], acc1[RN];
#pragma unroll
    for (int i = 0; i < RN; ++i) { acc0[i] = 0.f; acc1[i] = 0.f; }
    for (int l = 0; l < L; ++l) {
      const float e = elaS[l];
      const float y0 = dyS[l * P + lane] * e, y1 = dyS[l * P + lane + 32] * e;
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const float cv = cS[l * N + warp + NW * i];
        acc0[i] = fmaf(cv, y0, acc0[i]);
        acc1[i] = fmaf(cv, y1, acc1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      float* dr = dhS + (warp + NW * i) * PP;
      dr[lane] = decay * dr[lane] + acc0[i];
      dr[lane + 32] = decay * dr[lane + 32] + acc1[i];
    }
  }
  if (tid == 0) a.da_part[bh] = A * da;
}

// ---------------------------------------------------------------------------
// 3. the head and batch sums
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) ssd_bwd_reduce_kernel(Args a) {
  const long i = long(blockIdx.x) * NT + threadIdx.x;
  if (i < long(a.B) * a.S * N) {
    const long bs = i / N;
    const int n = int(i % N);
    const float* pb = a.db_part + bs * a.H * N + n;
    const float* pc = a.dc_part + bs * a.H * N + n;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < a.H; ++h) {
      sb += pb[long(h) * N];
      sc += pc[long(h) * N];
    }
    a.db[i] = sb;
    a.dc[i] = sc;
  }
  if (i < a.H) {
    float s = 0.f;
    for (int b = 0; b < a.B; ++b) s += a.da_part[long(b) * a.H + i];
    a.da_log[i] = s;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
}

int launch(const Args& a, cudaStream_t stream) {
  cudaError_t e = allow_smem(ssd_bwd_states_kernel, STATES_SMEM);
  if (e == cudaSuccess) e = allow_smem(ssd_bwd_kernel, WALK_SMEM);
  if (e != cudaSuccess) return int(e);
  ssd_bwd_states_kernel<<<dim3(a.H, a.B), NT, STATES_SMEM, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  ssd_bwd_kernel<<<dim3(a.H, a.B), NT, WALK_SMEM, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const long outs = std::max(long(a.B) * a.S * N, long(a.H));
  ssd_bwd_reduce_kernel<<<unsigned((outs + NT - 1) / NT), NT, 0, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, bm, cm, dy, dx, db, dc, dt, a_log, dh_final (null: zero), ddt, da_log
// f32 in the forward's layouts; work an f32 scratch of B*H*NC*N*P +
// 2*B*S*H*N + B*H floats (NC = ceil(S / chunk)); all contiguous. N = P =
// 64; any S: the last chunk has S - c0 rows.
int ssd_scan_bwd_f32(const float* x, const float* bm, const float* cm,
                     const float* dt, const float* a_log, const float* dy,
                     const float* dh_final, float* work, float* dx, float* ddt,
                     float* da_log, float* db, float* dc, int B, int S, int H,
                     int p, int n, int chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || p != P || n != N || chunk < 1 ||
      chunk > LC || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  const int NC = (S + chunk - 1) / chunk;
  float* states = work;
  float* db_part = states + long(B) * H * NC * N * P;
  float* dc_part = db_part + long(B) * S * H * N;
  float* da_part = dc_part + long(B) * S * H * N;
  Args a{x, bm, cm, dt, a_log, dy, dh_final, states, db_part, dc_part, da_part,
         dx, ddt, da_log, db, dc, B, S, H, chunk, NC};
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
