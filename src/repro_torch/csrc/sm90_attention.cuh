// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_attention.cu, flash_attention_bwd_sm90.cu, paged_attention_sm90.cu,
// ssd_scan.cu), as inline PTX:
//
// - the wgmma shared-memory descriptor of a 128-byte-swizzled tile, and
//   wgmma.fence / commit_group / wait_group;
// - m64n64k16 bf16 -> f32 wgmma with both operands in shared memory
//   (K-major, for S = Q K^T; K-major A with MN-major B, for C h with h
//   stored state-row-major; both MN-major, for B^T X with B and X stored
//   time-major) and with A in registers and B MN-major (for O += P V, V
//   stored key-major);
// - the f32 accumulator -> bf16 A-fragment conversion (P into PV);
// - quad (4-lane) row max and row sum over the accumulator layout, and a
//   named barrier for one warpgroup;
// - mbarrier init / arrive-expect-tx / bounded try-wait;
// - TMA loads (2-D, 3-D, 5-D, and a pair of 64-row tiles such as K and V)
//   completing on an mbarrier, TMA stores, and
//   the host-side tensor-map encoding, looked up with
//   cudaGetDriverEntryPoint (no -lcuda).
//
// Tile layout used by both kernels: a tile of R rows x hd bf16 columns is
// hd/64 sub-tiles of R rows x 128 bytes, each 1,024-byte aligned and
// 128-byte swizzled (16-byte chunk g of row r stored at chunk g ^ (r % 8)),
// which is what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and what the
// descriptors below describe.
//
// Accumulator layout of m64nNk16 (f32): thread t of the warpgroup (warp
// w = t / 32, lane l) holds value i at row w*16 + l/4 + 8*((i/2) % 2),
// column 8*(i/4) + 2*(l % 4) + (i % 2). A row is held by the 4 lanes of a
// quad; each thread holds two rows (half 0 and half 1).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

constexpr int kTile = 64;            // rows of a wgmma M, keys of a KV tile
constexpr int kSub = 64 * 128;       // bytes of a 64-row, 128-byte sub-tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (row, col) in a swizzled tile of sub-tiles
// that are `rows` rows tall.
__device__ __forceinline__ uint32_t swz_offset(int row, int col, int rows) {
  const int sub = col >> 6, c = col & 63;
  return uint32_t(sub * rows * 128 + row * 128 +
                  ((((c >> 3) ^ (row & 7)) << 4) | ((c & 7) << 1)));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `saddr`
// (1,024-byte aligned atom base, plus a k offset of 32 bytes a k-step for
// K-major operands). LBO: bytes between 64-element blocks along M/N
// (MN-major only); SBO: bytes between 8-row groups (1,024 here).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= uint64_t((saddr & 0x3FFFF) >> 4);
  d |= uint64_t((lbo >> 4) & 0x3FFF) << 16;
  d |= uint64_t((sbo >> 4) & 0x3FFF) << 32;
  d |= uint64_t(1) << 62;                     // layout: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_D32_OUT(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, A 64x16 and B 16x64 both K-major in shared memory.
// scale_d 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_D32_OUT(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B, A 64x16 K-major and B 16x64 MN-major (N contiguous, 16 rows
// of 128 bytes a k-step), both in shared memory.
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : SM90_D32_OUT(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B, A 64x16 MN-major (M contiguous) and B 16x64 MN-major, both
// in shared memory: A is stored as its transpose, 16 rows of 128 bytes a
// k-step, as B is.
__device__ __forceinline__ void wgmma_ss_tab(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : SM90_D32_OUT(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A 64x16 bf16 from registers (a[4], the A-fragment), B 16x64
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_D32
#undef SM90_D32_OUT

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A-fragment of k-step kk (keys 16kk .. 16kk+15) of P from the
// accumulator layout of a 64x64 score tile: values 8kk .. 8kk+7.
__device__ __forceinline__ void p_fragment(const float (&p)[32], int kk,
                                           uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = pack_bf16(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Barrier `id` (1..15; 0 is __syncthreads) over the `count` threads that
// reach it, e.g. the 128 threads of one warpgroup.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase `parity` has completed. A wait that never
// ends (a wrong phase bit, a copy that never lands) traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (tries > (1u << 24)) __trap();
  }
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
// One thread: the 64-row tiles at row `row` of batch `batch` of two 3-D
// maps (e.g. K and V), columns col0 .. col0 + NC*64 as NC sub-tiles, into
// `a` and `b`, completing on `bar`.
template <int NC>
__device__ __forceinline__ void load_tile_pair(uint8_t* a, uint8_t* b,
                                               const CUtensorMap* ta,
                                               const CUtensorMap* tb,
                                               uint64_t* bar, int col0, int row,
                                               int batch) {
  mbar_expect_tx(bar, 2 * NC * kSub);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    tma_load_3d(a + c * kSub, ta, bar, col0 + c * 64, row, batch);
    tma_load_3d(b + c * kSub, tb, bar, col0 + c * 64, row, batch);
  }
}

// Stores clip at the tensor's bounds: rows past a ragged edge are not
// written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Host: tensor-map encoding (cuTensorMapEncodeTiled, looked up at run time)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-`rank` tiled map over `base`: dims innermost first, byte strides of
// dims 1.. (`strides[rank-1]`), box sizes. Zero fill out of bounds. Returns
// false if the encoding is refused.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                       const void* base, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, type, cuuint32_t(rank), const_cast<void*>(base), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
