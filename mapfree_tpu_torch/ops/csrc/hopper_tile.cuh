// Device and host helpers for kernels that bring bf16 tiles into shared
// memory with the Tensor Memory Accelerator (TMA) and multiply them with
// Hopper's warpgroup matrix instructions (wgmma, sm_90a only): mbarriers,
// 3-d tensor-map copies, the proxy fence between thread stores and the
// tensor cores' reads, shared-memory matrix descriptors, the wgmma shapes
// these kernels take, and the host's encoding of a tensor map. Kept apart
// from mma_tile.cuh (mma.sync and cp.async), which the mma.sync K2 and K3
// include alone.
//
// Tiles. A tile that TMA writes with a swizzle of S = 32, 64 or 128 bytes
// holds rows of S bytes (16, 32 or 64 bf16), each 16-byte piece of row r at
// piece (p XOR (r / (128 / S)) % (S / 16)); wgmma reads the same layout when
// its descriptor names the same swizzle. A tile starts on a multiple of
// 1,024 bytes, so that the pattern's origin is the tile's. Wider operands are
// several such tiles side by side ("blocks").
//
// Descriptors (make_desc). Byte offsets in units of 16; "K-major" means the
// depth (the product's reduction axis) runs along a row:
// - K-major with a swizzle: SBO = the stride of 8-row groups (8 S), LBO unused;
//   the depth steps of 16 (32 bytes) inside a row advance the start address.
// - MN-major with a swizzle (B only, TRANS_B 1): rows are depth (keys), a row
//   holds S / 2 columns; SBO = the stride of 8-row groups, LBO the stride of
//   column blocks (unused while N <= S / 2).
// - K-major without a swizzle: 8 x 8 core matrices of 128 contiguous bytes
//   (8 rows of 16 bytes); LBO = the stride of core matrices along the depth,
//   SBO = along the rows.
//
// Accumulator of m64nNk16 (f32): warp w of the warpgroup owns rows 16 w ..
// 16 w + 15; lane (g, t) = (lane / 4, lane % 4) holds d[4 n + e] = (row
// 16 w + g + 8 (e / 2), column 8 n + 2 t + e % 2). The A operand in registers
// has the layout of an mma.sync m16n8k16 A fragment over the warp's rows, so
// two neighbouring 8-column blocks of an accumulator, packed to bf16, are the
// A fragment of the next product over those 16 columns as depth.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper_tile {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After every mbar_init, before any thread uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive, and expect `bytes` more from asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: parity 1 passes at once). A wait that never ends (a fault
// in a kernel's barrier counts) traps after some 2^28 tries, seconds on the
// card, so that the launch fails instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++tries == (1u << 28)) __trap();
  } while (!done);
}

// -- copies ---------------------------------------------------------------------

// The box of `map` at coordinates (c0, c1, c2), innermost first, into dst;
// the barrier counts its bytes. Coordinates past the tensor's extent read
// zeros (and count).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Makes this thread's ordinary stores to shared memory visible to the async
// proxy (TMA, wgmma) before a barrier hands them on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma ----------------------------------------------------------------------

constexpr uint32_t SWIZZLE_NONE = 0, SWIZZLE_128B = 1, SWIZZLE_64B = 2, SWIZZLE_32B = 3;

// The descriptor's code for a swizzle of rows of `bytes` (32, 64 or 128).
__host__ __device__ constexpr uint32_t swizzle_code(int bytes) {
  return bytes == 128 ? SWIZZLE_128B : bytes == 64 ? SWIZZLE_64B : SWIZZLE_32B;
}

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// x, hidden from the compiler's code motion: descriptors derived from it by
// constant offsets are formed where they are used, not hoisted out of a loop
// into registers that the accumulators need.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// Before the first wgmma of a group whose registers other instructions wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler sees a wgmma's registers written when it is issued; pinning
// them after the wait keeps their readers (and before the issue, their
// writers) on the right side of it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// -- tiles and warpgroups -------------------------------------------------------

// Byte offset of element (r, c) of a K-major tile held as blocks of [rows]
// [WB] bf16 (blk bytes apart) with TMA's swizzle of 2 WB bytes
// (this header's note): what TMA would write there.
template <int WB>
__device__ __forceinline__ int swizzled(int r, int c, int blk) {
  constexpr int S = 2 * WB;
  const int cc = c % WB;
  return (c / WB) * blk + r * S + (((cc >> 3) ^ ((r / (128 / S)) % (S / 16))) << 4) + (cc & 7) * 2;
}

// The descriptor offset (16-byte units) of depth step ks of a K-major tile
// in blocks of WB columns, blk bytes apart.
template <int WB>
__device__ __forceinline__ uint64_t kstep(int ks, int blk) {
  return static_cast<uint64_t>(((ks / (WB / 16)) * blk + (ks % (WB / 16)) * 32) >> 4);
}

// Named barrier `id` over one warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Whether x holds in any thread of the warpgroup (a barrier over its 128
// threads that ORs a predicate).
__device__ __forceinline__ bool warpgroup_any(bool x, int id) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(x)), "r"(id)
      : "memory");
  return r != 0;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// -- wgmma shapes ---------------------------------------------------------------

// d (+)= A . B^T, m64n64k16: A (64 x 16) and B (64 x 16) both K-major in
// shared memory; with scale_d == 0 the product overwrites d.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A . B^T, m64n32k16: A (64 x 16) and B (32 x 16) both K-major in
// shared memory; with scale_d == 0 the product overwrites d.
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A . B^T, m64n16k16: A (64 x 16) and B (16 x 16) both K-major in
// shared memory; with scale_d == 0 the product overwrites d.
__device__ __forceinline__ void wgmma_m64n16_ss(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A . B^T, m64nNk16 from shared memory, N of 16, 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "a shape of this header");
  if constexpr (N == 16) wgmma_m64n16_ss(d, desc_a, desc_b, scale_d);
  if constexpr (N == 32) wgmma_m64n32_ss(d, desc_a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_m64n64_ss(d, desc_a, desc_b, scale_d);
}

// d += A . B, m64n8k16: A (64 x 16) from registers (a, the layout of an
// mma.sync m16n8k16 A fragment, one warp's 16 rows), B (16 x 8) in shared
// memory, K-major (TRANS_B 0) or MN-major (TRANS_B 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n8_rs(float (&d)[4], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d += A . B, m64n16k16: A (64 x 16) from registers (a, the layout of an
// mma.sync m16n8k16 A fragment, one warp's 16 rows), B (16 x 16) in shared
// memory, K-major (TRANS_B 0) or MN-major (TRANS_B 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d += A . B, m64n32k16: A (64 x 16) from registers (a, the layout of an
// mma.sync m16n8k16 A fragment, one warp's 16 rows), B (16 x 32) in shared
// memory, K-major (TRANS_B 0) or MN-major (TRANS_B 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d += A . B, m64n64k16: A (64 x 16) from registers (a, the layout of an
// mma.sync m16n8k16 A fragment, one warp's 16 rows), B (16 x 64) in shared
// memory, K-major (TRANS_B 0) or MN-major (TRANS_B 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d += A . B, m64nNk16, A from registers, N of 8, 16, 32 or 64.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "a shape of this header");
  if constexpr (N == 8) wgmma_m64n8_rs<TRANS_B>(d, a, desc_b);
  if constexpr (N == 16) wgmma_m64n16_rs<TRANS_B>(d, a, desc_b);
  if constexpr (N == 32) wgmma_m64n32_rs<TRANS_B>(d, a, desc_b);
  if constexpr (N == 64) wgmma_m64n64_rs<TRANS_B>(d, a, desc_b);
}

// -- host -----------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query: no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &got);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a row-major bf16 array [depth][rows][cols] (cols a multiple of 8,
// the base aligned to 16 bytes) whose box is box_cols x box_rows x 1, with
// the swizzle of box_cols * 2 bytes (32, 64 or 128). Elements past the
// array's extent arrive as zeros.
inline cudaError_t encode_bf16_map(CUtensorMap* map, const void* base, int cols, int rows,
                                   int depth, int box_cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * 2 * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const int sw = box_cols * 2;
  const CUtensorMapSwizzle swizzle = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper_tile
