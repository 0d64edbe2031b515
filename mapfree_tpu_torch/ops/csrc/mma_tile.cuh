// Device helpers for kernels that keep bf16 tiles in shared memory and
// multiply them on the tensor cores with mma.sync (sm_80 and later; built
// here for sm_90a): 16-byte asynchronous copies into padded tiles, a ring of
// copy groups, ldmatrix fragment loads (plain and transposed), the m16n8k16
// product with float32 accumulators, and the repack of an accumulator
// fragment into the next product's A fragment.
//
// Tile layout. A tile is row-major bf16 with a pitch of (columns + PAD)
// elements: columns is a multiple of 16, so the pitch in bytes is an odd
// multiple of 16. Eight consecutive rows then start in eight different
// 16-byte slots of a 128-byte bank line, which is what makes every ldmatrix
// phase (eight rows of 16 bytes) free of bank conflicts without a swizzle.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 = (row g,     k 2t, 2t+1)   a1 = (row g + 8, k 2t, 2t+1)
//                     a2 = (row g,     k 2t+8, +9)   a3 = (row g + 8, k 2t+8, +9)
//   B (16 x 8, col):  b0 = (k 2t, 2t+1, n g)         b1 = (k 2t+8, 2t+9, n g)
//   C (16 x 8, f32):  c0, c1 = (row g, n 2t, 2t+1)   c2, c3 = (row g + 8, n 2t, 2t+1)
// Two C fragments of neighbouring n-tiles (16 columns) therefore hold exactly
// the elements of one A fragment over those 16 columns as depth:
//   a0 = pack(C0.c0, C0.c1)  a1 = pack(C0.c2, C0.c3)
//   a2 = pack(C1.c0, C1.c1)  a3 = pack(C1.c2, C1.c3)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mma_tile {

constexpr int PAD = 8;  // bf16 elements (16 bytes) added to every row's pitch

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- asynchronous copies ------------------------------------------------------

// 16 bytes global -> shared, bypassing L1; with !valid nothing is read and the
// 16 bytes are filled with zeros (src must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared; zeros with !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first width_bytes of rows [row0, row0 + ROWS) of a row-major global
// array whose rows lie stride_bytes apart (both multiples of 16, the base
// aligned to 16), into a shared tile of pitch_bytes, CHUNKS 16-byte pieces a
// row; rows at or past n_rows arrive as zeros. The pieces at or past
// width_bytes arrive as zeros with ZFILL and are not written without it. All
// NT threads of the block call it. CHUNKS is a compile-time bound so that the
// loop unrolls and a thread's row and chunk cost a shift, not a division.
template <int ROWS, int NT, int CHUNKS, bool ZFILL = false>
__device__ __forceinline__ void tile_copy_async_cols(void* dst, int pitch_bytes,
                                                     const void* src, int stride_bytes,
                                                     int width_bytes, int row0, int n_rows,
                                                     int tid) {
#pragma unroll
  for (int e0 = 0; e0 < ROWS * CHUNKS; e0 += NT) {
    const int e = e0 + tid;
    const int r = e / CHUNKS, ch = e % CHUNKS;
    const bool in = ch * 16 < width_bytes;
    if ((ROWS * CHUNKS % NT == 0 || e < ROWS * CHUNKS) && (ZFILL || in)) {
      const int row = row0 + r;
      const bool ok = in && row < n_rows;
      cp_async_16(static_cast<char*>(dst) + r * pitch_bytes + ch * 16,
                  static_cast<const char*>(src) +
                      (ok ? static_cast<size_t>(row) * stride_bytes + ch * 16 : 0),
                  ok);
    }
  }
}

// Whole rows of row_bytes each (at most 16 CHUNKS), as above without ZFILL.
template <int ROWS, int NT, int CHUNKS>
__device__ __forceinline__ void tile_copy_async(void* dst, int pitch_bytes, const void* src,
                                                int row_bytes, int row0, int n_rows,
                                                int tid) {
  tile_copy_async_cols<ROWS, NT, CHUNKS>(dst, pitch_bytes, src, row_bytes, row_bytes, row0,
                                         n_rows, tid);
}

// Zero columns [c0, c1) (both even) of a ROWS-row bf16 tile with plain stores.
template <int ROWS, int NT>
__device__ __forceinline__ void tile_zero_cols(__nv_bfloat16* tile, int pitch, int c0,
                                               int c1, int tid) {
  const int pairs = (c1 - c0) >> 1;
  for (int e = tid; e < ROWS * pairs; e += NT) {
    const int r = e / pairs, c = e - r * pairs;
    *reinterpret_cast<uint32_t*>(tile + r * pitch + c0 + 2 * c) = 0u;
  }
}

// -- fragments ------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The element of a tile whose address this lane hands to an x4 ldmatrix.
struct LaneOffsets {
  int a_row, a_col;  // matrices ordered (rows 0-7 | 8-15) x (cols 0-7), then cols 8-15
  int b_row, b_col;  // matrices ordered (cols 0-7 | 8-15) x (rows 0-7), then rows 8-15
  __device__ explicit LaneOffsets(int lane)
      : a_row(((lane >> 3) & 1) * 8 + (lane & 7)),
        a_col((lane >> 4) * 8),
        b_row((lane >> 4) * 8 + (lane & 7)),
        b_col(((lane >> 3) & 1) * 8) {}
};

// A fragment of tile[row0 .. +16][k0 .. +16] (rows x depth).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int pitch,
                                       int row0, int k0, const LaneOffsets& lo) {
  ldmatrix_x4(a, tile + (row0 + lo.a_row) * pitch + k0 + lo.a_col);
}

// B fragments for the product X . tile^T: the tile holds [n][depth]. Gives
// n-tiles n0 .. +8 (b[0], b[1]) and n0 + 8 .. +16 (b[2], b[3]) at depth
// k0 .. +16.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int pitch,
                                       int n0, int k0, const LaneOffsets& lo) {
  ldmatrix_x4(b, tile + (n0 + lo.b_row) * pitch + k0 + lo.b_col);
}

// B fragments for the product X . tile: the tile holds [depth][n], and the
// transpose comes with the load. Gives n-tiles n0 .. +8 (b[0], b[1]) and
// n0 + 8 .. +16 (b[2], b[3]) at depth (tile rows) k0 .. +16.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                             int pitch, int k0, int n0,
                                             const LaneOffsets& lo) {
  ldmatrix_x4_trans(b, tile + (k0 + lo.a_row) * pitch + n0 + lo.a_col);
}

// The x2 form of load_b_trans: the one n-tile n0 .. +8 (b[0], b[1]) at
// depth k0 .. +16.
__device__ __forceinline__ void load_b_trans_x2(uint32_t (&b)[2], const __nv_bfloat16* tile,
                                                int pitch, int k0, int n0,
                                                const LaneOffsets& lo) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_u32(tile + (k0 + lo.a_row) * pitch + n0))
               : "memory");
}

// c += a . b on the tensor cores: m16n8k16, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));  // registers only
}

// Two floats rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// 2^x by the special-function unit (2 ulp; flushes denormals).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma_tile
