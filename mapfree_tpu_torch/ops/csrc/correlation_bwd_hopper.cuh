// The parts of K2 and K3 that the two Hopper pairs of the "mma" design
// share (correlation_bwd_wgmma.cu, correlation_bwd_narrow.cu): K2's
// prologue (dmain and the row constants, formed while the first copies
// fly), its per-row values and the end of its sweep; K3's [v | grid | 0]
// tile and its store of dk and dv; the host's arguments. One arithmetic for
// both pairs, so that either pair's K2 hands on to either K3 and both give
// the mma.sync pair's bits (correlation_bwd_mma.cu holds the arithmetic
// they all share and its notes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace bwd_hopper {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E_F = 1.4426950408889634f;

// K2's prologue for one warp's 16 rows (rows r0 .. r0 + 15 of the block,
// whose first row is row0): four at a time with every load in flight, a lane
// columns lane + 32 j (the prologue kernel's order, so c has its bits);
// dmain's v columns into the block's tile (CV columns in blocks of WD, DBLK
// bytes apart, in the layout TMA would give it), zeros from Cv on; dmain
// [B, HW, DM] for K3 where write_dmain; the rows' (0, 1/d, c, d_ms) into rs.
template <int CV, int WD, int DBLK>
__device__ __forceinline__ void rows_prologue(const float* __restrict__ out,
                                              const float* __restrict__ dout,
                                              bf16* __restrict__ dmain, unsigned char* dms,
                                              float4* rs, int r0, int row0, int HW, int Cv, int DM,
                                              size_t boff, int lane, bool write_dmain) {
  constexpr int NJ = (CV + 3 + 31) / 32;
  static_assert(32 * NJ >= CV + 16, "the lanes reach every column of dmain");
  const int CO = Cv + 3;
#pragma unroll 1
  for (int i0 = 0; i0 < 16; i0 += 4) {
    float dv[4][NJ], ov[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + r0 + i0 + i;
      const size_t grow = boff + (row < HW ? row : 0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        const bool ok = row < HW && col < CO;
        dv[i][j] = ok ? dout[grow * CO + col] : 0.f;
        ov[i][j] = ok ? out[grow * CO + col] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i0 + i, row = row0 + r;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) part = fmaf(dv[i][j], ov[i][j], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL_MASK, part, off);
      bf16* drow = dmain + (boff + (row < HW ? row : 0)) * DM;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        const bf16 x = __float2bfloat16_rn(col < Cv + 2 ? dv[i][j] : 0.f);
        if (col < CV)
          *reinterpret_cast<bf16*>(dms + hopper_tile::swizzled<WD>(r, col, DBLK)) =
              col < Cv ? x : __float2bfloat16_rn(0.f);
        if (write_dmain && row < HW && col < DM) drow[col] = x;
      }
      // (0, 1/d, c, d_ms): the lane holding column Cv + 2 has both
      const int jl = (Cv + 2) >> 5, ll = (Cv + 2) & 31;
      float inv = 0.f, dms_v = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j == jl) {
          inv = __shfl_sync(FULL_MASK, ov[i][j], ll);
          dms_v = __shfl_sync(FULL_MASK, dv[i][j], ll);
        }
      if (lane == 0) rs[r] = make_float4(0.f, inv, part, dms_v);
    }
  }
}

// K2's per-row values for rows r0 + g and r0 + 8 + g of the block: the
// grid's depth step (A holds dmain's columns Cv, Cv + 1 at depth 0, 1 in
// lanes t = 0, zeros elsewhere), c, 1/d and d_ms.
__device__ __forceinline__ void rows_values(const float* __restrict__ dout, const float4* rs,
                                            int r0, int row0, int g, int t, int HW, int Cv,
                                            size_t boff, uint32_t (&ga)[4], float (&cval)[2],
                                            float (&inv_d)[2], float (&d_ms)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ga[i] = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h + g, row = row0 + r;
    if (t == 0 && row < HW) {
      const float* d = dout + (boff + row) * (Cv + 3) + Cv;
      ga[h] = mma_tile::pack_bf16(d[0], d[1]);
    }
    const float4 r4 = rs[r];
    inv_d[h] = r4.y;
    cval[h] = r4.z;
    d_ms[h] = r4.w;
  }
}

// The end of K2's sweep (correlation_bwd_mma.cu::rows_finish) for rows
// row0 + r0 + g and + 8: the row's lanes merge their maxima (the smallest key
// wins a tie) into M and the first argmax (key 0 for a row with none, a NaN
// row); dq = (2^((m - M) log2e) acc + d_ms k_amax) / d over the CTB column
// blocks of W from block cb0; where write_stats, lse = M log2e - log2(1/d),
// the row's other statistics and its argmax.
template <int CTB, int W>
__device__ __forceinline__ void rows_finish(const float (&acc)[CTB][W / 2],
                                            const float (&best)[2], const int (&bidx)[2],
                                            const float (&mref)[2], const float (&cval)[2],
                                            const float (&inv_d)[2], const float (&d_ms)[2],
                                            const bf16* __restrict__ k, float* __restrict__ dq,
                                            float* __restrict__ stats, int* __restrict__ amax_out,
                                            int r0, int row0, int g, int t, int HW, int Cq,
                                            size_t boff, int cb0, bool write_stats) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float bv = best[h];
    int bi = bidx[h];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL_MASK, bv, off);
      const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi >= HW) bi = 0;
    const float a = mma_tile::ex2((mref[h] - bv) * LOG2E_F);  // 1 where m is the row's max
    const int row = row0 + r0 + 8 * h + g;
    if (row < HW) {
      const bf16* ka = k + (boff + bi) * Cq;
      float* o = dq + (boff + row) * Cq;
#pragma unroll
      for (int cb = 0; cb < CTB; ++cb)
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const int col = (cb0 + cb) * W + n * 8 + 2 * t;
          if (col < Cq) {
            const float2 kv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ka + col));
            *reinterpret_cast<float2*>(o + col) =
                make_float2(fmaf(acc[cb][4 * n + 2 * h], a, d_ms[h] * kv.x) * inv_d[h],
                            fmaf(acc[cb][4 * n + 2 * h + 1], a, d_ms[h] * kv.y) * inv_d[h]);
          }
        }
      if (write_stats && t == 0) {
        *reinterpret_cast<float4*>(stats + (boff + row) * 4) =
            make_float4(bv * LOG2E_F - log2f(inv_d[h]), inv_d[h], cval[h], d_ms[h]);
        amax_out[boff + row] = bi;
      }
    }
  }
}

// K3's [v | grid | 0] of warpgroup wg's 64 keys (col0 the block's first), in
// DB blocks of WD columns GBLK bytes apart, in the layout TMA would give it:
// v's columns, the grid's two at Cv (Cv is a multiple of 8: one 16-byte
// piece), zeros past them and past HW. Written by the warpgroup's 128
// threads (tid its thread).
template <int DB, int WD, int GBLK>
__device__ __forceinline__ void cols_vgrid(const bf16* __restrict__ v,
                                           const bf16* __restrict__ grid, unsigned char* vgs,
                                           int wg, int tid, int col0, int HW, int Cv,
                                           size_t boff) {
  constexpr int PIECES = DB * WD / 8;
  for (int e = tid & 127; e < 64 * PIECES; e += 128) {
    const int r = 64 * wg + e / PIECES, c = 8 * (e % PIECES), key = col0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (key < HW) {
      if (c < Cv)
        x = __ldg(reinterpret_cast<const uint4*>(v + (boff + key) * Cv + c));
      else if (c == Cv)
        x.x = __ldg(reinterpret_cast<const unsigned*>(grid) + key);
    }
    *reinterpret_cast<uint4*>(vgs + hopper_tile::swizzled<WD>(r, c, GBLK)) = x;
  }
}

// K3's dk and dv of keys kw0 and kw0 + 8: TK blocks of W dk columns from
// block zk (where has_k) and TV blocks of WD dv columns from block zv
// (where has_v).
template <int TK, int W, int TV, int WD>
__device__ __forceinline__ void cols_store(const float (&acc_k)[TK][W / 2],
                                           const float (&acc_v)[TV][WD / 2],
                                           float* __restrict__ dk, float* __restrict__ dv,
                                           int kw0, int t, int HW, int Cq, int Cv, size_t boff,
                                           int zk, int zv, bool has_k, bool has_v) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + 8 * h;
    if (key >= HW) continue;
    if (has_k) {
      float* o = dk + (boff + key) * Cq;
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const int col = (zk + i) * W + n * 8 + 2 * t;
          if (col < Cq)
            *reinterpret_cast<float2*>(o + col) =
                make_float2(acc_k[i][4 * n + 2 * h], acc_k[i][4 * n + 2 * h + 1]);
        }
    }
    if (has_v) {
      float* o = dv + (boff + key) * Cv;
#pragma unroll
      for (int i = 0; i < TV; ++i)
#pragma unroll
        for (int n = 0; n < WD / 8; ++n) {
          const int col = (zv + i) * WD + n * 8 + 2 * t;
          if (col < Cv)
            *reinterpret_cast<float2*>(o + col) =
                make_float2(acc_v[i][4 * n + 2 * h], acc_v[i][4 * n + 2 * h + 1]);
        }
    }
  }
}

// -- host -----------------------------------------------------------------------

struct Args {
  const bf16 *q, *k, *v, *grid;
  const float *out, *dout;
  bf16* dmain;
  float *stats, *dq, *dk, *dv;
  int* amax;
  int B, HW, Cq, Cv, DM;
  cudaStream_t stream;
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Columns of the bf16 dmain: Cv + 2 rounded up to the tensor cores' depth of 16.
inline int dmain_width(int Cv) { return (Cv + 2 + 15) / 16 * 16; }

inline Args make_args(const void* q, const void* k, const void* v, const void* grid,
                      const void* out, const void* dout, const void* dmain, const void* stats,
                      const void* amax, void* dq, void* dk, void* dv, int B, int HW, int Cq,
                      int Cv, void* stream) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
              static_cast<const float*>(out), static_cast<const float*>(dout),
              const_cast<bf16*>(static_cast<const bf16*>(dmain)),
              const_cast<float*>(static_cast<const float*>(stats)), static_cast<float*>(dq),
              static_cast<float*>(dk), static_cast<float*>(dv),
              const_cast<int*>(static_cast<const int*>(amax)), B, HW, Cq, Cv, dmain_width(Cv),
              static_cast<cudaStream_t>(stream)};
}

// Above 48 KB a kernel's dynamic shared memory needs its attribute set.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace bwd_hopper
