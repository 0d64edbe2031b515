// Fused correlation-volume softmax-warp, backward pass on Hopper's own
// tensor-core path (sm_90a): the wgmma kernels of K2 and K3's "mma" design.
// correlation_bwd_mma.cu holds the design's mma.sync kernels and the
// arithmetic both share; correlation_bwd.cu the "fma" design.
//
// Replaces, with the mma.sync kernels, the two TPU kernels of
// mapfree_tpu/ops/correlation.py::_fcw_bwd: _bwd_rows_kernel (:109, K2, the
// row pass: correlation_bwd_rows_wgmma) and _bwd_cols_kernel (:148, K3, the
// column pass: correlation_bwd_cols_wgmma). Per batch and query row i, with
// s_ij = q_i . k_j and P = softmax_j(s):
//
//   dP_ij = dmain_i . [v_j | grid_j] + d_ms_i [j == first argmax_j s_ij]
//   dS_ij = P_ij (dP_ij - c_i),  c_i = dout_i . out_i
//   dq_i = sum_j dS_ij k_j   (K2)   dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dmain_i[:Cv]   (K3)
//
// The arguments, the outputs and the rounding points are the mma.sync
// kernels' (correlation_bwd_mma.cu's note): K2 forms dmain (bf16) and c
// itself, walks the keys once with an online row max moved lazily every TKG
// keys, rounds dS' = e (dP - c) to bf16 against the row's running reference
// and writes stats [B, HW, 4] = (lse, 1/d, c, d_ms), amax and dmain [B, HW,
// dmain_width(Cv)]; K3 takes them, P = 2^(s log2e - lse) and dS = P (dP -
// c) rounded to bf16. So either kernel of K2 hands on to either of K3, and
// ops/correlation.py's plain backward with bf16_roundings=True is the
// yardstick of both.
//
// Bound (chip_smoke.py::k2_bound, k3_bound; H100 SXM at 700 W): operations.
// K2 does 2 B HW^2 (2 Cq + Cv + 2) FLOP in products and B HW^2
// exponentials, K3 2 B HW^2 (2 Cq + 2 Cv + 2) and as many exponentials. At
// the 3d3d train shape (B = 10, HW = 6,256, C = 32) the exponentials bound
// both, 0.094 and 0.103 ms (with the products: 0.0936 and 0.1029); B = 90,
// 0.842 and 0.926; C = 128, the products: 0.306 and 0.407; Cq 256 / Cv 96,
// 0.483 and 0.559; C = 256, 0.609 and 0.812.
//
// The design, K1's wgmma kernel (correlation_fwd.cu) taken to the backward:
// - Warps. A block has NC consumer warpgroups of 64 rows (K2: query rows;
//   K3: keys) and a producer warpgroup whose first warp loads and whose
//   registers go to the consumers (setmaxnreg). The producer brings the
//   block's resident tile in once and keeps the streamed side's tiles in
//   flight through a ring of ST stages, each a full mbarrier counting the
//   TMA bytes and an empty one every consumer warp arrives on.
// - K2. Resident: q (TMA) and the block's dmain, which each consumer
//   warpgroup forms from dout while the first copies fly (with c = dout .
//   out, 1/d and d_ms; the prologue folded in, in the prologue kernel's sum
//   order, so c has its bits), written into shared memory in the layout TMA
//   would give it. Streamed: 64-key tiles of k and v (TMA, rank-3 maps: rows
//   past HW arrive as zeros, never the next batch element's) and a grid
//   tile the producer writes. Per tile: S = q k^T and dP = dmain v^T, both
//   m64n64k16 from shared memory, K-major; the grid's two columns are a
//   depth step of their own whose A is a register fragment (dmain's columns
//   Cv, Cv + 1, the other 14 zero) and whose B is the producer's [64 keys]
//   x [16] grid tile, K-major without a swizzle (4 bytes a key: no TMA box
//   reads it, as K1 found). Then, for each group of TKG keys: the lazy max
//   and the first argmax, dS' into A fragments, and dq += dS' k with B the
//   same k stage read MN-major (the transpose bit: no ldmatrix.trans).
//   Inside a pass the k16 steps of dq stay in flight together unless some
//   row of the warpgroup moves its reference after the pass's first group:
//   wgmma is collective, so the warpgroup votes once a pass (bar.red.or on
//   its own named barrier) and, where a row moves late, waits for the steps
//   in flight before rescaling. Moves are rare after the first tiles.
// - K3. Resident: k (TMA) and [v | grid | 0], which each consumer forms
//   from v and the grid, so that the grid shares its depth step with v's
//   last columns as in the mma.sync kernel (its bits). Streamed: 64-row
//   chunks of q and dmain (TMA) and the chunk's statistics and argmax, which
//   the producer loads itself (1.25 KB, zeros past HW: a row past HW has
//   q = dmain = c = 0 and adds nothing). Per chunk: S^T = k q^T, dP^T =
//   [v | grid] dmain^T, P^T and dS^T in registers, dk += dS^T q and dv +=
//   P^T dmain[:, :Cv] with B the same q and dmain stages read MN-major. The
//   chunks go in order with no atomics: equal bits run to run.
// - Widths. q stays resident up to 256 channels (WGMMA_MAX_CQ), v up to 256.
//   An accumulator too wide for the registers a consumer can take (K1: 128
//   columns a thread spilled past 240) is cut into column tiles, a grid
//   dimension whose tiles each recompute the same scores in the same order,
//   so the statistics agree to the bit; tile 0 writes them and dmain (each
//   tile forms its own dmain in shared memory: no prologue kernel). K2's dq
//   in tiles of CTB blocks; K3's [dk | dv] in tiles of TK q blocks and TV
//   dmain blocks, a tile holding none of dk skipping dP.
// - Rounding. As the mma.sync kernels: dmain, P and dS in bf16, the lazy
//   reference moved by LAZY_GAP after each group of TKG keys (the plain
//   backward's BWD_KEY_TILE and BWD_LAZY_GAP_LOG2). The tensor cores sum each
//   16-deep step in the mma.sync kernels' order, so the pair gives their bits;
//   K2's dP steps differ where Cv % 16 == 8 (the grid's step apart from v's
//   last 8 columns, where the mma.sync kernel shares one), and gave the same
//   bits there too at every width measured (24, 40, 120).
// - Passes. A tile of 64 keys (K2) or chunk of 64 rows (K3) goes in passes
//   of NH = 64, 32 or 16, so that the first products' accumulators take
//   NH / 2 registers a thread: ptxas compiles a consumer at the launch
//   bound's register cap, not at what setmaxnreg gives it, and four
//   warpgroups a SM (96 registers) need passes of 32 at 32 channels. A
//   pass's second products stay in flight while the next pass's first ones
//   are issued; the tile's last ones land before its stage is freed (steps
//   in flight across a tile's end made ptxas serialise every wgmma).
// The instantiations (dispatch_rows_wgmma, dispatch_cols_wgmma) were chosen
// by timing, tools/torch_chip_studies.py k23-wgmma-variants; the candidates
// and their times are beside the dispatch. Where the mma.sync pair measured
// faster (up to 64 channels), ops/correlation.py::backward_kernel keeps it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

namespace ht = hopper_tile;
namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

constexpr int TKW = 64;  // keys a tile (K2), rows a chunk (K3)
constexpr int TKG = 16;  // keys a step of K2's online max: ops/correlation.py::BWD_KEY_TILE
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LAZY_GAP = 8.f / LOG2E;  // how far a row's score may pass K2's reference: P up to 2^8
constexpr int GT = 2048;  // bytes of K2's grid tile: [64 keys] x [16 channels] bf16
constexpr int PRODUCER_REGS = 24;

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// What a consumer thread takes from the producer warpgroup (setmaxnreg),
// with MINB blocks a SM (correlation_fwd.cu::wgmma_consumer_regs).
__host__ __device__ constexpr int consumer_regs(int NC, int MINB) {
  const int launch = 512 / ((NC + 1) * MINB) / 8 * 8;
  const int take = (launch * (NC + 1) - PRODUCER_REGS) / NC / 8 * 8;
  return take > 240 ? 240 : take;
}

// Byte offset of element (r, c) of a K-major tile held as blocks of [rows]
// [WB] bf16 (blk bytes apart) with TMA's swizzle of 2 WB bytes
// (hopper_tile.cuh's note): what TMA would write there.
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

// =================================================================== K2 ==
// q and k channels in KB blocks of W, v and dmain's v columns in CV / WD
// blocks of WD, dq in column tiles of CTB blocks, NC consumer warpgroups.
template <int KB, int W, int CV, int WD, int CTB, int NC>
struct RowsGeo {
  static constexpr int DB = CV / WD;
  static constexpr int BR = 64 * NC;          // query rows a block
  static constexpr int KQ = KB * W / 16;      // depth steps of q k^T
  static constexpr int KV = CV / 16;          // of dmain v^T (the grid's step apart)
  static constexpr int QBLK = BR * W * 2;     // bytes of a resident q block
  static constexpr int DBLK = BR * WD * 2;    // of a resident dmain block
  static constexpr int KBLK = TKW * W * 2;    // of a k block of a stage
  static constexpr int VBLK = TKW * WD * 2;   // of a v block
  static constexpr int STAGE = KB * KBLK + DB * VBLK + GT;
  static constexpr int RESIDENT = KB * QBLK + DB * DBLK;
  static_assert(W == 16 || W == 32 || W == 64, "a swizzle width");
  static_assert(WD == 16 || WD == 32 || WD == 64, "a swizzle width");
  static_assert(CV % WD == 0 && KB % CTB == 0, "whole blocks");
  static_assert(QBLK % 1024 == 0 && DBLK % 1024 == 0 && KBLK % 1024 == 0 && VBLK % 1024 == 0,
                "tiles on 1,024-byte boundaries");
  static_assert(BR <= 256, "a TMA box");
};

// Dynamic shared memory after the 1,024-byte alignment: the resident tiles,
// the ring, the rows' (0, 1/d, c, d_ms); the barriers follow.
template <int KB, int W, int CV, int WD, int CTB, int NC, int ST>
__host__ __device__ constexpr size_t rows_region() {
  using G = RowsGeo<KB, W, CV, WD, CTB, NC>;
  return static_cast<size_t>(G::RESIDENT) + static_cast<size_t>(ST) * G::STAGE + 16 * G::BR;
}

template <int KB, int W, int CV, int WD, int CTB, int NC, int ST, int MINB, int NH>
__global__ void __launch_bounds__(128 * (NC + 1), MINB)
correlation_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const bf16* __restrict__ k, const bf16* __restrict__ grid,
                                  const float* __restrict__ out, const float* __restrict__ dout,
                                  bf16* __restrict__ dmain, float* __restrict__ stats,
                                  float* __restrict__ dq, int* __restrict__ amax_out, int HW,
                                  int Cq, int Cv, int DM) {
  using G = RowsGeo<KB, W, CV, WD, CTB, NC>;
  constexpr int DB = G::DB;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (ht::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* qs = base;                  // KB blocks [BR][W]
  unsigned char* dms = qs + KB * G::QBLK;    // DB blocks [BR][WD]: dmain's v columns
  unsigned char* ring = dms + DB * G::DBLK;  // ST x (KB k blocks, DB v blocks, grid tile)
  float4* rs = reinterpret_cast<float4*>(ring + ST * G::STAGE);  // [BR] (0, 1/d, c, d_ms)
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + G::BR);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * G::BR;
  const int z = blockIdx.z;  // the column tile of dq: blocks CTB z ..
  const int nkb = (Cq + W - 1) / W;
  const int nT = (HW + TKW - 1) / TKW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t boff = static_cast<size_t>(b) * HW;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      ht::mbar_init(&full[s], 1);
      ht::mbar_init(&empty[s], 4 * NC);  // lane 0 of every consumer warp
    }
    ht::mbar_init(qfull, 1);
    ht::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // ---- the producer warpgroup: its first warp loads, the others leave ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > 4 * NC) return;
    // the grid tiles: key r's 16 bytes at (r / 8) 256 + (r % 8) 16 (core
    // matrices of 8 keys, the depth's second 8 channels 128 bytes on); all
    // zero but each key's first 4 bytes, written per tile
    for (int i = lane; i < ST * (GT / 16); i += 32) {
      const int s = i / (GT / 16), o = i % (GT / 16);
      *reinterpret_cast<uint4*>(ring + s * G::STAGE + KB * G::KBLK + DB * G::VBLK + o * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    if (lane == 0) {
      ht::mbar_arrive_expect_tx(qfull, KB * G::QBLK);
      for (int kb = 0; kb < KB; ++kb)
        ht::tma_load_3d(qs + kb * G::QBLK, &tq, qfull, kb * W, row0, b);
    }
    for (int j = 0; j < nT; ++j) {
      const int s = j % ST;
      unsigned char* st = ring + s * G::STAGE;
      ht::mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
      unsigned char* gt = st + KB * G::KBLK + DB * G::VBLK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, key = j * TKW + r;
        *reinterpret_cast<uint32_t*>(gt + (r >> 3) * 256 + (r & 7) * 16) =
            key < HW ? __ldg(reinterpret_cast<const unsigned*>(grid) + key) : 0u;
      }
      ht::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        ht::mbar_arrive_expect_tx(&full[s], KB * G::KBLK + DB * G::VBLK);
        for (int kb = 0; kb < KB; ++kb)
          ht::tma_load_3d(st + kb * G::KBLK, &tk, &full[s], kb * W, j * TKW, b);
        for (int db = 0; db < DB; ++db)
          ht::tma_load_3d(st + KB * G::KBLK + db * G::VBLK, &tv, &full[s], db * WD, j * TKW, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs(NC, MINB)));
  const int wg = warp >> 2, wq = warp & 3;  // rows 64 wg + 16 wq .. + 16 of the block
  const int g = lane >> 2, t = lane & 3;    // within them rows g and g + 8
  const int bar = 1 + wg;

  // the prologue, while the copies fly: each warp its 16 rows, four at a
  // time with every load in flight, a lane columns lane + 32 j (the
  // prologue kernel's order, so c has its bits); dmain's v columns into the
  // warpgroup's tile, zeros from Cv on; tile 0 writes dmain for K3
  constexpr int NJ = (CV + 3 + 31) / 32;
  static_assert(32 * NJ >= CV + 16, "the lanes reach every column of dmain");
  const int CO = Cv + 3;
#pragma unroll 1
  for (int i0 = 0; i0 < 16; i0 += 4) {
    float dv[4][NJ], ov[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 64 * wg + 16 * wq + i0 + i;
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
      const int r = 64 * wg + 16 * wq + i0 + i, row = row0 + r;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) part = fmaf(dv[i][j], ov[i][j], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
      bf16* drow = dmain + (boff + (row < HW ? row : 0)) * DM;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        const bf16 x = __float2bfloat16_rn(col < Cv + 2 ? dv[i][j] : 0.f);
        if (col < CV)
          *reinterpret_cast<bf16*>(dms + swizzled<WD>(r, col, G::DBLK)) =
              col < Cv ? x : __float2bfloat16_rn(0.f);
        if (z == 0 && row < HW && col < DM) drow[col] = x;
      }
      // (0, 1/d, c, d_ms): the lane holding column Cv + 2 has both
      const int jl = (Cv + 2) >> 5, ll = (Cv + 2) & 31;
      float inv = 0.f, dms_v = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j == jl) {
          inv = __shfl_sync(FULL, ov[i][j], ll);
          dms_v = __shfl_sync(FULL, dv[i][j], ll);
        }
      if (lane == 0) rs[r] = make_float4(0.f, inv, part, dms_v);
    }
  }
  ht::fence_proxy_async();  // the dmain tile, written by threads, read by wgmma
  warpgroup_sync(bar);

  // the grid's depth step: A holds dmain's columns Cv, Cv + 1 of rows g and
  // g + 8 at depth 0, 1 (lanes t = 0), zeros elsewhere
  uint32_t ga[4] = {0u, 0u, 0u, 0u};
  float cval[2], inv_d[2], d_ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * wq + 8 * h + g, row = row0 + r;
    if (t == 0 && row < HW) {
      const float* d = dout + (boff + row) * CO + Cv;
      ga[h] = mt::pack_bf16(d[0], d[1]);
    }
    const float4 r4 = rs[r];
    inv_d[h] = r4.y;
    cval[h] = r4.z;
    d_ms[h] = r4.w;
  }

  constexpr uint32_t SWQ = ht::swizzle_code(2 * W), SWD = ht::swizzle_code(2 * WD);
  const uint64_t dq_base = ht::make_desc(qs + wg * 64 * W * 2, 16, 16 * W, SWQ);
  const uint64_t dd_base = ht::make_desc(dms + wg * 64 * WD * 2, 16, 16 * WD, SWD);

  float acc[CTB][W / 2];  // dq: column 8 n + 2 t + e % 2 of block CTB z + cb at acc[cb][4 n + e]
#pragma unroll
  for (int cb = 0; cb < CTB; ++cb) zero(acc[cb]);
  float mref[2], best[2];  // the rows' reference (a raw score, common to a row's 4 lanes); this lane's largest score
  int bidx[2];             // ... and its first index
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mref[h] = best[h] = -INFINITY;
    bidx[h] = 0x7fffffff;
  }

  ht::mbar_wait(qfull, 0);
  constexpr int NG = NH / TKG;  // groups of TKG keys a pass
  // a pass's dS' fragments: alive until the next pass's first wait, while
  // their steps fly beside its first products
  uint32_t da[NG][4];
  for (int j = 0; j < nT; ++j) {
    const int sj = j % ST;
    const unsigned char* st = ring + sj * G::STAGE;
    ht::mbar_wait(&full[sj], (j / ST) & 1);
    const uint64_t dkt = ht::make_desc(st, G::KBLK, 16 * W, SWQ);
#pragma unroll
    for (int hh = 0; hh < TKW / NH; ++hh) {
      // keys NH hh .. + NH of the tile: S = q k^T and dP = dmain [v | grid]^T
      float s[NH / 2], dp[NH / 2];  // key 8 n + 2 t + e % 2 of the pass at [4 n + e]
      ht::wgmma_fence();
      {
        const uint64_t dqd = ht::opaque(dq_base);
        const uint64_t dkd = ht::make_desc(st + hh * NH * 2 * W, 16, 16 * W, SWQ);
#pragma unroll
        for (int ks = 0; ks < G::KQ; ++ks)
          ht::wgmma_ss<NH>(s, dqd + kstep<W>(ks, G::QBLK), dkd + kstep<W>(ks, G::KBLK),
                           ks > 0 ? 1 : 0);
        const uint64_t ddd = ht::opaque(dd_base);
        const uint64_t dvd = ht::make_desc(st + KB * G::KBLK + hh * NH * 2 * WD, 16, 16 * WD, SWD);
#pragma unroll
        for (int ks = 0; ks < G::KV; ++ks)
          ht::wgmma_ss<NH>(dp, ddd + kstep<WD>(ks, G::DBLK), dvd + kstep<WD>(ks, G::VBLK),
                           ks > 0 ? 1 : 0);
        ht::wgmma_rs<NH, 0>(dp, ga,
                            ht::make_desc(st + KB * G::KBLK + DB * G::VBLK + hh * NH * 32, 128,
                                          256, ht::SWIZZLE_NONE));
      }
      ht::wgmma_commit();
      ht::wgmma_wait<0>();  // also the last pass's dq steps
      ht::fence_regs(s);
      ht::fence_regs(dp);
#pragma unroll
      for (int cb = 0; cb < CTB; ++cb) ht::fence_regs(acc[cb]);
      if (hh > 0) {
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) ht::fence_regs(da[gi]);
      }

      // the groups of TKG keys in order: keys past HW score -inf; each lane
      // keeps its largest score and its first index (the first in ascending
      // order among equal ones: where the group's largest passes the lane's,
      // the first of the group's keys that holds it); a row's reference
      // moves where its max passes it by LAZY_GAP (the max over its 4 lanes,
      // taken where the warp votes so), as in the mma.sync kernel; every move
      // is decided here, before any of the pass's dq steps is issued: mg[gi]
      // is the reference after group gi (a move always changes it), m_in the
      // one the pass started with
      const int key0 = j * TKW + hh * NH;
      float mg[NG][2], m_in[2] = {mref[0], mref[1]};
      bool late = false;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int n_valid = HW - key0 - gi * TKG;
        if (n_valid < TKG) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (nt * 8 + 2 * t + (e & 1) >= n_valid) s[4 * (2 * gi + nt) + e] = -INFINITY;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // this lane's keys of the group for row h, ascending: 2t, 2t + 1, 2t + 8, 2t + 9
          const float* x = s + 8 * gi;
          const float gmax = fmaxf(fmaxf(x[2 * h], x[2 * h + 1]), fmaxf(x[4 + 2 * h], x[5 + 2 * h]));
          if (gmax > best[h]) {
            best[h] = gmax;
            const int kl = x[2 * h] == gmax ? 0 : x[2 * h + 1] == gmax ? 1 : x[4 + 2 * h] == gmax ? 8 : 9;
            bidx[h] = key0 + gi * TKG + 2 * t + kl;
          }
        }
        const bool renew = best[0] > mref[0] + LAZY_GAP || best[1] > mref[1] + LAZY_GAP;
        if (__any_sync(FULL, renew)) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = best[h];
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
            if (mx > mref[h] + LAZY_GAP) {
              mref[h] = mx;
              if (gi > 0) late = true;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) mg[gi][h] = mref[h];
      }
      if (NG > 1) late = warpgroup_any(late, bar);

      // dS' = e (dP - c), e = 2^((s - m) log2e) against the reference after
      // the group, packed to bf16 A fragments; dq += dS' . k[keys of the
      // group][this tile's columns], k read MN-major from the same stage
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        // a row that moved at this group: acc *= 2^((m_old - m_new) log2e),
        // 0 on the first move
        const auto rescale = [&] {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float m_old = gi > 0 ? mg[gi - 1][h] : m_in[h];
            if (mg[gi][h] != m_old) {
              const float alpha = mt::ex2((m_old - mg[gi][h]) * LOG2E);
#pragma unroll
              for (int cb = 0; cb < CTB; ++cb)
#pragma unroll
                for (int i = 0; i < W / 2; ++i)
                  if (((i >> 1) & 1) == h) acc[cb][i] *= alpha;
            }
          }
        };
        if (gi == 0) {
          rescale();  // the pass's first group: no dq step in flight
        } else if (late) {
          ht::wgmma_wait<0>();
#pragma unroll
          for (int cb = 0; cb < CTB; ++cb) ht::fence_regs(acc[cb]);
          rescale();
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * (2 * gi + nt) + e, h = e >> 1;
            const float ev = mt::ex2((s[i] - mg[gi][h]) * LOG2E);
            ds[e] = ev * (dp[i] - cval[h]);
          }
          da[gi][2 * nt] = mt::pack_bf16(ds[0], ds[1]);
          da[gi][2 * nt + 1] = mt::pack_bf16(ds[2], ds[3]);
        }
        ht::wgmma_fence();
#pragma unroll
        for (int cb = 0; cb < CTB; ++cb)
          if (z * CTB + cb < nkb)
            ht::wgmma_rs<W, 1>(
                acc[cb], da[gi],
                dkt + (((z * CTB + cb) * G::KBLK + (hh * NH + gi * TKG) * 2 * W) >> 4));
        ht::wgmma_commit();
      }
    }
    // the tile's last steps land before its stage is freed (steps in flight
    // across the tile's end made ptxas serialise every wgmma)
    ht::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < CTB; ++cb) ht::fence_regs(acc[cb]);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) ht::fence_regs(da[gi]);
    if (lane == 0) ht::mbar_arrive(&empty[sj]);
  }

  // the end of the sweep (correlation_bwd_mma.cu::rows_finish): the row's
  // lanes merge their maxima (the smallest key wins a tie) into M and the
  // first argmax (key 0 for a row with none, a NaN row); dq = (2^((m - M)
  // log2e) acc + d_ms k_amax) / d; tile 0 writes lse = M log2e - log2(1/d),
  // the row's other statistics and its argmax
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float bv = best[h];
    int bi = bidx[h];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi >= HW) bi = 0;
    const float a = mt::ex2((mref[h] - bv) * LOG2E);  // 1 where m is the row's max
    const int row = row0 + 64 * wg + 16 * wq + 8 * h + g;
    if (row < HW) {
      const bf16* ka = k + (boff + bi) * Cq;
      float* o = dq + (boff + row) * Cq;
#pragma unroll
      for (int cb = 0; cb < CTB; ++cb)
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const int col = (z * CTB + cb) * W + n * 8 + 2 * t;
          if (col < Cq) {
            const float2 kv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ka + col));
            *reinterpret_cast<float2*>(o + col) =
                make_float2(fmaf(acc[cb][4 * n + 2 * h], a, d_ms[h] * kv.x) * inv_d[h],
                            fmaf(acc[cb][4 * n + 2 * h + 1], a, d_ms[h] * kv.y) * inv_d[h]);
          }
        }
      if (z == 0 && t == 0) {
        *reinterpret_cast<float4*>(stats + (boff + row) * 4) =
            make_float4(bv * LOG2E - log2f(inv_d[h]), inv_d[h], cval[h], d_ms[h]);
        amax_out[boff + row] = bi;
      }
    }
  }
}

// =================================================================== K3 ==
// q and k channels in KB blocks of W; [v | grid | 0] and dmain in DB blocks
// of WD (DB WD >= CV + 16), dv's columns in CV / WD of them; a column tile
// holds TK blocks of dk and TV of dv; NC consumer warpgroups.
template <int KB, int W, int CV, int WD, int TK, int TV, int NC>
struct ColsGeo {
  static constexpr int DB = (CV + 16 + WD - 1) / WD;
  static constexpr int BR = 64 * NC;          // keys a block
  static constexpr int KQ = KB * W / 16;      // depth steps of k q^T
  static constexpr int KD = CV / 16 + 1;      // of [v | grid] dmain^T
  static constexpr int KBLK = BR * W * 2;     // bytes of a resident k block
  static constexpr int GBLK = BR * WD * 2;    // of a resident [v | grid | 0] block
  static constexpr int QBLK = TKW * W * 2;    // of a chunk's q block
  static constexpr int MBLK = TKW * WD * 2;   // of a chunk's dmain block
  static constexpr int STAGE = KB * QBLK + DB * MBLK;
  static constexpr int RESIDENT = KB * KBLK + DB * GBLK;
  static_assert(W == 16 || W == 32 || W == 64, "a swizzle width");
  static_assert(WD == 16 || WD == 32 || WD == 64, "a swizzle width");
  static_assert(CV % WD == 0, "whole blocks of dv");
  static_assert(KBLK % 1024 == 0 && GBLK % 1024 == 0 && QBLK % 1024 == 0 && MBLK % 1024 == 0,
                "tiles on 1,024-byte boundaries");
  static_assert(BR <= 256, "a TMA box");
};

// The resident tiles, the ring, then each stage's statistics (float4) and
// argmax (int) of its 64 rows; the barriers follow.
template <int KB, int W, int CV, int WD, int TK, int TV, int NC, int ST>
__host__ __device__ constexpr size_t cols_region() {
  using G = ColsGeo<KB, W, CV, WD, TK, TV, NC>;
  return static_cast<size_t>(G::RESIDENT) + static_cast<size_t>(ST) * (G::STAGE + TKW * 20);
}

template <int KB, int W, int CV, int WD, int TK, int TV, int NC, int ST, int MINB, int NH>
__global__ void __launch_bounds__(128 * (NC + 1), MINB)
correlation_bwd_cols_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tm,
                                  const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                  const float* __restrict__ stats, const int* __restrict__ amax,
                                  float* __restrict__ dk, float* __restrict__ dv, int HW,
                                  int Cq, int Cv) {
  using G = ColsGeo<KB, W, CV, WD, TK, TV, NC>;
  constexpr int DB = G::DB;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (ht::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* ks = base;                  // KB blocks [BR][W]: k
  unsigned char* vgs = ks + KB * G::KBLK;    // DB blocks [BR][WD]: [v | grid | 0]
  unsigned char* ring = vgs + DB * G::GBLK;  // ST x (KB q blocks, DB dmain blocks)
  float4* sts = reinterpret_cast<float4*>(ring + ST * G::STAGE);  // [ST][64] (lse, 1/d, c, d_ms)
  int* ams = reinterpret_cast<int*>(sts + ST * TKW);              // [ST][64] argmax
  uint64_t* full = reinterpret_cast<uint64_t*>(ams + ST * TKW);
  uint64_t* empty = full + ST;
  uint64_t* kfull = empty + ST;

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * G::BR;  // the block's first key
  const int nkb = (Cq + W - 1) / W, nvb = (Cv + WD - 1) / WD;
  const int zk = blockIdx.z * TK, zv = blockIdx.z * TV;  // the tile's first dk and dv blocks
  const bool has_k = zk < nkb, has_v = zv < nvb;
  const int nT = (HW + TKW - 1) / TKW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t boff = static_cast<size_t>(b) * HW;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      ht::mbar_init(&full[s], 1);
      ht::mbar_init(&empty[s], 4 * NC);
    }
    ht::mbar_init(kfull, 1);
    ht::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > 4 * NC) return;
    if (lane == 0) {
      ht::mbar_arrive_expect_tx(kfull, KB * G::KBLK);
      for (int kb = 0; kb < KB; ++kb)
        ht::tma_load_3d(ks + kb * G::KBLK, &tk, kfull, kb * W, col0, b);
    }
    for (int u = 0; u < nT; ++u) {
      const int s = u % ST;
      unsigned char* st = ring + s * G::STAGE;
      ht::mbar_wait(&empty[s], ((u / ST) & 1) ^ 1);
      // the chunk's statistics and argmax, zeros past HW: such a row has
      // q = dmain = c = 0, so P = 1 there adds nothing to dv and its dS is 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, row = u * TKW + r;
        const bool ok = row < HW;
        sts[s * TKW + r] = ok ? __ldg(reinterpret_cast<const float4*>(stats) + boff + row)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        ams[s * TKW + r] = ok ? __ldg(amax + boff + row) : 0;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) {
        ht::mbar_arrive_expect_tx(&full[s], KB * G::QBLK + DB * G::MBLK);
        for (int kb = 0; kb < KB; ++kb)
          ht::tma_load_3d(st + kb * G::QBLK, &tq, &full[s], kb * W, u * TKW, b);
        for (int db = 0; db < DB; ++db)
          ht::tma_load_3d(st + KB * G::QBLK + db * G::MBLK, &tm, &full[s], db * WD, u * TKW, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs(NC, MINB)));
  const int wg = warp >> 2, wq = warp & 3;  // keys 64 wg + 16 wq .. + 16 of the block
  const int g = lane >> 2, t = lane & 3;    // within them keys g and g + 8
  const int bar = 1 + wg;

  // [v | grid | 0] of the warpgroup's 64 keys, in the layout TMA would give
  // it: v's columns, the grid's two at Cv (Cv is a multiple of 8: one
  // 16-byte piece), zeros past them and past HW
  {
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
      *reinterpret_cast<uint4*>(vgs + swizzled<WD>(r, c, G::GBLK)) = x;
    }
  }
  ht::fence_proxy_async();
  warpgroup_sync(bar);

  constexpr uint32_t SWQ = ht::swizzle_code(2 * W), SWD = ht::swizzle_code(2 * WD);
  const uint64_t dk_base = ht::make_desc(ks + wg * 64 * W * 2, 16, 16 * W, SWQ);
  const uint64_t dg_base = ht::make_desc(vgs + wg * 64 * WD * 2, 16, 16 * WD, SWD);
  const int kw0 = col0 + 64 * wg + 16 * wq + g;  // this thread's keys kw0 and kw0 + 8

  float acc_k[TK][W / 2], acc_v[TV][WD / 2];  // key 16 wq + g + 8 (e / 2), column 8 n + 2 t + e % 2 at [4 n + e]
#pragma unroll
  for (int i = 0; i < TK; ++i) zero(acc_k[i]);
#pragma unroll
  for (int i = 0; i < TV; ++i) zero(acc_v[i]);

  ht::mbar_wait(kfull, 0);
  constexpr int NK = NH / 16;  // depth steps of 16 rows a pass
  // a pass's P^T and dS^T fragments: alive until the next pass's first wait,
  // while their steps fly beside its first products
  uint32_t pa[NK][4], da[NK][4];
  for (int u = 0; u < nT; ++u) {
    const int su = u % ST;
    const unsigned char* st = ring + su * G::STAGE;
    const float4* srow = sts + su * TKW;
    const int* arow = ams + su * TKW;
    ht::mbar_wait(&full[su], (u / ST) & 1);
    const uint64_t dqt = ht::make_desc(st, G::QBLK, 16 * W, SWQ);
    const uint64_t dmt = ht::make_desc(st + KB * G::QBLK, G::MBLK, 16 * WD, SWD);
#pragma unroll
    for (int hh = 0; hh < TKW / NH; ++hh) {
      // rows NH hh .. + NH of the chunk: S^T = k q^T and dP^T = [v | grid] dmain^T
      float s[NH / 2], dp[NH / 2];  // row 8 n + 2 t + e % 2 of the pass at [4 n + e]
      ht::wgmma_fence();
      {
        const uint64_t dkd = ht::opaque(dk_base);
        const uint64_t dqd = ht::make_desc(st + hh * NH * 2 * W, 16, 16 * W, SWQ);
#pragma unroll
        for (int kq = 0; kq < G::KQ; ++kq)
          ht::wgmma_ss<NH>(s, dkd + kstep<W>(kq, G::KBLK), dqd + kstep<W>(kq, G::QBLK),
                           kq > 0 ? 1 : 0);
        if (has_k) {
          const uint64_t dgd = ht::opaque(dg_base);
          const uint64_t dmd =
              ht::make_desc(st + KB * G::QBLK + hh * NH * 2 * WD, 16, 16 * WD, SWD);
#pragma unroll
          for (int kd = 0; kd < G::KD; ++kd)
            ht::wgmma_ss<NH>(dp, dgd + kstep<WD>(kd, G::GBLK), dmd + kstep<WD>(kd, G::MBLK),
                             kd > 0 ? 1 : 0);
        }
      }
      ht::wgmma_commit();
      ht::wgmma_wait<0>();  // also the last pass's dk and dv steps
      ht::fence_regs(s);
      ht::fence_regs(dp);
      if (hh > 0) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          ht::fence_regs(pa[kk]);
          ht::fence_regs(da[kk]);
        }
      }

      // P^T = 2^(s log2e - lse) and dS^T = P^T (dP^T - c), the max-score
      // cotangent in dP^T where a row's argmax is the key (as the mma.sync
      // kernel's cols_terms), packed to bf16 A fragments over 16 rows each;
      // dk += dS^T q and dv += P^T dmain[:, :Cv], q and dmain read MN-major
      // from the same stage
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int il = hh * NH + 16 * kk + 8 * nt + 2 * t;
          const float4 st0 = srow[il], st1 = srow[il + 1];
          const int2 am = *reinterpret_cast<const int2*>(arow + il);  // il is even
          // the accumulators are only read: ptxas serialises every wgmma of
          // a kernel that writes one outside them (the max-score cotangent
          // goes into a copy), and straight-line code (no branch on the
          // argmax) lets it interleave the exponentials
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * (2 * kk + nt) + e;
            const float4 sx = (e & 1) ? st1 : st0;
            p[e] = mt::ex2(fmaf(s[i], LOG2E, -sx.x));
            float dpe = dp[i];
            if (kw0 + 8 * (e >> 1) == ((e & 1) ? am.y : am.x)) dpe += sx.w;
            ds[e] = p[e] * (dpe - sx.z);
          }
          pa[kk][2 * nt] = mt::pack_bf16(p[0], p[1]);
          pa[kk][2 * nt + 1] = mt::pack_bf16(p[2], p[3]);
          da[kk][2 * nt] = mt::pack_bf16(ds[0], ds[1]);
          da[kk][2 * nt + 1] = mt::pack_bf16(ds[2], ds[3]);
        }
        ht::wgmma_fence();
        const int r16 = hh * NH + 16 * kk;  // the step's first row of the chunk
        if (has_k) {
#pragma unroll
          for (int i = 0; i < TK; ++i)
            if (zk + i < nkb)
              ht::wgmma_rs<W, 1>(acc_k[i], da[kk], dqt + (((zk + i) * G::QBLK + r16 * 2 * W) >> 4));
        }
        if (has_v) {
#pragma unroll
          for (int i = 0; i < TV; ++i)
            if (zv + i < nvb)
              ht::wgmma_rs<WD, 1>(acc_v[i], pa[kk],
                                  dmt + (((zv + i) * G::MBLK + r16 * 2 * WD) >> 4));
        }
      }
      ht::wgmma_commit();
    }
    // the chunk's last steps land before its stage is freed
    ht::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < TK; ++i) ht::fence_regs(acc_k[i]);
#pragma unroll
    for (int i = 0; i < TV; ++i) ht::fence_regs(acc_v[i]);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      ht::fence_regs(pa[kk]);
      ht::fence_regs(da[kk]);
    }
    if (lane == 0) ht::mbar_arrive(&empty[su]);
  }

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

// ============================================================ launches ==

struct Args {
  const bf16 *q, *k, *v, *grid;
  const float *out, *dout;
  bf16* dmain;
  float *stats, *dq, *dk, *dv;
  int* amax;
  int B, HW, Cq, Cv, DM;
  cudaStream_t stream;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int KB, int W, int CV, int WD, int CTB, int NC, int ST, int MINB, int NH>
cudaError_t launch_rows_wgmma(const Args& a) {
  using G = RowsGeo<KB, W, CV, WD, CTB, NC>;
  static_assert(NH == 16 || NH == 32 || NH == 64, "keys a pass");
  if (a.Cq > KB * W || a.Cv > CV) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_rows_wgmma_kernel<KB, W, CV, WD, CTB, NC, ST, MINB, NH>;
  constexpr size_t smem = 1024 + rows_region<KB, W, CV, WD, CTB, NC, ST>() + (2 * ST + 1) * 8;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  e = ht::encode_bf16_map(&tq, a.q, a.Cq, a.HW, a.B, W, G::BR);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tk, a.k, a.Cq, a.HW, a.B, W, TKW);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tv, a.v, a.Cv, a.HW, a.B, WD, TKW);
  if (e != cudaSuccess) return e;
  const dim3 blocks(ceil_div(a.HW, G::BR), a.B, ceil_div(ceil_div(a.Cq, W), CTB));
  kernel<<<blocks, 128 * (NC + 1), smem, a.stream>>>(tq, tk, tv, a.k, a.grid, a.out, a.dout,
                                                     a.dmain, a.stats, a.dq, a.amax, a.HW, a.Cq,
                                                     a.Cv, a.DM);
  return cudaGetLastError();
}

template <int KB, int W, int CV, int WD, int TK, int TV, int NC, int ST, int MINB, int NH>
cudaError_t launch_cols_wgmma(const Args& a) {
  using G = ColsGeo<KB, W, CV, WD, TK, TV, NC>;
  static_assert(NH == 16 || NH == 32 || NH == 64, "rows a pass");
  if (a.Cq > KB * W || a.Cv > CV) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_cols_wgmma_kernel<KB, W, CV, WD, TK, TV, NC, ST, MINB, NH>;
  constexpr size_t smem = 1024 + cols_region<KB, W, CV, WD, TK, TV, NC, ST>() + (2 * ST + 1) * 8;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap tk, tq, tm;
  e = ht::encode_bf16_map(&tk, a.k, a.Cq, a.HW, a.B, W, G::BR);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tq, a.q, a.Cq, a.HW, a.B, W, TKW);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tm, a.dmain, a.DM, a.HW, a.B, WD, TKW);
  if (e != cudaSuccess) return e;
  const int tiles = ceil_div(ceil_div(a.Cq, W), TK) > ceil_div(ceil_div(a.Cv, WD), TV)
                        ? ceil_div(ceil_div(a.Cq, W), TK)
                        : ceil_div(ceil_div(a.Cv, WD), TV);
  const dim3 blocks(ceil_div(a.HW, G::BR), a.B, tiles);
  kernel<<<blocks, 128 * (NC + 1), smem, a.stream>>>(tk, tq, tm, a.v, a.grid, a.stats, a.amax,
                                                     a.dk, a.dv, a.HW, a.Cq, a.Cv);
  return cudaGetLastError();
}

// The instantiations. K2: q channels as KB blocks of W, v's class CV in
// blocks of WD, dq column tiles of CTB blocks, consumer warpgroups, ring
// stages, least blocks a SM, keys a pass (NH). K3: the same, with dk and dv
// column tiles of TK and TV blocks and rows a pass. Each width takes the
// smallest class that holds Cq and Cv (zeros pad the rest); every class of
// this list stands in ops/correlation.py::WGMMA_WIDTH_CLASSES.
//
// Chosen with tools/torch_chip_studies.py k23-wgmma-variants on an NVIDIA
// H100 80GB HBM3 at 700 W, the wgmma and mma.sync kernels in turns in one
// call, every variant giving the package's bits (ms, HW = 6,256, B = 10
// unless stated). What bounds the choice is the register cap: ptxas
// compiles a consumer at the launch bound's count (65,536 / threads / MINB:
// 168 with two consumer warpgroups, 128 with three, 96 with four, 80 with
// two blocks a SM), not at the count setmaxnreg gives it, and a kernel short
// of registers has every wgmma serialised (C7512).
// - C = 32: K2 four warpgroups in passes of 32 keys (96 registers)
//   0.4080-0.4136, a ring of 2 stages 0.4101-0.4154, passes of 16
//   0.4562-0.4642, two warpgroups with two blocks a SM 0.4629-0.4680, three
//   in passes of 64 0.4964-0.5013, two in passes of 64 0.5868-0.5876; K3
//   four warpgroups in passes of 16 0.4714-0.4715, of 32 0.4877-0.4878
//   (serialised for registers), three in passes of 64 0.5217-0.5224, two
//   0.7018-0.7066. The mma.sync pair 0.3994-0.4021 and 0.3796-0.3809, so the
//   package keeps it there (ops/correlation.py::MMA_SYNC_FASTER; B = 90:
//   3.5723-3.6051 and 4.1228-4.1247 against 3.1989-3.2709 and
//   3.0650-3.0901). The classes of 16 and 64 channels follow C = 32
//   (untimed: no driven path has them).
// - C = 128: K2 two warpgroups in passes of 64 0.8129-0.8301 (passes of 32
//   0.8842-0.8984, one warpgroup 1.3472-1.3665; mma.sync 1.1076-1.1250). K3
//   with the whole [dk | dv] in one warpgroup's registers 1.3211-1.3382 (two
//   column tiles 1.5793-1.6033; mma.sync 1.4365-1.4454).
// - Cq 256 / Cv 96: K2 two warpgroups, dq in two column tiles 1.7257-1.7551
//   (passes of 32 1.9190-1.9336; mma.sync 2.1817-2.1840). K3 the whole 176
//   columns in one warpgroup in passes of 16 1.8724-1.8842 (two tiles
//   2.5402-2.5735; mma.sync 2.3961-2.3967).
// - C = 256: K2 one warpgroup, dq in two column tiles 2.8081-2.8358 (four
//   tiles 5.3195-5.3402; mma.sync, streamed, 6.4420-6.4478); K3 two tiles of
//   dk and dv 3.1402-3.1536 (four 5.5984-5.6215; mma.sync 7.7059-7.7190).
cudaError_t dispatch_rows_wgmma(const Args& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_rows_wgmma<1, 16, 16, 16, 1, 4, 3, 1, 32>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_rows_wgmma<1, 16, 32, 32, 1, 4, 3, 1, 32>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_rows_wgmma<1, 32, 32, 32, 1, 4, 3, 1, 32>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_rows_wgmma<1, 64, 64, 64, 1, 2, 3, 1, 64>(a);
  if (a.Cq <= 128 && a.Cv <= 128) return launch_rows_wgmma<2, 64, 128, 64, 2, 2, 3, 1, 64>(a);
  if (a.Cq <= 256 && a.Cv <= 96) return launch_rows_wgmma<4, 64, 96, 32, 2, 2, 2, 1, 64>(a);
  if (a.Cq <= 256 && a.Cv <= 256) return launch_rows_wgmma<4, 64, 256, 64, 2, 1, 2, 1, 64>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_cols_wgmma(const Args& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_cols_wgmma<1, 16, 16, 16, 1, 1, 4, 3, 1, 16>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_cols_wgmma<1, 16, 32, 32, 1, 1, 4, 3, 1, 16>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_cols_wgmma<1, 32, 32, 32, 1, 1, 4, 3, 1, 16>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_cols_wgmma<1, 64, 64, 64, 1, 1, 2, 3, 1, 64>(a);
  if (a.Cq <= 128 && a.Cv <= 128) return launch_cols_wgmma<2, 64, 128, 64, 2, 2, 1, 3, 1, 64>(a);
  if (a.Cq <= 256 && a.Cv <= 96) return launch_cols_wgmma<4, 64, 96, 32, 4, 3, 1, 2, 1, 16>(a);
  if (a.Cq <= 256 && a.Cv <= 256) return launch_cols_wgmma<4, 64, 256, 64, 2, 2, 1, 2, 1, 64>(a);
  return cudaErrorInvalidValue;
}

bool wgmma_takes(int B, int HW, int Cq, int Cv, int dtype) {
  return B >= 0 && HW >= 0 && B <= 65535 && dtype == 1 && Cq % 8 == 0 && Cv % 8 == 0 &&
         Cq >= 8 && Cv >= 8 && Cq <= 256 && Cv <= 256;
}

int dmain_width(int Cv) { return (Cv + 2 + 15) / 16 * 16; }

Args wgmma_args(const void* q, const void* k, const void* v, const void* grid, const void* out,
                const void* dout, const void* dmain, const void* stats, const void* amax,
                void* dq, void* dk, void* dv, int B, int HW, int Cq, int Cv, void* stream) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
              static_cast<const float*>(out), static_cast<const float*>(dout),
              const_cast<bf16*>(static_cast<const bf16*>(dmain)),
              const_cast<float*>(static_cast<const float*>(stats)), static_cast<float*>(dq),
              static_cast<float*>(dk), static_cast<float*>(dv),
              const_cast<int*>(static_cast<const int*>(amax)), B, HW, Cq, Cv, dmain_width(Cv),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The wgmma kernels of the "mma" design: bf16 (dtype 1), Cq and Cv multiples
// of 8 from 8 to 256; q, k, v, dmain, stats, dq, dk, dv aligned to 16 bytes,
// the grid to 4. Arguments and outputs as correlation_bwd_rows_mma and
// correlation_bwd_cols_mma; cudaErrorInvalidValue for inputs they do not take.

// K2: dq [B, HW, Cq], stats [B, HW, 4] = (lse, 1/d, c, d_ms), amax [B, HW]
// int32 and dmain [B, HW, dmain_width(Cv)] bf16 from q, k, v, the grid, the
// forward's out and its cotangent dout (float32). One launch.
extern "C" int correlation_bwd_rows_wgmma(const void* q, const void* k, const void* v,
                                          const void* grid, const void* out, const void* dout,
                                          void* dq, void* stats, void* amax, void* dmain, int B,
                                          int HW, int Cq, int Cv, int dtype, void* stream) {
  if (!wgmma_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  return dispatch_rows_wgmma(wgmma_args(q, k, v, grid, out, dout, dmain, stats, amax, dq,
                                        nullptr, nullptr, B, HW, Cq, Cv, stream));
}

// K3: dk [B, HW, Cq] and dv [B, HW, Cv] from q, k, v, the grid and what K2
// left (either kernel's).
extern "C" int correlation_bwd_cols_wgmma(const void* q, const void* k, const void* v,
                                          const void* grid, const void* dmain,
                                          const void* stats, const void* amax, void* dk, void* dv,
                                          int B, int HW, int Cq, int Cv, int dtype,
                                          void* stream) {
  if (!wgmma_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  return dispatch_cols_wgmma(wgmma_args(q, k, v, grid, nullptr, nullptr, dmain, stats, amax,
                                        nullptr, dk, dv, B, HW, Cq, Cv, stream));
}
