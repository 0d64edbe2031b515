// Fused correlation-volume softmax-warp, backward pass, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of mapfree_tpu/ops/correlation.py::_fcw_bwd:
// _bwd_rows_kernel (K2, the row pass) and _bwd_cols_kernel (K3, the column
// pass). The forward (correlation_fwd.cu) computes, per batch and query row i,
//
//   s_ij = q_i . k_j,  P_ij = softmax_j(s_ij),
//   out_i = [ sum_j P_ij [v_j | grid_j] ,  max_j P_ij ]        [Cv + 3] floats
//
// Given the cotangent dout [B, HW, Cv + 3] (dmain = its first Cv + 2 columns,
// d_ms = its last), the backward is, without materialising [HW, HW]:
//
//   dP_ij = dmain_i . [v_j | grid_j] + d_ms_i [j == first argmax_j s_ij]
//   c_i   = sum_j dP_ij P_ij = dout_i . out_i
//   dS_ij = P_ij (dP_ij - c_i)
//   dq_i  = sum_j dS_ij k_j                  (K2, one block per tile of rows i)
//   dk_j  = sum_i dS_ij q_i                  (K3, one block per tile of columns j)
//   dv_j  = sum_i P_ij dmain_i[:Cv]          (K3; the grid is a constant)
//
// Bound at the 3d3d training shape (B=10, HW=6,256, Cq=Cv=32, bf16): K2 does
// 2*B*HW^2*(32+34+32) = 7.7e10 FLOP in three products and B*HW^2 = 3.9e8
// exponentials; K3 does 2*B*HW^2*(32+34+32+32) = 1.0e11 FLOP in four products
// and as many exponentials. At 989 TFLOP/s (bf16 tensor cores) and 16
// exponentials per SM per clock both sit near 0.1 ms, set by operations: the
// inputs and outputs are some 20 MB (0.006 ms at 3.35 TB/s). So the work is
// products and exponentials, nearly balanced, and nothing else may cost much.
//
// Two designs, chosen by the caller (ops/correlation.py::backward_design),
// each complete for its inputs: "fma" lives here, "mma" (the tensor cores) in
// correlation_bwd_mma.cu, built apart so that the two compile in parallel.
//
// "fma": float32 inputs, where exact float32 arithmetic is the
// point (no TF32), and the bf16 shapes the other design does not take (widths
// that are not multiples of 8; widened to float32 on load), at
// any Cq >= 1 and Cv >= 0. Scalar fused multiply-adds on float32 register
// tiles; no atomics, fixed sum orders, so two runs give the same bits.
//
// What bounds it. At the 3d3d training shape in float32 (B=10, HW=6,256,
// Cq=Cv=32) a score costs K2 Cq + (Cv + 2) + Cq = 98 FMAs and K3 Cq + (Cv + 2)
// + Cq + Cv = 130, plus one exponential each: 7.7e10 and 1.0e11 FLOP, 1.145
// and 1.519 ms at the FP32 FMA rate of 67 TFLOP/s (132 SMs x 128 lanes x 2
// FLOP x 1.98 GHz). The exponentials (3.9e8 a kernel) take 0.093 ms on the
// special-function units (16 per SM per clock), beside the FMAs; every other
// instruction (shared-memory loads, compares, shuffles) takes an FMA's issue
// slot. At the ResNet bottleneck (HW = 20, Cq = Cv = 1,024, B = 10) the bound
// is bytes: some 3.7 MB (bf16 inputs) to 5 MB (float32) read and written,
// 0.0011-0.0015 ms at 3.35 TB/s; there the work is to spread over the card
// at all. dispatch_rows / dispatch_cols
// pick one of two kernel pairs by HW alone, so that K2 and K3 always take the
// same family for a shape and K3 recomputes the very bits K2 took its
// statistics from:
//
// - Long rows (HW > SHORT_HW), correlation_bwd_rows_kernel (K2) and
//   correlation_bwd_cols_kernel (K3). A block of 256 threads owns BO = 64 OH
//   rows of its own side (K2: query rows; K3: keys) and walks the other side
//   in tiles of BS = 64 SH (K2: keys; K3: query rows). Thread (ty, tx) =
//   (tid / 16, tid % 16) owns own rows 64 h + 4 ty + r and streamed columns
//   64 h + 4 tx + j: two register tiles of 4 OH x 4 SH (8 x 4 as
//   dispatched), the scores s = q . k and dP = dmain . [v | grid], whose
//   operands are float4 reads of transposed tiles in shared memory (OH + SH
//   reads for 16 OH SH FMAs a channel, each read by a phase of eight lanes
//   one broadcast or eight consecutive 16-byte pieces). Two score-shaped
//   tiles are what K1's 8 x 8 could not afford: 2 x 64 accumulators and the
//   dq (K2) or dk and dv (K3) accumulators do not fit 255 registers, 2 x 32
//   do (ptxas's count is printed by chip_smoke.py's phase 2).
//   The streamed side's k^T / q^T and [v | grid]^T / dmain^T arrive in
//   chunks of KC channels through a ring of RING stages of 4-byte cp.async
//   copies issued a stage ahead; the copies transpose as they go (a warp
//   copies 8 channels of 4 rows: 32-byte pieces of global memory into 32
//   distinct banks, the pitches being 4 mod 32 floats), each thread's share
//   fixed at compile time, no division in the loop. Up to KC = 40 channels of
//   each product (Cq and Cv + 2: 32 and 34 at 3d3d) the own side's two tiles
//   stay resident and a tile is one ring step; wider, they stream through
//   the ring with each chunk. A tile's row-major operand of the second
//   products (K2: k rows; K3: q rows and dmain rows; K3 also the rows'
//   statistics) comes with its last chunk. One barrier for the ring and one
//   for the P / dS tile each step.
//   Every score is one FMA chain from channel 0 upwards, the order of a
//   float32 matrix product, in K2 and in K3 alike (fmaf(a, b, c) =
//   fmaf(b, a, c)), so K3's scores are K2's to the bit.
//   K2 takes one sweep: an online max m (raw score), the denominator, the
//   first argmax (each of the 16 lanes sharing a row keeps its own; the
//   smallest index wins among equal maxima when they merge) and the
//   unnormalised accumulator sum_j e_ij (dP_ij - c_i) k_j with e_ij =
//   2^((s_ij - m_i) log2e), the last two rescaled when m moves. m moves
//   lazily, as in K1: only a tile where some lane's max passes it by
//   LAZY_GAP (P up to 2^8) takes the max over the 16 lanes (four shuffles).
//   The row constant c_i = dout_i . out_i comes from the forward's buffer;
//   the max-score cotangent enters dP only at the first argmax, where P =
//   1 / d, so at the end dq_i = (2^((m - M) log2e) acc_i + d_ms_i
//   k_{amax_i}) / d_i with M the row's exact max: one k row from device
//   memory instead of a compare per score. That is the 98 FMAs a score of
//   the bound and one exponential, where the first port's first sweep spent
//   32 more and another exponential. A row with no score above -inf (a NaN
//   row) keeps no argmax; it takes key 0, so that the k row read stays in
//   the batch element and the NaN reaches dq.
//   dS goes once through a [BO][BS + 4] tile (float4 stores, conflict-free),
//   and the second products are register tiles as K1's P . v: the 16 lanes
//   of a row group split the CT = 4 CX NG accumulator columns into CX groups
//   of 4 NG (columns 4 cx + 4 CX g) and the streamed rows into 16 / CX
//   slices (4 OH rows x 4 NG columns a lane: 2 OH + 4 NG float4 reads for
//   64 OH NG FMAs, K3 twice), the slices added in a fixed butterfly order at
//   the end. Beyond CT columns (dq's in K2, dk's and dv's in K3: tile z
//   takes columns CT z.. of both) the accumulator is cut into column tiles,
//   a grid dimension: every column tile sums the same scores in the same
//   order, and tile 0 alone writes the statistics. As every tile recomputes
//   the scores, wide channels take the widest tile that fits: 128 columns
//   (NG = 2) beyond 64 channels, where the streamed 4 x 4 score tiles leave
//   the registers for it.
//   K3: one block owns a tile of keys and walks every row tile, dk and dv in
//   registers, no atomics. It reads K2's statistics: the row max M (a raw
//   score), 1 / d, c, and the argmax as an int32, which arrive through the
//   ring with the row tile; streaming, the tile's q and dmain rows land in
//   one buffer outside the ring (the ring's two stages and two such buffers
//   of 128 columns would pass 227 KB): a tile's rows come with its last
//   chunk, copied after the barrier of the step before, which with two
//   chunks or more a tile follows the last tile's second products. P_ij = 2^((s_ij - M_i) log2e) / d_i: s_ij - M_i
//   is exact zero at the argmax, so P <= 1 / d there to the bit, and 1 / d
//   <= 1 holds to the one rounding of K2's final rescale of d by 2^((m -
//   M) log2e).
// - Few rows (HW <= SHORT_HW), correlation_bwd_rows_short_kernel (K2) and
//   correlation_bwd_cols_short_kernel (K3), as K1's few-rows kernel: a
//   block owns one batch element at its real HW (a 5x4 grid is not padded
//   to 64 rows) and a tile of output columns, one a thread (K2: dq's; K3:
//   dk's and dv's, two threads a column index), and the dispatch cuts the
//   columns into as many tiles as give every SM a block at the batch
//   (short_col_tiles). Each tile sums every score again, so the block's
//   time is the kernel's: it is set by the shared-memory reads of the score
//   sums and by the latency of each ring step, and the design cuts both. q
//   and k, and dmain and [v | grid], arrive in chunks of SKC channels
//   through a ring of stages, up to 32 rows both pairs of a channel range in
//   one stage (SPLIT: half the threads sum the scores, half dP, in half the
//   steps, 2 x 2 a thread at HW = 20); float32 rows by 16-byte cp.async,
//   bf16 rows by 16-byte loads into registers issued before a step's sums
//   and widened into the next stage after them (HeldRows), so that neither
//   waits on device memory. The block's columns of k (K2) or of q and dmain
//   (K3) come into the stage the last step frees. Each score is one chain
//   of FMAs from channel 0 upwards (another order, a sum split over groups
//   of channels, moves a score near 100 at 1,024 unscaled channels by some
//   1e-4, more than chip_smoke.py's phase 3 allows). K2: one warp a row
//   takes the max, the first argmax and the denominator over all keys by
//   shuffles, P against the row's own max, and writes dS key-major; K3 forms
//   P and dS from K2's statistics. Each thread then sums its column over
//   every row.
// Both: rows and keys past HW are zero-filled by the copies and nothing
// past HW is stored; K2 scores keys past HW -inf (a padded score of 0 must
// not count), and a row past HW has q = dmain = c = d_ms = 1/d = 0, so it
// adds nothing to dk and dv. K2 and K3 change together: K3 recomputes K2's
// scores in K2's order and reads its statistics, so a new tiling of one is
// a new tiling of both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ============================================================ "fma" design ==

constexpr int NT = 256;         // threads a block, every "fma" kernel
constexpr int KC = 40;          // channels a chunk of the long-rows kernels
constexpr int SHORT_HW = 64;    // the few-rows kernels take HW up to this
constexpr int SKC = 128;        // channels a chunk of the few-rows kernels
constexpr int SPQ = SKC + 4;    // the pitch of their chunks (floats)
constexpr float LAZY_GAP = 8.f / LOG2E;  // how far a lane's score may pass its row's reference: P up to 2^8

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// One element into shared memory as float32, zero where !valid (src must
// then still be a mapped address): a 4-byte cp.async for float32, a load and
// a store for bf16.
__device__ __forceinline__ void put(float* dst, const float* src, bool valid) {
  mt::cp_async_4(dst, src, valid);
}
__device__ __forceinline__ void put(float* dst, const bf16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// -------------------------------------------------------- long-rows kernels --

// dst[c][r] (pitch P floats, P = 4 mod 32) = src[(row0 + r) * ld + c0 + c]
// for r < R, c < KC; zeros for rows at or past n_rows and channels at or past
// n_cols. A warp copies 8 channels of 4 rows at a time: 32-byte pieces of 4
// rows of global memory into 32 distinct banks of shared memory.
template <int R, typename T>
__device__ __forceinline__ void copy_t(float* dst, int P, const T* src, int ld, int row0,
                                       int n_rows, int c0, int n_cols, int tid) {
  static_assert(R % 4 == 0 && KC % 8 == 0 && R * KC % NT == 0, "whole warps of 8 x 4");
#pragma unroll
  for (int e0 = 0; e0 < R * KC; e0 += NT) {
    const int e = e0 + tid;
    const int grp = e >> 5;
    const int c = (grp % (KC / 8)) * 8 + (e & 7);
    const int r = (grp / (KC / 8)) * 4 + ((e >> 3) & 3);
    const bool ok = row0 + r < n_rows && c0 + c < n_cols;
    put(dst + c * P + r, ok ? src + static_cast<size_t>(row0 + r) * ld + c0 + c : src, ok);
  }
}

// The same for [v | grid]: channel c < Cv from v [HW, Cv], Cv and Cv + 1 from
// grid [HW, 2], zeros from Cv + 2 on.
template <int R, typename T>
__device__ __forceinline__ void copy_vg_t(float* dst, int P, const T* vb, const T* grid, int Cv,
                                          int row0, int HW, int c0, int tid) {
  static_assert(R % 4 == 0 && KC % 8 == 0 && R * KC % NT == 0, "whole warps of 8 x 4");
#pragma unroll
  for (int e0 = 0; e0 < R * KC; e0 += NT) {
    const int e = e0 + tid;
    const int grp = e >> 5;
    const int c = (grp % (KC / 8)) * 8 + (e & 7);
    const int r = (grp / (KC / 8)) * 4 + ((e >> 3) & 3);
    const int row = row0 + r, ch = c0 + c;
    const bool ok = row < HW && ch < Cv + 2;
    const T* src = !ok     ? grid
                   : ch < Cv ? vb + static_cast<size_t>(row) * Cv + ch
                             : grid + static_cast<size_t>(row) * 2 + (ch - Cv);
    put(dst + c * P + r, src, ok);
  }
}

// dst[r][c] (pitch CT) = src[(row0 + r) * ld + col0 + c] for r < R, c < CT;
// zeros past n_rows and past n_cols.
template <int R, int CT, typename T>
__device__ __forceinline__ void copy_rm(float* dst, const T* src, int ld, int row0, int n_rows,
                                        int col0, int n_cols, int tid) {
  static_assert(R * CT % NT == 0 && (CT & (CT - 1)) == 0, "whole rounds, CT a power of 2");
#pragma unroll
  for (int e0 = 0; e0 < R * CT; e0 += NT) {
    const int e = e0 + tid;
    const int r = e / CT, c = e % CT;
    const bool ok = row0 + r < n_rows && col0 + c < n_cols;
    put(dst + e, ok ? src + static_cast<size_t>(row0 + r) * ld + col0 + c : src, ok);
  }
}

// dst[w][r] for r < R, rows row0 + r: w = 0, 1, 2 K2's row max, 1 / d and c
// (stats [B, HW, 3]), 3 the max-score cotangent (dout's last column), 4 the
// argmax (int32); zeros past HW.
template <int R>
__device__ __forceinline__ void copy_row_stats(float* dst, const float* stats, const float* dout,
                                               const int* amax, size_t boff, int row0, int HW,
                                               int CO, int tid) {
#pragma unroll
  for (int e0 = 0; e0 < 5 * R; e0 += NT) {
    const int e = e0 + tid;
    if (e < 5 * R) {
      const int w = e / R, r = e % R;
      const int row = row0 + r;
      const bool ok = row < HW;
      const size_t g = boff + row;
      const void* src = !ok    ? static_cast<const void*>(stats)
                        : w < 3  ? static_cast<const void*>(stats + g * 3 + w)
                        : w == 3 ? static_cast<const void*>(dout + g * CO + CO - 1)
                                 : static_cast<const void*>(amax + g);
      mt::cp_async_4(dst + e, src, ok);
    }
  }
}

template <int OH, int SH, int CX, int NG>
struct LongGeo {
  static constexpr int BO = 64 * OH;              // own rows a block: query rows (K2), keys (K3)
  static constexpr int BS = 64 * SH;              // a streamed tile: keys (K2), query rows (K3)
  static constexpr int PO = BO + 4;               // pitch of the own side's transposed tiles
  static constexpr int PS = BS + 4;               // pitch of the streamed side's, and of P and dS
  static constexpr int OT = 4 * OH, SN = 4 * SH;  // own rows and streamed columns a thread
  static constexpr int CN = 4 * NG;               // accumulator columns a thread
  static constexpr int CT = CX * CN;              // accumulator columns a column tile
  static constexpr int KX = 16 / CX;              // slices of a streamed tile in the second products
  static constexpr int KS = BS / KX;              // streamed rows a slice
  static_assert(16 % CX == 0 && KS % 4 == 0, "the 16 lanes of a row group split evenly");
  static_assert(PO % 32 == 4 && PS % 32 == 4, "conflict-free transposing copies");
};

// acc[i][j] += sum_{c < w} o[c][64 (i / 4) + 4 ty + i % 4] *
// s[c][64 (j / 4) + 4 tx + j % 4]: one fused multiply-add a channel, channel 0
// upwards, OH + SH float4 reads a channel.
template <int OH, int SH>
__device__ __forceinline__ void tile_fma(float (&acc)[4 * OH][4 * SH], const float* o, int po,
                                         const float* s, int ps, int w, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < w; ++c) {
    float a[4 * OH], b[4 * SH];
#pragma unroll
    for (int h = 0; h < OH; ++h) {
      const float4 t = *reinterpret_cast<const float4*>(o + c * po + 64 * h + 4 * ty);
      a[4 * h] = t.x;
      a[4 * h + 1] = t.y;
      a[4 * h + 2] = t.z;
      a[4 * h + 3] = t.w;
    }
#pragma unroll
    for (int h = 0; h < SH; ++h) {
      const float4 t = *reinterpret_cast<const float4*>(s + c * ps + 64 * h + 4 * tx);
      b[4 * h] = t.x;
      b[4 * h + 1] = t.y;
      b[4 * h + 2] = t.z;
      b[4 * h + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * OH; ++i)
#pragma unroll
      for (int j = 0; j < 4 * SH; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// K2. One block per (BO query rows, batch, column tile of CT dq columns).
// STREAM: q^T and dmain^T come through the ring with each chunk (else they
// stay resident: Cq <= KC and Cv + 2 <= KC); NG groups of 4 dq columns a
// lane; RING stages; MINB blocks a SM.
template <typename T, bool STREAM, int CX, int NG, int OH, int SH, int RING, int MINB>
__global__ void __launch_bounds__(NT, MINB)
correlation_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ grid,
                            const float* __restrict__ out, const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ stats,
                            int* __restrict__ amax_out, int HW, int Cq, int Cv) {
  using G = LongGeo<OH, SH, CX, NG>;
  constexpr int OQ = STREAM ? KC * G::PO : 0;      // a stage's q^T chunk, and its dmain^T chunk
  constexpr int KR = 2 * KC * G::PS + 2 * OQ;      // where a stage's k rows start
  constexpr int STAGE = KR + G::BS * G::CT;
  extern __shared__ __align__(16) float smem[];
  float* dst = smem;                                  // [BO][PS]  dS of this key tile
  float* res = dst + G::BO * G::PS;                   // [KC][PO] x 2  resident q^T, dmain^T
  float* ring = res + (STREAM ? 0 : 2 * KC * G::PO);  // RING x (k^T, [v | grid]^T, q^T, dmain^T, k rows)

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * G::BO;
  const int colz = blockIdx.z * G::CT;  // this block's dq columns
  const bool tile0 = blockIdx.z == 0;   // it writes the statistics
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kx = tx / CX, cx = tx % CX;  // second product: key slice, group of columns
  const int CvP = Cv + 2, CO = Cv + 3;

  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const T* vb = v + boff * Cv;
  const float* ob = out + boff * CO;
  const float* dob = dout + boff * CO;

  const int nQ = (Cq + KC - 1) / KC, nV = (CvP + KC - 1) / KC;
  const int nC = nQ > nV ? nQ : nV;  // ring steps a key tile
  const int nT = (HW + G::BS - 1) / G::BS;
  auto load_step = [&](int step) {
    if (step < nT * nC) {
      const int u = step / nC, c = step - u * nC;
      float* st = ring + (step % RING) * STAGE;
      const int key0 = u * G::BS;
      if (c < nQ) {
        copy_t<G::BS>(st, G::PS, kb, Cq, key0, HW, c * KC, Cq, tid);
        if constexpr (STREAM)
          copy_t<G::BO>(st + 2 * KC * G::PS, G::PO, qb, Cq, row0, HW, c * KC, Cq, tid);
      }
      if (c < nV) {
        copy_vg_t<G::BS>(st + KC * G::PS, G::PS, vb, grid, Cv, key0, HW, c * KC, tid);
        if constexpr (STREAM)
          copy_t<G::BO>(st + 2 * KC * G::PS + OQ, G::PO, dob, CO, row0, HW, c * KC, CvP, tid);
      }
      if (c == nC - 1) copy_rm<G::BS, G::CT>(st + KR, kb, Cq, key0, HW, colz, Cq, tid);
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };
  if constexpr (!STREAM) {  // resident q^T and dmain^T travel in the first group
    copy_t<G::BO>(res, G::PO, qb, Cq, row0, HW, 0, Cq, tid);
    copy_t<G::BO>(res + KC * G::PO, G::PO, dob, CO, row0, HW, 0, CvP, tid);
  }
  for (int step = 0; step < RING - 1; ++step) load_step(step);

  // row i of this thread: 64 (i / 4) + 4 ty + i % 4. c_i = dout_i . out_i
  // and the max-score cotangent d_ms_i, from the forward's buffer
  float cval[G::OT], dms[G::OT];
#pragma unroll
  for (int i = 0; i < G::OT; ++i) {
    const int row = row0 + 64 * (i / 4) + 4 * ty + i % 4;
    float part = 0.f;
    dms[i] = 0.f;
    if (row < HW) {
      const float* o = ob + static_cast<size_t>(row) * CO;
      const float* d = dob + static_cast<size_t>(row) * CO;
      for (int col = tx; col < CO; col += 16) part = fmaf(d[col], o[col], part);
      dms[i] = d[CvP];
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) part += __shfl_xor_sync(FULL, part, off);
    cval[i] = part;
  }

  // per row: the reference m (a raw score, common to the 16 lanes), this
  // lane's share of the denominator and its largest score and first argmax
  // over its keys, and the unnormalised dq columns of its key slice
  float m[G::OT], l[G::OT], best[G::OT], acc[G::OT][G::CN];
  int bidx[G::OT];
#pragma unroll
  for (int i = 0; i < G::OT; ++i) {
    m[i] = best[i] = -INFINITY;
    l[i] = 0.f;
    bidx[i] = 0x7fffffff;
#pragma unroll
    for (int e = 0; e < G::CN; ++e) acc[i][e] = 0.f;
  }

  int step = 0;
  for (int u = 0; u < nT; ++u) {
    // S = Q K^T and dP = dmain [v | grid]^T over the tile's keys
    float s[G::OT][G::SN], dp[G::OT][G::SN];
#pragma unroll
    for (int i = 0; i < G::OT; ++i)
#pragma unroll
      for (int j = 0; j < G::SN; ++j) s[i][j] = dp[i][j] = 0.f;
    const float* st = ring;
    for (int c = 0; c < nC; ++c, ++step) {
      mt::cp_async_wait<RING - 2>();
      __syncthreads();  // this step's stage has landed for all; the last step's is free
      load_step(step + RING - 1);
      st = ring + (step % RING) * STAGE;
      const float* oq = STREAM ? st + 2 * KC * G::PS : res;
      if (c < nQ) tile_fma<OH, SH>(s, oq, G::PO, st, G::PS, min(KC, Cq - c * KC), ty, tx);
      if (c < nV)
        tile_fma<OH, SH>(dp, oq + (STREAM ? OQ : KC * G::PO), G::PO, st + KC * G::PS, G::PS,
                         min(KC, CvP - c * KC), ty, tx);
    }
    const int key0 = u * G::BS;

    // only the last tile has keys past HW (zero rows, whose score 0 must not count)
    if (key0 + G::BS > HW) {
#pragma unroll
      for (int j = 0; j < G::SN; ++j)
        if (key0 + 64 * (j / 4) + 4 * tx + j % 4 >= HW)
#pragma unroll
          for (int i = 0; i < G::OT; ++i) s[i][j] = -INFINITY;
    }
    // each lane's largest score and first argmax (keys ascend within a
    // lane); the rows' common reference m moves only where a lane's max
    // passes it by more than LAZY_GAP: one vote a tile, the shuffles then
    bool renew = false;
#pragma unroll
    for (int i = 0; i < G::OT; ++i) {
#pragma unroll
      for (int j = 0; j < G::SN; ++j)
        if (s[i][j] > best[i]) {  // strict: the earlier key stays on a tie
          best[i] = s[i][j];
          bidx[i] = key0 + 64 * (j / 4) + 4 * tx + j % 4;
        }
      renew |= best[i] > m[i] + LAZY_GAP;
    }
    if (__any_sync(FULL, renew)) {
#pragma unroll
      for (int i = 0; i < G::OT; ++i) {
        float mx = best[i];
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        if (mx > m[i]) {  // the row's reference moves: rescale its sums
          const float alpha = mt::ex2((m[i] - mx) * LOG2E);  // 0 on the first tile
          l[i] *= alpha;
#pragma unroll
          for (int e = 0; e < G::CN; ++e) acc[i][e] *= alpha;
          m[i] = mx;
        }
      }
    }
    // e = 2^((s - m) log2e); dS' = e (dP - c), unnormalised, into dp
#pragma unroll
    for (int i = 0; i < G::OT; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < G::SN; ++j) {
        const float e = mt::ex2((s[i][j] - m[i]) * LOG2E);
        sum += e;
        dp[i][j] = e * (dp[i][j] - cval[i]);
      }
      l[i] += sum;
    }
#pragma unroll
    for (int i = 0; i < G::OT; ++i) {
      float* prow = dst + (64 * (i / 4) + 4 * ty + i % 4) * G::PS + 4 * tx;
#pragma unroll
      for (int h = 0; h < SH; ++h)
        *reinterpret_cast<float4*>(prow + 64 * h) =
            make_float4(dp[i][4 * h], dp[i][4 * h + 1], dp[i][4 * h + 2], dp[i][4 * h + 3]);
    }
    __syncthreads();  // the tile's dS is whole (its k rows came with the last chunk)

    // acc[rows][columns 4 cx + 4 CX g ..] += dS[rows][slice kx] . k[slice kx][..]
    const float* pk = dst + 4 * ty * G::PS + kx * G::KS;
    const float* kr = st + KR + kx * G::KS * G::CT + 4 * cx;
#pragma unroll 4
    for (int j = 0; j < G::KS; j += 4) {
      float4 pr[G::OT];
#pragma unroll
      for (int i = 0; i < G::OT; ++i)
        pr[i] = *reinterpret_cast<const float4*>(pk + (64 * (i / 4) + i % 4) * G::PS + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + (j + e) * G::CT + 4 * CX * g);
#pragma unroll
          for (int i = 0; i < G::OT; ++i) {
            const float pe = lane_of(pr[i], e);
            acc[i][4 * g] = fmaf(pe, kv.x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(pe, kv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pe, kv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pe, kv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }
  mt::cp_async_wait<0>();

  // the 16 lanes of a row group merge their maxima (the smallest key wins
  // among equal scores) and add their shares of the denominator (a fixed
  // butterfly), then the key slices of dq; the max-score cotangent enters at
  // the first argmax, where P = 1 / d
#pragma unroll
  for (int i = 0; i < G::OT; ++i) {
    float bv = best[i];
    int bi = bidx[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi >= HW) bi = 0;  // no score above -inf (a NaN row): key 0, as a first argmax
    float d = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) d += __shfl_xor_sync(FULL, d, off);
#pragma unroll
    for (int off = CX; off < 16; off <<= 1)
#pragma unroll
      for (int e = 0; e < G::CN; ++e) acc[i][e] += __shfl_xor_sync(FULL, acc[i][e], off);
    const float alpha = mt::ex2((m[i] - bv) * LOG2E);  // 1 where m is the row's max
    const float inv = 1.f / (d * alpha);
    const int row = row0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (row < HW) {
      if (kx == 0) {
        const T* ka = kb + static_cast<size_t>(bi) * Cq;
        float* o = dq + (boff + row) * Cq;
#pragma unroll
        for (int e = 0; e < G::CN; ++e) {
          const int col = colz + 4 * CX * (e / 4) + 4 * cx + e % 4;
          if (col < Cq) o[col] = fmaf(acc[i][e], alpha, dms[i] * to_f(ka[col])) * inv;
        }
      }
      if (tile0 && tx == 0) {
        float* o = stats + (boff + row) * 3;
        o[0] = bv;
        o[1] = inv;
        o[2] = cval[i];
        amax_out[boff + row] = bi;
      }
    }
  }
}

// K3. One block per (BO keys, batch, column tile: CT columns of dk and of
// dv); STREAM, NG, RING, MINB as K2's. Streaming, a tile's q and dmain rows
// land in one buffer outside the ring, which takes nC >= RING.
template <typename T, bool STREAM, int CX, int NG, int OH, int SH, int RING, int MINB>
__global__ void __launch_bounds__(NT, MINB)
correlation_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ grid,
                            const float* __restrict__ dout, const float* __restrict__ stats,
                            const int* __restrict__ amax, float* __restrict__ dk,
                            float* __restrict__ dv, int HW, int Cq, int Cv) {
  using G = LongGeo<OH, SH, CX, NG>;
  constexpr int OQ = STREAM ? KC * G::PO : 0;     // a stage's k^T chunk, and its [v | grid]^T chunk
  constexpr int QR = 2 * KC * G::PS + 2 * OQ;     // where a stage's q rows start (resident)
  constexpr int ROWS = 2 * G::BS * G::CT;         // a tile's q rows and dmain rows
  constexpr int RS = QR + (STREAM ? 0 : ROWS);    // where a stage's row statistics start
  constexpr int STAGE = RS + 5 * G::BS;
  extern __shared__ __align__(16) float smem[];
  float* pt = smem;                                   // [BO][PS]  P^T  [key][row]
  float* dt = pt + G::BO * G::PS;                     // [BO][PS]  dS^T [key][row]
  float* res = dt + G::BO * G::PS;                    // [KC][PO] x 2  resident k^T, [v | grid]^T
  float* ring = res + (STREAM ? 0 : 2 * KC * G::PO);  // RING x (q^T, dmain^T, k^T, [v|grid]^T, [rows], stats)
  float* rows_out = ring + RING * STAGE;              // streaming: the tile's q rows, dmain rows

  const int b = blockIdx.y;
  const int key0 = blockIdx.x * G::BO;
  const int colz = blockIdx.z * G::CT;  // this block's columns of dk and of dv
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kx = tx / CX, cx = tx % CX;  // second products: row slice, group of columns
  const int CvP = Cv + 2, CO = Cv + 3;

  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const T* vb = v + boff * Cv;
  const float* dob = dout + boff * CO;

  const int nQ = (Cq + KC - 1) / KC, nV = (CvP + KC - 1) / KC;
  const int nC = nQ > nV ? nQ : nV;  // ring steps a row tile
  const int nT = (HW + G::BS - 1) / G::BS;
  auto load_step = [&](int step) {
    if (step < nT * nC) {
      const int u = step / nC, c = step - u * nC;
      float* st = ring + (step % RING) * STAGE;
      const int row0 = u * G::BS;
      if (c < nQ) {
        copy_t<G::BS>(st, G::PS, qb, Cq, row0, HW, c * KC, Cq, tid);
        if constexpr (STREAM)
          copy_t<G::BO>(st + 2 * KC * G::PS, G::PO, kb, Cq, key0, HW, c * KC, Cq, tid);
      }
      if (c < nV) {
        copy_t<G::BS>(st + KC * G::PS, G::PS, dob, CO, row0, HW, c * KC, CvP, tid);
        if constexpr (STREAM)
          copy_vg_t<G::BO>(st + 2 * KC * G::PS + OQ, G::PO, vb, grid, Cv, key0, HW, c * KC, tid);
      }
      if (c == nC - 1) {
        float* rw = STREAM ? rows_out : st + QR;
        if (colz < Cq) copy_rm<G::BS, G::CT>(rw, qb, Cq, row0, HW, colz, Cq, tid);
        if (colz < Cv) copy_rm<G::BS, G::CT>(rw + G::BS * G::CT, dob, CO, row0, HW, colz, Cv, tid);
        copy_row_stats<G::BS>(st + RS, stats, dout, amax, boff, row0, HW, CO, tid);
      }
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };
  if constexpr (!STREAM) {  // resident k^T and [v | grid]^T travel in the first group
    copy_t<G::BO>(res, G::PO, kb, Cq, key0, HW, 0, Cq, tid);
    copy_vg_t<G::BO>(res + KC * G::PO, G::PO, vb, grid, Cv, key0, HW, 0, tid);
  }
  for (int step = 0; step < RING - 1; ++step) load_step(step);

  // key a of this thread: 64 (a / 4) + 4 ty + a % 4; its dk and dv columns
  // colz + 4 CX g + 4 cx .. + 3, summed over its row slice
  float acc_k[G::OT][G::CN], acc_v[G::OT][G::CN];
#pragma unroll
  for (int a = 0; a < G::OT; ++a)
#pragma unroll
    for (int e = 0; e < G::CN; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;

  int step = 0;
  for (int u = 0; u < nT; ++u) {
    // S^T = K Q^T and dP^T = [v | grid] dmain^T over the tile's rows, each
    // score in K2's order
    float s[G::OT][G::SN], dp[G::OT][G::SN];
#pragma unroll
    for (int a = 0; a < G::OT; ++a)
#pragma unroll
      for (int j = 0; j < G::SN; ++j) s[a][j] = dp[a][j] = 0.f;
    const float* st = ring;
    for (int c = 0; c < nC; ++c, ++step) {
      mt::cp_async_wait<RING - 2>();
      __syncthreads();  // this step's stage has landed for all; the last step's is free
      load_step(step + RING - 1);
      st = ring + (step % RING) * STAGE;
      const float* ok = STREAM ? st + 2 * KC * G::PS : res;
      if (c < nQ) tile_fma<OH, SH>(s, ok, G::PO, st, G::PS, min(KC, Cq - c * KC), ty, tx);
      if (c < nV)
        tile_fma<OH, SH>(dp, ok + (STREAM ? OQ : KC * G::PO), G::PO, st + KC * G::PS, G::PS,
                         min(KC, CvP - c * KC), ty, tx);
    }

    // P = 2^((s - M) log2e) / d and dS = P (dP + [key = argmax] d_ms - c)
    // from K2's statistics of this thread's rows 4 tx + j (+ 64 h)
    const float* sr = st + RS;
    float rm[G::SN], ril[G::SN], rc[G::SN], rdms[G::SN];
    int ram[G::SN];
#pragma unroll
    for (int h = 0; h < SH; ++h) {
      const int r = 64 * h + 4 * tx;
      const float4 x0 = *reinterpret_cast<const float4*>(sr + r);
      const float4 x1 = *reinterpret_cast<const float4*>(sr + G::BS + r);
      const float4 x2 = *reinterpret_cast<const float4*>(sr + 2 * G::BS + r);
      const float4 x3 = *reinterpret_cast<const float4*>(sr + 3 * G::BS + r);
      const int4 x4 = *reinterpret_cast<const int4*>(sr + 4 * G::BS + r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rm[4 * h + e] = lane_of(x0, e);
        ril[4 * h + e] = lane_of(x1, e);
        rc[4 * h + e] = lane_of(x2, e);
        rdms[4 * h + e] = lane_of(x3, e);
      }
      ram[4 * h] = x4.x;
      ram[4 * h + 1] = x4.y;
      ram[4 * h + 2] = x4.z;
      ram[4 * h + 3] = x4.w;
    }
#pragma unroll
    for (int a = 0; a < G::OT; ++a) {
      const int key = key0 + 64 * (a / 4) + 4 * ty + a % 4;
#pragma unroll
      for (int j = 0; j < G::SN; ++j) {
        const float p = mt::ex2((s[a][j] - rm[j]) * LOG2E) * ril[j];
        const float dpv = dp[a][j] + (key == ram[j] ? rdms[j] : 0.f);
        s[a][j] = p;
        dp[a][j] = p * (dpv - rc[j]);
      }
      const int o = (64 * (a / 4) + 4 * ty + a % 4) * G::PS + 4 * tx;
#pragma unroll
      for (int h = 0; h < SH; ++h) {
        *reinterpret_cast<float4*>(pt + o + 64 * h) =
            make_float4(s[a][4 * h], s[a][4 * h + 1], s[a][4 * h + 2], s[a][4 * h + 3]);
        *reinterpret_cast<float4*>(dt + o + 64 * h) =
            make_float4(dp[a][4 * h], dp[a][4 * h + 1], dp[a][4 * h + 2], dp[a][4 * h + 3]);
      }
    }
    __syncthreads();  // the tile's P and dS are whole (its rows came with the last chunk)

    // acc_k[keys][columns 4 cx + 4 CX g ..] += dS^T[keys][slice kx] . q[slice kx][..]
    // acc_v[keys][columns 4 cx + 4 CX g ..] += P^T[keys][slice kx] . dmain[slice kx][..]
    const int po = 4 * ty * G::PS + kx * G::KS;
    const float* qr = (STREAM ? rows_out : st + QR) + kx * G::KS * G::CT + 4 * cx;
    const float* mr = qr + G::BS * G::CT;
#pragma unroll 2
    for (int i = 0; i < G::KS; i += 4) {
      float4 pr[G::OT], dr[G::OT];
#pragma unroll
      for (int a = 0; a < G::OT; ++a) {
        const int at = po + (64 * (a / 4) + a % 4) * G::PS + i;
        pr[a] = *reinterpret_cast<const float4*>(pt + at);
        dr[a] = *reinterpret_cast<const float4*>(dt + at);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int at = (i + e) * G::CT + 4 * CX * g;
          const float4 qv = *reinterpret_cast<const float4*>(qr + at);
          const float4 mv = *reinterpret_cast<const float4*>(mr + at);
#pragma unroll
          for (int a = 0; a < G::OT; ++a) {
            const float de = lane_of(dr[a], e), pe = lane_of(pr[a], e);
            float* ak = acc_k[a] + 4 * g;
            float* av = acc_v[a] + 4 * g;
            ak[0] = fmaf(de, qv.x, ak[0]);
            ak[1] = fmaf(de, qv.y, ak[1]);
            ak[2] = fmaf(de, qv.z, ak[2]);
            ak[3] = fmaf(de, qv.w, ak[3]);
            av[0] = fmaf(pe, mv.x, av[0]);
            av[1] = fmaf(pe, mv.y, av[1]);
            av[2] = fmaf(pe, mv.z, av[2]);
            av[3] = fmaf(pe, mv.w, av[3]);
          }
        }
      }
    }
  }

  // the row slices add up in a fixed butterfly; slice 0 writes
#pragma unroll
  for (int a = 0; a < G::OT; ++a) {
#pragma unroll
    for (int off = CX; off < 16; off <<= 1)
#pragma unroll
      for (int e = 0; e < G::CN; ++e) {
        acc_k[a][e] += __shfl_xor_sync(FULL, acc_k[a][e], off);
        acc_v[a][e] += __shfl_xor_sync(FULL, acc_v[a][e], off);
      }
    const int key = key0 + 64 * (a / 4) + 4 * ty + a % 4;
    if (kx == 0 && key < HW) {
#pragma unroll
      for (int e = 0; e < G::CN; ++e) {
        const int col = colz + 4 * CX * (e / 4) + 4 * cx + e % 4;
        if (col < Cq) dk[(boff + key) * Cq + col] = acc_k[a][e];
        if (col < Cv) dv[(boff + key) * Cv + col] = acc_v[a][e];
      }
    }
  }
}

// -------------------------------------------------------- few-rows kernels --

// The ring of the few-rows kernels: a stage holds two channel chunks
// [HWP][SPQ] (HWP = HW rounded up to 4), q and k in the first steps, then
// dmain and [v | grid]; or, with SPLIT, four: both pairs of one channel
// range, the scores summed by half the threads and dP by the other half, in
// half the steps. The block's columns go into the stage after the last step.
template <bool SPLIT>
__host__ __device__ inline int short_stage(int HWP) {
  return (SPLIT ? 4 : 2) * HWP * SPQ;
}
template <bool SPLIT>
__host__ __device__ inline int short_steps(int Cq, int Cv) {
  const int nQ = (Cq + SKC - 1) / SKC, nV = (Cv + 2 + SKC - 1) / SKC;
  return SPLIT ? (nQ > nV ? nQ : nV) : nQ + nV;
}

// Shared memory in floats at HW rows and RING stages: the ring, the scores,
// dP and K2's dS [HWP][HWP] each, K3's row statistics.
template <bool SPLIT>
__host__ __device__ inline size_t short_floats(int HW, int RING) {
  const int HWP = (HW + 3) / 4 * 4;
  return static_cast<size_t>(RING) * short_stage<SPLIT>(HWP) + 3 * HWP * HWP + 8 * HWP;
}

// Whether rows of C elements of T at p go W = 16 / sizeof(T) at a time: 16
// bytes aligned, C a multiple of W.
template <typename T>
__device__ __forceinline__ bool vec_rows(const T* p, int C) {
  return C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 8 bf16 as float32: two float4 stores
__device__ __forceinline__ void widen8(float* dst, const uint4& u) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                  __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
}

// Rows [0, HWP) x channels [c0, c0 + SKC) of a [HW, C] array whose rows lie
// ld elements apart, into a [HWP][SPQ] chunk; zeros past HW and past C.
// float32: 16-byte cp.async copies where vec (vec_rows of the array).
template <typename T>
__device__ __forceinline__ void copy_chunk(float* dst, const T* src, int ld, int HW, int HWP,
                                           int C, int c0, bool vec, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int e = tid; e < HWP * (SKC / 4); e += NT) {
        const int r = e / (SKC / 4), c = 4 * (e % (SKC / 4));
        const bool ok = r < HW && c0 + c < C;
        mt::cp_async_16(dst + r * SPQ + c, ok ? src + static_cast<size_t>(r) * ld + c0 + c : src,
                        ok);
      }
      return;
    }
  }
  for (int e = tid; e < HWP * SKC; e += NT) {
    const int r = e / SKC, c = e % SKC;
    const bool ok = r < HW && c0 + c < C;
    put(dst + r * SPQ + c, ok ? src + static_cast<size_t>(r) * ld + c0 + c : src, ok);
  }
}

// The same for [v | grid] (Cv + 2 channels). Where vecv (vec_rows of v),
// v's whole pieces of W = 16 / sizeof(T) channels go by 16-byte cp.async
// (float32) or are left out (bf16: they travel through registers, HeldRows).
template <typename T>
__device__ __forceinline__ void copy_vg_chunk(float* dst, const T* vb, const T* grid, int Cv,
                                              int HW, int HWP, int c0, bool vecv, int tid) {
  constexpr int W = 16 / sizeof(T);
  for (int e = tid; e < HWP * (SKC / W); e += NT) {
    const int r = e / (SKC / W), c = W * (e % (SKC / W)), ch = c0 + c;
    float* d = dst + r * SPQ + c;
    if (vecv && r < HW && ch + W <= Cv) {
      if constexpr (std::is_same<T, float>::value) mt::cp_async_16(d, vb + r * Cv + ch, true);
      continue;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const bool ok = r < HW && ch + i < Cv + 2;
      const T* src = !ok         ? grid
                     : ch + i < Cv ? vb + static_cast<size_t>(r) * Cv + ch + i
                                   : grid + static_cast<size_t>(r) * 2 + (ch + i - Cv);
      put(d + i, src, ok);
    }
  }
}

// bf16 rows in flight: a thread's 16-byte pieces (8 channels) of up to
// three chunks (q, k, v), loaded from device memory before a step's sums
// and widened into their stage after them, so that the loads overlap the
// sums as the float32 path's cp.async copies do. NV pieces a thread a
// chunk: HWP <= 4 RQ rows of SKC / 8 pieces.
template <int RQ>
struct HeldRows {
  static constexpr int NV = (4 * RQ * (SKC / 8) + NT - 1) / NT;
  uint4 u[3][NV];
  float* dst[3] = {nullptr, nullptr, nullptr};

  // chunk slot s (0: q, 1: k, 2: v) of [HW, C] rows ld apart from channel
  // c0; with vg, only v's whole pieces (the rest went by copy_vg_chunk)
  __device__ __forceinline__ void load(int s, float* chunk, const bf16* src, int ld, int HW,
                                       int HWP, int C, int c0, int tid) {
    dst[s] = chunk;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * NT, r = e / (SKC / 8), c = 8 * (e % (SKC / 8));
      const bool ok = e < HWP * (SKC / 8) && r < HW && c0 + c + (s == 2 ? 8 : 1) <= C;
      u[s][i] = ok ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * ld + c0 + c)
                   : make_uint4(0, 0, 0, 0);
    }
  }
  // widen what load() held into the chunks, and forget it
  __device__ __forceinline__ void store(int HW, int HWP, int Cv, int c0v, int tid) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (!dst[s]) continue;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int e = tid + i * NT, r = e / (SKC / 8), c = 8 * (e % (SKC / 8));
        if (e < HWP * (SKC / 8) && (s < 2 || (r < HW && c0v + c + 8 <= Cv)))
          widen8(dst[s] + r * SPQ + c, u[s][i]);
      }
      dst[s] = nullptr;
    }
  }
};

// acc[r][j] += sum_c a[r][c] b[j][c] over c < width (a multiple of 4; the
// chunk holds zeros past its data): rows TR, keys TC, one FMA chain a score
// from channel 0 upwards.
template <int TR, int TC>
__device__ __forceinline__ void short_fma(float (&acc)[TR][TC], const float* a, const float* b,
                                          int width) {
#pragma unroll 4
  for (int c = 0; c < width; c += 4) {
    float4 x[TR], y[TC];
#pragma unroll
    for (int r = 0; r < TR; ++r) x[r] = *reinterpret_cast<const float4*>(a + r * SPQ + c);
#pragma unroll
    for (int j = 0; j < TC; ++j) y[j] = *reinterpret_cast<const float4*>(b + j * SPQ + c);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        acc[r][j] = fmaf(x[r].x, y[j].x, acc[r][j]);
        acc[r][j] = fmaf(x[r].y, y[j].y, acc[r][j]);
        acc[r][j] = fmaf(x[r].z, y[j].z, acc[r][j]);
        acc[r][j] = fmaf(x[r].w, y[j].w, acc[r][j]);
      }
  }
}

// The few-rows kernels' first part, shared by K2 and K3: issue the ring
// (the channel chunks, then the block's columns through load_cols into the
// stage after the last step), sum the HW x HW scores into ss and dP into dps
// ([HWP][HWP], row-major), and return once every copy has landed and both
// are whole.
template <typename T, int TR, int TC, int RQ, int RING, bool SPLIT, typename LoadCols>
__device__ __forceinline__ void short_products(float* smem, float* ss, float* dps, const T* qb,
                                               const T* kb, const T* vb, const T* grid,
                                               const float* dob, int HW, int Cq, int Cv,
                                               LoadCols load_cols) {
  const int tid = threadIdx.x;
  const bool vec = vec_rows(qb, Cq) && vec_rows(kb, Cq), vecv = vec_rows(vb, Cv);
  const int HWP = (HW + 3) / 4 * 4;
  const int STAGE = short_stage<SPLIT>(HWP), CH = HWP * SPQ;
  const int CvP = Cv + 2;
  const int nQ = (Cq + SKC - 1) / SKC, nV = (CvP + SKC - 1) / SKC;
  const int nS = short_steps<SPLIT>(Cq, Cv);
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  HeldRows<RQ> held;  // bf16 pieces in flight (unused for float32)
  int c0v = 0;        // the channel of v's chunk held
  // chunk step of q and k, or of dmain and [v | grid] (pair index nQ + c)
  auto load_pair = [&](float* st, int step) {
    if (step < nQ) {
      if (BF16 && vec) {
        if constexpr (BF16) {
          held.load(0, st, qb, Cq, HW, HWP, Cq, step * SKC, tid);
          held.load(1, st + CH, kb, Cq, HW, HWP, Cq, step * SKC, tid);
        }
      } else {
        copy_chunk(st, qb, Cq, HW, HWP, Cq, step * SKC, vec, tid);
        copy_chunk(st + CH, kb, Cq, HW, HWP, Cq, step * SKC, vec, tid);
      }
    } else {
      const int c0 = (step - nQ) * SKC;
      copy_chunk(st, dob, Cv + 3, HW, HWP, CvP, c0, false, tid);
      copy_vg_chunk(st + CH, vb, grid, Cv, HW, HWP, c0, vecv, tid);
      if constexpr (BF16) {
        if (vecv) {
          held.load(2, st + CH, vb, Cv, HW, HWP, Cv, c0, tid);
          c0v = c0;
        }
      }
    }
  };
  // issue the copies of a step (its bf16 pieces into registers)
  auto load_step = [&](int step) {
    float* st = smem + (step % RING) * STAGE;
    if (step < nS) {
      if constexpr (SPLIT) {
        if (step < nQ) load_pair(st, step);
        if (step < nV) load_pair(st + 2 * CH, nQ + step);
      } else {
        load_pair(st, step);
      }
    } else if (step == nS) {
      load_cols(st);
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };
  // the bf16 pieces of the step load_step issued last into its stage
  auto land_held = [&]() {
    if constexpr (BF16) held.store(HW, HWP, Cv, c0v, tid);
  };
  for (int step = 0; step < RING - 1; ++step) {
    load_step(step);
    land_held();
  }

  // SPLIT: threads [0, NT / 2) sum the scores, [NT / 2, NT) dP
  const int grp = SPLIT ? tid / (NT / 2) : 0, lt = tid - grp * (NT / 2);
  const int GR = (HW + TR - 1) / TR, GC = (HW + TC - 1) / TC;
  const bool active = lt < GR * GC;
  const int pi = active ? lt / GC : 0, pj = active ? lt % GC : 0;
  float as[TR][TC] = {}, ad[TR][TC] = {};
  for (int step = 0; step < nS; ++step) {
    mt::cp_async_wait<RING - 2>();
    __syncthreads();  // this step has landed for all; the last step's stage is free
    load_step(step + RING - 1);
    if (active) {
      const float* st = smem + (step % RING) * STAGE;
      if constexpr (SPLIT) {
        const int C = grp ? CvP : Cq, c0 = step * SKC;
        if (c0 < C)
          short_fma<TR, TC>(as, st + 2 * grp * CH + TR * pi * SPQ,
                            st + (2 * grp + 1) * CH + TC * pj * SPQ, min(SKC, (C - c0 + 3) & ~3));
      } else {
        const float* a = st + TR * pi * SPQ;
        const float* bk = st + CH + TC * pj * SPQ;
        if (step < nQ) {
          short_fma<TR, TC>(as, a, bk, min(SKC, (Cq - step * SKC + 3) & ~3));
        } else {
          const int c0 = (step - nQ) * SKC;
          short_fma<TR, TC>(ad, a, bk, min(SKC, (CvP - c0 + 3) & ~3));
        }
      }
    }
    land_held();  // visible after the next step's barrier
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (TR * pi + r < HW && TC * pj + j < HW) {
          const int at = (TR * pi + r) * HWP + TC * pj + j;
          if (SPLIT) {
            (grp ? dps : ss)[at] = as[r][j];
          } else {
            ss[at] = as[r][j];
            dps[at] = ad[r][j];
          }
        }
  }
  mt::cp_async_wait<0>();  // the block's columns too
  __syncthreads();
}

// K2, few rows: one block per (column tile of CT dq columns, batch), one
// column a thread. Scores TR x TC a thread ((HW / TR) (HW / TC) <= NT
// threads, or NT / 2 with SPLIT), RQ row quads of dq a thread (4 RQ >= HW),
// RING ring stages.
template <typename T, int TR, int TC, int RQ, int RING, bool SPLIT>
__global__ void __launch_bounds__(NT)
correlation_bwd_rows_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ grid,
                                  const float* __restrict__ out, const float* __restrict__ dout,
                                  float* __restrict__ dq, float* __restrict__ stats,
                                  int* __restrict__ amax_out, int HW, int Cq, int Cv, int CT) {
  extern __shared__ __align__(16) float smem[];
  const int HWP = (HW + 3) / 4 * 4;
  float* ss = smem + RING * short_stage<SPLIT>(HWP);  // [HWP rows][HWP keys] scores
  float* dps = ss + HWP * HWP;                       // [HWP rows][HWP keys] dmain . [v | grid]
  float* dts = dps + HWP * HWP;                      // [HWP keys][HWP rows] dS

  const int b = blockIdx.y, tid = threadIdx.x;
  const int colz = blockIdx.x * CT;
  const int CvP = Cv + 2, CO = Cv + 3;
  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const float* ob = out + boff * CO;
  const float* dob = dout + boff * CO;
  // the block's k columns [HW][CT]
  auto load_cols = [&](float* st) {
    for (int e = tid; e < HW * CT; e += NT) {
      const int j = e / CT, col = colz + e - j * CT;
      const bool ok = col < Cq;
      put(st + e, ok ? kb + static_cast<size_t>(j) * Cq + col : kb, ok);
    }
  };
  short_products<T, TR, TC, RQ, RING, SPLIT>(smem, ss, dps, qb, kb, v + boff * Cv, grid, dob, HW,
                                         Cq, Cv, load_cols);

  // one warp a row: the max, the first argmax and the denominator over all
  // keys by shuffles, P against the row's own max (exactly 1 / d there), c
  // = dout . out; dS key-major
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < HW; i += NT / 32) {
    float sv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = lane + 32 * e;
      sv[e] = j < HW ? ss[i * HWP + j] : -INFINITY;
    }
    float bv = sv[0];
    int bi = lane;
    if (sv[1] > bv) {
      bv = sv[1];
      bi = lane + 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    float p[2], d = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[e] = lane + 32 * e < HW ? mt::ex2((sv[e] - bv) * LOG2E) : 0.f;
      d += p[e];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
    const float inv = 1.f / d;
    const float* o = ob + static_cast<size_t>(i) * CO;
    const float* dd = dob + static_cast<size_t>(i) * CO;
    float c = 0.f;
    for (int col = lane; col < CO; col += 32) c = fmaf(dd[col], o[col], c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(FULL, c, off);
    const float dms = dd[CvP];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = lane + 32 * e;
      if (j < HW) {
        const float dpv = dps[i * HWP + j] + (j == bi ? dms : 0.f);
        dts[j * HWP + i] = p[e] * inv * (dpv - c);
      }
    }
    if (blockIdx.x == 0 && lane == 0) {
      float* st = stats + (boff + i) * 3;
      st[0] = bv;
      st[1] = inv;
      st[2] = c;
      amax_out[boff + i] = bi;
    }
  }
  __syncthreads();

  // dq[rows][col] = sum_j dS[j][rows] k[j][col], keys ascending
  const int col = colz + tid;
  if (tid < CT && col < Cq) {
    const float* kc =
        smem + (short_steps<SPLIT>(Cq, Cv) % RING) * short_stage<SPLIT>(HWP) + tid;
    float o[4 * RQ];
#pragma unroll
    for (int i = 0; i < 4 * RQ; ++i) o[i] = 0.f;
    for (int j = 0; j < HW; ++j) {
      const float x = kc[j * CT];
      const float* dr = dts + j * HWP;
#pragma unroll
      for (int rq = 0; rq < RQ; ++rq) {
        if (4 * rq < HW) {
          const float4 p4 = *reinterpret_cast<const float4*>(dr + 4 * rq);
          o[4 * rq] = fmaf(p4.x, x, o[4 * rq]);
          o[4 * rq + 1] = fmaf(p4.y, x, o[4 * rq + 1]);
          o[4 * rq + 2] = fmaf(p4.z, x, o[4 * rq + 2]);
          o[4 * rq + 3] = fmaf(p4.w, x, o[4 * rq + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * RQ; ++i)
      if (i < HW) dq[(boff + i) * Cq + col] = o[i];
  }
}

// K3, few rows: one block per (column tile, batch); thread t < CT takes dk
// column colz + t, thread CT + t dv column colz + t. TR, TC, RQ, RING, SPLIT
// as K2's.
template <typename T, int TR, int TC, int RQ, int RING, bool SPLIT>
__global__ void __launch_bounds__(NT)
correlation_bwd_cols_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ grid,
                                  const float* __restrict__ dout, const float* __restrict__ stats,
                                  const int* __restrict__ amax, float* __restrict__ dk,
                                  float* __restrict__ dv, int HW, int Cq, int Cv, int CT) {
  extern __shared__ __align__(16) float smem[];
  const int HWP = (HW + 3) / 4 * 4;
  float* ss = smem + RING * short_stage<SPLIT>(HWP);  // [HWP rows][HWP keys] scores, then P
  float* dps = ss + HWP * HWP;                       // [HWP rows][HWP keys] dP, then dS
  float* rs = dps + HWP * HWP;                       // [5][HWP] the rows' statistics

  const int b = blockIdx.y, tid = threadIdx.x;
  const int colz = blockIdx.x * CT;
  const int CvP = Cv + 2, CO = Cv + 3;
  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const float* dob = dout + boff * CO;
  int* ram = reinterpret_cast<int*>(rs + 4 * HWP);
  for (int i = tid; i < HW; i += NT) {  // read before the first barrier below
    const float* st = stats + (boff + i) * 3;
    rs[i] = st[0];
    rs[HWP + i] = st[1];
    rs[2 * HWP + i] = st[2];
    rs[3 * HWP + i] = dob[static_cast<size_t>(i) * CO + CvP];
    ram[i] = amax[boff + i];
  }
  // the block's columns of q and of dmain, [HW][CT] each
  auto load_cols = [&](float* st) {
    for (int e = tid; e < HW * CT; e += NT) {
      const int i = e / CT, col = colz + e - i * CT;
      const bool okq = col < Cq, okm = col < Cv;
      put(st + e, okq ? qb + static_cast<size_t>(i) * Cq + col : qb, okq);
      put(st + HW * CT + e, okm ? dob + static_cast<size_t>(i) * CO + col : dob, okm);
    }
  };
  short_products<T, TR, TC, RQ, RING, SPLIT>(smem, ss, dps, qb, k + boff * Cq, v + boff * Cv, grid,
                                         dob, HW, Cq, Cv, load_cols);

  // P = 2^((s - M) log2e) / d and dS = P (dP + [j = argmax] d_ms - c), in place
  for (int e = tid; e < HW * HW; e += NT) {
    const int i = e / HW, j = e - i * HW;
    const float p = mt::ex2((ss[i * HWP + j] - rs[i]) * LOG2E) * rs[HWP + i];
    const float dpv = dps[i * HWP + j] + (j == ram[i] ? rs[3 * HWP + i] : 0.f);
    ss[i * HWP + j] = p;
    dps[i * HWP + j] = p * (dpv - rs[2 * HWP + i]);
  }
  __syncthreads();

  // dk[keys][col] = sum_i dS[i][keys] q[i][col]; dv[keys][col] = sum_i
  // P[i][keys] dmain[i][col], rows ascending
  const bool is_k = tid < CT;
  const int ci = is_k ? tid : tid - CT, col = colz + ci;
  if (ci < CT && col < (is_k ? Cq : Cv)) {
    const float* xc = smem + (short_steps<SPLIT>(Cq, Cv) % RING) * short_stage<SPLIT>(HWP) +
                      (is_k ? 0 : HW * CT) + ci;
    const float* mat = is_k ? dps : ss;
    float o[4 * RQ];
#pragma unroll
    for (int j = 0; j < 4 * RQ; ++j) o[j] = 0.f;
    for (int i = 0; i < HW; ++i) {
      const float x = xc[i * CT];
      const float* mr = mat + i * HWP;
#pragma unroll
      for (int jq = 0; jq < RQ; ++jq) {
        if (4 * jq < HW) {
          const float4 p4 = *reinterpret_cast<const float4*>(mr + 4 * jq);
          o[4 * jq] = fmaf(p4.x, x, o[4 * jq]);
          o[4 * jq + 1] = fmaf(p4.y, x, o[4 * jq + 1]);
          o[4 * jq + 2] = fmaf(p4.z, x, o[4 * jq + 2]);
          o[4 * jq + 3] = fmaf(p4.w, x, o[4 * jq + 3]);
        }
      }
    }
    float* dst = is_k ? dk + boff * Cq : dv + boff * Cv;
    const int ld = is_k ? Cq : Cv;
#pragma unroll
    for (int j = 0; j < 4 * RQ; ++j)
      if (j < HW) dst[static_cast<size_t>(j) * ld + col] = o[j];
  }
}

// ------------------------------------------------- launches, "fma" design --

struct Args {
  const void *q, *k, *v, *grid;
  const float *out, *dout;
  float *dq, *dk, *dv, *stats;
  int* amax;
  int B, HW, Cq, Cv;
  cudaStream_t stream;
};

bool bad_shape(int B, int HW, int Cq, int Cv) {
  return B < 0 || HW < 0 || Cq <= 0 || Cv < 0;
}

// q^T and dmain^T (K2), k^T and [v | grid]^T (K3) stay resident when each
// product fits one chunk
bool resident(int Cq, int Cv) { return Cq <= KC && Cv + 2 <= KC; }

template <typename T, bool STREAM, int CX, int NG, int OH, int SH, int RING, int MINB>
cudaError_t launch_rows(const Args& a) {
  using G = LongGeo<OH, SH, CX, NG>;
  auto kernel = correlation_bwd_rows_kernel<T, STREAM, CX, NG, OH, SH, RING, MINB>;
  if (!STREAM && !resident(a.Cq, a.Cv)) return cudaErrorInvalidValue;
  const size_t oq = STREAM ? KC * G::PO : 0;
  const size_t stage = 2 * KC * G::PS + 2 * oq + G::BS * G::CT;
  const size_t smem =
      sizeof(float) * (G::BO * G::PS + (STREAM ? 0 : 2 * KC * G::PO) + RING * stage);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 blocks((a.HW + G::BO - 1) / G::BO, a.B, (a.Cq + G::CT - 1) / G::CT);
  kernel<<<blocks, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.grid), a.out, a.dout, a.dq, a.stats, a.amax, a.HW, a.Cq, a.Cv);
  return cudaGetLastError();
}

template <typename T, bool STREAM, int CX, int NG, int OH, int SH, int RING, int MINB>
cudaError_t launch_cols(const Args& a) {
  using G = LongGeo<OH, SH, CX, NG>;
  auto kernel = correlation_bwd_cols_kernel<T, STREAM, CX, NG, OH, SH, RING, MINB>;
  const int nQ = (a.Cq + KC - 1) / KC, nV = (a.Cv + 2 + KC - 1) / KC, nC = nQ > nV ? nQ : nV;
  if (STREAM ? nC < RING : !resident(a.Cq, a.Cv)) return cudaErrorInvalidValue;
  const size_t oq = STREAM ? KC * G::PO : 0, rows = 2 * G::BS * G::CT;
  const size_t stage = 2 * KC * G::PS + 2 * oq + (STREAM ? 0 : rows) + 5 * G::BS;
  const size_t smem = sizeof(float) * (2 * G::BO * G::PS + (STREAM ? rows : 2 * KC * G::PO) +
                                       RING * stage);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tk = (a.Cq + G::CT - 1) / G::CT, tv = (a.Cv + G::CT - 1) / G::CT;
  const dim3 blocks((a.HW + G::BO - 1) / G::BO, a.B, tk > tv ? tk : tv);
  kernel<<<blocks, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.grid), a.dout, a.stats, a.amax, a.dk, a.dv, a.HW, a.Cq, a.Cv);
  return cudaGetLastError();
}

// Whether the few-rows kernels' score tiles cover HW with their threads.
template <int TR, int TC, int RQ, bool SPLIT>
bool short_fits(int HW) {
  const int tiles = ((HW + TR - 1) / TR) * ((HW + TC - 1) / TC);
  return HW <= SHORT_HW && 4 * RQ >= HW && tiles <= (SPLIT ? NT / 2 : NT);
}

// n_ct column tiles of dq, each of at most NT columns.
template <typename T, int TR, int TC, int RQ, int RING, bool SPLIT>
cudaError_t launch_rows_short(const Args& a, int n_ct) {
  auto kernel = correlation_bwd_rows_short_kernel<T, TR, TC, RQ, RING, SPLIT>;
  const int CT = n_ct < 1 ? 0 : (a.Cq + n_ct - 1) / n_ct;
  if (!short_fits<TR, TC, RQ, SPLIT>(a.HW) || n_ct < 1 || CT > NT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * short_floats<SPLIT>(a.HW, RING);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_ct, a.B), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.grid), a.out, a.dout, a.dq, a.stats, a.amax, a.HW, a.Cq, a.Cv, CT);
  return cudaGetLastError();
}

// n_ct column tiles, each of at most NT / 2 columns of dk and as many of dv.
template <typename T, int TR, int TC, int RQ, int RING, bool SPLIT>
cudaError_t launch_cols_short(const Args& a, int n_ct) {
  auto kernel = correlation_bwd_cols_short_kernel<T, TR, TC, RQ, RING, SPLIT>;
  const int cols = a.Cq > a.Cv ? a.Cq : a.Cv;
  const int CT = n_ct < 1 ? 0 : (cols + n_ct - 1) / n_ct;
  if (!short_fits<TR, TC, RQ, SPLIT>(a.HW) || n_ct < 1 || 2 * CT > NT)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * short_floats<SPLIT>(a.HW, RING);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_ct, a.B), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.grid), a.dout, a.stats, a.amax, a.dk, a.dv, a.HW, a.Cq, a.Cv, CT);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, got = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      n = got;
    else
      n = 132;
  }
  return n;
}

// Column tiles of the few-rows kernels: each tile sums every score again, so
// as few as give every SM one block at this batch (and at least 32 columns a
// tile, at most max_ct).
int short_col_tiles(int B, int cols, int max_ct) {
  const int least = (cols + max_ct - 1) / max_ct;
  const int fill = sm_count() / (B > 0 ? B : 1), most = (cols + 31) / 32;
  const int want = fill < most ? fill : most;
  return least > want ? least : want;
}

// The instantiations. Few rows: up to 32 positions SPLIT with two ring
// stages (2 x 2 scores a thread at HW = 20), beyond 32 all threads on each
// product. Long rows: a thread's 8 x 4 scores (BO = 128 own rows, BS = 64 a
// streamed tile), two ring stages, one block a SM; 32 accumulator columns a
// column tile up to 32 channels, 64 up to 64, else 128 (NG = 2); streaming
// the own side's operands (beyond 40 channels) a block owns 64 rows (K3: 128
// keys do not fit 227 KB of shared memory with the ring). On an H100 80GB
// HBM3 at 700 W (tools/torch_chip_studies.py k23-fma-variants) at the 3d3d
// grid in float32 at B=10, K2 took 3.04-3.07 ms in one sweep and 5.13-5.16
// in two (a first sweep for the statistics alone), 3.76-3.78 with 8 x 8
// scores (spilling), 3.83-3.86 with 4 x 8, 3.64-3.67 with 4 x 4 two blocks
// a SM, 3.04-3.07 with three stages; K3 3.72-3.75, 3.65-3.68 with three
// stages, 5.18-5.22 with 64 keys. At 1,024 channels on the 5x4 grid at B=10
// (the device alone) the few-rows K2 / K3 took 0.042 / 0.038 ms SPLIT and
// 0.054-0.062 / 0.055-0.058 with all threads on each product in turn; 8
// column tiles as 13, 26 nearly twice as long. At Cq 256 / Cv 96 bf16 K2
// took 56.0-56.6 ms with 128-column tiles, 70.4 with two blocks a SM, 100.9
// with 64-column tiles, 91.4 with 64 owning 128 rows; K3 59.7-60.5, 77.9
// with two blocks a SM, 104.1 with 64-column tiles (the first port's
// 128-column tiles 89.0-89.5 and 66.5-66.9).
template <typename T>
cudaError_t dispatch_rows(const Args& a) {
  if (a.HW <= SHORT_HW) {
    const int n = short_col_tiles(a.B, a.Cq, NT);
    if (a.HW <= 16) return launch_rows_short<T, 1, 2, 4, 2, true>(a, n);
    if (a.HW <= 22) return launch_rows_short<T, 2, 2, 6, 2, true>(a, n);
    if (a.HW <= 32) return launch_rows_short<T, 2, 4, 8, 2, true>(a, n);
    return launch_rows_short<T, 4, 4, 16, 2, false>(a, n);
  }
  const bool res = resident(a.Cq, a.Cv);
  if (a.Cq <= 32)
    return res ? launch_rows<T, false, 8, 1, 2, 1, 2, 1>(a)
               : launch_rows<T, true, 8, 1, 1, 1, 2, 1>(a);
  if (a.Cq <= 64)
    return res ? launch_rows<T, false, 16, 1, 2, 1, 2, 1>(a)
               : launch_rows<T, true, 16, 1, 1, 1, 2, 1>(a);
  return launch_rows<T, true, 16, 2, 1, 1, 2, 1>(a);
}

template <typename T>
cudaError_t dispatch_cols(const Args& a) {
  const int cols = a.Cq > a.Cv ? a.Cq : a.Cv;
  if (a.HW <= SHORT_HW) {
    const int n = short_col_tiles(a.B, cols, NT / 2);
    if (a.HW <= 16) return launch_cols_short<T, 1, 2, 4, 2, true>(a, n);
    if (a.HW <= 22) return launch_cols_short<T, 2, 2, 6, 2, true>(a, n);
    if (a.HW <= 32) return launch_cols_short<T, 2, 4, 8, 2, true>(a, n);
    return launch_cols_short<T, 4, 4, 16, 2, false>(a, n);
  }
  const bool res = resident(a.Cq, a.Cv);
  if (cols <= 32)
    return res ? launch_cols<T, false, 8, 1, 2, 1, 2, 1>(a)
               : launch_cols<T, true, 8, 1, 1, 1, 2, 1>(a);
  if (cols <= 64)
    return res ? launch_cols<T, false, 16, 1, 2, 1, 2, 1>(a)
               : launch_cols<T, true, 16, 1, 1, 1, 2, 1>(a);
  return launch_cols<T, true, 16, 2, 1, 1, 2, 1>(a);
}

}  // namespace

// Every function returns a cudaError_t (0 on success). dtype: 0 = float32,
// 1 = bfloat16.

// The "fma" design, at any Cq >= 1 and Cv >= 0.

// K2: dq [B, HW, Cq], stats [B, HW, 3] = (row max, a raw score; 1 /
// denominator; c) and amax [B, HW] int32, from q, k, v, grid, the forward's
// output out [B, HW, Cv + 3] and its cotangent dout, both float32.
extern "C" int correlation_bwd_rows(const void* q, const void* k, const void* v,
                                    const void* grid, const void* out, const void* dout,
                                    void* dq, void* stats, void* amax, int B, int HW,
                                    int Cq, int Cv, int dtype, void* stream) {
  if (bad_shape(B, HW, Cq, Cv)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  Args a{q, k, v, grid, static_cast<const float*>(out), static_cast<const float*>(dout),
         static_cast<float*>(dq), nullptr, nullptr, static_cast<float*>(stats),
         static_cast<int*>(amax), B, HW, Cq, Cv, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_rows<float>(a);
  if (dtype == 1) return dispatch_rows<bf16>(a);
  return cudaErrorInvalidValue;
}

// K3: dk [B, HW, Cq] and dv [B, HW, Cv] from q, k, v, grid, dout and the
// statistics K2 wrote.
extern "C" int correlation_bwd_cols(const void* q, const void* k, const void* v,
                                    const void* grid, const void* dout, const void* stats,
                                    const void* amax, void* dk, void* dv, int B, int HW,
                                    int Cq, int Cv, int dtype, void* stream) {
  if (bad_shape(B, HW, Cq, Cv)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  Args a{q, k, v, grid, nullptr, static_cast<const float*>(dout), nullptr,
         static_cast<float*>(dk), static_cast<float*>(dv),
         const_cast<float*>(static_cast<const float*>(stats)),
         const_cast<int*>(static_cast<const int*>(amax)), B, HW, Cq, Cv,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_cols<float>(a);
  if (dtype == 1) return dispatch_cols<bf16>(a);
  return cudaErrorInvalidValue;
}
