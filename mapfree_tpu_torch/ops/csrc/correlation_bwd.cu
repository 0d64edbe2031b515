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
// Two designs live here, chosen by the caller (ops/correlation.py::
// backward_design), each complete for its inputs.
//
// "mma" (second half of this file): bf16 inputs, Cq and Cv multiples of 8 up
// to 128. What it does about the bound:
// - Every product runs on the tensor cores: mma.sync m16n8k16, bf16 operands,
//   float32 accumulators in registers. A warp owns one or two m-tiles of 16
//   rows; K3 at up to 32 channels takes two, which share every fragment of
//   the streamed operand and so halve the shared-memory reads per product.
//   (wgmma would need shared-memory descriptors and a 64-row operand per
//   warpgroup; at depth 32 the fragment traffic and the latency between the
//   two products, not the tensor pipe, are what mma.sync leaves to win.)
// - Operands stay bf16 in shared memory, in padded tiles that ldmatrix reads
//   without bank conflicts (mma_tile.cuh). The 64-key tiles (K2) or 64-row
//   chunks (K3) arrive through a ring of two stages filled by 16-byte
//   cp.async copies, so the next tile is in flight while this one is
//   multiplied: one __syncthreads per tile. Each thread's share of a copy is
//   fixed at compile time (no division in the loop).
// - P and dS never touch shared memory: the accumulator fragments of the
//   first products (S, dP) are turned into P and dS in float32 and packed to
//   bf16 straight into the A fragments of the second products. The
//   transposes the second products need come with ldmatrix.trans.
// - A prologue kernel reads out and dout once and leaves what both passes
//   can copy 16 bytes at a time: dmain as bf16 rows of round_up(Cv + 2, 16)
//   columns, zero-padded, and per row (1/d, c = dout . out, d_ms) as float32.
// - K2 takes no exponential in its first sweep: 1/d is the forward's saved
//   max score (out[Cv + 2]), so sweep 1 is the score product, the row max
//   and the first argmax only. It leaves lse = max * log2e - log2(1/d), the
//   log2 of the row's softmax normaliser, so that P = 2^(s log2e - lse) is
//   one fused multiply-add and one ex2 in sweep 2 and in K3. Sweep 2 rebuilds
//   P, forms dS, accumulates dq. (With the row max and argmax saved by the
//   forward, sweep 1 would go.)
// - The max-score cotangent enters dP at one key per row, so both passes test
//   per 16 keys (K2) or per warp (K3) whether an argmax falls there at all
//   and only then compare per element.
// - K3 keeps a fixed order: one block owns (batch, 128 columns), loops over
//   all row chunks, dk and dv in registers, no atomics: equal bits run to run.
// - Ragged edges: rows and keys past HW are zero-filled by the copies
//   (src-size 0) and nothing past HW is stored. That is all the masking the
//   second sweep and K3 need: a key past HW has k = 0 and adds nothing to dq
//   whatever its dS (the exponent is clamped at 0 to keep it finite); a row
//   past HW has q = dmain = c = 0, so its P adds nothing to dv and its dS is
//   0. Only K2's first sweep masks, so that a padded score of 0 cannot win
//   the max.
// - dmain, P and dS are rounded to bf16 (2^-9 relative each) where the "fma"
//   design keeps float32; c, the row statistics and every sum are float32,
//   and dS = P (dP - c) is formed in float32 and rounded once.
// - 1/d comes from the forward, whose scores are summed in another order than
//   mma sums them, so P <= 1 holds only to rounding. The argmax goes from K2
//   to K3 as an index, so K3 needs no bit-equal score.
//
// "fma" (first half): float32 inputs, where exact float32 arithmetic is the
// point, and bf16 shapes the other design does not take, at any Cq >= 1 and
// Cv >= 0. Scalar fused multiply-adds on float32 tiles staged transposed in
// shared memory: 256 threads as 16 x 16, each owning a 4 x 4 patch of the
// 64 x 64 score tile.
// - Every product over channels (q . k over Cq, dmain . [v | grid] over
//   Cv + 2) is summed over chunks of at most QC = 128 channels staged in turn
//   (resident when one chunk holds them all), so shared memory does not grow
//   with the width (171 KB at most, K3).
// - The grid's third dimension tiles the accumulator columns, at most 128 a
//   block: K2's dq columns, K3's dk and dv columns (tile z takes columns
//   128 z.. of both). Every column tile recomputes the same scores in the same
//   order, so the row statistics and the first argmax agree bit for bit
//   across tiles; only tile 0 writes them (K2).
// - K2 sweeps the key tiles twice. Sweep 1 keeps, per row, the running
//   max, the denominator and the first argmax (each of the 16 lanes that share
//   a row keeps its own state; they are merged once at the end, the smallest
//   index winning among equal maxima). Sweep 2 rebuilds P tile by tile, forms
//   dS and accumulates dq in registers.
// - K3 reads the per-row statistics K2 wrote: the row max (log2 domain), the
//   reciprocal denominator, c, and the argmax as an int32. It keeps a fixed
//   order with no atomics.
// - Scores are recomputed with the same fused multiply-adds in the same order
//   in K2's two sweeps and in K3 (a*b commutes), so here P_ij <= 1 holds bit
//   for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "mma_tile.cuh"

namespace {

constexpr int TM = 64;      // tile edge: query rows and key columns per tile
constexpr int NT = 256;     // threads: 16 groups of 4 rows x 16 lanes of 4 columns
constexpr int LD = TM + 4;  // padded stride (floats) of every transposed tile
constexpr int MAX_CPT = 8;  // accumulator columns per lane: 128 per column tile
constexpr int QC = 128;     // channels per chunk of a product over channels
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int chunk_of(int C) { return C < QC ? C : QC; }
__host__ __device__ __forceinline__ int n_chunks(int C) { return (C + QC - 1) / QC; }

// dst[c * LD + r] = src[(row0 + r) * ld_src + c0 + c] for r < TM, c < C; rows
// past HW are zero.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src, int row0, int HW,
                                            int c0, int C, int ld_src, int tid) {
  for (int e = tid; e < TM * C; e += NT) {
    const int r = e / C, c = e - r * C;
    const int row = row0 + r;
    dst[c * LD + r] = row < HW ? to_f(src[static_cast<size_t>(row) * ld_src + c0 + c]) : 0.f;
  }
}

// dst[c * LD + r] = [v | grid][(row0 + r), c0 + c] for c < C, transposed,
// zero past HW.
template <typename T>
__device__ __forceinline__ void load_vg_tile_t(float* dst, const T* vb, const T* grid,
                                               int row0, int HW, int Cv, int c0, int C,
                                               int tid) {
  for (int e = tid; e < TM * C; e += NT) {
    const int r = e / C, c = c0 + e - r * C;
    const int row = row0 + r;
    float x = 0.f;
    if (row < HW) {
      x = c < Cv ? to_f(vb[static_cast<size_t>(row) * Cv + c])
                 : to_f(grid[static_cast<size_t>(row) * 2 + (c - Cv)]);
    }
    dst[(c - c0) * LD + r] = x;
  }
}

// s[i][jj] += sum_c a[c][4 ty + i] * b[c][4 tx + jj], c ascending, one fma each
__device__ __forceinline__ void tile_product(const float* a, const float* b, int C,
                                             int ty, int tx, float s[4][4]) {
  for (int c = 0; c < C; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(&a[c * LD + 4 * ty]);
    const float4 y = *reinterpret_cast<const float4*>(&b[c * LD + 4 * tx]);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(xv[i], yv[jj], s[i][jj]);
  }
}

__device__ __forceinline__ void zero44(float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
}

// The two products of a 64 x 64 tile over channels, chunk by chunk:
//   s  = A_rows . B_cols over Ca channels   (q . k, or k . q in K3)
//   dp = D_rows . V_cols over Cd channels   (dmain . [v | grid], or the swap)
// given loaders that stage chunk (c0, width) of each operand transposed. A
// and D are resident (loaded by the caller) when one chunk holds them. Ends
// with every thread past the last product, so the caller may reuse the
// buffers after one more __syncthreads.
template <typename LA, typename LB, typename LD_, typename LV>
__device__ __forceinline__ void chunked_products(
    float* aT, float* bT, float* dT, float* vT, int Ca, int Cd, bool with_dp, int ty, int tx,
    float s[4][4], float dp[4][4], LA load_a, LB load_b, LD_ load_d, LV load_v) {
  zero44(s);
  zero44(dp);
  const int na = n_chunks(Ca), nd = with_dp ? n_chunks(Cd) : 0;
  const int n = na > nd ? na : nd;
  for (int ch = 0; ch < n; ++ch) {
    const int c0 = ch * QC;
    __syncthreads();  // the previous chunk (or tile) is consumed
    if (ch < na) {
      const int w = Ca - c0 < QC ? Ca - c0 : QC;
      if (na > 1) load_a(aT, c0, w);
      load_b(bT, c0, w);
    }
    if (ch < nd) {
      const int w = Cd - c0 < QC ? Cd - c0 : QC;
      if (nd > 1) load_d(dT, c0, w);
      load_v(vT, c0, w);
    }
    __syncthreads();
    if (ch < na) tile_product(aT, bT, Ca - c0 < QC ? Ca - c0 : QC, ty, tx, s);
    if (ch < nd) tile_product(dT, vT, Cd - c0 < QC ? Cd - c0 : QC, ty, tx, dp);
  }
}

// ---------------------------------------------------------------------- K2 --

// grid (x: 64-row tile, y: batch, z: tile of 16 CPT dq columns)
template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
correlation_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ grid,
                            const float* __restrict__ out, const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ stats,
                            int* __restrict__ amax_out, int HW, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  const int CvP = Cv + 2;
  const int CO = Cv + 3;                    // columns of out and dout
  const int CQC = chunk_of(Cq), CVC = chunk_of(CvP);
  float* qT = smem;                 // [CQC][LD]  query chunk (resident if one)
  float* dmT = qT + CQC * LD;       // [CVC][LD]  dmain chunk (resident if one)
  float* kT = dmT + CVC * LD;       // [CQC][LD]  key chunk
  float* vgT = kT + CQC * LD;       // [CVC][LD]  [v | grid] chunk
  float* ps = vgT + CVC * LD;       // [TM][LD]   dS of this key tile

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;  // lane within the half-warp that shares those rows

  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const T* vb = v + boff * Cv;
  const float* ob = out + boff * CO;
  const float* dob = dout + boff * CO;

  auto load_q = [&](float* dst, int c0, int w) { load_tile_t(dst, qb, row0, HW, c0, w, Cq, tid); };
  auto load_dm = [&](float* dst, int c0, int w) {
    load_tile_t(dst, dob, row0, HW, c0, w, CO, tid);
  };
  int key0 = 0;
  auto load_k = [&](float* dst, int c0, int w) { load_tile_t(dst, kb, key0, HW, c0, w, Cq, tid); };
  auto load_vg = [&](float* dst, int c0, int w) {
    load_vg_tile_t(dst, vb, grid, key0, HW, Cv, c0, w, tid);
  };
  if (n_chunks(Cq) == 1) load_q(qT, 0, Cq);
  if (n_chunks(CvP) == 1) load_dm(dmT, 0, CvP);

  // c_i = dout_i . out_i, and the max-score cotangent of each row
  float cval[4], dms[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    float part = 0.f;
    dms[i] = 0.f;
    if (row < HW) {
      const float* o = ob + static_cast<size_t>(row) * CO;
      const float* d = dob + static_cast<size_t>(row) * CO;
      for (int col = tx; col < CO; col += 16) part = fmaf(d[col], o[col], part);
      dms[i] = d[CvP];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    cval[i] = part;
  }

  // sweep 1: per lane, the running max (log2 domain), the denominator and the
  // first argmax of the raw scores over this lane's columns
  float m[4], l[4], best[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    best[i] = -INFINITY;
    bidx[i] = 0x7fffffff;
  }
  for (key0 = 0; key0 < HW; key0 += TM) {
    float s[4][4], unused[4][4];
    chunked_products(qT, kT, dmT, vgT, Cq, CvP, false, ty, tx, s, unused, load_q, load_k,
                     load_dm, load_vg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s2[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = key0 + 4 * tx + jj;
        const bool valid = key < HW;
        if (valid && s[i][jj] > best[i]) {  // strict: the earlier index stays on a tie
          best[i] = s[i][jj];
          bidx[i] = key;
        }
        s2[jj] = valid ? s[i][jj] * LOG2E : NEG;
      }
      const float mx = fmaxf(fmaxf(s2[0], s2[1]), fmaxf(s2[2], s2[3]));
      const float m_new = fmaxf(m[i], mx);
      l[i] = l[i] * exp2f(m[i] - m_new) +
             ((exp2f(s2[0] - m_new) + exp2f(s2[1] - m_new)) +
              (exp2f(s2[2] - m_new) + exp2f(s2[3] - m_new)));
      m[i] = m_new;
    }
  }
  // merge the 16 lanes of each row
  float inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mm = m[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float ll = l[i] * exp2f(m[i] - mm);  // a lane that saw no valid key drops out
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) ll += __shfl_xor_sync(0xffffffffu, ll, off);
    m[i] = mm;
    inv_l[i] = 1.f / ll;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob2 = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (ob2 > best[i] || (ob2 == best[i] && oi < bidx[i])) {
        best[i] = ob2;
        bidx[i] = oi;
      }
    }
    const int row = row0 + 4 * ty + i;
    if (tx == 0 && z == 0 && row < HW) {
      float* st = stats + (boff + row) * 3;
      st[0] = m[i];
      st[1] = inv_l[i];
      st[2] = cval[i];
      amax_out[boff + row] = bidx[i];
    }
  }

  // sweep 2: dS tile by tile, this block's dq columns in registers
  const int colz = z * 16 * CPT;
  const int CW = Cq - colz < 16 * CPT ? Cq - colz : 16 * CPT;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;

  for (key0 = 0; key0 < HW; key0 += TM) {
    float s[4][4], dp[4][4];
    chunked_products(qT, kT, dmT, vgT, Cq, CvP, true, ty, tx, s, dp, load_q, load_k, load_dm,
                     load_vg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ds[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = key0 + 4 * tx + jj;
        const float p = key < HW ? exp2f(s[i][jj] * LOG2E - m[i]) * inv_l[i] : 0.f;
        const float dpv = dp[i][jj] + (key == bidx[i] ? dms[i] : 0.f);
        ds[jj] = p * (dpv - cval[i]);
      }
      *reinterpret_cast<float4*>(&ps[(4 * ty + i) * LD + 4 * tx]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // dS is written; every product has read kT
    if (n_chunks(Cq) > 1) {  // kT holds the last chunk: bring this block's columns
      load_k(kT, colz, CW);
      __syncthreads();
    }

    // acc[rows, cols tx + 16 cc] += dS[rows, tile] . k[tile, colz + cols]
    for (int j = 0; j < TM; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * LD + j]);
        pr[i][0] = t.x;
        pr[i][1] = t.y;
        pr[i][2] = t.z;
        pr[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = tx + 16 * cc;
        if (col < CW) {
          const float4 t = *reinterpret_cast<const float4*>(&kT[col * LD + j]);
          const float kv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pr[i][jj], kv[jj], acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row < HW) {
      float* o = dq + (boff + row) * Cq + colz;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = tx + 16 * cc;
        if (col < CW) o[col] = acc[i][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------- K3 --

// grid (x: 64-column tile, y: batch, z: tile of 16 CPT columns of dk and of dv)
template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
correlation_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ grid,
                            const float* __restrict__ dout, const float* __restrict__ stats,
                            const int* __restrict__ amax, float* __restrict__ dk,
                            float* __restrict__ dv, int HW, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  const int CvP = Cv + 2;
  const int CO = Cv + 3;
  const int CQC = chunk_of(Cq), CVC = chunk_of(CvP);
  float* kT = smem;                 // [CQC][LD]  key chunk of this block (resident if one)
  float* vgT = kT + CQC * LD;       // [CVC][LD]  [v | grid] chunk (resident if one)
  float* qT = vgT + CVC * LD;       // [CQC][LD]  query chunk of this row chunk
  float* dmT = qT + CQC * LD;       // [CVC][LD]  dmain chunk of this row chunk
  float* ps = dmT + CVC * LD;       // [TM][LD]   P^T  [column j][row i]
  float* dss = ps + TM * LD;        // [TM][LD]   dS^T [column j][row i]
  float* r_m = dss + TM * LD;       // [TM] per-row statistics of this row chunk
  float* r_il = r_m + TM;
  float* r_c = r_il + TM;
  float* r_dms = r_c + TM;
  int* r_amax = reinterpret_cast<int*>(r_dms + TM);

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * TM;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // columns j = col0 + 4*ty .. + 3 (rows of the tile)
  const int tx = tid & 15;  // rows i = row0 + 4*tx .. + 3 (columns of the tile)

  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const T* vb = v + boff * Cv;
  const float* dob = dout + boff * CO;

  auto load_k = [&](float* dst, int c0, int w) { load_tile_t(dst, kb, col0, HW, c0, w, Cq, tid); };
  auto load_vg = [&](float* dst, int c0, int w) {
    load_vg_tile_t(dst, vb, grid, col0, HW, Cv, c0, w, tid);
  };
  int row0 = 0;
  auto load_q = [&](float* dst, int c0, int w) { load_tile_t(dst, qb, row0, HW, c0, w, Cq, tid); };
  auto load_dm = [&](float* dst, int c0, int w) {
    load_tile_t(dst, dob, row0, HW, c0, w, CO, tid);
  };
  if (n_chunks(Cq) == 1) load_k(kT, 0, Cq);
  if (n_chunks(CvP) == 1) load_vg(vgT, 0, CvP);

  // this block's columns of dk (z < tiles of Cq) and of dv (z < tiles of Cv)
  const int colz = z * 16 * CPT;
  const int CWK = Cq - colz < 16 * CPT ? Cq - colz : 16 * CPT;  // <= 0: none
  const int CWV = Cv - colz < 16 * CPT ? Cv - colz : 16 * CPT;
  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      acc_k[a][cc] = 0.f;
      acc_v[a][cc] = 0.f;
    }

  for (row0 = 0; row0 < HW; row0 += TM) {
    // the previous row chunk's statistics were last read before the
    // __syncthreads that follows its P and dS
    if (tid < TM) {
      const int row = row0 + tid;
      const bool valid = row < HW;
      const float* st = stats + (boff + row) * 3;
      r_m[tid] = valid ? st[0] : 0.f;
      r_il[tid] = valid ? st[1] : 0.f;
      r_c[tid] = valid ? st[2] : 0.f;
      r_dms[tid] = valid ? dob[static_cast<size_t>(row) * CO + CvP] : 0.f;
      r_amax[tid] = valid ? amax[boff + row] : -1;
    }
    float s[4][4], dp[4][4];
    // s[a][bb] = k_j . q_i; dp[a][bb] = [v|grid]_j . dmain_i
    chunked_products(kT, qT, vgT, dmT, Cq, CvP, true, ty, tx, s, dp, load_k, load_q, load_vg,
                     load_dm);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int jg = col0 + 4 * ty + a;
      float p[4], ds[4];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int il = 4 * tx + bb;
        const bool valid = jg < HW && row0 + il < HW;
        p[bb] = valid ? exp2f(s[a][bb] * LOG2E - r_m[il]) * r_il[il] : 0.f;
        const float dpv = dp[a][bb] + (jg == r_amax[il] ? r_dms[il] : 0.f);
        ds[bb] = p[bb] * (dpv - r_c[il]);
      }
      *reinterpret_cast<float4*>(&ps[(4 * ty + a) * LD + 4 * tx]) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(&dss[(4 * ty + a) * LD + 4 * tx]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // P and dS are written; every product has read qT and dmT
    const bool reload_q = n_chunks(Cq) > 1 && CWK > 0;
    const bool reload_dm = n_chunks(CvP) > 1 && CWV > 0;
    if (reload_q || reload_dm) {  // the last chunks are staged: bring this block's columns
      if (reload_q) load_q(qT, colz, CWK);
      if (reload_dm) load_dm(dmT, colz, CWV);
      __syncthreads();
    }

    // acc_k[cols j, ch] += dS^T[j, chunk] . q[chunk, colz + ch]
    // acc_v[cols j, ch] += P^T[j, chunk] . dmain[chunk, colz + ch]
    for (int i = 0; i < TM; i += 4) {
      float pr[4][4], dr[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 t = *reinterpret_cast<const float4*>(&ps[(4 * ty + a) * LD + i]);
        pr[a][0] = t.x;
        pr[a][1] = t.y;
        pr[a][2] = t.z;
        pr[a][3] = t.w;
        const float4 u = *reinterpret_cast<const float4*>(&dss[(4 * ty + a) * LD + i]);
        dr[a][0] = u.x;
        dr[a][1] = u.y;
        dr[a][2] = u.z;
        dr[a][3] = u.w;
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = tx + 16 * cc;
        if (col < CWK) {
          const float4 t = *reinterpret_cast<const float4*>(&qT[col * LD + i]);
          const float qv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int a = 0; a < 4; ++a) acc_k[a][cc] = fmaf(dr[a][ii], qv[ii], acc_k[a][cc]);
        }
        if (col < CWV) {
          const float4 t = *reinterpret_cast<const float4*>(&dmT[col * LD + i]);
          const float dm[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int a = 0; a < 4; ++a) acc_v[a][cc] = fmaf(pr[a][ii], dm[ii], acc_v[a][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int jg = col0 + 4 * ty + a;
    if (jg < HW) {
      float* ok = dk + (boff + jg) * Cq + colz;
      float* ov = dv + (boff + jg) * Cv + colz;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = tx + 16 * cc;
        if (col < CWK) ok[col] = acc_k[a][cc];
        if (col < CWV) ov[col] = acc_v[a][cc];
      }
    }
  }
}

// ============================================================ "mma" design ==

namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

// A block is NW warps; a warp owns MT m-tiles of 16 rows of the block's own
// tile, which share every B fragment they multiply with. Measured at B=10,
// HW=6,256, C=32 on an H100 (K2 / K3 in ms): MT=1 with 8 warps and a ring of
// two stages 0.50 / 0.48; with 4 warps and a ring of three 0.51 / 0.49; with 2
// warps 0.85 / 0.79; MT=2 with 4 warps 0.52 / 0.38 (K3 reads half the
// fragments per product; K2 gains nothing at 245 registers). A ring of four,
// or MT=1 with registers uncapped (153 a thread, 12 warps a SM), were slower
// than the cap of 128 with a few spilled bytes. So K2 runs MT=1 with 8 warps,
// K3 MT=2 with 4 warps where its accumulators fit (channels up to 32).
constexpr int STAGES = 2;  // ring of 64-key tiles (K2) or 64-row chunks (K3) in flight

template <int MT, int NW>
struct MmaBlock {
  static constexpr int NT = 32 * NW;  // threads of a block
  static constexpr int WR = 16 * MT;  // rows of the block's own tile a warp owns
  static constexpr int BR = WR * NW;  // rows (K2) or columns (K3) a block owns
};

// Sizes for channels padded to CQ and CV (multiples of 16): tiles are bf16,
// row-major, with mma_tile's padded pitch.
template <int CQ, int CV, int MT>
struct MmaGeo {
  static constexpr int VG = CV + 16;        // [v | grid | zeros] and dmain: depth of dP
  static constexpr int PQ = CQ + mt::PAD;   // pitch of a q or k tile
  static constexpr int PV = VG + mt::PAD;   // pitch of a [v | grid] or dmain tile
  static constexpr int KQ = CQ / 16;        // depth-16 steps of the score product
  static constexpr int KV = VG / 16;        // depth-16 steps of the dP product
  // the warp's own WR x CQ and WR x VG operands stay in registers for the
  // whole loop where they fit; wider ones are re-read from shared memory
  static constexpr bool A_IN_REGS = (CQ + CV) * MT <= 128;
  static constexpr int HELD_Q = A_IN_REGS ? KQ : 1;
  static constexpr int HELD_V = A_IN_REGS ? KV : 1;
};

// The warp's A fragments of a resident tile, all depth steps, into registers.
template <int MT, int KS>
__device__ __forceinline__ void hold_a(uint32_t (&held)[MT][KS][4], const bf16* tile, int pitch,
                                       int row0, const mt::LaneOffsets& lo) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mt::load_a(held[m][ks], tile, pitch, row0 + 16 * m, ks * 16, lo);
}

// acc[m] (16 rows x 16 tile rows n0 .. n0 + 16) = A[m] . tile^T over KS depth
// steps, for each of the warp's m-tiles; a B fragment is loaded once for all.
template <bool IN_REGS, int KS, int MT, int N>
__device__ __forceinline__ void first_product(float (&acc)[MT][2][4],
                                              const uint32_t (&held)[MT][N][4],
                                              const bf16* a_tile, int a_row0,
                                              const bf16* b_tile, int pitch, int n0,
                                              const mt::LaneOffsets& lo) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[4];
    mt::load_b(b, b_tile, pitch, n0, ks * 16, lo);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t a[4];
      if constexpr (IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = held[m][ks][i];
      } else {
        mt::load_a(a, a_tile, pitch, a_row0 + 16 * m, ks * 16, lo);
      }
      mt::mma_bf16(acc[m][0], a, b[0], b[1]);
      mt::mma_bf16(acc[m][1], a, b[2], b[3]);
    }
  }
}

// acc[m] (16 rows x 16 NP columns) += A[m] (16 x 16, from registers) .
// tile[k0 .. k0 + 16][:], for each of the warp's m-tiles
template <int NP, int MT>
__device__ __forceinline__ void second_product(float (&acc)[MT][2 * NP][4],
                                               const uint32_t (&a)[MT][4], const bf16* tile,
                                               int pitch, int k0, const mt::LaneOffsets& lo) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    uint32_t b[4];
    mt::load_b_trans(b, tile, pitch, k0, np * 16, lo);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mt::mma_bf16(acc[m][2 * np], a[m], b[0], b[1]);
      mt::mma_bf16(acc[m][2 * np + 1], a[m], b[2], b[3]);
    }
  }
}

// The warp's accumulators into a [rows, C] float32 array: m-tile m holds rows
// r0 + 16 m + g (acc[.][0..1]) and + 8 (acc[.][2..3]); rows from n_rows on and
// columns from C on are not stored.
template <int MT, int NTILES>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[MT][NTILES][4], int C,
                                          size_t boff, int r0, int n_rows, int g, int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * m + 8 * h + g;
      if (row < n_rows) {
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) {
          const int col = nt * 8 + 2 * t;
          if (col < C)
            *reinterpret_cast<float2*>(dst + (boff + row) * C + col) =
                make_float2(acc[m][nt][2 * h], acc[m][nt][2 * h + 1]);
        }
      }
    }
}

// ---------------------------------------------------------------- prologue --
// One warp per (batch, row): dmain[row] = bf16(dout[row][:Cv + 2]) padded with
// zeros to DM columns; stats[row] = (0, out[row][Cv + 2] = 1/d, dout . out,
// dout[row][Cv + 2]). K2 fills stats[row][0] with lse, the log2 of the row's
// softmax normaliser.
__global__ void __launch_bounds__(256)
correlation_bwd_prologue_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                                bf16* __restrict__ dmain, float* __restrict__ stats,
                                int n_rows, int Cv, int DM) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int CO = Cv + 3;
  const float* o = out + static_cast<size_t>(row) * CO;
  const float* d = dout + static_cast<size_t>(row) * CO;
  float part = 0.f;
  for (int col = lane; col < CO; col += 32) part = fmaf(d[col], o[col], part);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  bf16* dm = dmain + static_cast<size_t>(row) * DM;
  for (int col = lane; col < DM; col += 32)
    dm[col] = __float2bfloat16_rn(col < Cv + 2 ? d[col] : 0.f);
  if (lane == 0)
    *reinterpret_cast<float4*>(stats + static_cast<size_t>(row) * 4) =
        make_float4(0.f, o[Cv + 2], part, d[Cv + 2]);
}

// ---------------------------------------------------------------------- K2 --
// One block per (batch, BR rows i); warp w owns rows WR w .. WR w + WR - 1 as
// MT m-tiles of 16, and within a fragment a thread owns rows g and g + 8
// (g = lane / 4) and, per 8-key n-tile, keys 2t and 2t + 1 (t = lane % 4).
template <int CQ, int CV, int MT, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
correlation_bwd_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                const bf16* __restrict__ dmain, float* __restrict__ stats,
                                float* __restrict__ dq, int* __restrict__ amax_out, int HW,
                                int Cq, int Cv, int DM) {
  using G = MmaGeo<CQ, CV, MT>;
  constexpr int NTM = MmaBlock<MT, NW>::NT, WR = MmaBlock<MT, NW>::WR, BR = MmaBlock<MT, NW>::BR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BR][PQ]  query tile (resident)
  bf16* dms = qs + BR * G::PQ;                   // [BR][PV]  dmain tile (resident)
  bf16* ring = dms + BR * G::PV;                 // STAGES x ([TM][PQ] keys, [TM][PV] v|grid)
  constexpr int STAGE = TM * (G::PQ + G::PV);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const mt::LaneOffsets lo(lane);

  const size_t boff = static_cast<size_t>(b) * HW;
  const bf16* qb = q + boff * Cq;
  const bf16* kb = k + boff * Cq;
  const bf16* vb = v + boff * Cv;
  const bf16* dmb = dmain + boff * DM;

  // the padding channels are written once: no copy ever touches them
  mt::tile_zero_cols<BR, NTM>(qs, G::PQ, Cq, CQ, tid);
  mt::tile_zero_cols<BR, NTM>(dms, G::PV, DM, G::VG, tid);
  for (int st = 0; st < STAGES; ++st) {
    mt::tile_zero_cols<TM, NTM>(ring + st * STAGE, G::PQ, Cq, CQ, tid);
    mt::tile_zero_cols<TM, NTM>(ring + st * STAGE + TM * G::PQ, G::PV, Cv + 2, G::VG, tid);
  }

  // step u < nT: sweep 1 over key tile u (keys only); step u >= nT: sweep 2
  // over key tile u - nT (keys and [v | grid]). One ring serves both, so the
  // copies run ahead across the boundary between the sweeps.
  const int nT = (HW + TM - 1) / TM;
  const int n_steps = 2 * nT;
  auto load_step = [&](int u) {
    if (u < n_steps) {
      bf16* kt = ring + (u % STAGES) * STAGE;
      const bool second = u >= nT;
      const int key0 = (second ? u - nT : u) * TM;
      mt::tile_copy_async<TM, NTM, CQ / 8>(kt, G::PQ * 2, kb, Cq * 2, key0, HW, tid);
      if (second) {
        bf16* vt = kt + TM * G::PQ;
        mt::tile_copy_async<TM, NTM, CV / 8>(vt, G::PV * 2, vb, Cv * 2, key0, HW, tid);
        if (tid < TM) {
          const int key = key0 + tid;
          const bool ok = key < HW;
          mt::cp_async_4(vt + tid * G::PV + Cv, grid + 2 * (ok ? key : 0), ok);
        }
      }
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };

  // the resident tiles travel in the first group
  mt::tile_copy_async<BR, NTM, CQ / 8>(qs, G::PQ * 2, qb, Cq * 2, row0, HW, tid);
  mt::tile_copy_async<BR, NTM, G::VG / 8>(dms, G::PV * 2, dmb, DM * 2, row0, HW, tid);
  for (int u = 0; u < STAGES - 1; ++u) load_step(u);

  // this thread's rows: m-tile m, half h -> row wr0 + 16 m + 8 h + g
  const int wr0 = row0 + warp * WR;
  float inv_d[MT][2], cval[MT][2], d_ms[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr0 + 16 * m + 8 * h + g;
      float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < HW) st = *reinterpret_cast<const float4*>(stats + (boff + row) * 4);
      inv_d[m][h] = st.y;
      cval[m][h] = st.z;
      d_ms[m][h] = st.w;
    }

  uint32_t qa[MT][G::HELD_Q][4], da[MT][G::HELD_V][4];
  float best[MT][2];
  int bidx[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[m][h] = -INFINITY;
      bidx[m][h] = 0x7fffffff;
    }

  // sweep 1: the row max and the first argmax of the raw scores. Each thread
  // sees its own keys in ascending order, so a strict > keeps the first.
  int u = 0;
  for (; u < nT; ++u) {
    mt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step u has landed for everyone; step u - 1's stage is free
    load_step(u + STAGES - 1);
    if (u == 0 && G::A_IN_REGS) {
      hold_a(qa, qs, G::PQ, warp * WR, lo);
      hold_a(da, dms, G::PV, warp * WR, lo);
    }
    const bf16* kt = ring + (u % STAGES) * STAGE;
    const int key0 = u * TM;
    // only the last tile has keys past HW (zero rows, whose score 0 must not win)
    const int n_keys = HW - key0;
#pragma unroll
    for (int gi = 0; gi < TM / 16; ++gi) {
      float s[MT][2][4] = {};
      first_product<G::A_IN_REGS, G::KQ>(s, qa, qs, warp * WR, kt, G::PQ, gi * 16, lo);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = gi * 16 + nt * 8 + 2 * t + (e & 1);
            const int h = e >> 1;
            const float sv = kl < n_keys ? s[m][nt][e] : -INFINITY;
            if (sv > best[m][h]) {
              best[m][h] = sv;
              bidx[m][h] = key0 + kl;
            }
          }
    }
  }

  // merge the four threads of each row: the smaller index wins a tie
  float lse[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[m][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[m][h], off);
        if (ob > best[m][h] || (ob == best[m][h] && oi < bidx[m][h])) {
          best[m][h] = ob;
          bidx[m][h] = oi;
        }
      }
      // log2 of the row's softmax normaliser, so that P = 2^(s log2e - lse) with
      // no further factor; 1/d = 0 (a row past HW) gives lse = +inf and P = 0
      lse[m][h] = best[m][h] * LOG2E - log2f(inv_d[m][h]);
      const int row = wr0 + 16 * m + 8 * h + g;
      if (t == 0 && row < HW) {
        stats[(boff + row) * 4] = lse[m][h];
        amax_out[boff + row] = bidx[m][h];
      }
    }

  // sweep 2: P and dS per 16 keys in registers, dq accumulated in registers
  float acc[MT][CQ / 8][4] = {};
  for (; u < n_steps; ++u) {
    mt::cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_step(u + STAGES - 1);
    const bf16* kt = ring + (u % STAGES) * STAGE;
    const bf16* vt = kt + TM * G::PQ;
    const int key0 = (u - nT) * TM;
#pragma unroll
    for (int gi = 0; gi < TM / 16; ++gi) {
      float s[MT][2][4] = {}, dp[MT][2][4] = {};
      first_product<G::A_IN_REGS, G::KQ>(s, qa, qs, warp * WR, kt, G::PQ, gi * 16, lo);
      first_product<G::A_IN_REGS, G::KV>(dp, da, dms, warp * WR, vt, G::PV, gi * 16, lo);
      const int gk0 = key0 + gi * 16;
      uint32_t ds_a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // the max-score cotangent enters at the argmax: rarely in this group
        if (static_cast<unsigned>(bidx[m][0] - gk0) < 16u ||
            static_cast<unsigned>(bidx[m][1] - gk0) < 16u) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (gk0 + nt * 8 + 2 * t + (e & 1) == bidx[m][e >> 1])
                dp[m][nt][e] += d_ms[m][e >> 1];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            // keys past HW need no mask: their k rows are zero, so whatever dS
            // they get adds nothing to dq; the clamp keeps that dS finite
            const float p = mt::ex2(fminf(fmaf(s[m][nt][e], LOG2E, -lse[m][h]), 0.f));
            ds[e] = p * (dp[m][nt][e] - cval[m][h]);
          }
          ds_a[m][2 * nt] = mt::pack_bf16(ds[0], ds[1]);
          ds_a[m][2 * nt + 1] = mt::pack_bf16(ds[2], ds[3]);
        }
      }
      second_product<CQ / 16>(acc, ds_a, kt, G::PQ, gi * 16, lo);
    }
  }

  store_acc(dq, acc, Cq, boff, wr0, HW, g, t);
}

// ---------------------------------------------------------------------- K3 --
// One block per (batch, BR columns j); warp w owns columns WR w .. WR w + WR - 1
// as the rows of the transposed tile (MT m-tiles of 16), and loops over all
// row chunks i in a fixed order. Per chunk a stage brings q, dmain, the row
// statistics K2 completed (lse, 1/d, c, d_ms as one float4) and the argmax.
template <int CQ, int CV, int MT, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
correlation_bwd_cols_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                const bf16* __restrict__ dmain,
                                const float* __restrict__ stats, const int* __restrict__ amax,
                                float* __restrict__ dk, float* __restrict__ dv, int HW, int Cq,
                                int Cv, int DM) {
  using G = MmaGeo<CQ, CV, MT>;
  constexpr int NTM = MmaBlock<MT, NW>::NT, WR = MmaBlock<MT, NW>::WR, BR = MmaBlock<MT, NW>::BR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BR][PQ]  key tile (resident)
  bf16* vgs = ks + BR * G::PQ;                   // [BR][PV]  [v | grid] tile (resident)
  unsigned char* ring = smem_raw + sizeof(bf16) * BR * (G::PQ + G::PV);
  // a stage: [TM][PQ] q, [TM][PV] dmain, [TM] float4 statistics, [TM] int argmax
  constexpr int STAGE_BYTES = sizeof(bf16) * TM * (G::PQ + G::PV) + TM * 16 + TM * 4;

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const mt::LaneOffsets lo(lane);

  const size_t boff = static_cast<size_t>(b) * HW;
  const bf16* qb = q + boff * Cq;
  const bf16* kb = k + boff * Cq;
  const bf16* vb = v + boff * Cv;
  const bf16* dmb = dmain + boff * DM;
  const float* stb = stats + boff * 4;
  const int* amb = amax + boff;

  mt::tile_zero_cols<BR, NTM>(ks, G::PQ, Cq, CQ, tid);
  mt::tile_zero_cols<BR, NTM>(vgs, G::PV, Cv + 2, G::VG, tid);
  for (int st = 0; st < STAGES; ++st) {
    bf16* qt = reinterpret_cast<bf16*>(ring + st * STAGE_BYTES);
    mt::tile_zero_cols<TM, NTM>(qt, G::PQ, Cq, CQ, tid);
    mt::tile_zero_cols<TM, NTM>(qt + TM * G::PQ, G::PV, DM, G::VG, tid);
  }

  const int nT = (HW + TM - 1) / TM;
  auto load_step = [&](int u) {
    if (u < nT) {
      bf16* qt = reinterpret_cast<bf16*>(ring + (u % STAGES) * STAGE_BYTES);
      bf16* dt = qt + TM * G::PQ;
      float4* st = reinterpret_cast<float4*>(dt + TM * G::PV);
      int* am = reinterpret_cast<int*>(st + TM);
      const int i0 = u * TM;
      mt::tile_copy_async<TM, NTM, CQ / 8>(qt, G::PQ * 2, qb, Cq * 2, i0, HW, tid);
      mt::tile_copy_async<TM, NTM, G::VG / 8>(dt, G::PV * 2, dmb, DM * 2, i0, HW, tid);
      if (tid < TM) {
        // rows past HW arrive as zeros: their q, dmain and c are 0, so P = 1
        // there adds nothing to dv and their dS is 0
        const int row = i0 + tid;
        const bool ok = row < HW;
        mt::cp_async_16(st + tid, stb + 4 * static_cast<size_t>(ok ? row : 0), ok);
        mt::cp_async_4(am + tid, amb + (ok ? row : 0), ok);
      }
    }
    mt::cp_async_commit();
  };

  // the resident tiles travel in the first group
  mt::tile_copy_async<BR, NTM, CQ / 8>(ks, G::PQ * 2, kb, Cq * 2, col0, HW, tid);
  mt::tile_copy_async<BR, NTM, CV / 8>(vgs, G::PV * 2, vb, Cv * 2, col0, HW, tid);
  for (int r = tid; r < BR; r += NTM) {
    const int key = col0 + r;
    const bool ok = key < HW;
    mt::cp_async_4(vgs + r * G::PV + Cv, grid + 2 * (ok ? key : 0), ok);
  }
  for (int u = 0; u < STAGES - 1; ++u) load_step(u);

  const int jw0 = col0 + warp * WR;  // this warp's columns jw0 .. jw0 + WR - 1
  uint32_t ka[MT][G::HELD_Q][4], va[MT][G::HELD_V][4];
  float acc_k[MT][CQ / 8][4] = {}, acc_v[MT][CV / 8][4] = {};

  for (int u = 0; u < nT; ++u) {
    mt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk u has landed for everyone; chunk u - 1's stage is free
    load_step(u + STAGES - 1);
    if (u == 0 && G::A_IN_REGS) {
      hold_a(ka, ks, G::PQ, warp * WR, lo);
      hold_a(va, vgs, G::PV, warp * WR, lo);
    }
    const bf16* qt = reinterpret_cast<const bf16*>(ring + (u % STAGES) * STAGE_BYTES);
    const bf16* dt = qt + TM * G::PQ;
    const float4* st = reinterpret_cast<const float4*>(dt + TM * G::PV);
    const int* am = reinterpret_cast<const int*>(st + TM);
#pragma unroll
    for (int gi = 0; gi < TM / 16; ++gi) {
      // s[m][nt][e], dp[m][nt][e]: column jw0 + 16 m + 8 (e >> 1) + g,
      // row i = 16 gi + 8 nt + 2t + (e & 1) of the chunk
      float s[MT][2][4] = {}, dp[MT][2][4] = {};
      first_product<G::A_IN_REGS, G::KQ>(s, ka, ks, warp * WR, qt, G::PQ, gi * 16, lo);
      first_product<G::A_IN_REGS, G::KV>(dp, va, vgs, warp * WR, dt, G::PV, gi * 16, lo);
      uint32_t p_a[MT][4], ds_a[MT][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int il = gi * 16 + nt * 8 + 2 * t;
        const float4 st0 = st[il], st1 = st[il + 1];  // (lse, 1/d, c, d_ms) of rows i, i + 1
        const int2 am2 = *reinterpret_cast<const int2*>(am + il);
        // the max-score cotangent enters where a row's argmax is one of this
        // warp's columns: rarely
        if (static_cast<unsigned>(am2.x - jw0) < static_cast<unsigned>(WR) ||
            static_cast<unsigned>(am2.y - jw0) < static_cast<unsigned>(WR)) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (jw0 + 16 * m + 8 * (e >> 1) + g == ((e & 1) ? am2.y : am2.x))
                dp[m][nt][e] += (e & 1) ? st1.w : st0.w;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 sx = (e & 1) ? st1 : st0;
            p[e] = mt::ex2(fmaf(s[m][nt][e], LOG2E, -sx.x));
            ds[e] = p[e] * (dp[m][nt][e] - sx.z);
          }
          p_a[m][2 * nt] = mt::pack_bf16(p[0], p[1]);
          p_a[m][2 * nt + 1] = mt::pack_bf16(p[2], p[3]);
          ds_a[m][2 * nt] = mt::pack_bf16(ds[0], ds[1]);
          ds_a[m][2 * nt + 1] = mt::pack_bf16(ds[2], ds[3]);
        }
      }
      second_product<CQ / 16>(acc_k, ds_a, qt, G::PQ, gi * 16, lo);  // dk += dS^T . q
      second_product<CV / 16>(acc_v, p_a, dt, G::PV, gi * 16, lo);   // dv += P^T . dmain
    }
  }

  store_acc(dk, acc_k, Cq, boff, jw0, HW, g, t);
  store_acc(dv, acc_v, Cv, boff, jw0, HW, g, t);
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

size_t rows_smem(int Cq, int Cv) {
  return sizeof(float) * static_cast<size_t>(LD) *
         (2 * chunk_of(Cq) + 2 * chunk_of(Cv + 2) + TM);
}

size_t cols_smem(int Cq, int Cv) {
  return sizeof(float) * (static_cast<size_t>(LD) *
                              (2 * chunk_of(Cq) + 2 * chunk_of(Cv + 2) + 2 * TM) +
                          5 * TM);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int col_tiles(int channels, int cpt) { return (channels + 16 * cpt - 1) / (16 * cpt); }

template <typename T, int CPT>
cudaError_t launch_rows(const Args& a) {
  const size_t smem = rows_smem(a.Cq, a.Cv);
  const cudaError_t e = allow_smem(correlation_bwd_rows_kernel<T, CPT>, smem);
  if (e != cudaSuccess) return e;
  const dim3 blocks((a.HW + TM - 1) / TM, a.B, col_tiles(a.Cq, CPT));
  correlation_bwd_rows_kernel<T, CPT><<<blocks, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.grid), a.out, a.dout, a.dq, a.stats, a.amax, a.HW, a.Cq,
      a.Cv);
  return cudaGetLastError();
}

template <typename T, int CPT>
cudaError_t launch_cols(const Args& a) {
  const size_t smem = cols_smem(a.Cq, a.Cv);
  const cudaError_t e = allow_smem(correlation_bwd_cols_kernel<T, CPT>, smem);
  if (e != cudaSuccess) return e;
  const int tk = col_tiles(a.Cq, CPT), tv = col_tiles(a.Cv, CPT);
  const dim3 blocks((a.HW + TM - 1) / TM, a.B, tk > tv ? tk : tv);
  correlation_bwd_cols_kernel<T, CPT><<<blocks, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.grid), a.dout, a.stats, a.amax, a.dk, a.dv, a.HW, a.Cq,
      a.Cv);
  return cudaGetLastError();
}

// accumulator columns per lane, rounded up to 1, 2, 4 or 8; wider inputs take
// 8 and more column tiles
int cpt_for(int channels) {
  const int need = (channels + 15) / 16;
  for (int cpt = 1; cpt < MAX_CPT; cpt *= 2)
    if (need <= cpt) return cpt;
  return MAX_CPT;
}

template <typename T>
cudaError_t dispatch_rows(int cpt, const Args& a) {
  switch (cpt) {
    case 1: return launch_rows<T, 1>(a);
    case 2: return launch_rows<T, 2>(a);
    case 4: return launch_rows<T, 4>(a);
    case 8: return launch_rows<T, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_cols(int cpt, const Args& a) {
  switch (cpt) {
    case 1: return launch_cols<T, 1>(a);
    case 2: return launch_cols<T, 2>(a);
    case 4: return launch_cols<T, 4>(a);
    case 8: return launch_cols<T, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int HW, int Cq, int Cv) {
  return B < 0 || HW < 0 || Cq <= 0 || Cv < 0;
}

// ------------------------------------------------- launches, "mma" design --

struct MmaArgs {
  const bf16 *q, *k, *v, *grid, *dmain;
  float *stats, *dq, *dk, *dv;
  int* amax;
  int B, HW, Cq, Cv, DM;
  cudaStream_t stream;
};

// bytes of a q-or-k tile and a dmain-or-[v | grid] tile of `rows` rows
template <int CQ, int CV>
constexpr size_t mma_tiles_bytes(int rows) {
  return sizeof(bf16) * rows * (MmaGeo<CQ, CV, 1>::PQ + MmaGeo<CQ, CV, 1>::PV);
}

template <int CQ, int CV, int MT, int NW, int MINB>
cudaError_t launch_rows_mma(const MmaArgs& a) {
  using Blk = MmaBlock<MT, NW>;
  auto kernel = correlation_bwd_rows_mma_kernel<CQ, CV, MT, NW, MINB>;
  const size_t smem = mma_tiles_bytes<CQ, CV>(Blk::BR) + STAGES * mma_tiles_bytes<CQ, CV>(TM);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 blocks((a.HW + Blk::BR - 1) / Blk::BR, a.B);
  kernel<<<blocks, Blk::NT, smem, a.stream>>>(a.q, a.k, a.v, a.grid, a.dmain, a.stats, a.dq,
                                             a.amax, a.HW, a.Cq, a.Cv, a.DM);
  return cudaGetLastError();
}

template <int CQ, int CV, int MT, int NW, int MINB>
cudaError_t launch_cols_mma(const MmaArgs& a) {
  using Blk = MmaBlock<MT, NW>;
  auto kernel = correlation_bwd_cols_mma_kernel<CQ, CV, MT, NW, MINB>;
  const size_t smem = mma_tiles_bytes<CQ, CV>(Blk::BR) +
                      STAGES * (mma_tiles_bytes<CQ, CV>(TM) + TM * 20);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 blocks((a.HW + Blk::BR - 1) / Blk::BR, a.B);
  kernel<<<blocks, Blk::NT, smem, a.stream>>>(a.q, a.k, a.v, a.grid, a.dmain, a.stats, a.amax,
                                             a.dk, a.dv, a.HW, a.Cq, a.Cv, a.DM);
  return cudaGetLastError();
}

// The instantiations: channels padded up to (CQ, CV); then m-tiles a warp,
// warps a block, and the least blocks a SM should hold (which caps the
// registers a thread may take).
cudaError_t dispatch_rows_mma(const MmaArgs& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_rows_mma<16, 16, 1, 8, 2>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_rows_mma<16, 32, 1, 8, 2>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_rows_mma<32, 32, 1, 8, 2>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_rows_mma<64, 64, 1, 8, 1>(a);
  return launch_rows_mma<128, 128, 1, 8, 1>(a);
}

cudaError_t dispatch_cols_mma(const MmaArgs& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_cols_mma<16, 16, 2, 4, 2>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_cols_mma<16, 32, 2, 4, 2>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_cols_mma<32, 32, 2, 4, 2>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_cols_mma<64, 64, 1, 8, 1>(a);
  return launch_cols_mma<128, 128, 1, 8, 1>(a);
}

bool mma_takes(int B, int HW, int Cq, int Cv, int dtype) {
  return !bad_shape(B, HW, Cq, Cv) && dtype == 1 && Cq % 8 == 0 && Cv % 8 == 0 &&
         Cv >= 8 && Cq <= 128 && Cv <= 128;
}

int dmain_width(int Cv) { return (Cv + 2 + 15) / 16 * 16; }

}  // namespace

// Every function returns a cudaError_t (0 on success). dtype: 0 = float32,
// 1 = bfloat16.

// The "fma" design, at any Cq >= 1 and Cv >= 0.

// K2: dq [B, HW, Cq], stats [B, HW, 3] = (row max in the log2 domain,
// 1 / denominator, c) and amax [B, HW] int32, from q, k, v, grid, the
// forward's output out [B, HW, Cv + 3] and its cotangent dout, both float32.
extern "C" int correlation_bwd_rows(const void* q, const void* k, const void* v,
                                    const void* grid, const void* out, const void* dout,
                                    void* dq, void* stats, void* amax, int B, int HW,
                                    int Cq, int Cv, int dtype, void* stream) {
  if (bad_shape(B, HW, Cq, Cv)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  const int cpt = cpt_for(Cq);
  Args a{q, k, v, grid, static_cast<const float*>(out), static_cast<const float*>(dout),
         static_cast<float*>(dq), nullptr, nullptr, static_cast<float*>(stats),
         static_cast<int*>(amax), B, HW, Cq, Cv, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_rows<float>(cpt, a);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(cpt, a);
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
  const int cpt = cpt_for(Cq > Cv ? Cq : Cv);
  Args a{q, k, v, grid, nullptr, static_cast<const float*>(dout), nullptr,
         static_cast<float*>(dk), static_cast<float*>(dv),
         const_cast<float*>(static_cast<const float*>(stats)),
         const_cast<int*>(static_cast<const int*>(amax)), B, HW, Cq, Cv,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_cols<float>(cpt, a);
  if (dtype == 1) return dispatch_cols<__nv_bfloat16>(cpt, a);
  return cudaErrorInvalidValue;
}

// The "mma" design (bf16, Cq and Cv multiples of 8 up to 128; dtype must be 1).

// K2 with its prologue: from out and dout (float32) the prologue writes dmain
// [B, HW, round_up(Cv + 2, 16)] bf16 and stats [B, HW, 4] = (., 1/d, c, d_ms);
// the row pass then writes dq [B, HW, Cq], stats[..., 0] = the log2 of the
// row's softmax normaliser, and amax [B, HW] int32.
extern "C" int correlation_bwd_rows_mma(const void* q, const void* k, const void* v,
                                        const void* grid, const void* out, const void* dout,
                                        void* dq, void* stats, void* amax, void* dmain, int B,
                                        int HW, int Cq, int Cv, int dtype, void* stream) {
  if (!mma_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
            static_cast<const bf16*>(dmain), static_cast<float*>(stats),
            static_cast<float*>(dq), nullptr, nullptr, static_cast<int*>(amax), B, HW, Cq, Cv,
            dmain_width(Cv), static_cast<cudaStream_t>(stream)};
  const int n_rows = B * HW;
  correlation_bwd_prologue_kernel<<<(n_rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<bf16*>(dmain), a.stats, n_rows, Cv, a.DM);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return dispatch_rows_mma(a);
}

// K3: dk [B, HW, Cq] and dv [B, HW, Cv] from q, k, v, grid and what K2 left.
extern "C" int correlation_bwd_cols_mma(const void* q, const void* k, const void* v,
                                        const void* grid, const void* dmain, const void* stats,
                                        const void* amax, void* dk, void* dv, int B, int HW,
                                        int Cq, int Cv, int dtype, void* stream) {
  if (!mma_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
            static_cast<const bf16*>(dmain),
            const_cast<float*>(static_cast<const float*>(stats)), nullptr,
            static_cast<float*>(dk), static_cast<float*>(dv),
            const_cast<int*>(static_cast<const int*>(amax)), B, HW, Cq, Cv, dmain_width(Cv),
            static_cast<cudaStream_t>(stream)};
  return dispatch_cols_mma(a);
}
