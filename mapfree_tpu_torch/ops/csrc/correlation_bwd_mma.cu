// Fused correlation-volume softmax-warp, backward pass on the tensor cores,
// for Hopper (sm_90a): the "mma" design of K2 and K3 (correlation_bwd.cu
// holds the "fma" design and the bound of the training shape).
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
// "mma": bf16 inputs, Cq and Cv multiples of 8, at any width. What bounds it:
// operations. At the 3d3d training shape (B=10, HW=6,256, Cq=Cv=32) K2 does
// 2 B HW^2 (Cq + (Cv + 2) + Cq) = 7.7e10 FLOP and K3 2 B HW^2 (2 Cq + 2 Cv +
// 2) = 1.0e11 in products, and each B HW^2 = 3.9e8 exponentials: near 0.1 ms
// each at 989 TFLOP/s (bf16) and 16 exponentials per SM per clock, against
// 0.006 ms for their 20 MB of inputs and outputs. At Cq 256 / Cv 96 the
// products take 0.48 + 0.56 ms, and the operands no longer fit a block's
// registers whole. What the first tensor-core pair lost to, and what this
// design does:
// - K2 swept the keys twice (a score product, a k-tile copy and a barrier a
//   tile paid twice) and a prologue kernel read out and dout apart. K2 now
//   takes one sweep, as the FMA K2 does: an online max m of the raw scores
//   per row, moved lazily every TKG = 16 keys (only in a row whose largest
//   score passes it by LAZY_GAP, P up to 2^8; the vote is per warp, the move
//   per row, so a row's m depends on its own scores alone), each lane's
//   first argmax (merged at the end, the smallest index winning a tie), and
//   the unnormalised sum_j e_ij (dP_ij - c_i) k_j with e = 2^((s - m) log2e),
//   rescaled only where a row's m moved. At the end dq_i = (2^((m - M)
//   log2e) acc_i + d_ms_i k_{amax_i}) / d_i, with M the row's max and 1/d the
//   forward's saved max score; the max-score cotangent enters at one k row
//   instead of a compare per score. K2 writes lse = M log2e - log2(1/d), so
//   that K3's P = 2^(s log2e - lse) is one FMA and one ex2. dS' is rounded to
//   bf16 relative to the row's running reference, not to its max:
//   ops/correlation.py's plain backward with key_tile=BWD_KEY_TILE rounds
//   the same way. A row of NaN scores keeps no argmax and takes key 0, so
//   that the k row read stays in the batch element and the NaN reaches dq.
// - Where the block's own tiles fit shared memory (Cq and Cv up to 128, and
//   Cq up to 256 with Cv up to 96) each K2 block forms its rows' dmain (the
//   cotangent of [warped | pos] in bf16, into its tile and to device memory
//   for K3), c = dout . out, 1/d and d_ms itself while its first copies fly,
//   every load in flight: the prologue kernel, folded in. The warp's A
//   fragments of q and dmain stay in registers up to 128 channels (the
//   first pair re-read them from shared memory beyond 64); the 64-key tiles of k and
//   [v | grid | 0] arrive through a ring of ST stages of 16-byte cp.async
//   copies, one __syncthreads a tile. K3 keeps the first pair's structure there: one
//   block owns (batch, BR keys), loops over the row chunks of 64 in a fixed
//   order with dk and dv in registers, two m-tiles a warp sharing every B
//   fragment up to 32 channels, A fragments in registers up to 128. At 256 /
//   96 the whole dq (K2) or [dk | dv] (K3) stays in one 8-warp block's
//   registers, so no score is summed twice.
// - Wider than that (the ResNet encoder's 1,024 channels, a 256-channel
//   ResUNet) both stream, as K1's wide design: q and k, and dmain and [v |
//   grid], arrive in channel chunks of KCH = 64 through
//   the ring (a key tile (K2) or row chunk (K3) takes max(ceil(Cq / 64),
//   ceil(DM / 64)) ring steps, the scores of 64 keys or rows accumulating in
//   registers), and the tile's row-major operand of the second products (K2:
//   k rows; K3: q and dmain rows, the rows' statistics and argmax) rides with
//   its last chunk into a buffer outside the ring. The accumulator is cut
//   into column tiles of CT = 128, a grid dimension: dq's columns in K2, CT
//   columns of dk and of dv in K3. Every column tile sums the same scores in
//   the same order, so its row max, argmax and rescaling agree to the bit,
//   and tile 0 alone writes the statistics. The prologue kernel stays
//   there: a column tile would otherwise read dmain while tile 0 writes it.
// - Every product runs on the tensor cores: mma.sync m16n8k16, bf16
//   operands from padded shared-memory tiles (mma_tile.cuh, ldmatrix without
//   bank conflicts), float32 accumulators. P and dS never touch shared
//   memory: the first products' accumulator fragments become the second
//   products' A fragments in registers, the transposes coming with
//   ldmatrix.trans. (wgmma would need shared-memory descriptors and a
//   64-row operand per warpgroup; at depth 32 the fragment traffic and the
//   latency between the two products, not the tensor pipe, are what
//   mma.sync leaves to win.)
// - Ragged edges: rows and keys past HW, and channels past Cq or DM in a
//   streamed chunk, are zero-filled by the copies and nothing past HW is
//   stored; K2 scores keys past HW -inf, and a row past HW has q = dmain = c
//   = 0, so it adds nothing to dv and its dS is 0.
// - dmain, P and dS are rounded to bf16 (2^-9 relative each) where the "fma"
//   design keeps float32; c, the row statistics and every sum are float32.
//   K3 forms dk and dv in a fixed order with no atomics: equal bits run to
//   run, as K2's dq.
// - 1/d comes from the forward, whose scores are summed in another order than
//   mma sums them, so P <= 1 holds only to rounding. The argmax goes from K2
//   to K3 as an index, so K3 needs no bit-equal score.
// The instantiation per width (dispatch_rows_mma, dispatch_cols_mma) was
// chosen by timing, tools/torch_chip_studies.py k23-mma-variants; the
// candidates and their times are beside the dispatch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "mma_tile.cuh"

namespace {

namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

constexpr int TM = 64;  // tiles: 64 keys (K2), 64-row chunks (K3)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LAZY_GAP = 8.f / LOG2E;  // how far a row's score may pass K2's reference: P up to 2^8

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool bad_shape(int B, int HW, int Cq, int Cv) {
  return B < 0 || HW < 0 || Cq <= 0 || Cv < 0;
}

// ============================================================ "mma" design ==

constexpr int TKG = 16;  // keys a step of K2's online max: ops/correlation.py::BWD_KEY_TILE
constexpr int KCH = 64;  // channels a chunk where the operands stream
constexpr int PCH = KCH + mt::PAD;  // the pitch of a chunk (bf16)

// Sizes for channels padded to CQ and CV (multiples of 16) where the own
// side's tiles stay in shared memory: tiles are bf16, row-major, with
// mma_tile's padded pitch.
template <int CQ, int CV>
struct MmaGeo {
  static constexpr int VG = CV + 16;        // [v | grid | zeros] and dmain: depth of dP
  static constexpr int PQ = CQ + mt::PAD;   // pitch of a q or k tile
  static constexpr int PV = VG + mt::PAD;   // pitch of a [v | grid] or dmain tile
  static constexpr int KQ = CQ / 16;        // depth-16 steps of the score product
  static constexpr int KV = VG / 16;        // depth-16 steps of the dP product
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

// acc[m] (16 rows x 16 tile rows n0 .. n0 + 16) += A[m] . tile^T over KS depth
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

// acc[m][8 g ..] (16 rows x 64 tile rows) += A[m] . chunk^T over one chunk of
// KCH channels, A from a_tile (the warp's rows from a_row0), B from b_tile
// (64 rows): the streamed designs' first products, every m-tile sharing each
// B fragment.
template <int MT>
__device__ __forceinline__ void chunk_product(float (&acc)[MT][TM / 8][4], const bf16* a_tile,
                                              int a_row0, const bf16* b_tile,
                                              const mt::LaneOffsets& lo) {
#pragma unroll
  for (int ks = 0; ks < KCH / 16; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) mt::load_a(a[m], a_tile, PCH, a_row0 + 16 * m, ks * 16, lo);
#pragma unroll
    for (int kg = 0; kg < TM / 16; ++kg) {
      uint32_t b[4];
      mt::load_b(b, b_tile, PCH, kg * 16, ks * 16, lo);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mt::mma_bf16(acc[m][2 * kg], a[m], b[0], b[1]);
        mt::mma_bf16(acc[m][2 * kg + 1], a[m], b[2], b[3]);
      }
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

// The warp's accumulators into columns col0 .. of a [rows, C] float32 array:
// m-tile m holds rows r0 + 16 m + g (acc[.][0..1]) and + 8 (acc[.][2..3]);
// rows from n_rows on and columns from C on are not stored.
template <int MT, int NTILES>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[MT][NTILES][4], int C,
                                          int col0, size_t boff, int r0, int n_rows, int g,
                                          int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * m + 8 * h + g;
      if (row < n_rows) {
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) {
          const int col = col0 + nt * 8 + 2 * t;
          if (col < C)
            *reinterpret_cast<float2*>(dst + (boff + row) * C + col) =
                make_float2(acc[m][nt][2 * h], acc[m][nt][2 * h + 1]);
        }
      }
    }
}

// Rows [row0, row0 + ROWS) of [v | grid | zeros], channels c0 .. c0 + KCH, into
// a chunk of pitch PCH: v's columns by 16-byte copies (Cv is a multiple of 8),
// the grid's two values per row into the first two columns of its 16-byte
// piece, zeros in the rest of that piece and beyond; rows at or past HW zero.
// Every piece of the chunk is written, so a stage needs no zeroing.
template <int ROWS, int NT>
__device__ __forceinline__ void vg_chunk_async(bf16* dst, const bf16* vb, const bf16* grid,
                                               int Cv, int c0, int row0, int HW, int tid) {
  constexpr int PIECES = KCH / 8;
#pragma unroll
  for (int e0 = 0; e0 < ROWS * PIECES; e0 += NT) {
    const int e = e0 + tid;
    if (ROWS * PIECES % NT == 0 || e < ROWS * PIECES) {
      const int r = e / PIECES, pc = e % PIECES;
      const int row = row0 + r, col = c0 + 8 * pc;
      const bool ok = row < HW;
      bf16* d = dst + r * PCH + 8 * pc;
      if (col < Cv) {
        mt::cp_async_16(d, ok ? vb + static_cast<size_t>(row) * Cv + col : vb, ok);
      } else if (col == Cv) {
        mt::cp_async_4(d, grid + 2 * (ok ? row : 0), ok);
        mt::cp_async_4(d + 2, grid, false);
        mt::cp_async_4(d + 4, grid, false);
        mt::cp_async_4(d + 6, grid, false);
      } else {
        mt::cp_async_16(d, vb, false);
      }
    }
  }
}

// ------------------------------------------------------------- K2's pass --
// What a thread carries through K2's one sweep for its rows (m-tile m, half
// h: row 16 m + 8 h + g of its warp's rows): the reference m of the row's
// online max (a raw score, common to the four lanes of the row), this lane's
// largest score and first argmax, and the row constant c.
template <int MT>
struct RowPassState {
  float mref[MT][2], best[MT][2], cval[MT][2];
  int bidx[MT][2];
  __device__ void init() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mref[m][h] = best[m][h] = -INFINITY;
        bidx[m][h] = 0x7fffffff;
        cval[m][h] = 0.f;
      }
  }
};

// One step of K2's sweep over the TKG keys gk0 .. gk0 + 16, of which the first
// n_valid lie in the batch element (keys past HW score -inf: a padded score of
// 0 must not count). s and dp are the step's S = q k^T and dP = dmain [v |
// grid]^T fragments. Each lane sees its keys in ascending order, so a strict >
// keeps the first argmax. The reference m moves only in a row whose max passes
// it by LAZY_GAP (e up to 2^8), to the row's max so far (two shuffles), and
// the row's dq columns are rescaled then; the vote is once a step. Then
// dS' = e (dP - c) with e = 2^((s - m) log2e), packed to bf16 A fragments,
// and acc += dS' . rows[k0 .. k0 + 16][:].
template <int MT, int NA>
__device__ __forceinline__ void rows_step(float (&s)[MT][2][4], const float (&dp)[MT][2][4],
                                          int gk0, int n_valid, RowPassState<MT>& st,
                                          float (&acc)[MT][NA][4], const bf16* rows, int pitch,
                                          int k0, const mt::LaneOffsets& lo, int t) {
  bool renew = false;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        const int h = e >> 1;
        if (n_valid < TKG && kl >= n_valid) s[m][nt][e] = -INFINITY;
        if (s[m][nt][e] > st.best[m][h]) {
          st.best[m][h] = s[m][nt][e];
          st.bidx[m][h] = gk0 + kl;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) renew |= st.best[m][h] > st.mref[m][h] + LAZY_GAP;
  }
  if (__any_sync(FULL, renew)) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = st.best[m][h];
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        if (mx > st.mref[m][h] + LAZY_GAP) {  // the row's reference moves
          const float alpha = mt::ex2((st.mref[m][h] - mx) * LOG2E);  // 0 on the first move
#pragma unroll
          for (int n = 0; n < NA; ++n) {
            acc[m][n][2 * h] *= alpha;
            acc[m][n][2 * h + 1] *= alpha;
          }
          st.mref[m][h] = mx;
        }
      }
  }
  uint32_t ds_a[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float ev = mt::ex2((s[m][nt][e] - st.mref[m][h]) * LOG2E);
        ds[e] = ev * (dp[m][nt][e] - st.cval[m][h]);
      }
      ds_a[m][2 * nt] = mt::pack_bf16(ds[0], ds[1]);
      ds_a[m][2 * nt + 1] = mt::pack_bf16(ds[2], ds[3]);
    }
  second_product<NA / 2>(acc, ds_a, rows, pitch, k0, lo);
}

// The end of K2's sweep for this thread's rows (r0: the global index of its
// warp's first row). The four lanes of a row merge their maxima (the smallest
// key wins among equal scores) into the row's max M and first argmax; a row
// with no score above -inf (a NaN row) takes key 0, as a first argmax, so
// that the k row read stays in the batch element and the NaN reaches dq. dq's
// columns col0 + 8 n + 2t (+1) take (2^((m - M) log2e) acc + d_ms k_amax) / d,
// the max-score cotangent entering at the first argmax, where P = 1 / d.
// best and bidx are left holding M and the argmax.
template <int MT, int NA>
__device__ __forceinline__ void rows_finish(RowPassState<MT>& st, const float (&acc)[MT][NA][4],
                                            const float (&inv_d)[MT][2],
                                            const float (&d_ms)[MT][2], float* dq,
                                            const bf16* kb, size_t boff, int r0, int HW, int Cq,
                                            int col0, int g, int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bv = st.best[m][h];
      int bi = st.bidx[m][h];
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
      st.best[m][h] = bv;
      st.bidx[m][h] = bi;
      const float alpha = mt::ex2((st.mref[m][h] - bv) * LOG2E);  // 1 where m is the row's max
      const int row = r0 + 16 * m + 8 * h + g;
      if (row < HW) {
        const bf16* ka = kb + static_cast<size_t>(bi) * Cq;
        float* o = dq + (boff + row) * Cq;
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          const int col = col0 + n * 8 + 2 * t;
          if (col < Cq) {
            const float2 kv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ka + col));
            *reinterpret_cast<float2*>(o + col) =
                make_float2(fmaf(acc[m][n][2 * h], alpha, d_ms[m][h] * kv.x) * inv_d[m][h],
                            fmaf(acc[m][n][2 * h + 1], alpha, d_ms[m][h] * kv.y) * inv_d[m][h]);
          }
        }
      }
    }
}

// ---------------------------------------------------------------- prologue --
// One warp per (batch, row): dmain[row] = bf16(dout[row][:Cv + 2]) padded with
// zeros to DM columns; stats[row] = (0, out[row][Cv + 2] = 1/d, dout . out,
// dout[row][Cv + 2]). K2 fills stats[row][0] with lse, the log2 of the row's
// softmax normaliser. Only the streamed K2 needs it: its column tiles all
// read dmain, which one block alone could not write before the others read
// it.
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
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
  bf16* dm = dmain + static_cast<size_t>(row) * DM;
  for (int col = lane; col < DM; col += 32)
    dm[col] = __float2bfloat16_rn(col < Cv + 2 ? d[col] : 0.f);
  if (lane == 0)
    *reinterpret_cast<float4*>(stats + static_cast<size_t>(row) * 4) =
        make_float4(0.f, o[Cv + 2], part, d[Cv + 2]);
}

// ------------------------------------------------------- K2, own tiles resident --
// One block per (batch, BR rows i); warp w owns rows WR w .. WR w + WR - 1 as
// MT m-tiles of 16, and within a fragment a thread owns rows g and g + 8
// (g = lane / 4) and, per 8-key n-tile, keys 2t and 2t + 1 (t = lane % 4).
// The block forms its rows' dmain (bf16, into its tile and to device memory
// for K3), c = dout . out, 1/d and d_ms itself (the prologue, folded in),
// then walks the keys once in tiles of TM through a ring of ST stages. AREG:
// the warp's A fragments of q and dmain stay in registers for the whole
// sweep.
template <int CQ, int CV, int MT, int NW, int MINB, int ST, bool AREG>
__global__ void __launch_bounds__(32 * NW, MINB)
correlation_bwd_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                const float* __restrict__ out, const float* __restrict__ dout,
                                bf16* __restrict__ dmain, float* __restrict__ stats,
                                float* __restrict__ dq, int* __restrict__ amax_out, int HW,
                                int Cq, int Cv, int DM) {
  using G = MmaGeo<CQ, CV>;
  constexpr int NTM = 32 * NW, WR = 16 * MT, BR = WR * NW;
  constexpr int HQ = AREG ? G::KQ : 1, HV = AREG ? G::KV : 1;
  constexpr int STAGE = TM * (G::PQ + G::PV);
  static_assert(NTM >= TM, "one thread per key copies the grid");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* rs = reinterpret_cast<float4*>(smem_raw);  // [BR] (0, 1/d, c, d_ms) of the rows
  bf16* qs = reinterpret_cast<bf16*>(rs + BR);        // [BR][PQ]  query tile (resident)
  bf16* dms = qs + BR * G::PQ;                        // [BR][PV]  dmain tile (resident)
  bf16* ring = dms + BR * G::PV;                      // ST x ([TM][PQ] keys, [TM][PV] v|grid)

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

  // the padding channels are written once: no copy ever touches them
  mt::tile_zero_cols<BR, NTM>(qs, G::PQ, Cq, CQ, tid);
  for (int st = 0; st < ST; ++st) {
    mt::tile_zero_cols<TM, NTM>(ring + st * STAGE, G::PQ, Cq, CQ, tid);
    mt::tile_zero_cols<TM, NTM>(ring + st * STAGE + TM * G::PQ, G::PV, Cv + 2, G::VG, tid);
  }

  const int nT = (HW + TM - 1) / TM;
  auto load_step = [&](int u) {
    if (u < nT) {
      bf16* kt = ring + (u % ST) * STAGE;
      bf16* vt = kt + TM * G::PQ;
      const int key0 = u * TM;
      mt::tile_copy_async<TM, NTM, CQ / 8>(kt, G::PQ * 2, kb, Cq * 2, key0, HW, tid);
      mt::tile_copy_async<TM, NTM, CV / 8>(vt, G::PV * 2, vb, Cv * 2, key0, HW, tid);
      if (tid < TM) {
        const int key = key0 + tid;
        const bool ok = key < HW;
        mt::cp_async_4(vt + tid * G::PV + Cv, grid + 2 * (ok ? key : 0), ok);
      }
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };

  // the query tile travels in the first group
  mt::tile_copy_async<BR, NTM, CQ / 8>(qs, G::PQ * 2, qb, Cq * 2, row0, HW, tid);
  for (int u = 0; u < ST - 1; ++u) load_step(u);

  // the prologue, while the copies fly: each warp its own rows, four at a
  // time with every load in flight, a lane columns lane + 32 j (the prologue
  // kernel's order, so c has its bits)
  constexpr int NJ = (CV + 3 + 31) / 32;  // columns a lane, at most
  static_assert(32 * NJ >= G::VG, "the lanes reach every column of the dmain tile");
  const int CO = Cv + 3;
#pragma unroll 1
  for (int i0 = 0; i0 < WR; i0 += 4) {
    float dv[4][NJ], ov[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + warp * WR + i0 + i;
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
      const int r = warp * WR + i0 + i, row = row0 + r;
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
        if (col < G::VG) dms[r * G::PV + col] = x;
        if (row < HW && col < DM) drow[col] = x;
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

  const int wr0 = warp * WR;  // the warp's first row in the block
  uint32_t qa[MT][HQ][4], da[MT][HV][4];
  float acc[MT][CQ / 8][4] = {};
  RowPassState<MT> st;
  st.init();

  for (int u = 0; u < nT; ++u) {
    mt::cp_async_wait<ST - 2>();
    __syncthreads();  // tile u has landed for everyone; tile u - 1's stage is free
    load_step(u + ST - 1);
    if (u == 0) {
      if constexpr (AREG) {
        hold_a(qa, qs, G::PQ, wr0, lo);
        hold_a(da, dms, G::PV, wr0, lo);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) st.cval[m][h] = rs[wr0 + 16 * m + 8 * h + g].z;
    }
    const bf16* kt = ring + (u % ST) * STAGE;
    const bf16* vt = kt + TM * G::PQ;
    const int key0 = u * TM;
#pragma unroll
    for (int gi = 0; gi < TM / TKG; ++gi) {
      float s[MT][2][4] = {}, dp[MT][2][4] = {};
      first_product<AREG, G::KQ>(s, qa, qs, wr0, kt, G::PQ, gi * TKG, lo);
      first_product<AREG, G::KV>(dp, da, dms, wr0, vt, G::PV, gi * TKG, lo);
      rows_step(s, dp, key0 + gi * TKG, HW - key0 - gi * TKG, st, acc, kt, G::PQ, gi * TKG, lo,
                t);
    }
  }

  float inv_d[MT][2], d_ms[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 r4 = rs[wr0 + 16 * m + 8 * h + g];
      inv_d[m][h] = r4.y;
      d_ms[m][h] = r4.w;
    }
  rows_finish(st, acc, inv_d, d_ms, dq, kb, boff, row0 + wr0, HW, Cq, 0, g, t);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wr0 + 16 * m + 8 * h + g;
      if (t == 0 && row < HW) {
        // log2 of the row's softmax normaliser, so that K3's P = 2^(s log2e - lse)
        const float lse = st.best[m][h] * LOG2E - log2f(inv_d[m][h]);
        *reinterpret_cast<float4*>(stats + (boff + row) * 4) =
            make_float4(lse, inv_d[m][h], st.cval[m][h], d_ms[m][h]);
        amax_out[boff + row] = st.bidx[m][h];
      }
    }
}

// --------------------------------------------------------- K2, streamed --
// One block per (BR rows i, batch, column tile of CT dq columns). Each key
// tile takes nC = max(ceil(Cq / KCH), ceil(DM / KCH)) ring steps: step c
// brings channels KCH c .. of the tile's k and of the block's q (c < nQ) and of
// the tile's [v | grid] and of the block's dmain (c < nV), which the prologue
// kernel wrote; the tile's k rows of this column tile arrive with its last
// chunk in a buffer outside the ring (nC >= ST: the copy is issued after the
// barrier that follows the last tile's second products). Every column tile
// sums the same scores in the same order; tile 0 alone writes the statistics.
template <int CT, int MT, int NW, int MINB, int ST>
__global__ void __launch_bounds__(32 * NW, MINB)
correlation_bwd_rows_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                   const bf16* __restrict__ dmain, float* __restrict__ stats,
                                   float* __restrict__ dq, int* __restrict__ amax_out, int HW,
                                   int Cq, int Cv, int DM) {
  constexpr int NTM = 32 * NW, WR = 16 * MT, BR = WR * NW;
  constexpr int PR = CT + mt::PAD;                 // pitch of the k rows
  constexpr int STAGE = (2 * TM + 2 * BR) * PCH;  // k, [v | grid], q, dmain chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kr = reinterpret_cast<bf16*>(smem_raw);  // [TM][PR]  the key tile's k rows, this tile's columns
  bf16* ring = kr + TM * PR;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int col0 = blockIdx.z * CT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const mt::LaneOffsets lo(lane);

  const size_t boff = static_cast<size_t>(b) * HW;
  const bf16* qb = q + boff * Cq;
  const bf16* kb = k + boff * Cq;
  const bf16* vb = v + boff * Cv;
  const bf16* dmb = dmain + boff * DM;

  const int nQ = (Cq + KCH - 1) / KCH, nV = (DM + KCH - 1) / KCH;
  const int nC = nQ > nV ? nQ : nV;
  const int nT = (HW + TM - 1) / TM;
  auto load_step = [&](int step) {
    if (step < nT * nC) {
      const int u = step / nC, c = step - u * nC;
      bf16* kt = ring + (step % ST) * STAGE;
      bf16* vt = kt + TM * PCH;
      bf16* qt = vt + TM * PCH;
      bf16* dt = qt + BR * PCH;
      const int key0 = u * TM, c0 = c * KCH;
      if (c < nQ) {
        mt::tile_copy_async_cols<TM, NTM, KCH / 8, true>(kt, PCH * 2, kb + c0, Cq * 2,
                                                         (Cq - c0) * 2, key0, HW, tid);
        mt::tile_copy_async_cols<BR, NTM, KCH / 8, true>(qt, PCH * 2, qb + c0, Cq * 2,
                                                         (Cq - c0) * 2, row0, HW, tid);
      }
      if (c < nV) {
        vg_chunk_async<TM, NTM>(vt, vb, grid, Cv, c0, key0, HW, tid);
        mt::tile_copy_async_cols<BR, NTM, KCH / 8, true>(dt, PCH * 2, dmb + c0, DM * 2,
                                                         (DM - c0) * 2, row0, HW, tid);
      }
      if (c == nC - 1)
        mt::tile_copy_async_cols<TM, NTM, CT / 8, true>(kr, PR * 2, kb + col0, Cq * 2,
                                                        (Cq - col0) * 2, key0, HW, tid);
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };
  for (int step = 0; step < ST - 1; ++step) load_step(step);

  const int wr0 = warp * WR;
  float acc[MT][CT / 8][4] = {};
  float inv_d[MT][2], d_ms[MT][2];
  RowPassState<MT> st;
  st.init();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wr0 + 16 * m + 8 * h + g;
      float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < HW) r4 = *reinterpret_cast<const float4*>(stats + (boff + row) * 4);
      inv_d[m][h] = r4.y;
      st.cval[m][h] = r4.z;
      d_ms[m][h] = r4.w;
    }

  int step = 0;
  for (int u = 0; u < nT; ++u) {
    float s[MT][TM / 8][4] = {}, dp[MT][TM / 8][4] = {};
    for (int c = 0; c < nC; ++c, ++step) {
      mt::cp_async_wait<ST - 2>();
      __syncthreads();  // this step's chunks have landed for everyone; the last step's stage is free
      load_step(step + ST - 1);
      const bf16* kt = ring + (step % ST) * STAGE;
      const bf16* vt = kt + TM * PCH;
      const bf16* qt = vt + TM * PCH;
      const bf16* dt = qt + BR * PCH;
      if (c < nQ) chunk_product(s, qt, wr0, kt, lo);
      if (c < nV) chunk_product(dp, dt, wr0, vt, lo);
    }
    const int key0 = u * TM;
#pragma unroll
    for (int gi = 0; gi < TM / TKG; ++gi) {
      float s16[MT][2][4], dp16[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s16[m][nt][e] = s[m][2 * gi + nt][e];
            dp16[m][nt][e] = dp[m][2 * gi + nt][e];
          }
      rows_step(s16, dp16, key0 + gi * TKG, HW - key0 - gi * TKG, st, acc, kr, PR, gi * TKG, lo,
                t);
    }
  }

  rows_finish(st, acc, inv_d, d_ms, dq, kb, boff, row0 + wr0, HW, Cq, col0, g, t);
  if (blockIdx.z == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wr0 + 16 * m + 8 * h + g;
        if (t == 0 && row < HW) {
          stats[(boff + row) * 4] = st.best[m][h] * LOG2E - log2f(inv_d[m][h]);
          amax_out[boff + row] = st.bidx[m][h];
        }
      }
  }
}

// ------------------------------------------------------------- K3's step --
// P and dS for 16 rows i (chunk rows i0 .. i0 + 16, the n dimension of s and
// dp) and the warp's columns j (jw0 + 16 m + 8 (e >> 1) + g), from the rows'
// statistics (lse, 1/d, c, d_ms) and argmax: P = 2^(s log2e - lse), dS = P
// (dP - c), the max-score cotangent in dP where a row's argmax is one of the
// warp's WR columns (rarely), both packed to bf16 A fragments of the second
// products (the transposes come with the fragment layout).
template <int MT>
__device__ __forceinline__ void cols_terms(const float (&s)[MT][2][4], float (&dp)[MT][2][4],
                                           const float4* st, const int* am, int i0, int jw0,
                                           int WR, int g, int t, uint32_t (&p_a)[MT][4],
                                           uint32_t (&ds_a)[MT][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int il = i0 + nt * 8 + 2 * t;
    const float4 st0 = st[il], st1 = st[il + 1];  // (lse, 1/d, c, d_ms) of rows i, i + 1
    const int2 am2 = *reinterpret_cast<const int2*>(am + il);
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
}

// ------------------------------------------------------- K3, own tiles resident --
// One block per (batch, BR columns j); warp w owns columns WR w .. WR w + WR - 1
// as the rows of the transposed tile (MT m-tiles of 16), and loops over all
// row chunks i in a fixed order. Per chunk a stage brings q, dmain, the row
// statistics K2 completed (lse, 1/d, c, d_ms as one float4) and the argmax.
template <int CQ, int CV, int MT, int NW, int MINB, int ST, bool AREG>
__global__ void __launch_bounds__(32 * NW, MINB)
correlation_bwd_cols_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                const bf16* __restrict__ dmain,
                                const float* __restrict__ stats, const int* __restrict__ amax,
                                float* __restrict__ dk, float* __restrict__ dv, int HW, int Cq,
                                int Cv, int DM) {
  using G = MmaGeo<CQ, CV>;
  constexpr int NTM = 32 * NW, WR = 16 * MT, BR = WR * NW;
  constexpr int HQ = AREG ? G::KQ : 1, HV = AREG ? G::KV : 1;
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
  for (int st = 0; st < ST; ++st) {
    bf16* qt = reinterpret_cast<bf16*>(ring + st * STAGE_BYTES);
    mt::tile_zero_cols<TM, NTM>(qt, G::PQ, Cq, CQ, tid);
    mt::tile_zero_cols<TM, NTM>(qt + TM * G::PQ, G::PV, DM, G::VG, tid);
  }

  const int nT = (HW + TM - 1) / TM;
  auto load_step = [&](int u) {
    if (u < nT) {
      bf16* qt = reinterpret_cast<bf16*>(ring + (u % ST) * STAGE_BYTES);
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
  for (int u = 0; u < ST - 1; ++u) load_step(u);

  const int jw0 = col0 + warp * WR;  // this warp's columns jw0 .. jw0 + WR - 1
  uint32_t ka[MT][HQ][4], va[MT][HV][4];
  float acc_k[MT][CQ / 8][4] = {}, acc_v[MT][CV / 8][4] = {};

  for (int u = 0; u < nT; ++u) {
    mt::cp_async_wait<ST - 2>();
    __syncthreads();  // chunk u has landed for everyone; chunk u - 1's stage is free
    load_step(u + ST - 1);
    if constexpr (AREG) {
      if (u == 0) {
        hold_a(ka, ks, G::PQ, warp * WR, lo);
        hold_a(va, vgs, G::PV, warp * WR, lo);
      }
    }
    const bf16* qt = reinterpret_cast<const bf16*>(ring + (u % ST) * STAGE_BYTES);
    const bf16* dt = qt + TM * G::PQ;
    const float4* st = reinterpret_cast<const float4*>(dt + TM * G::PV);
    const int* am = reinterpret_cast<const int*>(st + TM);
#pragma unroll
    for (int gi = 0; gi < TM / 16; ++gi) {
      // s[m][nt][e], dp[m][nt][e]: column jw0 + 16 m + 8 (e >> 1) + g,
      // row i = 16 gi + 8 nt + 2t + (e & 1) of the chunk
      float s[MT][2][4] = {}, dp[MT][2][4] = {};
      first_product<AREG, G::KQ>(s, ka, ks, warp * WR, qt, G::PQ, gi * 16, lo);
      first_product<AREG, G::KV>(dp, va, vgs, warp * WR, dt, G::PV, gi * 16, lo);
      uint32_t p_a[MT][4], ds_a[MT][4];
      cols_terms(s, dp, st, am, gi * 16, jw0, WR, g, t, p_a, ds_a);
      second_product<CQ / 16>(acc_k, ds_a, qt, G::PQ, gi * 16, lo);  // dk += dS^T . q
      second_product<CV / 16>(acc_v, p_a, dt, G::PV, gi * 16, lo);   // dv += P^T . dmain
    }
  }

  store_acc(dk, acc_k, Cq, 0, boff, jw0, HW, g, t);
  store_acc(dv, acc_v, Cv, 0, boff, jw0, HW, g, t);
}

// --------------------------------------------------------- K3, streamed --
// One block per (BR columns j, batch, column tile z: CT columns of dk and of
// dv from CT z). A row chunk of TM rows takes nC ring steps as K2's key tile
// does: step c brings channels KCH c .. of the block's k and of the chunk's q
// (c < nQ) and of the block's [v | grid] and of the chunk's dmain (c < nV);
// the chunk's q and dmain rows of this column tile, its statistics and
// argmax arrive with its last chunk in a buffer outside the ring (nC >= ST).
template <int CT, int MT, int NW, int MINB, int ST>
__global__ void __launch_bounds__(32 * NW, MINB)
correlation_bwd_cols_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                   const bf16* __restrict__ dmain,
                                   const float* __restrict__ stats, const int* __restrict__ amax,
                                   float* __restrict__ dk, float* __restrict__ dv, int HW, int Cq,
                                   int Cv, int DM) {
  constexpr int NTM = 32 * NW, WR = 16 * MT, BR = WR * NW;
  constexpr int PR = CT + mt::PAD;
  constexpr int STAGE = (2 * BR + 2 * TM) * PCH;  // k, [v | grid] (own), q, dmain chunks
  static_assert(NTM >= TM, "one thread per row copies the statistics");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qr = reinterpret_cast<bf16*>(smem_raw);  // [TM][PR]  the chunk's q rows, this tile's columns
  bf16* dr = qr + TM * PR;                        // [TM][PR]  its dmain rows
  float4* srow = reinterpret_cast<float4*>(dr + TM * PR);  // [TM] statistics
  int* arow = reinterpret_cast<int*>(srow + TM);           // [TM] argmax
  bf16* ring = reinterpret_cast<bf16*>(arow + TM);

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * BR;
  const int z0 = blockIdx.z * CT;
  const bool has_k = z0 < Cq, has_v = z0 < Cv;
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

  const int nQ = (Cq + KCH - 1) / KCH, nV = (DM + KCH - 1) / KCH;
  const int nC = nQ > nV ? nQ : nV;
  const int nT = (HW + TM - 1) / TM;
  auto load_step = [&](int step) {
    if (step < nT * nC) {
      const int u = step / nC, c = step - u * nC;
      bf16* kt = ring + (step % ST) * STAGE;
      bf16* vt = kt + BR * PCH;
      bf16* qt = vt + BR * PCH;
      bf16* dt = qt + TM * PCH;
      const int i0 = u * TM, c0 = c * KCH;
      if (c < nQ) {
        mt::tile_copy_async_cols<BR, NTM, KCH / 8, true>(kt, PCH * 2, kb + c0, Cq * 2,
                                                         (Cq - c0) * 2, col0, HW, tid);
        mt::tile_copy_async_cols<TM, NTM, KCH / 8, true>(qt, PCH * 2, qb + c0, Cq * 2,
                                                         (Cq - c0) * 2, i0, HW, tid);
      }
      if (c < nV) {
        vg_chunk_async<BR, NTM>(vt, vb, grid, Cv, c0, col0, HW, tid);
        mt::tile_copy_async_cols<TM, NTM, KCH / 8, true>(dt, PCH * 2, dmb + c0, DM * 2,
                                                         (DM - c0) * 2, i0, HW, tid);
      }
      if (c == nC - 1) {
        if (has_k)
          mt::tile_copy_async_cols<TM, NTM, CT / 8, true>(qr, PR * 2, qb + z0, Cq * 2,
                                                          (Cq - z0) * 2, i0, HW, tid);
        if (has_v)
          mt::tile_copy_async_cols<TM, NTM, CT / 8, true>(dr, PR * 2, dmb + z0, DM * 2,
                                                          (Cv - z0) * 2, i0, HW, tid);
        if (tid < TM) {
          const int row = i0 + tid;
          const bool ok = row < HW;
          mt::cp_async_16(srow + tid, stb + 4 * static_cast<size_t>(ok ? row : 0), ok);
          mt::cp_async_4(arow + tid, amb + (ok ? row : 0), ok);
        }
      }
    }
    mt::cp_async_commit();
  };
  for (int step = 0; step < ST - 1; ++step) load_step(step);

  const int wr0 = warp * WR;
  const int jw0 = col0 + wr0;
  float acc_k[MT][CT / 8][4] = {}, acc_v[MT][CT / 8][4] = {};

  int step = 0;
  for (int u = 0; u < nT; ++u) {
    // s[m][n][e], dp[m][n][e]: column jw0 + 16 m + 8 (e >> 1) + g, chunk row
    // 8 n + 2t + (e & 1)
    float s[MT][TM / 8][4] = {}, dp[MT][TM / 8][4] = {};
    for (int c = 0; c < nC; ++c, ++step) {
      mt::cp_async_wait<ST - 2>();
      __syncthreads();
      load_step(step + ST - 1);
      const bf16* kt = ring + (step % ST) * STAGE;
      const bf16* vt = kt + BR * PCH;
      const bf16* qt = vt + BR * PCH;
      const bf16* dt = qt + TM * PCH;
      if (c < nQ) chunk_product(s, kt, wr0, qt, lo);
      if (c < nV) chunk_product(dp, vt, wr0, dt, lo);
    }
#pragma unroll
    for (int gi = 0; gi < TM / 16; ++gi) {
      float s16[MT][2][4], dp16[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s16[m][nt][e] = s[m][2 * gi + nt][e];
            dp16[m][nt][e] = dp[m][2 * gi + nt][e];
          }
      uint32_t p_a[MT][4], ds_a[MT][4];
      cols_terms(s16, dp16, srow, arow, gi * 16, jw0, WR, g, t, p_a, ds_a);
      if (has_k) second_product<CT / 16>(acc_k, ds_a, qr, PR, gi * 16, lo);  // dk += dS^T . q
      if (has_v) second_product<CT / 16>(acc_v, p_a, dr, PR, gi * 16, lo);   // dv += P^T . dmain
    }
  }

  if (has_k) store_acc(dk, acc_k, Cq, z0, boff, jw0, HW, g, t);
  if (has_v) store_acc(dv, acc_v, Cv, z0, boff, jw0, HW, g, t);
}

// ------------------------------------------------- launches, "mma" design --

struct MmaArgs {
  const bf16 *q, *k, *v, *grid;
  const float *out, *dout;
  bf16* dmain;
  float *stats, *dq, *dk, *dv;
  int* amax;
  int B, HW, Cq, Cv, DM;
  cudaStream_t stream;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ring steps a key tile (K2) or row chunk (K3) of the streamed kernels
int stream_steps(const MmaArgs& a) {
  const int nQ = ceil_div(a.Cq, KCH), nV = ceil_div(a.DM, KCH);
  return nQ > nV ? nQ : nV;
}

template <int CQ, int CV, int MT, int NW, int MINB, int ST, bool AREG>
cudaError_t launch_rows_mma(const MmaArgs& a) {
  using G = MmaGeo<CQ, CV>;
  constexpr int BR = 16 * MT * NW;
  if (a.Cq > CQ || a.Cv > CV) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_rows_mma_kernel<CQ, CV, MT, NW, MINB, ST, AREG>;
  const size_t smem = 16 * BR + sizeof(bf16) * (BR + ST * TM) * (G::PQ + G::PV);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(ceil_div(a.HW, BR), a.B), 32 * NW, smem, a.stream>>>(
      a.q, a.k, a.v, a.grid, a.out, a.dout, a.dmain, a.stats, a.dq, a.amax, a.HW, a.Cq, a.Cv,
      a.DM);
  return cudaGetLastError();
}

// The prologue kernel, then the streamed K2.
template <int CT, int MT, int NW, int MINB, int ST>
cudaError_t launch_rows_stream(const MmaArgs& a) {
  constexpr int BR = 16 * MT * NW;
  if (stream_steps(a) < ST) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_rows_stream_kernel<CT, MT, NW, MINB, ST>;
  const size_t smem = sizeof(bf16) * (TM * (CT + mt::PAD) + ST * (2 * TM + 2 * BR) * PCH);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int n_rows = a.B * a.HW;
  correlation_bwd_prologue_kernel<<<ceil_div(n_rows, 8), 256, 0, a.stream>>>(
      a.out, a.dout, a.dmain, a.stats, n_rows, a.Cv, a.DM);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kernel<<<dim3(ceil_div(a.HW, BR), a.B, ceil_div(a.Cq, CT)), 32 * NW, smem, a.stream>>>(
      a.q, a.k, a.v, a.grid, a.dmain, a.stats, a.dq, a.amax, a.HW, a.Cq, a.Cv, a.DM);
  return cudaGetLastError();
}

template <int CQ, int CV, int MT, int NW, int MINB, int ST, bool AREG>
cudaError_t launch_cols_mma(const MmaArgs& a) {
  using G = MmaGeo<CQ, CV>;
  constexpr int BR = 16 * MT * NW;
  if (a.Cq > CQ || a.Cv > CV) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_cols_mma_kernel<CQ, CV, MT, NW, MINB, ST, AREG>;
  const size_t smem = sizeof(bf16) * (BR + ST * TM) * (G::PQ + G::PV) + ST * TM * 20;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(ceil_div(a.HW, BR), a.B), 32 * NW, smem, a.stream>>>(
      a.q, a.k, a.v, a.grid, a.dmain, a.stats, a.amax, a.dk, a.dv, a.HW, a.Cq, a.Cv, a.DM);
  return cudaGetLastError();
}

template <int CT, int MT, int NW, int MINB, int ST>
cudaError_t launch_cols_stream(const MmaArgs& a) {
  constexpr int BR = 16 * MT * NW;
  if (stream_steps(a) < ST) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_cols_stream_kernel<CT, MT, NW, MINB, ST>;
  const size_t smem = sizeof(bf16) * (2 * TM * (CT + mt::PAD) + ST * (2 * BR + 2 * TM) * PCH) +
                      TM * 20;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = ceil_div(a.Cq > a.Cv ? a.Cq : a.Cv, CT);
  kernel<<<dim3(ceil_div(a.HW, BR), a.B, tiles), 32 * NW, smem, a.stream>>>(
      a.q, a.k, a.v, a.grid, a.dmain, a.stats, a.amax, a.dk, a.dv, a.HW, a.Cq, a.Cv, a.DM);
  return cudaGetLastError();
}

// The instantiations. Own tiles resident: channels padded up to (CQ, CV),
// then m-tiles a warp, warps a block, the least blocks a SM (which caps the
// registers a thread may take), ring stages, and whether the A fragments stay
// in registers. Streamed: column tiles of CT, m-tiles, warps, blocks a SM,
// stages. Chosen with tools/torch_chip_studies.py k23-mma-variants on an
// NVIDIA H100 80GB HBM3 at 700 W (ms; every variant gave the package's bits):
// - C=32, B=10 (B=90): K2 one m-tile with 8 warps and registers for 2 blocks
//   a SM, 0.395-0.419 (3.20-3.43), its prologue folded in with its loads in
//   flight; the prologue kernel apart 0.407 (3.31), a fold loading one row at
//   a time 0.419 against 0.407; three stages 0.421, two m-tiles with 4 warps
//   0.475 (3.17 with 3 blocks a SM, 3.12 with the prologue apart), 4 warps
//   with 3 stages 0.489, registers uncapped 0.405-0.419. K3 two
//   m-tiles with 4 warps 0.377-0.378 (3.01-3.06); 8 warps 0.375-0.377 (3.29-3.32),
//   one m-tile 0.471 (3.89), three stages 0.388, 3 blocks a SM 0.426.
// - C=128, B=10: K2 with its A fragments in registers (252 registers) 1.104-
//   1.170, from shared memory 1.567-1.613, streamed 2.16-3.34; K3 with them
//   in registers 1.445-1.450 (120 bytes spilled), from shared memory
//   1.818-1.939, streamed 2.74-7.03.
// - Cq 256 / Cv 96, B=10: own tiles resident in shared memory (198 KB, one
//   8-warp block a SM, the whole dq or [dk | dv] in registers: no column
//   tiles, so no score is summed twice) K2 2.165 (52 bytes spilled), K3 2.445
//   (264); streamed with column tiles of 128, 4.74 and 5.61; 4 warps 3.15 and
//   3.97; CV 128 2.27 (K2).
// - C=1,024 (streamed; the resident tiles would pass 227 KB), HW=20, B=10
//   on the device alone: 4 warps with 2 blocks a SM K2 0.0287-0.0294, K3
//   0.0234-0.0248 (the FMA few-rows pair on the same inputs 0.0415-0.0421
//   and 0.0380-0.0384, so the tensor cores serve HW <= 64 too); 2 warps
//   0.0363 / 0.0389, column tiles of 64 0.0324 / 0.0220-0.0225; HW=1,000: K2
//   2.53-2.56, with 8 warps 2.28-2.29 (4.99 at 256 / 96), K3 2.48-2.49.
cudaError_t dispatch_rows_mma(const MmaArgs& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_rows_mma<16, 16, 1, 8, 2, 2, true>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_rows_mma<16, 32, 1, 8, 2, 2, true>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_rows_mma<32, 32, 1, 8, 2, 2, true>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_rows_mma<64, 64, 1, 8, 1, 2, true>(a);
  if (a.Cq <= 128 && a.Cv <= 128) return launch_rows_mma<128, 128, 1, 8, 1, 2, true>(a);
  if (a.Cq <= 256 && a.Cv <= 96) return launch_rows_mma<256, 96, 1, 8, 1, 2, false>(a);
  return launch_rows_stream<128, 1, 4, 2, 2>(a);
}

cudaError_t dispatch_cols_mma(const MmaArgs& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_cols_mma<16, 16, 2, 4, 2, 2, true>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_cols_mma<16, 32, 2, 4, 2, 2, true>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_cols_mma<32, 32, 2, 4, 2, 2, true>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_cols_mma<64, 64, 1, 8, 1, 2, true>(a);
  if (a.Cq <= 128 && a.Cv <= 128) return launch_cols_mma<128, 128, 1, 8, 1, 2, true>(a);
  if (a.Cq <= 256 && a.Cv <= 96) return launch_cols_mma<256, 96, 1, 8, 1, 2, false>(a);
  return launch_cols_stream<128, 1, 4, 2, 2>(a);
}

bool mma_takes(int B, int HW, int Cq, int Cv, int dtype) {
  return !bad_shape(B, HW, Cq, Cv) && B <= 65535 && dtype == 1 && Cq % 8 == 0 && Cv % 8 == 0 &&
         Cv >= 8;
}

int dmain_width(int Cv) { return (Cv + 2 + 15) / 16 * 16; }

MmaArgs mma_args(const void* q, const void* k, const void* v, const void* grid, const void* out,
                 const void* dout, const void* dmain, const void* stats, const void* amax,
                 void* dq, void* dk, void* dv, int B, int HW, int Cq, int Cv, void* stream) {
  return MmaArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
                 static_cast<const float*>(out), static_cast<const float*>(dout),
                 const_cast<bf16*>(static_cast<const bf16*>(dmain)),
                 const_cast<float*>(static_cast<const float*>(stats)), static_cast<float*>(dq),
                 static_cast<float*>(dk), static_cast<float*>(dv),
                 const_cast<int*>(static_cast<const int*>(amax)), B, HW, Cq, Cv,
                 dmain_width(Cv), static_cast<cudaStream_t>(stream)};
}

}  // namespace

// The "mma" design (bf16, Cq and Cv multiples of 8, at any width; dtype must
// be 1; q, k, v, dmain, stats, dq, dk, dv aligned to 16 bytes, the grid to 4).

// K2: from q, k, v, grid and the forward's out and its cotangent dout
// (float32), dq [B, HW, Cq], dmain [B, HW, round_up(Cv + 2, 16)] bf16 (the
// cotangent of [warped | pos], zero-padded), stats [B, HW, 4] = (the log2 of
// the row's softmax normaliser, 1/d, c = dout . out, d_ms) and amax [B, HW]
// int32. Beyond 128 channels it launches the prologue kernel first.
extern "C" int correlation_bwd_rows_mma(const void* q, const void* k, const void* v,
                                        const void* grid, const void* out, const void* dout,
                                        void* dq, void* stats, void* amax, void* dmain, int B,
                                        int HW, int Cq, int Cv, int dtype, void* stream) {
  if (!mma_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  return dispatch_rows_mma(mma_args(q, k, v, grid, out, dout, dmain, stats, amax, dq, nullptr,
                                    nullptr, B, HW, Cq, Cv, stream));
}

// K3: dk [B, HW, Cq] and dv [B, HW, Cv] from q, k, v, grid and what K2 left.
extern "C" int correlation_bwd_cols_mma(const void* q, const void* k, const void* v,
                                        const void* grid, const void* dmain, const void* stats,
                                        const void* amax, void* dk, void* dv, int B, int HW,
                                        int Cq, int Cv, int dtype, void* stream) {
  if (!mma_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  return dispatch_cols_mma(mma_args(q, k, v, grid, nullptr, nullptr, dmain, stats, amax,
                                    nullptr, dk, dv, B, HW, Cq, Cv, stream));
}
