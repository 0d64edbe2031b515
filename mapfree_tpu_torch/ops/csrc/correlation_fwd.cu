// Fused correlation-volume softmax-warp, forward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel mapfree_tpu/ops/correlation.py::_kernel (reached
// from fused_correlation_warp's pallas_call). For each batch b and query
// row i it computes, without materialising the [HW, HW] score matrix,
//
//   s_ij  = q_i . k_j                       (f32 accumulation)
//   P_ij  = softmax_j(s_ij)                 (online, over key tiles)
//   out_i = [ sum_j P_ij [v_j | grid_j] ,  max_j P_ij ]
//
// with max_j P_ij = exp(s_max - m) / d = 1 / d, so the max-score channel is
// free. Output layout [B, HW, Cv + 3] float32: warped (Cv), soft-argmax
// position (2), max score (1). Inputs are row-major contiguous; q, k are
// [B, HW, Cq], v is [B, HW, Cv], grid is [HW, 2] in v's type; float32 or
// bfloat16.
//
// Bound at the 3d3d main path (B=64, HW=6,256, Cq=Cv=32, bf16):
//   q.k^T          2*B*HW^2*Cq      = 1.60e11 FLOP
//   P.[v|grid]     2*B*HW^2*(Cv+2)  = 1.70e11 FLOP
//   exponentials   B*HW^2           = 2.50e9
//   bytes          q, k, v read once + out written once ~= 0.13 GB
// At 989 TFLOP/s (bf16 tensor cores) the products take 0.33 ms; at 16
// exponentials per SM per clock (132 SMs, 1.98 GHz) the exponentials take
// 0.60 ms; the bytes take 0.04 ms at 3.35 TB/s. The work is bound by
// operations, not memory: both designs keep the [HW, HW] scores on chip
// (registers) and read each key/value tile once per block of query rows.
//
// Two designs live here, chosen by the caller (ops/correlation.py::
// forward_design), each complete for its inputs. Both walk the keys in tiles
// of TK = 64 (ops/correlation.py::FWD_KEY_TILE, which the plain version with
// the kernel's roundings takes as its tile) and keep the running max, the
// denominator and the accumulator in float32.
//
// "mma" (second half of this file): bf16 inputs, Cq and Cv multiples of 8, at
// any width. What it does about the bound:
// - Both products run on the tensor cores: mma.sync m16n8k16, bf16 operands,
//   float32 accumulators. A warp owns MT m-tiles of 16 query rows, which share
//   every B fragment they multiply with.
// - The 64-key tiles of k and of [v | grid | zeros] arrive bf16 in padded
//   shared-memory tiles (mma_tile.cuh) through a ring of cp.async stages: one
//   __syncthreads per stage, the next stages in flight while this one is
//   multiplied, each thread's share of a copy fixed at compile time. The
//   grid's two values per key come by a 4-byte copy into the two columns after
//   v's; the columns up to the next whole n-tile are zero.
// - Up to 128 q channels the block's q tile stays in shared memory and its A
//   fragments in registers for the whole key loop. Wider, q and k stream
//   through the ring in channel chunks of KC, the A fragments come from the
//   stage, and a key tile's [v | grid] arrives with its last chunk. Either
//   way a score sums its channels from 0 upwards, 16 at a time.
// - Beyond one column tile of v channels (120 up to 128 q channels, else
//   128) the accumulator is cut into column tiles, a grid dimension: every
//   column tile sums the same scores in the same order, so the row max and
//   the denominator agree to the bit, and tile 0 alone writes the max score.
// - Online softmax on the accumulator fragments: the row max over the 4 lanes
//   that share a row (two shfl_xor), P = ex2(s log2e - m) with the scale
//   folded into one FMA, the accumulator rescaled by ex2(m_old - m_new) only
//   in a warp where some row's max moved. The denominator is summed from the
//   float32 P, so 1/d stays a true softmax normaliser (K2 and K3 read it back
//   as the max score).
// - P never touches shared memory: two neighbouring S accumulator fragments
//   pack into one bf16 A fragment of P.[v | grid], whose B fragments come by
//   ldmatrix.trans. P is rounded to bf16 there (2^-9 relative), relative to the
//   row's running max after this tile; that is the design's one rounding.
// - Ragged edges: copies zero-fill rows and keys past HW (and, streamed,
//   channels past Cq); only the last key tile masks scores to -inf; rows past
//   HW are computed on zeros and not stored.
// - Epilogue: the block's rows go through shared memory as float32 rows of
//   its columns and 1/d, and leave as whole output rows in one contiguous,
//   coalesced stream where the block has every column, else row by row.
//
// "fma" (first half): float32 inputs, where exact float32 arithmetic is the
// point (no TF32), and the bf16 widths the other design does not take (not
// multiples of 8), at any Cq >= 1 and Cv >= 0. One block of 256 threads per
// (64-row query tile, batch, tile of at most 128 accumulator columns of
// [v | grid]). The block
// loops over all key tiles of 64 keys itself (the TPU's sequential key-chunk
// grid axis only existed to fit VMEM). Each key tile's scores are summed over
// channel chunks of at most QC = 128: the chunk of q (transposed; resident
// when Cq <= QC) and of k (transposed) are staged in shared memory as
// float32, so shared memory does not grow with the width (119 KB at most).
// The block's columns of the [v | grid] tile are staged beside them. Thread
// (ty, tx) owns rows 4ty..4ty+3 and, for the scores, columns 4tx..4tx+3 of the
// tile. Row maxima reduce over the 16 lanes of a half-warp with shuffles; the
// running max, the denominator (per-lane partial sums, reduced once at the
// end) and the [rows, 16 CPT] accumulator stay in float32 registers. The
// exponentials are exp2 of log2(e)-scaled scores. Arithmetic is scalar FMA on
// float32 tiles. Every column tile sums the same scores in the same order
// (channel 0 upwards, whatever the chunking), so the row max and the
// denominator agree bit for bit across column tiles; only column tile 0
// writes the max-score channel. Wider inputs cost one more recomputation of
// the scores per 128 columns: simple and right first. Masking: keys past HW
// score -1e30 (the ragged last key tile); rows past HW are computed on zero
// queries and not stored (the ragged row tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "mma_tile.cuh"

namespace {

constexpr int TM = 64;        // query rows per block
constexpr int TK = 64;        // keys per tile: ops/correlation.py::FWD_KEY_TILE
constexpr int NT = 256;       // threads: 16 row groups x 16 column lanes
constexpr int LD = TM + 4;    // padded row stride (floats) of qT, kT and P
constexpr int MAX_CPT = 8;    // accumulator columns per lane: 128 per column tile
constexpr int QC = 128;       // channels per chunk of the score product
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// dst[c * LD + r] = src[(row0 + r) * ld + c0 + c] for r < TM, c < C; rows past
// HW are zero.
template <typename T>
__device__ __forceinline__ void load_chunk_t(float* dst, const T* src, int row0, int HW,
                                             int c0, int C, int ld, int tid) {
  for (int e = tid; e < TM * C; e += NT) {
    const int r = e / C, c = e - r * C;
    const int row = row0 + r;
    dst[c * LD + r] = row < HW ? to_f(src[static_cast<size_t>(row) * ld + c0 + c]) : 0.f;
  }
}

// grid (x: 64-row query tile, y: batch, z: tile of 16 CPT columns of [v | grid])
template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
correlation_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ grid,
                       float* __restrict__ out, int HW, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  const int CvP = Cv + 2;
  const int CQC = Cq < QC ? Cq : QC;         // channels of a chunk
  const int n_chunks = (Cq + QC - 1) / QC;
  const int col0 = blockIdx.z * 16 * CPT;    // this block's columns of [v | grid]
  const int CW = CvP - col0 < 16 * CPT ? CvP - col0 : 16 * CPT;
  float* qT = smem;             // [CQC][LD]  query chunk, transposed
  float* kT = qT + CQC * LD;    // [CQC][LD]  key chunk, transposed
  float* vs = kT + CQC * LD;    // [TK][CW]   this block's columns of the [v | grid] tile
  float* ps = vs + TK * 16 * CPT;  // [TM][LD]  probabilities of this key tile

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;  // lane within the half-warp that shares those rows

  const T* qb = q + static_cast<size_t>(b) * HW * Cq;
  const T* kb = k + static_cast<size_t>(b) * HW * Cq;
  const T* vb = v + static_cast<size_t>(b) * HW * Cv;

  if (n_chunks == 1) load_chunk_t(qT, qb, row0, HW, 0, Cq, Cq, tid);  // resident

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  for (int key0 = 0; key0 < HW; key0 += TK) {
    // scores of rows 4ty.. against keys 4tx.. of this tile, chunk by chunk
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c0 = ch * QC;
      const int nc = Cq - c0 < QC ? Cq - c0 : QC;
      __syncthreads();  // the previous chunk (and tile's vs and ps) are consumed
      if (n_chunks > 1) load_chunk_t(qT, qb, row0, HW, c0, nc, Cq, tid);
      load_chunk_t(kT, kb, key0, HW, c0, nc, Cq, tid);
      if (ch == 0) {
        for (int e = tid; e < TK * CW; e += NT) {
          const int j = e / CW, c = col0 + e - j * CW;
          const int key = key0 + j;
          float x = 0.f;
          if (key < HW) {
            x = c < Cv ? to_f(vb[static_cast<size_t>(key) * Cv + c])
                       : to_f(grid[static_cast<size_t>(key) * 2 + (c - Cv)]);
          }
          vs[e] = x;
        }
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&qT[c * LD + 4 * ty]);
        const float4 bk = *reinterpret_cast<const float4*>(&kT[c * LD + 4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], bv[jj], s[i][jj]);
      }
    }

    // online softmax in the log2 domain; masked keys score NEG
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const bool valid = key0 + 4 * tx + jj < HW;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][jj] = valid ? s[i][jj] * LOG2E : NEG;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float4 p;
      p.x = exp2f(s[i][0] - m_new);
      p.y = exp2f(s[i][1] - m_new);
      p.z = exp2f(s[i][2] - m_new);
      p.w = exp2f(s[i][3] - m_new);
      l[i] = l[i] * alpha + ((p.x + p.y) + (p.z + p.w));
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= alpha;
      *reinterpret_cast<float4*>(&ps[(4 * ty + i) * LD + 4 * tx]) = p;
    }
    __syncthreads();

    // acc[rows, cols tx + 16 cc] += P[rows, tile] . [v | grid][tile, col0 + cols]
    for (int j = 0; j < TK; j += 4) {
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
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const int col = tx + 16 * cc;
          const float vv = col < CW ? vs[(j + jj) * CW + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pr[i][jj], vv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = row0 + 4 * ty + i;
    if (row < HW) {
      const float inv = 1.f / li;
      float* o = out + (static_cast<size_t>(b) * HW + row) * (CvP + 1);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = tx + 16 * cc;
        if (col < CW) o[col0 + col] = acc[i][cc] * inv;
      }
      if (tx == 0 && blockIdx.z == 0) o[CvP] = inv;
    }
  }
}

// shared memory of the "fma" design: the q and k chunks, the block's columns
// of the [v | grid] tile, P
size_t fma_smem(int Cq, int cpt) {
  const size_t cqc = Cq < QC ? Cq : QC;
  return sizeof(float) * (2 * cqc * LD + static_cast<size_t>(TK) * 16 * cpt +
                          static_cast<size_t>(TM) * LD);
}

template <typename T, int CPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* grid,
                   float* out, int B, int HW, int Cq, int Cv, cudaStream_t stream) {
  const size_t smem = fma_smem(Cq, CPT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_fwd_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int n_col_tiles = (Cv + 2 + 16 * CPT - 1) / (16 * CPT);
  const dim3 blocks((HW + TM - 1) / TM, B, n_col_tiles);
  correlation_fwd_kernel<T, CPT><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(grid), out, HW, Cq, Cv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cpt, const void* q, const void* k, const void* v,
                     const void* grid, float* out, int B, int HW, int Cq, int Cv,
                     cudaStream_t stream) {
  switch (cpt) {
    case 1: return launch<T, 1>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    case 2: return launch<T, 2>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    case 3: return launch<T, 3>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    case 4: return launch<T, 4>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    case 5: return launch<T, 5>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    case 6: return launch<T, 6>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    case 7: return launch<T, 7>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    case 8: return launch<T, 8>(q, k, v, grid, out, B, HW, Cq, Cv, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ============================================================ "mma" design ==

namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

// Sizes for q and k tiles of KC channels (a multiple of 16: all of Cq padded
// where q stays resident, a chunk of Cq where q and k stream) and a column
// tile of CT v channels (a multiple of 8). Tiles are bf16, row-major, with a
// pitch of an odd number of 16-byte slots, so that ldmatrix reads them
// without bank conflicts.
template <int KC, int CT>
struct FwdGeo {
  static constexpr int VG = CT + 8;          // [v | grid | zeros]: whole 8-column n-tiles
  static constexpr int PQ = KC + mt::PAD;    // pitch of the q and k tiles
  static constexpr int PV = (VG / 8) % 2 ? VG : VG + mt::PAD;  // pitch of the [v | grid] tile
  static constexpr int KQ = KC / 16;         // depth-16 steps of the score product
  static constexpr int NV = VG / 8;          // n-tiles of P . [v | grid]
};

// One block per (BR query rows, batch, column tile of CT v channels); warp w
// owns rows WR w .. WR w + WR - 1 as MT m-tiles of 16, and within a fragment
// a thread owns rows g and g + 8 (g = lane / 4) and, per 8-column n-tile,
// columns 2t and 2t + 1 (t = lane % 4). Without STREAM the block's q tile
// (Cq <= KC) stays in shared memory and its A fragments in registers, and a
// ring stage holds a key tile of k and of [v | grid]; with STREAM a stage
// holds one channel chunk of KC of the key tile's k and of the block's q,
// and the key tile's [v | grid] comes with its last chunk. ST stages.
template <int KC, int CT, bool STREAM, int MT, int NW, int MINB, int ST>
__global__ void __launch_bounds__(32 * NW, MINB)
correlation_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ grid,
                           float* __restrict__ out, int HW, int Cq, int Cv) {
  using G = FwdGeo<KC, CT>;
  constexpr int NTM = 32 * NW, WR = 16 * MT, BR = WR * NW;
  constexpr int STAGE = TK * (G::PQ + G::PV) + (STREAM ? BR * G::PQ : 0);
  static_assert(NTM >= TK, "one thread per key copies the grid");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BR][PQ]  resident query tile
  bf16* ring = qs + (STREAM ? 0 : BR * G::PQ);   // ST x ([TK][PQ] k, [TK][PV] v|grid, [BR][PQ] q)

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int col0 = blockIdx.z * CT;               // this block's v channels
  const int w = Cv - col0 < CT ? Cv - col0 : CT;  // how many
  const bool has_grid = col0 + w == Cv;           // the last tile: the grid at w, w + 1
  const int wo = w + (has_grid ? 2 : 0);          // its columns of the output
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const mt::LaneOffsets lo(lane);

  const size_t boff = static_cast<size_t>(b) * HW;
  const bf16* qb = q + boff * Cq;
  const bf16* kb = k + boff * Cq;
  const bf16* vb = v + boff * Cv + col0;

  // the padding columns are written once: no copy ever touches them (the
  // streamed chunks fill their own with zeros)
  if constexpr (!STREAM) mt::tile_zero_cols<BR, NTM>(qs, G::PQ, Cq, KC, tid);
  for (int st = 0; st < ST; ++st) {
    bf16* kt = ring + st * STAGE;
    if constexpr (!STREAM) mt::tile_zero_cols<TK, NTM>(kt, G::PQ, Cq, KC, tid);
    mt::tile_zero_cols<TK, NTM>(kt + TK * G::PQ, G::PV, wo, G::VG, tid);
  }

  const int nT = (HW + TK - 1) / TK;
  const int nC = STREAM ? (Cq + KC - 1) / KC : 1;  // channel chunks a key tile
  auto load_step = [&](int step) {
    if (step < nT * nC) {
      const int u = step / nC, c = step - u * nC;
      bf16* kt = ring + (step % ST) * STAGE;
      bf16* vt = kt + TK * G::PQ;
      const int key0 = u * TK;
      if constexpr (STREAM) {
        const int c0 = c * KC;
        mt::tile_copy_async_cols<TK, NTM, KC / 8, true>(kt, G::PQ * 2, kb + c0, Cq * 2,
                                                        (Cq - c0) * 2, key0, HW, tid);
        mt::tile_copy_async_cols<BR, NTM, KC / 8, true>(vt + TK * G::PV, G::PQ * 2, qb + c0,
                                                        Cq * 2, (Cq - c0) * 2, row0, HW, tid);
      } else {
        mt::tile_copy_async<TK, NTM, KC / 8>(kt, G::PQ * 2, kb, Cq * 2, key0, HW, tid);
      }
      if (c == nC - 1) {
        mt::tile_copy_async_cols<TK, NTM, CT / 8>(vt, G::PV * 2, vb, Cv * 2, w * 2, key0, HW,
                                                  tid);
        if (has_grid && tid < TK) {  // the grid's two values per key: columns w and w + 1
          const int key = key0 + tid;
          const bool ok = key < HW;
          mt::cp_async_4(vt + tid * G::PV + w, grid + 2 * (ok ? key : 0), ok);
        }
      }
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };

  // a resident query tile travels in the first group, with key tile 0
  if constexpr (!STREAM)
    mt::tile_copy_async<BR, NTM, KC / 8>(qs, G::PQ * 2, qb, Cq * 2, row0, HW, tid);
  for (int step = 0; step < ST - 1; ++step) load_step(step);

  // this thread's rows: m-tile m, half h -> row warp * WR + 16 m + 8 h + g
  uint32_t qa[MT][STREAM ? 1 : G::KQ][4];
  float acc[MT][G::NV][4] = {};
  float m_run[MT][2], l_run[MT][2];  // running max of s log2e; this lane's share of d
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[m][h] = -INFINITY;
      l_run[m][h] = 0.f;
    }

  int step = 0;
  for (int u = 0; u < nT; ++u) {
    // S = Q K^T over the tile's 64 keys, channel 0 upwards in every column
    // tile; each B fragment serves every m-tile
    float s[MT][TK / 8][4] = {};
    const bf16* kt = ring;
    for (int c = 0; c < nC; ++c, ++step) {
      mt::cp_async_wait<ST - 2>();
      __syncthreads();  // this step's tiles have landed for everyone; the last step's stage is free
      load_step(step + ST - 1);
      kt = ring + (step % ST) * STAGE;
      if constexpr (STREAM) {
        const bf16* qt = kt + TK * (G::PQ + G::PV);
#pragma unroll
        for (int ks = 0; ks < G::KQ; ++ks) {
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) mt::load_a(a[m], qt, G::PQ, warp * WR + 16 * m, ks * 16, lo);
#pragma unroll
          for (int kg = 0; kg < TK / 16; ++kg) {
            uint32_t bk[4];
            mt::load_b(bk, kt, G::PQ, kg * 16, ks * 16, lo);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mt::mma_bf16(s[m][2 * kg], a[m], bk[0], bk[1]);
              mt::mma_bf16(s[m][2 * kg + 1], a[m], bk[2], bk[3]);
            }
          }
        }
      } else {
        if (u == 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int ks = 0; ks < G::KQ; ++ks)
              mt::load_a(qa[m][ks], qs, G::PQ, warp * WR + 16 * m, ks * 16, lo);
        }
#pragma unroll
        for (int kg = 0; kg < TK / 16; ++kg)
#pragma unroll
          for (int ks = 0; ks < G::KQ; ++ks) {
            uint32_t bk[4];
            mt::load_b(bk, kt, G::PQ, kg * 16, ks * 16, lo);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mt::mma_bf16(s[m][2 * kg], qa[m][ks], bk[0], bk[1]);
              mt::mma_bf16(s[m][2 * kg + 1], qa[m][ks], bk[2], bk[3]);
            }
          }
      }
    }
    const bf16* vt = kt + TK * G::PQ;  // came with the tile's last chunk
    const int key0 = u * TK;

    // only the last tile has keys past HW (zero rows, whose score 0 must not count)
    if (key0 + TK > HW) {
      const int n_keys = HW - key0;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (nt * 8 + 2 * t + (e & 1) >= n_keys) s[m][nt][e] = -INFINITY;
    }

    // online softmax in the log2 domain: the row max over the 4 lanes of a row
    float alpha[MT][2];
    bool moved = false;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[m][nt][2 * h], s[m][nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[m][h], mx * LOG2E);
        moved |= m_new != m_run[m][h];
        alpha[m][h] = mt::ex2(m_run[m][h] - m_new);  // 0 on the first tile
        m_run[m][h] = m_new;
      }

    // P in float32 for the denominator, packed to bf16 A fragments of P . [v | grid]:
    // n-tiles 2 kg and 2 kg + 1 of S are the A fragment of keys 16 kg .. +16
    uint32_t pa[MT][TK / 16][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = mt::ex2(fmaf(s[m][nt][e], LOG2E, -m_run[m][e >> 1]));
        sum0 += p[0] + p[1];
        sum1 += p[2] + p[3];
        pa[m][nt >> 1][(nt & 1) * 2] = mt::pack_bf16(p[0], p[1]);
        pa[m][nt >> 1][(nt & 1) * 2 + 1] = mt::pack_bf16(p[2], p[3]);
      }
      l_run[m][0] = fmaf(l_run[m][0], alpha[m][0], sum0);
      l_run[m][1] = fmaf(l_run[m][1], alpha[m][1], sum1);
    }
    if (__any_sync(0xffffffffu, moved)) {  // after the first tiles, rarely
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < G::NV; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] *= alpha[m][e >> 1];
    }

    // acc += P . [v | grid]; each B fragment serves every m-tile
#pragma unroll
    for (int kg = 0; kg < TK / 16; ++kg) {
#pragma unroll
      for (int np = 0; np < G::NV / 2; ++np) {
        uint32_t bv[4];
        mt::load_b_trans(bv, vt, G::PV, kg * 16, np * 16, lo);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mt::mma_bf16(acc[m][2 * np], pa[m][kg], bv[0], bv[1]);
          mt::mma_bf16(acc[m][2 * np + 1], pa[m][kg], bv[2], bv[3]);
        }
      }
      if constexpr (G::NV % 2 == 1) {
        uint32_t bv[2];
        mt::load_b_trans_x2(bv, vt, G::PV, kg * 16, (G::NV - 1) * 8, lo);
#pragma unroll
        for (int m = 0; m < MT; ++m) mt::mma_bf16(acc[m][G::NV - 1], pa[m][kg], bv[0], bv[1]);
      }
    }
  }

  // epilogue: the ring becomes the block's [BR, wo + 1] float32 output tile
  // (its columns, then 1 / d), which leaves as whole rows of the output where
  // the block has them all, else row by row; only column tile 0 writes the
  // max score
  mt::cp_async_wait<0>();
  __syncthreads();
  float* ot = reinterpret_cast<float*>(ring);
  const int E = wo + 1;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d = l_run[m][h];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const float inv = 1.f / d;
      float* o = ot + (warp * WR + 16 * m + 8 * h + g) * E;
#pragma unroll
      for (int n = 0; n < G::NV; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < wo) {  // wo is even: both columns or neither
          o[col] = acc[m][n][2 * h] * inv;
          o[col + 1] = acc[m][n][2 * h + 1] * inv;
        }
      }
      if (t == 0) o[wo] = inv;  // the max score: max_j P_ij = 1 / d
    }
  __syncthreads();
  const int CO = Cv + 3;
  const int rows = HW - row0 < BR ? HW - row0 : BR;
  float* dst = out + (boff + row0) * CO;
  if (E == CO) {
    for (int i = tid; i < rows * CO; i += NTM) dst[i] = ot[i];
  } else {
    for (int i = tid; i < rows * E; i += NTM) {
      const int r = i / E, c = i - r * E;
      if (c < wo)
        dst[r * CO + col0 + c] = ot[i];
      else if (blockIdx.z == 0)
        dst[r * CO + Cv + 2] = ot[i];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct MmaArgs {
  const bf16 *q, *k, *v, *grid;
  float* out;
  int B, HW, Cq, Cv;
  cudaStream_t stream;
};

template <int KC, int CT, bool STREAM, int MT, int NW, int MINB, int ST>
cudaError_t launch_mma(const MmaArgs& a) {
  using G = FwdGeo<KC, CT>;
  constexpr int BR = 16 * MT * NW;
  auto kernel = correlation_fwd_mma_kernel<KC, CT, STREAM, MT, NW, MINB, ST>;
  const size_t stage = TK * (G::PQ + G::PV) + (STREAM ? BR * G::PQ : 0);
  const size_t ring = sizeof(bf16) * ST * stage;
  const size_t tile = sizeof(float) * BR * (CT + 3);  // the epilogue's, in the ring's place
  const size_t smem = sizeof(bf16) * (STREAM ? 0 : BR * G::PQ) + (ring > tile ? ring : tile);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 blocks((a.HW + BR - 1) / BR, a.B, (a.Cv + CT - 1) / CT);
  kernel<<<blocks, 32 * NW, smem, a.stream>>>(a.q, a.k, a.v, a.grid, a.out, a.HW, a.Cq, a.Cv);
  return cudaGetLastError();
}

// The instantiations: q channels a tile (all of Cq, or a chunk where q
// streams), v channels a column tile, whether q streams; then m-tiles a
// warp, warps a block, the least blocks a SM should hold (which caps the
// registers a thread may take) and the ring's stages.
//
// Up to 32 channels a block owns 128 rows as 4 warps of two m-tiles that
// share every B fragment, with registers for 3 blocks a SM: at B=10,
// HW=6,256 that is 490 blocks on 396 slots, at B=64 3,136 blocks. Timed on
// an H100 against this choice, a cap for 4 blocks a SM (128 registers,
// spilling), 2 blocks, one m-tile a warp with 4 or 8 warps, two m-tiles with
// 8 warps, and a ring of two stages were all slower.
//
// At 128 q channels and 121 to 128 v channels (a 128-channel ResUNet: Cv + 2
// = 130, 17 n-tiles) a block owns 64 rows as 4 warps of one m-tile, q
// resident, with a ring of two stages: 87 KB of shared memory, so 2 blocks a
// SM, 8 warps. On an H100 80GB HBM3 at 700 W (tools/torch_chip_studies.py
// k1-variants) it took 0.802 ms at B=10 and 4.73 ms at B=64 on the 3d3d
// grid, against 0.835 and 4.84 for 128 rows as 8 warps with three stages
// (139 KB, 1 block a SM), 0.832 for those with two stages, 1.209 for 64
// rows with three stages (1 block a SM, 4 warps), and 1.020 and 1.234 for q
// streamed in chunks of 64 (4 and 8 warps). No instantiation spills.
//
// Wider than 128 q channels, q and k stream through the ring in chunks of
// KC, and the accumulator is cut into column tiles of 128 v channels, a grid
// dimension: every column tile sums the same scores in the same order, so
// the row max and the denominator agree to the bit and tile 0 alone writes
// the max score. The other way to hold a wide accumulator, every column of a
// few rows in one block with the warps splitting the columns, needs P and
// the row statistics passed between the warps through shared memory with a
// barrier at every key tile; recomputing the scores costs Cq / (Cq + 128)
// of a column tile's products instead, and nothing at the ResNet
// bottleneck's HW = 20, which is bound by bytes. So the column tiles won
// without that design being built. On the same card: at 1,024 channels on
// the 5x4 grid (B=64) 32 rows as 2 warps with chunks of 64 and three
// stages took 0.0310 ms a launch, 64 rows as 4 warps 0.0333, chunks of 128
// 0.0529, chunks of 32 (4 stages) 0.0365, four stages 0.0549; at Cq = 256,
// Cv = 96 on the 3d3d grid (B=10) 64 rows as 4 warps 1.603 ms, 128 rows as
// 8 warps 1.888, chunks of 128 2.218, chunks of 32 1.852.
cudaError_t dispatch_mma(const MmaArgs& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_mma<16, 16, false, 2, 4, 3, 3>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_mma<16, 32, false, 2, 4, 3, 3>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_mma<32, 32, false, 2, 4, 3, 3>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_mma<64, 64, false, 1, 8, 2, 3>(a);
  if (a.Cq <= 128 && a.Cv <= 120) return launch_mma<128, 120, false, 1, 8, 1, 3>(a);
  if (a.Cq <= 128) return launch_mma<128, 128, false, 1, 4, 2, 2>(a);
  if (a.HW <= 32) return launch_mma<64, 128, true, 1, 2, 2, 3>(a);
  return launch_mma<64, 128, true, 1, 4, 2, 3>(a);
}

bool mma_takes(int B, int HW, int Cq, int Cv, int dtype) {
  return B >= 0 && B <= 65535 && HW >= 0 && dtype == 1 && Cq % 8 == 0 && Cv % 8 == 0 &&
         Cq >= 8 && Cv >= 8;
}

}  // namespace

// The "mma" design: bf16 (dtype 1), Cq and Cv multiples of 8, at any width;
// q, k, v aligned to 16 bytes, the grid to 4. Same arguments and output as
// correlation_fwd. Returns a cudaError_t (0 on success), cudaErrorInvalidValue
// for inputs the design does not take.
extern "C" int correlation_fwd_mma(const void* q, const void* k, const void* v,
                                   const void* grid, void* out, int B, int HW, int Cq,
                                   int Cv, int dtype, void* stream) {
  if (!mma_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
                  static_cast<float*>(out), B, HW, Cq, Cv, static_cast<cudaStream_t>(stream)};
  return dispatch_mma(a);
}

// The "fma" design, at any Cq >= 1 and Cv >= 0. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int correlation_fwd(const void* q, const void* k, const void* v,
                               const void* grid, void* out, int B, int HW, int Cq,
                               int Cv, int dtype, void* stream) {
  if (B <= 0 || HW <= 0) return cudaSuccess;
  if (Cq <= 0 || Cv < 0) return cudaErrorInvalidValue;
  // columns per lane: as many as Cv + 2 needs, at most MAX_CPT (then the
  // grid's third dimension takes the rest, 128 columns a tile)
  const int need = (Cv + 2 + 15) / 16;
  const int cpt = need < MAX_CPT ? need : MAX_CPT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return dispatch<float>(cpt, q, k, v, grid, o, B, HW, Cq, Cv, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(cpt, q, k, v, grid, o, B, HW, Cq, Cv, s);
  return cudaErrorInvalidValue;
}
