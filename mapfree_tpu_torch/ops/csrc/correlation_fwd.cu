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
// Two designs live here, chosen by the caller (ops/correlation.py::
// forward_design), each complete for its inputs. Both keep the running max,
// the denominator and the accumulator in float32, use no atomics and sum in
// fixed orders, so two runs give the same bits.
//
// "fma" (first half): float32 inputs, where exact float32 arithmetic is the
// point (no TF32), and the bf16 widths the other design does not take (not
// multiples of 8; loaded and widened to float32), at any Cq >= 1 and Cv >= 0.
// Its bound is the FP32 FMA rate, 67 TFLOP/s (132 SMs x 128 lanes x 2 FLOP
// x 1.98 GHz): a score costs Cq + Cv + 2 FMAs and one exponential, so at the
// 3d3d grid (HW = 6,256, Cq = Cv = 32) the 3.3e11 FLOP take 4.935 ms at B=64
// and about 0.77 ms at B=10. The exponentials run on the special-function
// units at 1/8 of the FMA rate, beside the FMAs; every other instruction
// (shared-memory loads, shuffles) takes an FMA's issue slot. At the ResNet
// bottleneck (HW = 20, Cq = Cv = 1,024, B = 64) the bound is bytes: some
// 21 MB read and written, 0.0063 ms at 3.35 TB/s. dispatch_fma picks one of
// two kernels by shape:
//
// - Long rows (HW > SHORT_HW), correlation_fwd_rows_kernel: a block of 256
//   threads owns BM = 64 RH query rows and walks the keys in tiles of BN =
//   64 KH. Thread (ty, tx) = (tid / 16, tid % 16) owns rows 64 h + 4 ty + r
//   and keys 64 h + 4 tx + k (r, k < 4): a register tile of 4 RH x 4 KH
//   scores (8 x 8), whose operands are float4 reads of q^T and k^T tiles in
//   shared memory, 2 (RH + KH) reads for 16 RH KH FMAs a channel, each read
//   by a phase of eight lanes either one broadcast or eight consecutive
//   16-byte pieces (no bank conflict).
//   k^T arrives in chunks of KC channels (and q^T with it beyond KC
//   channels; up to KC q^T stays resident), a key tile's v columns and grid
//   with its last chunk, through a ring of ST stages of 4-byte cp.async
//   copies issued a stage ahead: the copies transpose as they go (a warp
//   copies 8 channels of 4 rows, 32-byte pieces of global memory into 32
//   distinct banks, the pitches being 4 mod 32 floats), with no division in
//   the loop; a tile takes two barriers, the ring's and P's.
//   Online softmax in registers, P = 2^(s log2e - m) with the scale folded
//   into one FMA, each lane's share of the denominator and of the grid's
//   two columns (the soft-argmax position) summed over its own keys. The
//   rows' reference m moves lazily: each lane keeps its largest score, and
//   only a tile where some lane's score passes m by more than LAZY_GAP (P up
//   to 2^8) takes the max over the 16 lanes that share the rows (four
//   shuffles) and rescales the sums by 2^(m_old - m_new); after the first
//   tiles one vote a tile stands for the shuffles. The max score is
//   2^(s_max log2e - m) / d, s_max taken over the lanes at the end.
//   P goes once through a [BM][BN + 4] tile (float4 stores, conflict-free),
//   and P . v is a second register tile: the 16 lanes of a row group split
//   the CT = 4 CX v columns into CX groups of 4 and the keys into 16 / CX
//   slices, 4 RH rows x 4 columns a lane (12 float4 reads for 128 FMAs at
//   RH = 2), the slices added in a fixed butterfly order at the end; no
//   column is padded beyond a whole 4. Beyond CT v columns the accumulator
//   is cut into column tiles of CT, a grid dimension: every column tile sums
//   the same scores in the same order, so the row max and the denominator
//   agree to the bit, and tile 0 alone writes the position and the max
//   score.
// - Few rows (HW <= SHORT_HW), correlation_fwd_short_kernel: a block owns
//   one batch element and a tile of [v | grid] columns, one a thread, at its
//   real HW (a 5x4 grid is not padded to 64 rows), and dispatch_fma cuts the
//   columns into enough tiles to fill the card. q and k arrive in chunks of
//   SKC channels (16-byte copies where the rows allow, else 4-byte ones)
//   through a ring of ST stages, and the block's [v | grid] columns into the
//   stage the last chunk frees, so they land while the scores are summed.
//   The HW x HW scores are summed once, TS x TS a thread, each in one chain
//   of FMAs from channel 0 upwards (the order of the long-rows kernel and of
//   a float32 matrix product: at 1,024 unscaled channels another order, a
//   sum split over groups of channels, changes a score's round-off by some
//   sqrt(1,024) ulps, about 1e-4 at scores near 100, and a peaked row's
//   output by as much). One warp a row then takes the max and
//   the denominator over all keys at once by shuffles and writes P
//   key-major, and each thread sums P . [v | grid] for its column over every
//   row.
// Both: rows past HW are computed on zeros and not stored; keys past HW
// score -inf (the copies fill zeros past HW and past Cq).
//
// "mma" (second half of this file): bf16 inputs, Cq and Cv multiples of 8, at
// any width. Bound at the 3d3d main path (B=64, HW=6,256, Cq=Cv=32, bf16):
//   q.k^T          2*B*HW^2*Cq      = 1.60e11 FLOP
//   P.[v|grid]     2*B*HW^2*(Cv+2)  = 1.70e11 FLOP
//   exponentials   B*HW^2           = 2.50e9
//   bytes          q, k, v read once + out written once ~= 0.13 GB
// At 989 TFLOP/s (bf16 tensor cores) the products take 0.33 ms; at 16
// exponentials per SM per clock (132 SMs, 1.98 GHz) the exponentials take
// 0.60 ms; the bytes take 0.04 ms at 3.35 TB/s. The work is bound by
// operations, not memory: the [HW, HW] scores stay on chip (registers) and
// each key/value tile is read once per block of query rows. It walks the
// keys in tiles of TK = 64 (ops/correlation.py::FWD_KEY_TILE, which the
// plain version with the kernel's roundings takes as its tile). It has two
// kernels, which give the same bits; ops/correlation.py::forward_kernel
// picks: the wgmma kernel at the end of this file (Hopper's warpgroup
// products and TMA copies, its design described there) beyond 64 positions
// with Cq up to 256, and the mma.sync kernel below for the few-rows grids
// (the ResNet encoder's 5x4) and wider q. What the mma.sync kernel does
// about the bound:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

constexpr int TK = 64;        // keys per tile of the "mma" design: ops/correlation.py::FWD_KEY_TILE
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ============================================================ "fma" design ==

constexpr int NT = 256;        // threads a block, both kernels
constexpr int SHORT_HW = 64;   // the few-rows kernel takes HW up to this
constexpr int SKC = 128;       // its channels a chunk
constexpr int SPQ = SKC + 4;   // the pitch of its q and k chunks (floats)
constexpr float LAZY_GAP = 8.f;  // log2 of how far P may exceed 1 before a row's reference moves

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

// dst[c][r] (pitch P floats, P = 4 mod 32) = src[(row0 + r) * ld + c0 + c]
// for r < R, c < KC; zeros for rows at or past n_rows and channels at or
// past n_cols. A warp copies 8 channels of 4 rows at a time: 32-byte pieces
// of 4 rows of global memory, 32 distinct banks of shared memory.
template <int R, int KC, typename T>
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

// dst[j][c] (pitch CT) = vb[(key0 + j) * Cv + col0 + c] for j < BN, c < CT;
// zeros past HW and past Cv (read from the always-mapped grid).
template <int BN, int CT, typename T>
__device__ __forceinline__ void copy_v(float* dst, const T* vb, const T* grid, int Cv, int col0,
                                       int key0, int HW, int tid) {
  static_assert(BN * CT % NT == 0 && (CT & (CT - 1)) == 0, "whole rounds, CT a power of 2");
#pragma unroll
  for (int e0 = 0; e0 < BN * CT; e0 += NT) {
    const int e = e0 + tid;
    const int j = e / CT, c = e % CT;
    const bool ok = key0 + j < HW && col0 + c < Cv;
    put(dst + e, ok ? vb + static_cast<size_t>(key0 + j) * Cv + col0 + c : grid, ok);
  }
}

// dst[d][j] = grid[(key0 + j) * 2 + d] for j < BN, d < 2; zeros past HW.
template <int BN, typename T>
__device__ __forceinline__ void copy_grid(float* dst, const T* grid, int key0, int HW, int tid) {
#pragma unroll
  for (int e0 = 0; e0 < 2 * BN; e0 += NT) {
    const int e = e0 + tid;
    const int j = e >> 1, d = e & 1;
    if (e < 2 * BN) {
      const bool ok = key0 + j < HW;
      put(dst + d * BN + j, ok ? grid + static_cast<size_t>(key0 + j) * 2 + d : grid, ok);
    }
  }
}

template <int RH, int KH, int CX>
struct RowsGeo {
  static constexpr int RG = 64;                   // rows a half: 16 row groups of 4
  static constexpr int BM = RG * RH;              // query rows a block
  static constexpr int BN = 64 * KH;              // keys a tile
  static constexpr int PQ = BM + 4;               // pitch of q^T (4 mod 32)
  static constexpr int PK = BN + 4;               // pitch of k^T and of P (4 mod 32)
  static constexpr int CT = 4 * CX;               // v columns a column tile
  static constexpr int KX = 16 / CX;              // key slices of P . v
  static constexpr int KS = BN / KX;              // keys a slice
  static constexpr int RT = 4 * RH, KT = 4 * KH;  // rows and keys a thread
  static_assert(16 % CX == 0 && KS % 4 == 0, "the 16 lanes of a row group split evenly");
  static_assert(PQ % 32 == 4 && PK % 32 == 4, "conflict-free transposing copies");
};

// One block per (BM query rows, batch, column tile of CT v columns). KC:
// channels a k^T chunk; STREAM: q^T comes through the ring with each chunk
// (else it stays resident, Cq <= KC); ST ring stages; MINB blocks a SM.
template <typename T, int KC, bool STREAM, int CX, int RH, int KH, int ST, int MINB>
__global__ void __launch_bounds__(NT, MINB)
correlation_fwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ grid,
                            float* __restrict__ out, int HW, int Cq, int Cv) {
  using G = RowsGeo<RH, KH, CX>;
  constexpr int KQ = STREAM ? KC * G::PQ : 0;  // a stage's q^T chunk
  constexpr int STAGE = KC * G::PK + KQ + G::BN * G::CT + 2 * G::BN;
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                                // [BM][PK]  P of this key tile
  float* qres = ps + G::BM * G::PK;                // [KC][PQ]  resident q^T
  float* ring = qres + (STREAM ? 0 : KC * G::PQ);  // ST x (k^T, q^T, v, grid)

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * G::BM;
  const int col0 = blockIdx.z * G::CT;  // this block's v columns
  const bool tile0 = blockIdx.z == 0;   // it writes the position and the max score
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kx = tx / CX, cx = tx % CX;  // P . v: key slice, group of 4 columns

  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const T* vb = v + boff * Cv;

  const int nT = (HW + G::BN - 1) / G::BN;
  const int nC = STREAM ? (Cq + KC - 1) / KC : 1;  // chunks a key tile
  auto load_step = [&](int step) {
    if (step < nT * nC) {
      const int u = step / nC, c = step - u * nC;
      float* kt = ring + (step % ST) * STAGE;
      float* vt = kt + KC * G::PK + KQ;
      copy_t<G::BN, KC>(kt, G::PK, kb, Cq, u * G::BN, HW, c * KC, Cq, tid);
      if constexpr (STREAM)
        copy_t<G::BM, KC>(kt + KC * G::PK, G::PQ, qb, Cq, row0, HW, c * KC, Cq, tid);
      if (c == nC - 1) {
        copy_v<G::BN, G::CT>(vt, vb, grid, Cv, col0, u * G::BN, HW, tid);
        if (tile0) copy_grid<G::BN>(vt + G::BN * G::CT, grid, u * G::BN, HW, tid);
      }
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };
  // a resident q^T travels in the first group, with key tile 0
  if constexpr (!STREAM) copy_t<G::BM, KC>(qres, G::PQ, qb, Cq, row0, HW, 0, Cq, tid);
  for (int step = 0; step < ST - 1; ++step) load_step(step);

  // row i of this thread: RG (i / 4) + 4 ty + i % 4; running max of s log2e,
  // this lane's shares of the denominator and the position, and of P . v
  float m[G::RT], top[G::RT], l[G::RT], px[G::RT], py[G::RT], acc[G::RT][4];
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    m[i] = top[i] = -INFINITY;
    l[i] = px[i] = py[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  int step = 0;
  for (int u = 0; u < nT; ++u) {
    // S = Q K^T over the tile's keys, channel 0 upwards in every column tile
    float s[G::RT][G::KT];
#pragma unroll
    for (int i = 0; i < G::RT; ++i)
#pragma unroll
      for (int j = 0; j < G::KT; ++j) s[i][j] = 0.f;
    const float* st = ring;
    for (int c = 0; c < nC; ++c, ++step) {
      mt::cp_async_wait<ST - 2>();
      __syncthreads();  // this step's stage has landed for all; the last step's is free
      load_step(step + ST - 1);
      st = ring + (step % ST) * STAGE;
      const float* kt = st;
      const float* qt = STREAM ? st + KC * G::PK : qres;
#pragma unroll 8
      for (int cc = 0; cc < KC; ++cc) {
        float a[G::RT], bk[G::KT];
#pragma unroll
        for (int h = 0; h < RH; ++h) {
          const float4 t = *reinterpret_cast<const float4*>(qt + cc * G::PQ + G::RG * h + 4 * ty);
          a[4 * h] = t.x;
          a[4 * h + 1] = t.y;
          a[4 * h + 2] = t.z;
          a[4 * h + 3] = t.w;
        }
#pragma unroll
        for (int h = 0; h < KH; ++h) {
          const float4 t = *reinterpret_cast<const float4*>(kt + cc * G::PK + 64 * h + 4 * tx);
          bk[4 * h] = t.x;
          bk[4 * h + 1] = t.y;
          bk[4 * h + 2] = t.z;
          bk[4 * h + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < G::RT; ++i)
#pragma unroll
          for (int j = 0; j < G::KT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
    }
    const float* vt = st + KC * G::PK + KQ;  // came with the tile's last chunk
    const float* gt = vt + G::BN * G::CT;
    const int key0 = u * G::BN;

    // only the last tile has keys past HW (zero rows, whose score 0 must not count)
    if (key0 + G::BN > HW) {
#pragma unroll
      for (int j = 0; j < G::KT; ++j)
        if (key0 + 64 * (j / 4) + 4 * tx + j % 4 >= HW)
#pragma unroll
          for (int i = 0; i < G::RT; ++i) s[i][j] = -INFINITY;
    }
    float gx[G::KT], gy[G::KT];
#pragma unroll
    for (int h = 0; h < KH; ++h) {
      const float4 x = tile0 ? *reinterpret_cast<const float4*>(gt + 64 * h + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 y = tile0 ? *reinterpret_cast<const float4*>(gt + G::BN + 64 * h + 4 * tx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      gx[4 * h] = x.x;
      gx[4 * h + 1] = x.y;
      gx[4 * h + 2] = x.z;
      gx[4 * h + 3] = x.w;
      gy[4 * h] = y.x;
      gy[4 * h + 1] = y.y;
      gy[4 * h + 2] = y.z;
      gy[4 * h + 3] = y.w;
    }

    // online softmax in the log2 domain, row by row; P into the shared tile.
    // Each lane keeps the largest score it has seen; the rows' common
    // reference m moves only where a lane's max passes it by more than
    // LAZY_GAP (2^8 in P): one vote a tile, the shuffles only then
    float tile_mx[G::RT];
    bool renew = false;
#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < G::KT; ++j) mx = fmaxf(mx, s[i][j]);
      tile_mx[i] = mx;
      top[i] = fmaxf(top[i], mx);
      renew |= mx * LOG2E > m[i] + LAZY_GAP;
    }
    if (__any_sync(FULL, renew)) {
#pragma unroll
      for (int i = 0; i < G::RT; ++i) {
        float mx = tile_mx[i];
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[i], mx * LOG2E);
        const float alpha = mt::ex2(m[i] - m_new);  // 0 on the first tile
        m[i] = m_new;
        if (alpha != 1.f) {  // the row's reference moved
          l[i] *= alpha;
          px[i] *= alpha;
          py[i] *= alpha;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G::RT; ++i) {
      float p[G::KT], sum = 0.f;
#pragma unroll
      for (int j = 0; j < G::KT; ++j) {
        p[j] = mt::ex2(fmaf(s[i][j], LOG2E, -m[i]));
        sum += p[j];
      }
      l[i] += sum;
      if (tile0) {
        float sx = 0.f, sy = 0.f;
#pragma unroll
        for (int j = 0; j < G::KT; ++j) {
          sx = fmaf(p[j], gx[j], sx);
          sy = fmaf(p[j], gy[j], sy);
        }
        px[i] += sx;
        py[i] += sy;
      }
      float* prow = ps + (G::RG * (i / 4) + 4 * ty + i % 4) * G::PK + 4 * tx;
#pragma unroll
      for (int h = 0; h < KH; ++h)
        *reinterpret_cast<float4*>(prow + 64 * h) =
            make_float4(p[4 * h], p[4 * h + 1], p[4 * h + 2], p[4 * h + 3]);
    }
    __syncthreads();  // the tile's P is whole

    // acc[rows][4 columns] += P[rows][slice kx] . v[slice kx][4 cx .. 4 cx + 3]
    const float* pk = ps + 4 * ty * G::PK + kx * G::KS;
    const float* vk = vt + kx * G::KS * G::CT + 4 * cx;
#pragma unroll 4
    for (int j = 0; j < G::KS; j += 4) {
      float4 pr[G::RT];
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
        pr[i] = *reinterpret_cast<const float4*>(pk + (G::RG * (i / 4) + i % 4) * G::PK + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 vv = *reinterpret_cast<const float4*>(vk + (j + e) * G::CT);
#pragma unroll
        for (int i = 0; i < G::RT; ++i) {
          const float pe = e == 0 ? pr[i].x : e == 1 ? pr[i].y : e == 2 ? pr[i].z : pr[i].w;
          acc[i][0] = fmaf(pe, vv.x, acc[i][0]);
          acc[i][1] = fmaf(pe, vv.y, acc[i][1]);
          acc[i][2] = fmaf(pe, vv.z, acc[i][2]);
          acc[i][3] = fmaf(pe, vv.w, acc[i][3]);
        }
      }
    }
  }

  // the 16 lanes of a row group add their shares (a fixed butterfly), then
  // the key slices of P . v; only column tile 0 writes the position and 1/d
  const int CO = Cv + 3;
#pragma unroll
  for (int i = 0; i < G::RT; ++i) {
    float d = l[i], sx = px[i], sy = py[i], mx = top[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      d += __shfl_xor_sync(FULL, d, off);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    }
    if (tile0) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        sx += __shfl_xor_sync(FULL, sx, off);
        sy += __shfl_xor_sync(FULL, sy, off);
      }
    }
#pragma unroll
    for (int off = CX; off < 16; off <<= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += __shfl_xor_sync(FULL, acc[i][e], off);
    const float inv = 1.f / d;
    const int row = row0 + G::RG * (i / 4) + 4 * ty + i % 4;
    if (row < HW) {
      float* o = out + (boff + row) * CO;
      if (kx == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + 4 * cx + e;
          if (col < Cv) o[col] = acc[i][e] * inv;
        }
      }
      if (tile0 && tx == 0) {
        o[Cv] = sx * inv;
        o[Cv + 1] = sy * inv;
        o[Cv + 2] = mt::ex2(fmaf(mx, LOG2E, -m[i])) * inv;  // the max score, max_j P_ij
      }
    }
  }
}

// The few-rows kernel's shared memory in floats for HW rows (HWP = HW
// rounded up to 4) and ST stages: the ring of q and k chunks (one stage takes
// the [v | grid] tile after the last chunk), the scores, P, 1 / d.
__host__ __device__ inline size_t short_floats(int HW, int ST) {
  const size_t HWP = (HW + 3) / 4 * 4;
  return 2 * ST * HWP * SPQ + 2 * HWP * HWP + HWP;
}

// Rows [0, HWP) x channels [c0, c0 + SKC) of a [HW, Cq] array into a [HWP][SPQ]
// chunk; zeros past HW and past Cq. 16-byte copies where vec (float32, every
// row 16-byte aligned).
template <typename T>
__device__ __forceinline__ void copy_rows(float* dst, const T* src, int HW, int HWP, int Cq,
                                          int c0, bool vec, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int e = tid; e < HWP * (SKC / 4); e += NT) {
        const int r = e / (SKC / 4), c = 4 * (e % (SKC / 4));
        const bool ok = r < HW && c0 + c < Cq;
        mt::cp_async_16(dst + r * SPQ + c, ok ? src + static_cast<size_t>(r) * Cq + c0 + c : src,
                        ok);
      }
      return;
    }
  }
  for (int e = tid; e < HWP * SKC; e += NT) {
    const int r = e / SKC, c = e % SKC;
    const bool ok = r < HW && c0 + c < Cq;
    put(dst + r * SPQ + c, ok ? src + static_cast<size_t>(r) * Cq + c0 + c : src, ok);
  }
}

// One block per (column tile of CT columns of [v | grid], batch), one column a
// thread. The scores are TS x TS a thread (ceil(HW / TS)^2 <= NT threads);
// RQ row quads of P . [v | grid] accumulators (4 RQ >= HW); a ring of ST
// stages of q and k chunks, the block's [v | grid] columns arriving after the
// last chunk.
template <typename T, int TS, int RQ, int ST>
__global__ void __launch_bounds__(NT)
correlation_fwd_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ grid,
                             float* __restrict__ out, int HW, int Cq, int Cv, int CT) {
  extern __shared__ __align__(16) float smem[];
  const int HWP = (HW + 3) / 4 * 4;
  const int STAGE = 2 * HWP * SPQ;   // q then k chunk; or [HW][CT] of [v | grid]
  float* ss = smem + ST * STAGE;     // [HWP rows][HWP keys] scores
  float* pt = ss + HWP * HWP;        // [HWP keys][HWP rows] P
  float* inv_s = pt + HWP * HWP;     // [HWP] 1 / d

  const int b = blockIdx.y, tid = threadIdx.x;
  const int col0 = blockIdx.x * CT;
  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const bool vec = std::is_same<T, float>::value && Cq % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const int nCh = (Cq + SKC - 1) / SKC;
  auto load_step = [&](int step) {
    float* st = smem + (step % ST) * STAGE;
    if (step < nCh) {
      copy_rows(st, qb, HW, HWP, Cq, step * SKC, vec, tid);
      copy_rows(st + HWP * SPQ, kb, HW, HWP, Cq, step * SKC, vec, tid);
    } else if (step == nCh) {  // the block's columns of [v | grid], [HW][CT]
      for (int e = tid; e < HW * CT; e += NT) {
        const int j = e / CT, col = col0 + e - j * CT;
        const bool ok = col < Cv + 2;
        put(st + e,
            !ok ? grid : col < Cv ? v + (boff + j) * Cv + col : grid + 2 * j + (col - Cv), ok);
      }
    }
    mt::cp_async_commit();  // always: the wait below counts groups
  };
  for (int step = 0; step < ST - 1; ++step) load_step(step);

  // the scores: thread (pi, pj) sums rows TS pi .. +TS-1 against keys
  // TS pj .. +TS-1, each from channel 0 upwards in one chain of FMAs, as
  // the long-rows kernel (and a float32 matrix product) sums them
  const int GT = (HW + TS - 1) / TS;
  const bool active = tid < GT * GT;
  const int pi = active ? tid / GT : 0, pj = active ? tid % GT : 0;
  float acc[TS][TS] = {};
  for (int ch = 0; ch < nCh; ++ch) {
    mt::cp_async_wait<ST - 2>();
    __syncthreads();  // chunk ch has landed for all; the last chunk's stage is free
    load_step(ch + ST - 1);
    if (active) {
      const float* qs = smem + (ch % ST) * STAGE + TS * pi * SPQ;
      const float* ks = smem + (ch % ST) * STAGE + HWP * SPQ + TS * pj * SPQ;
      const int width = min(SKC, (Cq - ch * SKC + 3) & ~3);  // channels holding data
#pragma unroll 4
      for (int c = 0; c < width; c += 4) {
        float4 a[TS], bb[TS];
#pragma unroll
        for (int r = 0; r < TS; ++r) a[r] = *reinterpret_cast<const float4*>(qs + r * SPQ + c);
#pragma unroll
        for (int j = 0; j < TS; ++j) bb[j] = *reinterpret_cast<const float4*>(ks + j * SPQ + c);
#pragma unroll
        for (int r = 0; r < TS; ++r)
#pragma unroll
          for (int j = 0; j < TS; ++j) {
            acc[r][j] = fmaf(a[r].x, bb[j].x, acc[r][j]);
            acc[r][j] = fmaf(a[r].y, bb[j].y, acc[r][j]);
            acc[r][j] = fmaf(a[r].z, bb[j].z, acc[r][j]);
            acc[r][j] = fmaf(a[r].w, bb[j].w, acc[r][j]);
          }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < TS; ++r)
#pragma unroll
      for (int j = 0; j < TS; ++j)
        if (TS * pi + r < HW && TS * pj + j < HW) ss[(TS * pi + r) * HWP + TS * pj + j] = acc[r][j];
  }
  mt::cp_async_wait<0>();  // the [v | grid] tile too
  __syncthreads();

  // one warp a row: the max and the denominator over all keys by shuffles,
  // P key-major
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < HW; i += NT / 32) {
    float sv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = lane + 32 * e;
      sv[e] = j < HW ? ss[i * HWP + j] : -INFINITY;
    }
    float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = lane + 32 * e;
      // against the row's own max, so that its P is exactly 1 and 1 / d is
      // the max score (a rounded mx log2e would scale the whole row by up to
      // 2^(ulp / 2): 4e-5 at scores near 1,000)
      const float p = mt::ex2((sv[e] - mx) * LOG2E);
      if (j < HW) pt[j * HWP + i] = p;
      d += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
    if (lane == 0) inv_s[i] = 1.f / d;
  }
  __syncthreads();

  // P . [v | grid] for this thread's column, over every row
  const int col = col0 + tid;
  if (tid < CT && col < Cv + 2) {
    const float* vs = smem + (nCh % ST) * STAGE + tid;
    float o[4 * RQ];
#pragma unroll
    for (int i = 0; i < 4 * RQ; ++i) o[i] = 0.f;
    for (int j = 0; j < HW; ++j) {
      const float x = vs[j * CT];
      const float* pj_row = pt + j * HWP;
#pragma unroll
      for (int rq = 0; rq < RQ; ++rq) {
        if (4 * rq < HW) {
          const float4 p4 = *reinterpret_cast<const float4*>(pj_row + 4 * rq);
          o[4 * rq] = fmaf(p4.x, x, o[4 * rq]);
          o[4 * rq + 1] = fmaf(p4.y, x, o[4 * rq + 1]);
          o[4 * rq + 2] = fmaf(p4.z, x, o[4 * rq + 2]);
          o[4 * rq + 3] = fmaf(p4.w, x, o[4 * rq + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * RQ; ++i)
      if (i < HW) out[(boff + i) * (Cv + 3) + col] = o[i] * inv_s[i];
  }
  if (blockIdx.x == 0 && tid < HW) out[(boff + tid) * (Cv + 3) + Cv + 2] = inv_s[tid];
}

struct FmaArgs {
  const void *q, *k, *v, *grid;
  float* out;
  int B, HW, Cq, Cv;
  cudaStream_t stream;
};

template <typename T, int KC, bool STREAM, int CX, int RH, int KH, int ST, int MINB>
cudaError_t launch_rows(const FmaArgs& a) {
  using G = RowsGeo<RH, KH, CX>;
  auto kernel = correlation_fwd_rows_kernel<T, KC, STREAM, CX, RH, KH, ST, MINB>;
  const size_t stage = KC * G::PK + (STREAM ? KC * G::PQ : 0) + G::BN * G::CT + 2 * G::BN;
  const size_t smem = sizeof(float) * (G::BM * G::PK + (STREAM ? 0 : KC * G::PQ) + ST * stage);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int n_ct = a.Cv > G::CT ? (a.Cv + G::CT - 1) / G::CT : 1;
  const dim3 blocks((a.HW + G::BM - 1) / G::BM, a.B, n_ct);
  kernel<<<blocks, NT, smem, a.stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                         static_cast<const T*>(a.v),
                                         static_cast<const T*>(a.grid), a.out, a.HW, a.Cq, a.Cv);
  return cudaGetLastError();
}

// n_ct column tiles of [v | grid], each of at most NT columns.
template <typename T, int TS, int RQ, int ST>
cudaError_t launch_short(const FmaArgs& a, int n_ct) {
  auto kernel = correlation_fwd_short_kernel<T, TS, RQ, ST>;
  const size_t smem = sizeof(float) * short_floats(a.HW, ST);
  const int CT = (a.Cv + 2 + n_ct - 1) / n_ct;
  const int GT = (a.HW + TS - 1) / TS;
  if (4 * RQ < a.HW || GT * GT > NT || CT > NT) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 blocks(n_ct, a.B);
  kernel<<<blocks, NT, smem, a.stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                         static_cast<const T*>(a.v),
                                         static_cast<const T*>(a.grid), a.out, a.HW, a.Cq, a.Cv,
                                         CT);
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

// Column tiles of the few-rows kernel: as few as NT columns a tile allow,
// doubled while the blocks would not give every SM two and a tile keeps at
// least 32 columns. Each tile sums the scores again, so at the ResNet
// bottleneck (1,024 channels, HW = 20, B = 64: 5 tiles) more tiles were
// slower on an H100 (tools/torch_chip_studies.py k1-fma-variants, the device
// alone): 0.045 ms for 5, 0.072 for 8, 0.079 for 10, 0.116 for 16, 0.143
// for 20, 0.259 for 40; two ring stages 0.046, 4 x 4 scores a thread 0.081.
int short_col_tiles(int B, int Cv) {
  const int cvp = Cv + 2;
  int n = (cvp + NT - 1) / NT;
  while (n * B < 2 * sm_count() && (cvp + 2 * n - 1) / (2 * n) >= 32) n *= 2;
  return n;
}

// The long-rows instantiations: a thread's 8 x 8 scores and 8 x 4 outputs,
// BM = BN = 128, two ring stages, one block a SM (255 registers); 32 v
// columns a column tile (8 groups of 4, two key slices) up to Cv = 32, else
// 64. On an H100 80GB HBM3 at 700 W at the 3d3d grid in float32
// (tools/torch_chip_studies.py k1-fma-variants, k1-fma-edits), with the score
// loop unrolled fully, it took 10.37-10.76 ms at B=64 and 1.72-1.80 at B=10,
// against 10.90 and 1.82 with the row max reduced on every tile, 10.94-11.02
// for key tiles of 64, 11.00-11.02 for three stages (spilling), 12.16-12.26
// for 64-row blocks two a SM, 11.31-11.32 with the copy loops not unrolled
// and 10.67-11.07 for other unrolling of P . v; unrolled by 8 (16 bytes
// spilled) it took 10.565 and 1.768 against 10.647-10.652 and 1.779-1.780.
template <typename T, int KC, bool STREAM>
cudaError_t dispatch_rows(const FmaArgs& a) {
  if (a.Cv <= 32) return launch_rows<T, KC, STREAM, 8, 2, 2, 2, 1>(a);
  return launch_rows<T, KC, STREAM, 16, 2, 2, 2, 1>(a);
}

template <typename T>
cudaError_t dispatch_fma(const FmaArgs& a) {
  if (a.HW <= SHORT_HW) {
    const int n_ct = short_col_tiles(a.B, a.Cv);
    if (a.HW <= 16) return launch_short<T, 1, 4, 3>(a, n_ct);
    if (a.HW <= 32) return launch_short<T, 2, 8, 3>(a, n_ct);
    return launch_short<T, 4, 16, 2>(a, n_ct);
  }
  if (a.Cq <= 16) return dispatch_rows<T, 16, false>(a);
  if (a.Cq <= 32) return dispatch_rows<T, 32, false>(a);
  return dispatch_rows<T, 32, true>(a);
}

// ============================================================ "mma" design ==

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
//
// Since the wgmma kernel, the package takes this kernel only at 64 positions
// or fewer and beyond 256 q channels (ops/correlation.py::forward_kernel):
// at C = 1,024 on the 5x4 grid (B = 64) <64, 128, true, 1, 2, 2, 3> took
// 0.0278-0.0295 ms on the device alone (tools/torch_chip_studies.py
// k1-wgmma-variants, NVIDIA H100 80GB HBM3, 700 W). Its times at the shapes
// the wgmma kernel now serves are beside dispatch_wgmma.
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

// =========================================================== "wgmma" kernel ==
//
// The tensor-core design rebuilt on Hopper's own path (sm_90a): both
// products on warpgroup matrix instructions (wgmma), every tile brought in by
// the Tensor Memory Accelerator (TMA) with mbarriers (hopper_tile.cuh). It
// computes what the mma.sync kernel above computes: key tiles of TKW = TK =
// 64 in order, the same online softmax on the score accumulators, P rounded
// to bf16 relative to the row's running max after each tile, the
// denominator summed from the float32 P. Only the order in which the tensor
// cores sum a score's channels differs.
//
// - Warps. A block owns BR = 64 NC query rows: NC consumer warpgroups of 64
//   rows each (warps 0 .. 4 NC - 1), then a producer warpgroup whose first
//   warp loads (a warpgroup, so that setmaxnreg can hand its registers to the
//   consumers: with one warp alone, 9 warps put 3 on one of a SM's four
//   register files and capped every thread at 168). The producer
//   loads the block's q tile once, then keeps the key tiles of k and v in
//   flight through a ring of ST stages: it waits for a stage to be empty
//   (an mbarrier every consumer warp arrives on), writes the tile's grid
//   values, and has TMA copy k and v into it, the stage's full barrier
//   counting the bytes. No thread of the consumers spends an instruction or
//   a register on a copy.
// - S = q k^T: wgmma m64n64k16 with q and k from shared memory, both
//   K-major (channels along a row), channels in blocks of W = 16, 32 or 64
//   (rows of 32, 64 or 128 bytes, TMA's swizzle of the same width, which
//   the descriptors name); KB blocks hold Cq, zeros past it.
// - acc += P [v | grid]: P from registers (the S accumulator packed to
//   bf16 in place, as the mma.sync kernel packs its fragments), v as B from
//   shared memory MN-major (keys down the rows, channels along them: the
//   transpose bit), in VB blocks of WV columns, one m64nWVk16 per block and
//   16 keys.
// - Overlap. Each warpgroup takes its tiles in turn: the score product,
//   its softmax, then P . [v | grid]. What overlaps the exponentials, which
//   bound the 3d3d shape, with the products is the other warpgroups of the
//   SM: at 32 channels two blocks a SM (4 consumer warpgroups of 104
//   registers), at 128 and 256 one block of 2 or 3. The other schedule, a
//   warpgroup issuing tile j + 1's scores with tile j's P . [v | grid] and
//   running the softmax while the second product runs (two score tiles in
//   registers), was built and measured slower at every shape (see
//   dispatch_wgmma).
// - Width. The accumulator holds a column tile of CT = VB WV v channels,
//   with q resident up to 256 channels: one tile up to 128 v channels (the
//   128-channel ResUNet; 256 q with 96 v), column tiles of 128 beyond (a
//   grid dimension; the same scores in the same order in each, so the
//   statistics agree to the bit; tile 0 writes the max score, the last the
//   position). All 256 columns in one tile (128 accumulator registers a
//   thread) spilled beyond the 240 a consumer can take and measured slower
//   than recomputing the scores for two tiles (see dispatch_wgmma). Beyond
//   256 q channels (the ResNet encoder's 1,024) the mma.sync kernel streams
//   them.
//
// What was in the way, and what this does about it:
// 1. The grid's two columns. The grid is [HW, 2] bf16, 4 bytes a key: no
//    TMA box (16 bytes at least) reads it, and TMA cannot write into the
//    middle of a swizzled v tile. The producer warp loads it (4 bytes a key,
//    two keys a lane) into a tile of its own, [8 rows][64 keys] K-major
//    without swizzle (rows 2-7 zero), fences its stores for the async proxy
//    and only then arrives on the stage's barrier; a second, narrow product
//    (m64n8k16, the same P fragment) sums P . grid. A padded [v | grid | 0]
//    copy built by the wrapper would have cost a pass over v every call, and
//    a copy of the grid transposed one more launch on a host-bound path.
// 2. Batch boundaries. q, k and v have tensor maps of rank 3, [B][HW][C]:
//    rows past HW arrive as zeros, never the next batch element's rows (P =
//    0 times a NaN there would be NaN). Keys past HW are masked to -inf in
//    the last tile as before.
// 3. The output. Its rows are Cv + 3 floats (140 bytes at Cv = 32), no
//    multiple of 16: no TMA store. After the loop the consumers meet at a
//    named barrier, and the q tile and the ring become the block's float32
//    output tile, which leaves as whole rows in one coalesced stream (row by
//    row where the block has a column tile only), as the mma.sync epilogue.
// 4. Tensor maps. cuTensorMapEncodeTiled is a driver function: the runtime
//    hands it out (cudaGetDriverEntryPoint), so nothing links libcuda. The
//    three maps are encoded on the host at every call and passed by value
//    (__grid_constant__): the host's time to issue one call stayed within
//    the mma.sync kernel's (11.4-20.9 us against 14.7 at C = 32, B = 10, in
//    the same study), so no cache of maps was needed.
// 5. The rounding. The key tile stays 64 (TKW, which the plain forward's
//    bf16_roundings repeats: ops/correlation.py::FWD_KEY_TILES) and the max
//    moves on every tile as in the mma.sync kernel, so both kernels round P
//    at the same places.
// 6. Shared headers. The Hopper primitives live in hopper_tile.cuh; K2 and
//    K3 include mma_tile.cuh alone and are built as before.
// 7. No compiler here: the descriptors' strides, the swizzles and the
//    register pins (fence_regs: a wgmma's registers are read and written
//    asynchronously, so their readers are pinned after the wait, and an A
//    fragment in flight is kept alive until it) are the places to look
//    first when a result is wrong.

namespace ht = hopper_tile;

constexpr int TKW = 64;  // keys a tile of the wgmma kernel: ops/correlation.py::FWD_KEY_TILES
static_assert(TKW == TK, "both kernels of the design round P after the same key tiles");

// One instantiation's sizes: q and k channels in KB blocks of W, a column
// tile of v in VB blocks of WV columns, NC consumer warpgroups. Every tile
// starts on a 1,024-byte boundary.
template <int KB, int W, int VB, int WV, int NC>
struct WgGeo {
  static constexpr int BR = 64 * NC;          // query rows a block
  static constexpr int NTH = 128 * (NC + 1);  // threads: the consumers, then the producer warpgroup
  static constexpr int KQ = KB * W / 16;     // depth steps of q . k^T
  static constexpr int CT = VB * WV;         // v columns a column tile
  static constexpr int QBLK = BR * W * 2;    // bytes of a q block
  static constexpr int KBLK = TKW * W * 2;   // of a k block
  static constexpr int VBLK = TKW * WV * 2;  // of a v block
  static constexpr int GT = TKW * 16;        // of the grid tile: TKW / 8 core matrices of 128
  static constexpr int STAGE = KB * KBLK + VB * VBLK + GT;
  static constexpr int QBYTES = KB * QBLK;
  static_assert(W == 16 || W == 32 || W == 64, "a swizzle width");
  static_assert(WV == 16 || WV == 32 || WV == 64, "a swizzle width");
  static_assert(QBLK % 1024 == 0 && KBLK % 1024 == 0 && VBLK % 1024 == 0 && GT % 1024 == 0,
                "tiles on 1,024-byte boundaries");
  static_assert(BR <= 256 && CT <= 256, "a TMA box and one column tile");
};

// Dynamic shared memory of an instantiation: 1,024 bytes of alignment slack,
// the q tile and the ring (later the output tile), and the barriers.
template <int KB, int W, int VB, int WV, int NC, int ST>
__host__ __device__ constexpr size_t wgmma_region() {
  using G = WgGeo<KB, W, VB, WV, NC>;
  const size_t tiles = static_cast<size_t>(G::QBYTES) + static_cast<size_t>(ST) * G::STAGE;
  const size_t outs = sizeof(float) * G::BR * (G::CT + 3);
  return ((tiles > outs ? tiles : outs) + 7) / 8 * 8;
}

// Registers a thread of the producer warpgroup keeps, and what a consumer
// thread takes from them (setmaxnreg), with MINB blocks a SM: each of a SM's
// four register files (16,384 registers) holds one warp of every warpgroup.
constexpr int PRODUCER_REGS = 24;
__host__ __device__ constexpr int wgmma_consumer_regs(int NC, int MINB) {
  const int launch = 512 / ((NC + 1) * MINB) / 8 * 8;  // a warp's registers / 32 at launch
  const int take = (launch * (NC + 1) - PRODUCER_REGS) / NC / 8 * 8;
  return take > 240 ? 240 : take;  // at least the launch count where NC + 1 warps fit at 240
}

template <int KB, int W, int VB, int WV, int NC, int ST, int MINB>
__global__ void __launch_bounds__(128 * (NC + 1), MINB)
correlation_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const bf16* __restrict__ grid, float* __restrict__ out, int HW,
                             int Cv) {
  using G = WgGeo<KB, W, VB, WV, NC>;
  constexpr int NTK = TKW / 8;   // 8-key columns of S
  constexpr int NKS = TKW / 16;  // depth-16 steps of P . [v | grid]
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (ht::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* qs = base;                 // KB blocks [BR][W]
  unsigned char* ring = base + G::QBYTES;   // ST x (KB k blocks, VB v blocks, grid tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(base + wgmma_region<KB, W, VB, WV, NC, ST>());
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * G::BR;
  const int col0 = blockIdx.z * G::CT;              // this block's v channels
  const int w = Cv - col0 < G::CT ? Cv - col0 : G::CT;
  const bool has_grid = col0 + w == Cv;             // the last tile: the grid at w, w + 1
  const int wo = w + (has_grid ? 2 : 0);            // its columns of the output
  const int nvb = (w + WV - 1) / WV;                // v blocks holding columns
  const int nT = (HW + TKW - 1) / TKW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

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
    // the grid tiles' rows 2-7 stay zero; rows 0 and 1 are written per tile
    for (int i = lane; i < ST * (G::GT / 16); i += 32) {
      const int s = i / (G::GT / 16), o = i % (G::GT / 16);
      *reinterpret_cast<uint4*>(ring + s * G::STAGE + KB * G::KBLK + VB * G::VBLK + o * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    if (lane == 0) {
      ht::mbar_arrive_expect_tx(qfull, G::QBYTES);
      for (int kb = 0; kb < KB; ++kb) ht::tma_load_3d(qs + kb * G::QBLK, &tq, qfull, kb * W, row0, b);
    }
    for (int j = 0; j < nT; ++j) {
      const int s = j % ST;
      unsigned char* st = ring + s * G::STAGE;
      ht::mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
      // keys 2 lane and 2 lane + 1 of the tile: x into row 0, y into row 1
      const int jj = 2 * lane, key = j * TKW + jj;
      const uint32_t g0 = key < HW ? __ldg(reinterpret_cast<const unsigned*>(grid) + key) : 0u;
      const uint32_t g1 =
          key + 1 < HW ? __ldg(reinterpret_cast<const unsigned*>(grid) + key + 1) : 0u;
      unsigned char* gt = st + KB * G::KBLK + VB * G::VBLK + (jj >> 3) * 128 + (jj & 7) * 2;
      *reinterpret_cast<uint32_t*>(gt) = (g0 & 0xffffu) | (g1 << 16);
      *reinterpret_cast<uint32_t*>(gt + 16) = (g0 >> 16) | (g1 & 0xffff0000u);
      ht::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        ht::mbar_arrive_expect_tx(&full[s], KB * G::KBLK + nvb * G::VBLK);
        for (int kb = 0; kb < KB; ++kb)
          ht::tma_load_3d(st + kb * G::KBLK, &tk, &full[s], kb * W, j * TKW, b);
        for (int vb = 0; vb < nvb; ++vb)
          ht::tma_load_3d(st + KB * G::KBLK + vb * G::VBLK, &tv, &full[s], col0 + vb * WV,
                          j * TKW, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wgmma_consumer_regs(NC, MINB)));
  const int wg = warp >> 2;                // rows 64 wg .. of the block
  const int g = lane >> 2, t = lane & 3;   // within a warp's 16 rows: rows g, g + 8

  // descriptors (hopper_tile.cuh): q and k K-major, swizzled by their row
  // width; v MN-major; the grid tile K-major without a swizzle. Each product
  // adds constant offsets (in 16-byte units) to one base descriptor.
  constexpr uint32_t SWQ = ht::swizzle_code(2 * W), SWV = ht::swizzle_code(2 * WV);
  const uint64_t dq_base = ht::make_desc(qs + wg * 64 * W * 2, 16, 16 * W, SWQ);
  auto q_off = [](int ks, int blk) { return ((ks / (W / 16)) * blk + (ks % (W / 16)) * 32) >> 4; };

  float acc[VB][WV / 2];  // P . v: column 8 n + 2 t + e % 2 of block vb at acc[vb][4 n + e]
  float accg[4];          // P . grid: columns 0 (x) and 1 (y) at t = 0
  float m_run[2], l_run[2];  // running max of s log2e; this lane's share of d
#pragma unroll
  for (int vb = 0; vb < VB; ++vb)
#pragma unroll
    for (int i = 0; i < WV / 2; ++i) acc[vb][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) accg[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_run[h] = -INFINITY;
    l_run[h] = 0.f;
  }

  auto issue_s = [&](float (&s)[TKW / 2], const unsigned char* st) {
    const uint64_t dq = ht::opaque(dq_base);
    const uint64_t dk = ht::make_desc(st, 16, 16 * W, SWQ);
#pragma unroll
    for (int ks = 0; ks < G::KQ; ++ks)
      ht::wgmma_m64n64_ss(s, dq + q_off(ks, G::QBLK), dk + q_off(ks, G::KBLK), ks > 0 ? 1 : 0);
  };
  auto issue_pv = [&](uint32_t (&pa)[NKS][4], const unsigned char* st) {
    const uint64_t dv = ht::make_desc(st + KB * G::KBLK, G::VBLK, 16 * WV, SWV);
    const uint64_t dg = ht::make_desc(st + KB * G::KBLK + VB * G::VBLK, 128, G::GT,
                                      ht::SWIZZLE_NONE);
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
      for (int vb = 0; vb < VB; ++vb)
        ht::wgmma_rs<WV, 1>(acc[vb], pa[kk], dv + ((vb * G::VBLK + kk * 16 * 2 * WV) >> 4));
      ht::wgmma_rs<8, 0>(accg, pa[kk], dg + kk * 16);  // 2 core matrices (256 bytes) a step
    }
  };
  // the online softmax of one tile's scores (in the log2 domain, the row max
  // over the 4 lanes of a row), P packed into A fragments: keys 16 kk .. +16
  // are S columns 2 kk and 2 kk + 1. Returns whether a row's max moved.
  auto softmax = [&](float (&s)[TKW / 2], int key0, uint32_t (&pa)[NKS][4],
                     float (&alpha)[2]) {
    if (key0 + TKW > HW) {  // only the last tile has keys past HW
      const int n_keys = HW - key0;
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + 2 * t + (e & 1) >= n_keys) s[4 * n + e] = -INFINITY;
    }
    bool moved = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NTK; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_run[h], mx * LOG2E);
      moved |= m_new != m_run[h];
      alpha[h] = mt::ex2(m_run[h] - m_new);  // 0 on the first tile
      m_run[h] = m_new;
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = mt::ex2(fmaf(s[4 * n + e], LOG2E, -m_run[e >> 1]));
      sum0 += p[0] + p[1];
      sum1 += p[2] + p[3];
      pa[n >> 1][(n & 1) * 2] = mt::pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = mt::pack_bf16(p[2], p[3]);
    }
    l_run[0] = fmaf(l_run[0], alpha[0], sum0);
    l_run[1] = fmaf(l_run[1], alpha[1], sum1);
    return moved;
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int vb = 0; vb < VB; ++vb)
#pragma unroll
      for (int i = 0; i < WV / 2; ++i) acc[vb][i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) accg[i] *= alpha[i >> 1];
  };

  ht::mbar_wait(qfull, 0);
  for (int j = 0; j < nT; ++j) {
    const int sj = j % ST;
    const unsigned char* st = ring + sj * G::STAGE;
    ht::mbar_wait(&full[sj], (j / ST) & 1);
    float s[TKW / 2];
    ht::wgmma_fence();
    issue_s(s, st);
    ht::wgmma_commit();
    ht::wgmma_wait<0>();
    ht::fence_regs(s);
    uint32_t pa[NKS][4];
    float alpha[2];
    const bool moved = softmax(s, j * TKW, pa, alpha);
    if (__any_sync(FULL, moved)) rescale(alpha);
    ht::wgmma_fence();
    issue_pv(pa, st);
    ht::wgmma_commit();
    ht::wgmma_wait<0>();
#pragma unroll
    for (int vb = 0; vb < VB; ++vb) ht::fence_regs(acc[vb]);
    ht::fence_regs(accg);
    if (lane == 0) ht::mbar_arrive(&empty[sj]);
  }

  // epilogue: once every consumer is past the loop, the q tile and the ring
  // become the block's [BR, wo + 1] float32 output tile (its columns, then
  // 1 / d), which leaves as whole rows of the output where the block has
  // them all, else row by row; only column tile 0 writes the max score
  constexpr int NTC = 128 * NC;
  asm volatile("bar.sync 1, %0;\n" ::"n"(NTC) : "memory");
  float* ot = reinterpret_cast<float*>(base);
  const int E = wo + 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float d = l_run[h];
    d += __shfl_xor_sync(FULL, d, 1);
    d += __shfl_xor_sync(FULL, d, 2);
    const float inv = 1.f / d;
    float* o = ot + (64 * wg + 16 * (warp & 3) + 8 * h + g) * E;
#pragma unroll
    for (int vb = 0; vb < VB; ++vb)
#pragma unroll
      for (int n = 0; n < WV / 8; ++n) {
        const int col = vb * WV + n * 8 + 2 * t;
        if (col < w) {  // w is a multiple of 8: both columns or neither
          o[col] = acc[vb][4 * n + 2 * h] * inv;
          o[col + 1] = acc[vb][4 * n + 2 * h + 1] * inv;
        }
      }
    if (t == 0) {
      if (has_grid) {
        o[w] = accg[2 * h] * inv;
        o[w + 1] = accg[2 * h + 1] * inv;
      }
      o[wo] = inv;  // the max score: max_j P_ij = 1 / d
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NTC) : "memory");
  const int CO = Cv + 3;
  const int rows = HW - row0 < G::BR ? HW - row0 : G::BR;
  float* dst = out + (static_cast<size_t>(b) * HW + row0) * CO;
  if (E == CO) {
    for (int i = tid; i < rows * CO; i += NTC) dst[i] = ot[i];
  } else {
    for (int i = tid; i < rows * E; i += NTC) {
      const int r = i / E, c = i - r * E;
      if (c < wo)
        dst[r * CO + col0 + c] = ot[i];
      else if (blockIdx.z == 0)
        dst[r * CO + Cv + 2] = ot[i];
    }
  }
}

template <int KB, int W, int VB, int WV, int NC, int ST, int MINB>
cudaError_t launch_wgmma(const MmaArgs& a) {
  using G = WgGeo<KB, W, VB, WV, NC>;
  if (a.Cq > KB * W) return cudaErrorInvalidValue;
  auto kernel = correlation_fwd_wgmma_kernel<KB, W, VB, WV, NC, ST, MINB>;
  constexpr size_t smem = 1024 + wgmma_region<KB, W, VB, WV, NC, ST>() + (2 * ST + 1) * 8;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  e = ht::encode_bf16_map(&tq, a.q, a.Cq, a.HW, a.B, W, G::BR);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tk, a.k, a.Cq, a.HW, a.B, W, TKW);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tv, a.v, a.Cv, a.HW, a.B, WV, TKW);
  if (e != cudaSuccess) return e;
  const dim3 blocks((a.HW + G::BR - 1) / G::BR, a.B, (a.Cv + G::CT - 1) / G::CT);
  kernel<<<blocks, G::NTH, smem, a.stream>>>(tq, tk, tv, a.grid, a.out, a.HW, a.Cv);
  return cudaGetLastError();
}

// The wgmma instantiations: q and k channels as KB blocks of W, a column tile
// of v as VB blocks of WV, then consumer warpgroups, ring stages and the
// least blocks a SM. Each takes the smallest class that holds Cq and Cv
// (zeros pad the rest); beyond 64 channels v comes in column tiles of 128.
//
// Timed on an NVIDIA H100 80GB HBM3 at 700 W against each other and against
// the mma.sync kernel in turns, at the 3d3d grid (HW = 6,256) unless stated
// (tools/torch_chip_studies.py k1-wgmma-variants, CUDA events; every variant
// gave the package's bits, the mma.sync kernel's too; ms):
// - C = 32, B = 64: two blocks a SM (104 registers a consumer) 1.168-1.202
//   with three stages, 1.186-1.213 with four, 1.186-1.211 with two; one
//   block a SM 1.72-1.76; three warpgroups a block 1.35-1.38; one
//   warpgroup, three blocks a SM, 1.31-1.33; the mma.sync kernel
//   1.409-1.416. B = 10: 0.2054-0.2064 (two stages 0.2042-0.2058; mma.sync
//   0.2632-0.2642); B = 576: 10.25-10.28 (12.09-12.20); the ScanNet grid
//   (HW = 4,800, B = 64): 0.723-0.724 (0.857-0.859).
// - C = 128: B = 10, two warpgroups 0.425-0.426 (four stages 0.423-0.426),
//   three 0.451-0.452; B = 64, three 2.38-2.52, two 2.52-2.66; mma.sync
//   0.805 and 4.78-5.00.
// - Cq = 256, Cv = 96: two warpgroups 0.548 (two stages 0.581-0.586), three
//   0.592-0.597; mma.sync 1.607-1.613. Cq = Cv = 256 (two column tiles of
//   128): three warpgroups 1.010-1.019, two 1.119-1.128; all 256 columns in
//   one tile (128 accumulator registers a thread, 1,160 bytes spilled at the
//   consumers' 240) 1.430-1.431; mma.sync 3.257-3.261.
// So three consumer warpgroups where the grid has some 600 blocks of 192
// rows or more (counting column tiles: C = 128 at B = 64, C = 256 at B =
// 10), two below. The rejected schedule, a warpgroup overlapping tile
// j + 1's scores with tile j's P . [v | grid] (two score tiles in registers;
// its scores copied out of the accumulator, not pinned in place, or ptxas
// serialised every wgmma), measured slower wherever it was timed, with an
// earlier form of the same study: C = 32, B = 64 1.66-2.03 (spilling at two
// blocks a SM: 2.71-2.73); C = 128 0.521-0.582 at B = 10, 2.70-3.53 at
// B = 64; 256 / 96 0.72-0.95; C = 256 1.46-1.82.
cudaError_t dispatch_wgmma(const MmaArgs& a) {
  const long blocks = static_cast<long>(a.B) * ((a.HW + 191) / 192) * ((a.Cv + 127) / 128);
  if (a.Cq <= 16 && a.Cv <= 16) return launch_wgmma<1, 16, 1, 16, 2, 3, 2>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_wgmma<1, 32, 1, 32, 2, 3, 2>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_wgmma<1, 64, 1, 64, 2, 4, 1>(a);
  if (a.Cq <= 128 && a.Cv <= 128)
    return blocks >= 600 ? launch_wgmma<2, 64, 2, 64, 3, 3, 1>(a)
                         : launch_wgmma<2, 64, 2, 64, 2, 3, 1>(a);
  if (a.Cq <= 256)
    return blocks >= 600 ? launch_wgmma<4, 64, 2, 64, 3, 2, 1>(a)
                         : launch_wgmma<4, 64, 2, 64, 2, 3, 1>(a);
  return cudaErrorInvalidValue;
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

// The wgmma kernel of the "mma" design: as correlation_fwd_mma, for Cq up to
// 256 (any Cv). Same arguments and output.
extern "C" int correlation_fwd_wgmma(const void* q, const void* k, const void* v,
                                     const void* grid, void* out, int B, int HW, int Cq,
                                     int Cv, int dtype, void* stream) {
  if (!mma_takes(B, HW, Cq, Cv, dtype) || Cq > 256) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
                  static_cast<float*>(out), B, HW, Cq, Cv, static_cast<cudaStream_t>(stream)};
  return dispatch_wgmma(a);
}

// The "fma" design, at any Cq >= 1 and Cv >= 0. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int correlation_fwd(const void* q, const void* k, const void* v,
                               const void* grid, void* out, int B, int HW, int Cq,
                               int Cv, int dtype, void* stream) {
  if (B <= 0 || HW <= 0) return cudaSuccess;
  if (Cq <= 0 || Cv < 0 || B > 65535) return cudaErrorInvalidValue;
  const FmaArgs a{q, k, v, grid, static_cast<float*>(out), B, HW, Cq, Cv,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_fma<float>(a);
  if (dtype == 1) return dispatch_fma<bf16>(a);
  return cudaErrorInvalidValue;
}
