// Fused correlation-volume softmax-warp, backward pass on Hopper (sm_90a) at
// narrow widths: the "narrow" wgmma pair of K2 and K3's "mma" design, for
// bf16 with Cq and Cv up to 64 beyond 64 positions (every published config
// trains at 32 channels). correlation_bwd_wgmma.cu holds the design's wgmma
// pair for 65-256 channels, correlation_bwd_mma.cu its mma.sync pair and the
// arithmetic all of them share.
//
// Replaces, with the design's other pairs, the two TPU kernels of
// mapfree_tpu/ops/correlation.py::_fcw_bwd: _bwd_rows_kernel (:109, K2, the
// row pass: correlation_bwd_rows_narrow) and _bwd_cols_kernel (:148, K3, the
// column pass: correlation_bwd_cols_narrow). Per batch and query row i, with
// s_ij = q_i . k_j and P = softmax_j(s):
//
//   dP_ij = dmain_i . [v_j | grid_j] + d_ms_i [j == first argmax_j s_ij]
//   dS_ij = P_ij (dP_ij - c_i),  c_i = dout_i . out_i
//   dq_i = sum_j dS_ij k_j   (K2)   dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dmain_i[:Cv]   (K3)
//
// Arguments, outputs and rounding points are the other pairs': K2 forms
// dmain (bf16) and c itself, walks the keys once with an online row max
// moved lazily every TKG keys, rounds dS' = e (dP - c) to bf16 against the
// row's running reference and writes stats [B, HW, 4] = (lse, 1/d, c, d_ms),
// amax and dmain [B, HW, dmain_width(Cv)]; K3 takes them, P = 2^(s log2e -
// lse) and dS = P (dP - c) rounded to bf16. Either pair's K2 hands on to any
// K3, and ops/correlation.py's plain backward with bf16_roundings=True is the
// yardstick of all three.
//
// Bound (chip_smoke.py::k2_bound, k3_bound; H100 SXM at 700 W): operations,
// the exponentials at these widths. K2 does B HW^2 exponentials and 2 B HW^2
// (2 Cq + Cv + 2) FLOP in products, K3 as many exponentials and 2 B HW^2
// (2 Cq + 2 Cv + 2) FLOP: at the 3d3d train shape (B = 10, HW = 6,256, C =
// 32) 0.0936 and 0.1029 ms, at B = 90 0.842 and 0.926.
//
// What held the wgmma pair back at 32 channels (correlation_bwd_wgmma.cu's
// note), and what this pair does about it:
// - Registers. ptxas compiles every thread at the launch bound's register
//   cap, not at what setmaxnreg gives a consumer, so a producer warpgroup
//   costs the consumers a quarter to a half of their registers (four
//   consumer warpgroups and a producer: 96 a thread). This pair has no
//   producer: NC consumer warpgroups (four: 128 registers), warp 0 brings in
//   the resident tile and the first ST stages, and the last of the block's
//   warps done with a stage brings the tile ST on into it (a count in shared
//   memory per stage, fenced, in place of the empty barriers). So a pass is
//   64 keys (K2) or 32 rows (K3) with four warpgroups a SM.
// - A pass. Each warpgroup issues a pass's first products (S = q k^T and dP
//   = dmain [v | grid]^T; K3 their transposes) beside the previous pass's
//   second ones (K2 dq += dS' k; K3 dk += dS^T q and dv += P^T dmain), waits
//   for both, then forms the pass's dS' (K3: P and dS) in registers. Every
//   product has landed when any other instruction writes an accumulator or
//   a fragment and when K2 runs its divergent lazy-max code. Earlier forms
//   of this source that overlapped a warpgroup's own exponentials with its
//   products in flight (two passes' fragments or scores in two register
//   sets) had every wgmma serialised by ptxas (C7515; C7518 where divergent
//   code ran beside them) and measured slower in the same study (C = 32, B
//   = 10: K2 0.5322-1.6894 ms, K3 0.6783-1.4506), and two warpgroups taking
//   turns at the tensor cores on named barriers moved nothing (K2
//   0.4945-0.4949 against 0.4961-0.4972 ms). The warpgroups of a SM overlap
//   each other instead.
// - Less work a score. K2 takes its lazy-max decision once a pass: where no
//   lane's largest score passes the reference by LAZY_GAP (every pass after
//   the first few of a row) the reference stays for the whole pass, one vote
//   of the warp settles it, and the first argmax is searched only in a lane
//   whose largest score moved; else the pass takes the group-by-group steps
//   of the other pairs, and where a row of the warpgroup moved (one
//   bar.red.or a pass) the pass's dq steps go group by group with a wait
//   before each rescale. K3 keeps P = ex2(fma(s, log2e, -lse)).
// - Rounding and sum order. As the other pairs: dmain, P and dS in bf16, the
//   lazy reference moved by LAZY_GAP after each group of TKG keys (the plain
//   backward's BWD_KEY_TILE and BWD_LAZY_GAP_LOG2); the tensor cores sum each
//   16-deep step in the same order, so the pair gives the other pairs' bits.
// The instantiations (dispatch_rows_narrow, dispatch_cols_narrow) were chosen
// by timing, tools/torch_chip_studies.py k23-narrow-variants; the candidates
// and their times are beside the dispatch. At 64 channels the pair is ahead
// of the mma.sync one; at 16 and 32 it is behind, and
// ops/correlation.py::backward_kernel keeps the mma.sync pair there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "correlation_bwd_hopper.cuh"
#include "hopper_tile.cuh"
#include "mma_tile.cuh"

namespace {

namespace bh = bwd_hopper;
namespace ht = hopper_tile;
namespace mt = mma_tile;
using bf16 = __nv_bfloat16;

constexpr int TKW = 64;  // keys a tile (K2), rows a chunk (K3)
constexpr int TKG = 16;  // keys a step of K2's online max: ops/correlation.py::BWD_KEY_TILE
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LAZY_GAP = 8.f / LOG2E;  // how far a row's score may pass K2's reference: P up to 2^8
constexpr int GT = 2048;  // bytes of K2's grid tile: [64 keys] x [16 channels] bf16

// =================================================================== K2 ==
// q and k channels in one block of W (16, 32 or 64), v and dmain's v columns
// in one block of CV, NC consumer warpgroups.
template <int W, int CV, int NC>
struct RowsGeo {
  static constexpr int BR = 64 * NC;       // query rows a block
  static constexpr int KQ = W / 16;        // depth steps of q k^T
  static constexpr int KV = CV / 16;       // of dmain v^T (the grid's step apart)
  static constexpr int QBLK = BR * W * 2;  // bytes of the resident q tile
  static constexpr int DBLK = BR * CV * 2; // of the resident dmain tile
  static constexpr int KBLK = TKW * W * 2; // of a stage's k tile
  static constexpr int VBLK = TKW * CV * 2;
  static constexpr int STAGE = KBLK + VBLK + GT;
  static constexpr int RESIDENT = QBLK + DBLK;
  static_assert(W == 16 || W == 32 || W == 64, "a swizzle width");
  static_assert(CV == 16 || CV == 32 || CV == 64, "a swizzle width");
  static_assert(QBLK % 1024 == 0 && DBLK % 1024 == 0 && KBLK % 1024 == 0 && VBLK % 1024 == 0,
                "tiles on 1,024-byte boundaries");
};

// Dynamic shared memory after the 1,024-byte alignment: the resident tiles,
// the ring, the rows' (0, 1/d, c, d_ms); the barriers and the stages' counts
// follow.
template <int W, int CV, int NC, int ST>
__host__ __device__ constexpr size_t rows_region() {
  using G = RowsGeo<W, CV, NC>;
  return static_cast<size_t>(G::RESIDENT) + static_cast<size_t>(ST) * G::STAGE + 16 * G::BR;
}

template <int W, int CV, int NC, int ST, int MINB, int NH>
__global__ void __launch_bounds__(128 * NC, MINB)
correlation_bwd_rows_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const bf16* __restrict__ k, const bf16* __restrict__ grid,
                                   const float* __restrict__ out, const float* __restrict__ dout,
                                   bf16* __restrict__ dmain, float* __restrict__ stats,
                                   float* __restrict__ dq, int* __restrict__ amax_out, int HW,
                                   int Cq, int Cv, int DM) {
  using G = RowsGeo<W, CV, NC>;
  constexpr int NG = NH / TKG;  // groups of TKG keys a pass
  constexpr int PT = TKW / NH;  // passes a tile
  static_assert(ST >= 2, "a ring");
  extern __shared__ __align__(16) unsigned char nw_smem[];
  unsigned char* base = nw_smem + ((1024 - (ht::smem_u32(nw_smem) & 1023)) & 1023);
  unsigned char* qs = base;              // [BR][W]
  unsigned char* dms = qs + G::QBLK;     // [BR][CV]: dmain's v columns
  unsigned char* ring = dms + G::DBLK;   // ST x (k tile, v tile, grid tile)
  float4* rs = reinterpret_cast<float4*>(ring + ST * G::STAGE);  // [BR] (0, 1/d, c, d_ms)
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + G::BR);
  uint64_t* qfull = full + ST;
  int* done = reinterpret_cast<int*>(qfull + 1);  // [ST]: warps done with the stage's tile

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * G::BR;
  const int nT = (HW + TKW - 1) / TKW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t boff = static_cast<size_t>(b) * HW;

  // tile j into its stage, by one whole warp: the grid tile (key r's 16
  // bytes at (r / 8) 256 + (r % 8) 16: core matrices of 8 keys, the depth's
  // second 8 channels 128 bytes on; all zero but each key's first 4 bytes),
  // fenced for the async proxy, then k and v by TMA (rank-3 maps: rows past
  // HW arrive as zeros, never the next batch element's)
  const auto load_tile = [&](int j) {
    const int s = j % ST;
    unsigned char* st = ring + s * G::STAGE;
    unsigned char* gt = st + G::KBLK + G::VBLK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h, key = j * TKW + r;
      *reinterpret_cast<uint32_t*>(gt + (r >> 3) * 256 + (r & 7) * 16) =
          key < HW ? __ldg(reinterpret_cast<const unsigned*>(grid) + key) : 0u;
    }
    ht::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      ht::mbar_arrive_expect_tx(&full[s], G::KBLK + G::VBLK);
      ht::tma_load_3d(st, &tk, &full[s], 0, j * TKW, b);
      ht::tma_load_3d(st + G::KBLK, &tv, &full[s], 0, j * TKW, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      ht::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    ht::mbar_init(qfull, 1);
    ht::mbar_fence_init();
  }
  __syncthreads();
  // no producer warpgroup (its registers would lower every consumer's cap):
  // warp 0 brings in q and the first ST tiles, and the last warp done with a
  // stage brings the tile ST on into it (release_tile)
  if (warp == 0) {
    for (int i = lane; i < ST * (GT / 16); i += 32) {
      const int s = i / (GT / 16), o = i % (GT / 16);
      *reinterpret_cast<uint4*>(ring + s * G::STAGE + G::KBLK + G::VBLK + o * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    if (lane == 0) {
      ht::mbar_arrive_expect_tx(qfull, G::QBLK);
      ht::tma_load_3d(qs, &tq, qfull, 0, row0, b);
    }
    for (int j = 0; j < ST && j < nT; ++j) load_tile(j);
  }
  // this warp is done with tile j's stage; the last of the block's warps to
  // be so loads tile j + ST into it
  const auto release_tile = [&](int j) {
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[j % ST], 1) == 4 * NC - 1;
    }
    if (__shfl_sync(FULL, last, 0)) {
      __threadfence_block();
      if (lane == 0) done[j % ST] = 0;
      if (j + ST < nT) load_tile(j + ST);
    }
  };

  // ---- the consumer warpgroups ----
  const int wg = warp >> 2, wq = warp & 3;  // rows 64 wg + 16 wq .. + 16 of the block
  const int g = lane >> 2, t = lane & 3;    // within them rows g and g + 8
  const int bar = 1 + wg;

  // the prologue, while the copies fly: dmain's v columns into the
  // warpgroup's tile, the rows' (0, 1/d, c, d_ms)
  bh::rows_prologue<CV, CV, G::DBLK>(out, dout, dmain, dms, rs, 64 * wg + 16 * wq, row0, HW, Cv,
                                      DM, boff, lane, true);
  ht::fence_proxy_async();  // the dmain tile, written by threads, read by wgmma
  ht::warpgroup_sync(bar);

  uint32_t ga[4];  // the grid's depth step
  float cval[2], inv_d[2], d_ms[2];
  bh::rows_values(dout, rs, 64 * wg + 16 * wq, row0, g, t, HW, Cv, boff, ga, cval, inv_d, d_ms);

  constexpr uint32_t SWQ = ht::swizzle_code(2 * W), SWD = ht::swizzle_code(2 * CV);
  const uint64_t dq_base = ht::make_desc(qs + wg * 64 * W * 2, 16, 16 * W, SWQ);
  const uint64_t dd_base = ht::make_desc(dms + wg * 64 * CV * 2, 16, 16 * CV, SWD);

  float acc[1][W / 2];  // dq: column 8 n + 2 t + e % 2 at acc[0][4 n + e]
  ht::zero(acc[0]);
  float mref[2], best[2];  // the rows' reference (a raw score, common to a row's 4 lanes); this lane's largest score
  int bidx[2];             // ... and its first index
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mref[h] = best[h] = -INFINITY;
    bidx[h] = 0x7fffffff;
  }
  float s[NH / 2], dp[NH / 2];  // a pass's S and dP: key 8 n + 2 t + e % 2 of the pass at [4 n + e]
  uint32_t f[NG][4];              // its dS' fragments, 16 keys each
  // what a pass leaves for its dq steps, issued with the next pass's S and
  // dP: what the sum is multiplied by before group gi's steps (1 where the
  // row's reference stays), whether some row of the warp moved, and whether
  // some row of the warpgroup did
  float alpha[NG][2];
  bool moved = false, slow = false;
  const int NP = nT * PT;

  // S and dP of pass p: keys TKW j + NH hh .. + NH of tile j
  const auto issue_first = [&](int p) {
    const int j = p / PT, hh = p - j * PT, sj = j % ST;
    const unsigned char* st = ring + sj * G::STAGE;
    if (hh == 0) ht::mbar_wait(&full[sj], (j / ST) & 1);
    ht::wgmma_fence();
    const uint64_t dqd = ht::opaque(dq_base);
    const uint64_t dkd = ht::make_desc(st + hh * NH * 2 * W, 16, 16 * W, SWQ);
#pragma unroll
    for (int ks = 0; ks < G::KQ; ++ks)
      ht::wgmma_ss<NH>(s, dqd + ht::kstep<W>(ks, G::QBLK), dkd + ht::kstep<W>(ks, G::KBLK),
                       ks > 0 ? 1 : 0);
    const uint64_t ddd = ht::opaque(dd_base);
    const uint64_t dvd = ht::make_desc(st + G::KBLK + hh * NH * 2 * CV, 16, 16 * CV, SWD);
#pragma unroll
    for (int ks = 0; ks < G::KV; ++ks)
      ht::wgmma_ss<NH>(dp, ddd + ht::kstep<CV>(ks, G::DBLK), dvd + ht::kstep<CV>(ks, G::VBLK),
                       ks > 0 ? 1 : 0);
    ht::wgmma_rs<NH, 0>(dp, ga,
                        ht::make_desc(st + G::KBLK + G::VBLK + hh * NH * 32, 128, 256,
                                      ht::SWIZZLE_NONE));
    ht::wgmma_commit();
  };

  // dq += dS' k over pass p's keys, k read MN-major from the same stage: in
  // groups of TKG keys, where some row of the warpgroup moved (wgmma is
  // collective, so the warpgroup voted) each after the steps before it
  // landed and the sum was rescaled (the first group's rescale came at the
  // end of the pass)
  const auto issue_second = [&](int p) {
    const int j = p / PT, hh = p - j * PT;
    const uint64_t dkt = ht::make_desc(ring + (j % ST) * G::STAGE, G::KBLK, 16 * W, SWQ);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      if (slow && gi > 0) {
        ht::wgmma_wait<0>();
        ht::fence_regs(acc[0]);
        if (moved) {
#pragma unroll
          for (int i = 0; i < W / 2; ++i) acc[0][i] *= alpha[gi][(i >> 1) & 1];
        }
      }
      ht::wgmma_fence();
      ht::wgmma_rs<W, 1>(acc[0], f[gi], dkt + (((hh * NH + gi * TKG) * 2 * W) >> 4));
      ht::wgmma_commit();
    }
  };

  // pass p: its S and dP issued beside pass p - 1's dq steps, then, every
  // product landed, its lazy max, first argmax and dS'
  const auto step = [&](int p) {
    const int j = p / PT, hh = p - j * PT;
    const int key0 = j * TKW + hh * NH;
    issue_first(p);
    if (p > 0) issue_second(p - 1);
    ht::wgmma_wait<0>();
    ht::fence_regs(s);
    ht::fence_regs(dp);
    ht::fence_regs(acc[0]);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) ht::fence_regs(f[gi]);
    // pass p - 1's stage is free once that pass was its tile's last
    if (p > 0 && p % PT == 0) release_tile(p / PT - 1);
    const int n_valid = HW - key0;
    if (n_valid < NH) {  // the last tile's keys past HW score -inf
#pragma unroll
      for (int n = 0; n < NH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + 2 * t + (e & 1) >= n_valid) s[4 * n + e] = -INFINITY;
    }
    // this lane's largest score of the pass for row h
    float pm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = -INFINITY;
#pragma unroll
      for (int n = 0; n < NH / 8; ++n) m = fmaxf(m, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
      pm[h] = m;
    }
    float mg[NG][2];  // the reference after group gi
    const bool renew = fmaxf(best[0], pm[0]) > mref[0] + LAZY_GAP ||
                       fmaxf(best[1], pm[1]) > mref[1] + LAZY_GAP;
    moved = __any_sync(FULL, renew);
    if (moved) {
      // some row of the warp moves in this pass: the groups of TKG keys in
      // order, as the other pairs take them (correlation_bwd_wgmma.cu): each
      // lane keeps its largest score and first index (the first in
      // ascending order among equal ones); a row's reference moves where its
      // max passes it by LAZY_GAP (the max over its 4 lanes)
      float m_prev[2] = {mref[0], mref[1]};
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
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
        const bool rn = best[0] > mref[0] + LAZY_GAP || best[1] > mref[1] + LAZY_GAP;
        if (__any_sync(FULL, rn)) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = best[h];
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
            if (mx > mref[h] + LAZY_GAP) mref[h] = mx;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mg[gi][h] = mref[h];
          // 2^((m_old - m_new) log2e) where the row moved, 0 on its first move
          alpha[gi][h] = mref[h] != m_prev[h] ? mt::ex2((m_prev[h] - mref[h]) * LOG2E) : 1.f;
          m_prev[h] = mref[h];
        }
      }
    } else {
      // the reference stays for the pass; a lane whose largest score passed
      // its best finds the first key that holds it (keys 8 n + 2 t + e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pm[h] > best[h]) {
          int kl = 0;
#pragma unroll
          for (int n = NH / 8 - 1; n >= 0; --n)
#pragma unroll
            for (int e = 1; e >= 0; --e)
              if (s[4 * n + 2 * h + e] == pm[h]) kl = 8 * n + e;
          best[h] = pm[h];
          bidx[h] = key0 + 2 * t + kl;
        }
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) mg[gi][h] = mref[h];
      }
    }
    slow = NG > 1 && ht::warpgroup_any(moved, bar);

    // dS' = e (dP - c), e = 2^((s - m) log2e) against the reference after
    // the group, packed to bf16 A fragments over 16 keys each
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * (2 * gi + nt) + e, h = e >> 1;
          ds[e] = mt::ex2((s[i] - mg[gi][h]) * LOG2E) * (dp[i] - cval[h]);
        }
        f[gi][2 * nt] = mt::pack_bf16(ds[0], ds[1]);
        f[gi][2 * nt + 1] = mt::pack_bf16(ds[2], ds[3]);
      }
    // the rescale before the pass's first dq steps (pass p - 1's landed)
    if (moved) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[0][i] *= alpha[0][(i >> 1) & 1];
    }
  };

  ht::mbar_wait(qfull, 0);
#pragma unroll 1
  for (int p = 0; p < NP; ++p) step(p);
  issue_second(NP - 1);
  ht::wgmma_wait<0>();
  ht::fence_regs(acc[0]);

  // the end of the sweep
  bh::rows_finish<1, W>(acc, best, bidx, mref, cval, inv_d, d_ms, k, dq, stats, amax_out,
                        64 * wg + 16 * wq, row0, g, t, HW, Cq, boff, 0, true);
}

// =================================================================== K3 ==
// q and k channels in one block of W; [v | grid | 0] and dmain in DB blocks
// of CV (DB CV >= CV + 16), dv's columns in the first; NC consumer
// warpgroups.
template <int W, int CV, int NC>
struct ColsGeo {
  static constexpr int DB = (CV + 16 + CV - 1) / CV;
  static constexpr int BR = 64 * NC;        // keys a block
  static constexpr int KQ = W / 16;         // depth steps of k q^T
  static constexpr int KD = CV / 16 + 1;    // of [v | grid] dmain^T
  static constexpr int KBLK = BR * W * 2;   // bytes of the resident k tile
  static constexpr int GBLK = BR * CV * 2;  // of a resident [v | grid | 0] block
  static constexpr int QBLK = TKW * W * 2;  // of a chunk's q tile
  static constexpr int MBLK = TKW * CV * 2; // of a chunk's dmain block
  static constexpr int STAGE = QBLK + DB * MBLK;
  static constexpr int RESIDENT = KBLK + DB * GBLK;
  static_assert(W == 16 || W == 32 || W == 64, "a swizzle width");
  static_assert(CV == 16 || CV == 32 || CV == 64, "a swizzle width");
  static_assert(KBLK % 1024 == 0 && GBLK % 1024 == 0 && QBLK % 1024 == 0 && MBLK % 1024 == 0,
                "tiles on 1,024-byte boundaries");
};

// The resident tiles, the ring, then each stage's statistics (float4) and
// argmax (int) of its 64 rows; the barriers and the stages' counts follow.
template <int W, int CV, int NC, int ST>
__host__ __device__ constexpr size_t cols_region() {
  using G = ColsGeo<W, CV, NC>;
  return static_cast<size_t>(G::RESIDENT) + static_cast<size_t>(ST) * (G::STAGE + TKW * 20);
}

template <int W, int CV, int NC, int ST, int MINB, int NH>
__global__ void __launch_bounds__(128 * NC, MINB)
correlation_bwd_cols_narrow_kernel(const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tm,
                                   const bf16* __restrict__ v, const bf16* __restrict__ grid,
                                   const float* __restrict__ stats, const int* __restrict__ amax,
                                   float* __restrict__ dk, float* __restrict__ dv, int HW,
                                   int Cq, int Cv) {
  using G = ColsGeo<W, CV, NC>;
  constexpr int DB = G::DB;
  constexpr int NK = NH / 16;   // depth steps of 16 rows a pass
  constexpr int PT = TKW / NH;  // passes a chunk
  static_assert(ST >= 2, "a ring");
  extern __shared__ __align__(16) unsigned char nw_smem[];
  unsigned char* base = nw_smem + ((1024 - (ht::smem_u32(nw_smem) & 1023)) & 1023);
  unsigned char* ks = base;                  // [BR][W]: k
  unsigned char* vgs = ks + G::KBLK;         // DB blocks [BR][CV]: [v | grid | 0]
  unsigned char* ring = vgs + DB * G::GBLK;  // ST x (q tile, DB dmain blocks)
  float4* sts = reinterpret_cast<float4*>(ring + ST * G::STAGE);  // [ST][64] (lse, 1/d, c, d_ms)
  int* ams = reinterpret_cast<int*>(sts + ST * TKW);              // [ST][64] argmax
  uint64_t* full = reinterpret_cast<uint64_t*>(ams + ST * TKW);
  uint64_t* kfull = full + ST;
  int* done = reinterpret_cast<int*>(kfull + 1);  // [ST]: warps done with the stage's chunk

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * G::BR;  // the block's first key
  const int nT = (HW + TKW - 1) / TKW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t boff = static_cast<size_t>(b) * HW;

  // chunk u into its stage, by one whole warp: the chunk's statistics and
  // argmax, zeros past HW (such a row has q = dmain = c = 0, so P = 1 there
  // adds nothing to dv and its dS is 0), then q and dmain by TMA
  const auto load_chunk = [&](int u) {
    const int s = u % ST;
    unsigned char* st = ring + s * G::STAGE;
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
      ht::mbar_arrive_expect_tx(&full[s], G::QBLK + DB * G::MBLK);
      ht::tma_load_3d(st, &tq, &full[s], 0, u * TKW, b);
      for (int db = 0; db < DB; ++db)
        ht::tma_load_3d(st + G::QBLK + db * G::MBLK, &tm, &full[s], db * CV, u * TKW, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      ht::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    ht::mbar_init(kfull, 1);
    ht::mbar_fence_init();
  }
  __syncthreads();
  // no producer warpgroup: warp 0 brings in k and the first ST chunks, and
  // the last warp done with a stage brings the chunk ST on into it
  if (warp == 0) {
    if (lane == 0) {
      ht::mbar_arrive_expect_tx(kfull, G::KBLK);
      ht::tma_load_3d(ks, &tk, kfull, 0, col0, b);
    }
    for (int u = 0; u < ST && u < nT; ++u) load_chunk(u);
  }
  const auto release_chunk = [&](int u) {
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[u % ST], 1) == 4 * NC - 1;
    }
    if (__shfl_sync(FULL, last, 0)) {
      __threadfence_block();
      if (lane == 0) done[u % ST] = 0;
      if (u + ST < nT) load_chunk(u + ST);
    }
  };

  const int wg = warp >> 2, wq = warp & 3;  // keys 64 wg + 16 wq .. + 16 of the block
  const int g = lane >> 2, t = lane & 3;    // within them keys g and g + 8
  const int bar = 1 + wg;

  // [v | grid | 0] of the warpgroup's 64 keys
  bh::cols_vgrid<DB, CV, G::GBLK>(v, grid, vgs, wg, tid, col0, HW, Cv, boff);
  ht::fence_proxy_async();
  ht::warpgroup_sync(bar);

  constexpr uint32_t SWQ = ht::swizzle_code(2 * W), SWD = ht::swizzle_code(2 * CV);
  const uint64_t dk_base = ht::make_desc(ks + wg * 64 * W * 2, 16, 16 * W, SWQ);
  const uint64_t dg_base = ht::make_desc(vgs + wg * 64 * CV * 2, 16, 16 * CV, SWD);
  const int kw0 = col0 + 64 * wg + 16 * wq + g;  // this thread's keys kw0 and kw0 + 8

  float acc_k[1][W / 2], acc_v[1][CV / 2];  // key 16 wq + g + 8 (e / 2), column 8 n + 2 t + e % 2 at [0][4 n + e]
  ht::zero(acc_k[0]);
  ht::zero(acc_v[0]);
  float s[NH / 2], dp[NH / 2];  // a pass's S^T and dP^T: row 8 n + 2 t + e % 2 of the pass at [4 n + e]
  uint32_t pa[NK][4], da[NK][4];  // its P^T and dS^T fragments, 16 rows each
  const int NP = nT * PT;

  // S^T = k q^T and dP^T = [v | grid] dmain^T of pass p: rows TKW u + NH hh
  // .. + NH of chunk u
  const auto issue_first = [&](int p) {
    const int u = p / PT, hh = p - u * PT, su = u % ST;
    const unsigned char* st = ring + su * G::STAGE;
    if (hh == 0) ht::mbar_wait(&full[su], (u / ST) & 1);
    ht::wgmma_fence();
    const uint64_t dkd = ht::opaque(dk_base);
    const uint64_t dqd = ht::make_desc(st + hh * NH * 2 * W, 16, 16 * W, SWQ);
#pragma unroll
    for (int kq = 0; kq < G::KQ; ++kq)
      ht::wgmma_ss<NH>(s, dkd + ht::kstep<W>(kq, G::KBLK), dqd + ht::kstep<W>(kq, G::QBLK),
                       kq > 0 ? 1 : 0);
    const uint64_t dgd = ht::opaque(dg_base);
    const uint64_t dmd = ht::make_desc(st + G::QBLK + hh * NH * 2 * CV, 16, 16 * CV, SWD);
#pragma unroll
    for (int kd = 0; kd < G::KD; ++kd)
      ht::wgmma_ss<NH>(dp, dgd + ht::kstep<CV>(kd, G::GBLK), dmd + ht::kstep<CV>(kd, G::MBLK),
                       kd > 0 ? 1 : 0);
    ht::wgmma_commit();
  };

  // dk += dS^T q and dv += P^T dmain[:, :Cv] over pass p's rows, q and
  // dmain read MN-major from the same stage
  const auto issue_second = [&](int p) {
    const int u = p / PT, hh = p - u * PT;
    const unsigned char* st = ring + (u % ST) * G::STAGE;
    const uint64_t dqt = ht::make_desc(st, G::QBLK, 16 * W, SWQ);
    const uint64_t dmt = ht::make_desc(st + G::QBLK, G::MBLK, 16 * CV, SWD);
    ht::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int r16 = hh * NH + 16 * kk;  // the step's first row of the chunk
      ht::wgmma_rs<W, 1>(acc_k[0], da[kk], dqt + ((r16 * 2 * W) >> 4));
      ht::wgmma_rs<CV, 1>(acc_v[0], pa[kk], dmt + ((r16 * 2 * CV) >> 4));
    }
    ht::wgmma_commit();
  };

  // pass p: its S^T and dP^T issued beside pass p - 1's dk and dv steps,
  // then, every product landed, P^T = 2^(s log2e - lse) and dS^T = P^T
  // (dP^T - c), the max-score cotangent in a copy of dP^T where a row's
  // argmax is the key, packed to bf16 A fragments over 16 rows each
  const auto step = [&](int p) {
    const int u = p / PT, hh = p - u * PT;
    issue_first(p);
    if (p > 0) issue_second(p - 1);
    ht::wgmma_wait<0>();
    ht::fence_regs(s);
    ht::fence_regs(dp);
    ht::fence_regs(acc_k[0]);
    ht::fence_regs(acc_v[0]);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      ht::fence_regs(pa[kk]);
      ht::fence_regs(da[kk]);
    }
    // pass p - 1's stage is free once that pass was its chunk's last
    if (p > 0 && p % PT == 0) release_chunk(p / PT - 1);
    const float4* srow = sts + (u % ST) * TKW;
    const int* arow = ams + (u % ST) * TKW;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int il = hh * NH + 16 * kk + 8 * nt + 2 * t;
        const float4 st0 = srow[il], st1 = srow[il + 1];
        const int2 am = *reinterpret_cast<const int2*>(arow + il);  // il is even
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * (2 * kk + nt) + e;
          const float4 sx = (e & 1) ? st1 : st0;
          pv[e] = mt::ex2(fmaf(s[i], LOG2E, -sx.x));
          float dpe = dp[i];
          if (kw0 + 8 * (e >> 1) == ((e & 1) ? am.y : am.x)) dpe += sx.w;
          ds[e] = pv[e] * (dpe - sx.z);
        }
        pa[kk][2 * nt] = mt::pack_bf16(pv[0], pv[1]);
        pa[kk][2 * nt + 1] = mt::pack_bf16(pv[2], pv[3]);
        da[kk][2 * nt] = mt::pack_bf16(ds[0], ds[1]);
        da[kk][2 * nt + 1] = mt::pack_bf16(ds[2], ds[3]);
      }
    }
  };

  ht::mbar_wait(kfull, 0);
#pragma unroll 1
  for (int p = 0; p < NP; ++p) step(p);
  issue_second(NP - 1);
  ht::wgmma_wait<0>();
  ht::fence_regs(acc_k[0]);
  ht::fence_regs(acc_v[0]);

  bh::cols_store<1, W, 1, CV>(acc_k, acc_v, dk, dv, kw0, t, HW, Cq, Cv, boff, 0, 0, true, true);
}

// ============================================================ launches ==

using bh::Args;
using bh::ceil_div;

template <int W, int CV, int NC, int ST, int MINB, int NH>
cudaError_t launch_rows_narrow(const Args& a) {
  using G = RowsGeo<W, CV, NC>;
  static_assert(NH == 16 || NH == 32 || NH == 64, "keys a pass");
  if (a.Cq > W || a.Cv > CV) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_rows_narrow_kernel<W, CV, NC, ST, MINB, NH>;
  constexpr size_t smem = 1024 + rows_region<W, CV, NC, ST>() + (ST + 1) * 8 + ST * 4;
  cudaError_t e = bh::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  e = ht::encode_bf16_map(&tq, a.q, a.Cq, a.HW, a.B, W, G::BR);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tk, a.k, a.Cq, a.HW, a.B, W, TKW);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tv, a.v, a.Cv, a.HW, a.B, CV, TKW);
  if (e != cudaSuccess) return e;
  const dim3 blocks(ceil_div(a.HW, G::BR), a.B);
  kernel<<<blocks, 128 * NC, smem, a.stream>>>(tq, tk, tv, a.k, a.grid, a.out, a.dout,
                                                     a.dmain, a.stats, a.dq, a.amax, a.HW, a.Cq,
                                                     a.Cv, a.DM);
  return cudaGetLastError();
}

template <int W, int CV, int NC, int ST, int MINB, int NH>
cudaError_t launch_cols_narrow(const Args& a) {
  using G = ColsGeo<W, CV, NC>;
  static_assert(NH == 16 || NH == 32 || NH == 64, "rows a pass");
  if (a.Cq > W || a.Cv > CV) return cudaErrorInvalidValue;
  auto kernel = correlation_bwd_cols_narrow_kernel<W, CV, NC, ST, MINB, NH>;
  constexpr size_t smem = 1024 + cols_region<W, CV, NC, ST>() + (ST + 1) * 8 + ST * 4;
  cudaError_t e = bh::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap tk, tq, tm;
  e = ht::encode_bf16_map(&tk, a.k, a.Cq, a.HW, a.B, W, G::BR);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tq, a.q, a.Cq, a.HW, a.B, W, TKW);
  if (e == cudaSuccess) e = ht::encode_bf16_map(&tm, a.dmain, a.DM, a.HW, a.B, CV, TKW);
  if (e != cudaSuccess) return e;
  const dim3 blocks(ceil_div(a.HW, G::BR), a.B);
  kernel<<<blocks, 128 * NC, smem, a.stream>>>(tk, tq, tm, a.v, a.grid, a.stats, a.amax,
                                                     a.dk, a.dv, a.HW, a.Cq, a.Cv);
  return cudaGetLastError();
}

// The instantiations: q channels in a block of W, v's class CV, consumer
// warpgroups, ring stages, least blocks a SM, keys (K2) or rows (K3) a pass.
// Each width takes the smallest class that holds Cq and Cv (zeros pad the
// rest); every class of this list stands in
// ops/correlation.py::NARROW_WIDTH_CLASSES.
//
// Chosen with tools/torch_chip_studies.py k23-narrow-variants on an NVIDIA
// H100 80GB HBM3 at 700 W, the narrow and mma.sync pairs in turns in one
// call, every variant giving the package's bits (ms, HW = 6,256, B = 10
// unless stated):
// - C = 32: K2 four warpgroups in passes of 64 keys 0.3862-0.3971 (B = 90:
//   3.3324-3.4130), two blocks of two 0.4005-0.4038. A form that took e by
//   one FMA against m log2e was faster, 0.3803-0.3827 (3.2239-3.3040), with
//   two blocks of two 0.3865-0.3908 (3.1048-3.1718), but it gives other bits
//   than the plain backward's rounding and is not in this source (PERF.md).
//   K3 four warpgroups in passes of 32 rows with four stages 0.4441-0.4481
//   (3.8091-3.8154), three stages 0.4594-0.4598, five or six 0.4582-0.4604,
//   two blocks of two 0.4445-0.4492, three warpgroups in passes of 64
//   0.4962-0.4974 (3.5923-3.6016). The
//   mma.sync pair 0.4101-0.4126 and 0.3863-0.3878 (3.1828-3.2134 and
//   3.0367-3.0721), so the package keeps it at 32 channels, and at 16 / 32
//   (K2 0.3779-0.3786, K3 0.4127-0.4137 against 0.3573 and 0.3290-0.3295)
//   and 16 (0.3683-0.3714, 0.3921-0.3934 against 0.3424-0.3456,
//   0.2960-0.2975).
// - C = 64: K2 four warpgroups in passes of 32 0.5816-0.5829 (three in
//   passes of 64 0.5830-0.5847); K3 two warpgroups in passes of 64 (255
//   registers) 0.6390-0.6405 (four stages 0.6370-0.6413, three warpgroups in
//   passes of 32 0.6971-0.7007); mma.sync 0.7324-0.7345 and 0.8280-0.8288:
//   the class where the pair is ahead (outside
//   ops/correlation.py::MMA_SYNC_FASTER).
cudaError_t dispatch_rows_narrow(const Args& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_rows_narrow<16, 16, 4, 3, 1, 64>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_rows_narrow<16, 32, 4, 3, 1, 64>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_rows_narrow<32, 32, 4, 3, 1, 64>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_rows_narrow<64, 64, 4, 3, 1, 32>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_cols_narrow(const Args& a) {
  if (a.Cq <= 16 && a.Cv <= 16) return launch_cols_narrow<16, 16, 4, 4, 1, 32>(a);
  if (a.Cq <= 16 && a.Cv <= 32) return launch_cols_narrow<16, 32, 4, 4, 1, 32>(a);
  if (a.Cq <= 32 && a.Cv <= 32) return launch_cols_narrow<32, 32, 4, 4, 1, 32>(a);
  if (a.Cq <= 64 && a.Cv <= 64) return launch_cols_narrow<64, 64, 2, 3, 1, 64>(a);
  return cudaErrorInvalidValue;
}

bool narrow_takes(int B, int HW, int Cq, int Cv, int dtype) {
  return B >= 0 && HW >= 0 && B <= 65535 && dtype == 1 && Cq % 8 == 0 && Cv % 8 == 0 &&
         Cq >= 8 && Cv >= 8 && Cq <= 64 && Cv <= 64;
}

}  // namespace

// The narrow pair of the "mma" design: bf16 (dtype 1), Cq and Cv multiples
// of 8 from 8 to 64; q, k, v, dmain, stats, dq, dk, dv aligned to 16 bytes,
// the grid to 4. Arguments and outputs as correlation_bwd_rows_mma and
// correlation_bwd_cols_mma; cudaErrorInvalidValue for inputs they do not take.

// K2: dq [B, HW, Cq], stats [B, HW, 4] = (lse, 1/d, c, d_ms), amax [B, HW]
// int32 and dmain [B, HW, dmain_width(Cv)] bf16 from q, k, v, the grid, the
// forward's out and its cotangent dout (float32). One launch.
extern "C" int correlation_bwd_rows_narrow(const void* q, const void* k, const void* v,
                                           const void* grid, const void* out, const void* dout,
                                           void* dq, void* stats, void* amax, void* dmain, int B,
                                           int HW, int Cq, int Cv, int dtype, void* stream) {
  if (!narrow_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  return dispatch_rows_narrow(bh::make_args(q, k, v, grid, out, dout, dmain, stats, amax, dq,
                                          nullptr, nullptr, B, HW, Cq, Cv, stream));
}

// K3: dk [B, HW, Cq] and dv [B, HW, Cv] from q, k, v, the grid and what K2
// left (any pair's).
extern "C" int correlation_bwd_cols_narrow(const void* q, const void* k, const void* v,
                                           const void* grid, const void* dmain,
                                           const void* stats, const void* amax, void* dk, void* dv,
                                           int B, int HW, int Cq, int Cv, int dtype,
                                           void* stream) {
  if (!narrow_takes(B, HW, Cq, Cv, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || HW == 0) return cudaSuccess;
  return dispatch_cols_narrow(bh::make_args(q, k, v, grid, nullptr, nullptr, dmain, stats, amax,
                                          nullptr, dk, dv, B, HW, Cq, Cv, stream));
}
