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
//   c_i   = sum_j dP_ij P_ij
//   dS_ij = P_ij (dP_ij - c_i)
//   dq_i  = sum_j dS_ij k_j                  (K2, one block per 64 rows i)
//   dk_j  = sum_i dS_ij q_i                  (K3, one block per 64 columns j)
//   dv_j  = sum_i P_ij dmain_i[:Cv]          (K3; the grid is a constant)
//
// What differs from the TPU kernels, and why:
// - K2 cannot hold a row of P: at HW = 6,256 a 64-row block's scores are
//   1.6 MB. It sweeps the key tiles twice. Sweep 1 keeps, per row, the running
//   max, the denominator and the first argmax (each of the 16 lanes that share
//   a row keeps its own state; they are merged once at the end, the smallest
//   index winning among equal maxima). Sweep 2 rebuilds P tile by tile, forms
//   dS and accumulates dq in registers.
// - c needs no sweep: out_i = sum_j P_ij [v|grid]_j and P at the argmax is
//   out_i[Cv+2], so c_i = dout_i . out_i over all Cv + 3 columns. The wrapper
//   hands K2 the forward's output for this.
// - K3 needs no atomics: one block owns one (batch, column tile), loops over
//   all row tiles itself and keeps its [64, Cq] and [64, Cv] sums in
//   registers. The order of the sums is fixed, so two runs give equal bits.
//   It reads the per-row statistics K2 wrote: the row max (log2 domain), the
//   reciprocal denominator, c, and the argmax as an int32.
// - Ragged edges are masked in both directions, not padded in memory: keys
//   and rows past HW contribute zero and are not stored.
//
// Scores are recomputed with the same fused multiply-adds in the same order
// in K2's two sweeps and in K3 (a*b commutes), so P_ij <= 1 holds bit for bit
// and the argmax K3 compares against is the one K2 found.
//
// Bound at the 3d3d training shape (B=10, HW=6,256, Cq=Cv=32, bf16): K2 does
// 2*B*HW^2*(32+34+32) = 7.7e10 FLOP in three products and B*HW^2 = 3.9e8
// exponentials; K3 does 2*B*HW^2*(32+34+32+32) = 1.0e11 FLOP in four products
// and as many exponentials. At 989 TFLOP/s (bf16 tensor cores) and 16
// exponentials per SM per clock both sit near 0.1 ms, set by operations: the
// inputs and outputs are some 20 MB (0.006 ms at 3.35 TB/s). Like the
// forward, this first version is scalar FMA on float32 tiles staged in shared
// memory: 256 threads as 16 x 16, each owning a 4 x 4 patch of the 64 x 64
// score tile. Tensor cores (wgmma), TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int TM = 64;      // tile edge: query rows and key columns per tile
constexpr int NT = 256;     // threads: 16 groups of 4 rows x 16 lanes of 4 columns
constexpr int LD = TM + 4;  // padded stride (floats) of every transposed tile
constexpr int MAX_CPT = 8;  // accumulator columns per lane: channels <= 128
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// dst[c * LD + r] = src[(row0 + r) * ld_src + c] for r < TM, c < C; rows past
// HW are zero.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src, int row0, int HW,
                                            int C, int ld_src, int tid) {
  for (int e = tid; e < TM * C; e += NT) {
    const int r = e / C, c = e - r * C;
    const int row = row0 + r;
    dst[c * LD + r] = row < HW ? to_f(src[static_cast<size_t>(row) * ld_src + c]) : 0.f;
  }
}

// dst[c * LD + r] = [v | grid][(row0 + r), c], transposed, zero past HW.
template <typename T>
__device__ __forceinline__ void load_vg_tile_t(float* dst, const T* vb, const T* grid,
                                               int row0, int HW, int Cv, int tid) {
  const int CvP = Cv + 2;
  for (int e = tid; e < TM * CvP; e += NT) {
    const int r = e / CvP, c = e - r * CvP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < HW) {
      x = c < Cv ? to_f(vb[static_cast<size_t>(row) * Cv + c])
                 : to_f(grid[static_cast<size_t>(row) * 2 + (c - Cv)]);
    }
    dst[c * LD + r] = x;
  }
}

// s[i][jj] = sum_c a[c][4 ty + i] * b[c][4 tx + jj], c ascending, one fma each
__device__ __forceinline__ void tile_product(const float* a, const float* b, int C,
                                             int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
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

// ---------------------------------------------------------------------- K2 --

template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
correlation_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ grid,
                            const float* __restrict__ out, const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ stats,
                            int* __restrict__ amax_out, int HW, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  const int CvP = Cv + 2;
  const int CO = Cv + 3;         // columns of out and dout
  float* qT = smem;              // [Cq][LD]   query tile (resident)
  float* dmT = qT + Cq * LD;     // [CvP][LD]  dmain tile (resident)
  float* kT = dmT + CvP * LD;    // [Cq][LD]   key tile
  float* vgT = kT + Cq * LD;     // [CvP][LD]  [v | grid] tile
  float* ps = vgT + CvP * LD;    // [TM][LD]   dS of this key tile

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;  // lane within the half-warp that shares those rows

  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const T* vb = v + boff * Cv;
  const float* ob = out + boff * CO;
  const float* dob = dout + boff * CO;

  load_tile_t(qT, qb, row0, HW, Cq, Cq, tid);
  load_tile_t(dmT, dob, row0, HW, CvP, CO, tid);

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
  for (int key0 = 0; key0 < HW; key0 += TM) {
    __syncthreads();  // the previous key tile is consumed (and qT, dmT are written)
    load_tile_t(kT, kb, key0, HW, Cq, Cq, tid);
    __syncthreads();
    float s[4][4];
    tile_product(qT, kT, Cq, ty, tx, s);
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
    if (tx == 0 && row < HW) {
      float* st = stats + (boff + row) * 3;
      st[0] = m[i];
      st[1] = inv_l[i];
      st[2] = cval[i];
      amax_out[boff + row] = bidx[i];
    }
  }

  // sweep 2: dS tile by tile, dq in registers
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;

  for (int key0 = 0; key0 < HW; key0 += TM) {
    __syncthreads();  // the previous tile's kT and ps are consumed
    load_tile_t(kT, kb, key0, HW, Cq, Cq, tid);
    load_vg_tile_t(vgT, vb, grid, key0, HW, Cv, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_product(qT, kT, Cq, ty, tx, s);
    tile_product(dmT, vgT, CvP, ty, tx, dp);
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
    __syncthreads();

    // acc[rows, cols tx + 16 cc] += dS[rows, tile] . k[tile, cols]
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
        if (col < Cq) {
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
      float* o = dq + (boff + row) * Cq;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = tx + 16 * cc;
        if (col < Cq) o[col] = acc[i][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------- K3 --

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
  float* kT = smem;              // [Cq][LD]   key tile of this block (resident)
  float* vgT = kT + Cq * LD;     // [CvP][LD]  [v | grid] tile (resident)
  float* qT = vgT + CvP * LD;    // [Cq][LD]   query tile of this row chunk
  float* dmT = qT + Cq * LD;     // [CvP][LD]  dmain tile of this row chunk
  float* ps = dmT + CvP * LD;    // [TM][LD]   P^T  [column j][row i]
  float* dss = ps + TM * LD;     // [TM][LD]   dS^T [column j][row i]
  float* r_m = dss + TM * LD;    // [TM] per-row statistics of this row chunk
  float* r_il = r_m + TM;
  float* r_c = r_il + TM;
  float* r_dms = r_c + TM;
  int* r_amax = reinterpret_cast<int*>(r_dms + TM);

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // columns j = col0 + 4*ty .. + 3 (rows of the tile)
  const int tx = tid & 15;  // rows i = row0 + 4*tx .. + 3 (columns of the tile)

  const size_t boff = static_cast<size_t>(b) * HW;
  const T* qb = q + boff * Cq;
  const T* kb = k + boff * Cq;
  const T* vb = v + boff * Cv;
  const float* dob = dout + boff * CO;

  load_tile_t(kT, kb, col0, HW, Cq, Cq, tid);
  load_vg_tile_t(vgT, vb, grid, col0, HW, Cv, tid);

  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      acc_k[a][cc] = 0.f;
      acc_v[a][cc] = 0.f;
    }

  for (int row0 = 0; row0 < HW; row0 += TM) {
    __syncthreads();  // the previous row chunk is consumed (and kT, vgT are written)
    load_tile_t(qT, qb, row0, HW, Cq, Cq, tid);
    load_tile_t(dmT, dob, row0, HW, CvP, CO, tid);
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
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_product(kT, qT, Cq, ty, tx, s);       // s[a][bb] = k_j . q_i
    tile_product(vgT, dmT, CvP, ty, tx, dp);   // dp[a][bb] = [v|grid]_j . dmain_i
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
    __syncthreads();

    // acc_k[cols j, ch] += dS^T[j, chunk] . q[chunk, ch]
    // acc_v[cols j, ch] += P^T[j, chunk] . dmain[chunk, ch]
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
        if (col < Cq) {
          const float4 t = *reinterpret_cast<const float4*>(&qT[col * LD + i]);
          const float qv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int a = 0; a < 4; ++a) acc_k[a][cc] = fmaf(dr[a][ii], qv[ii], acc_k[a][cc]);
        }
        if (col < Cv) {
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
      float* ok = dk + (boff + jg) * Cq;
      float* ov = dv + (boff + jg) * Cv;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int col = tx + 16 * cc;
        if (col < Cq) ok[col] = acc_k[a][cc];
        if (col < Cv) ov[col] = acc_v[a][cc];
      }
    }
  }
}

// ----------------------------------------------------------------- launches --

struct Args {
  const void *q, *k, *v, *grid;
  const float *out, *dout;
  float *dq, *dk, *dv, *stats;
  int* amax;
  int B, HW, Cq, Cv;
  cudaStream_t stream;
};

size_t rows_smem(int Cq, int Cv) {
  return sizeof(float) * static_cast<size_t>(LD) * (2 * Cq + 2 * (Cv + 2) + TM);
}

size_t cols_smem(int Cq, int Cv) {
  return sizeof(float) * (static_cast<size_t>(LD) * (2 * Cq + 2 * (Cv + 2) + 2 * TM) +
                          5 * TM);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int CPT>
cudaError_t launch_rows(const Args& a) {
  const size_t smem = rows_smem(a.Cq, a.Cv);
  const cudaError_t e = allow_smem(correlation_bwd_rows_kernel<T, CPT>, smem);
  if (e != cudaSuccess) return e;
  const dim3 blocks((a.HW + TM - 1) / TM, a.B);
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
  const dim3 blocks((a.HW + TM - 1) / TM, a.B);
  correlation_bwd_cols_kernel<T, CPT><<<blocks, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.grid), a.dout, a.stats, a.amax, a.dk, a.dv, a.HW, a.Cq,
      a.Cv);
  return cudaGetLastError();
}

// accumulator columns per lane, rounded up to 1, 2, 4 or 8 (0 if too wide)
int cpt_for(int channels) {
  const int need = (channels + 15) / 16;
  for (int cpt = 1; cpt <= MAX_CPT; cpt *= 2)
    if (need <= cpt) return cpt;
  return 0;
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
  return B < 0 || HW < 0 || Cq <= 0 || Cv <= 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Both return a cudaError_t (0 on success).

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
  if (cpt == 0 || rows_smem(Cq, Cv) > 227 * 1024) return cudaErrorInvalidValue;
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
  if (cpt == 0 || cols_smem(Cq, Cv) > 227 * 1024) return cudaErrorInvalidValue;
  Args a{q, k, v, grid, nullptr, static_cast<const float*>(dout), nullptr,
         static_cast<float*>(dk), static_cast<float*>(dv),
         const_cast<float*>(static_cast<const float*>(stats)),
         const_cast<int*>(static_cast<const int*>(amax)), B, HW, Cq, Cv,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_cols<float>(cpt, a);
  if (dtype == 1) return dispatch_cols<__nv_bfloat16>(cpt, a);
  return cudaErrorInvalidValue;
}
