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
// operations, not memory: the design keeps the [HW, HW] scores on chip
// (registers and shared memory) and reads each key/value tile once per
// 64-row query tile.
//
// Design (a first, simple version): one block of 256 threads per (batch,
// 64-row query tile). The block loops over all key tiles of 64 keys itself
// (the TPU's sequential key-chunk grid axis only existed to fit VMEM). Each
// tile of k (transposed) and [v | grid] is staged in shared memory as
// float32; thread (ty, tx) owns rows 4ty..4ty+3 and, for the scores,
// columns 4tx..4tx+3 of the tile. Row maxima reduce over the 16 lanes of a
// half-warp with shuffles; the running max, the denominator (per-lane
// partial sums, reduced once at the end) and the [rows, Cv+2] accumulator
// stay in float32 registers. The exponentials are exp2 of log2(e)-scaled
// scores. Arithmetic is scalar FMA: the tensor-core (wgmma) and TMA
// pipeline that would approach the bound is later work.
// Masking: keys past HW score -1e30 (the ragged last key tile); rows past
// HW are computed on zero queries and not stored (the ragged row tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TM = 64;        // query rows per block
constexpr int TK = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column lanes
constexpr int LD = TM + 4;    // padded row stride (floats) of qT, kT and P
constexpr int MAX_CPT = 8;    // accumulator columns per lane: Cv + 2 <= 128
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
correlation_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ grid,
                       float* __restrict__ out, int HW, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  const int CvP = Cv + 2;
  float* qT = smem;             // [Cq][LD]  query tile, transposed
  float* kT = qT + Cq * LD;     // [Cq][LD]  key tile, transposed
  float* vs = kT + Cq * LD;     // [TK][CvP] [v | grid] tile
  float* ps = vs + TK * CvP;    // [TM][LD]  probabilities of this key tile

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;  // lane within the half-warp that shares those rows

  const T* qb = q + static_cast<size_t>(b) * HW * Cq;
  const T* kb = k + static_cast<size_t>(b) * HW * Cq;
  const T* vb = v + static_cast<size_t>(b) * HW * Cv;

  for (int e = tid; e < TM * Cq; e += NT) {
    const int r = e / Cq, c = e - r * Cq;
    const int row = row0 + r;
    qT[c * LD + r] = row < HW ? to_f(qb[static_cast<size_t>(row) * Cq + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  for (int key0 = 0; key0 < HW; key0 += TK) {
    __syncthreads();  // the previous tile's kT, vs and ps are consumed
    for (int e = tid; e < TK * Cq; e += NT) {
      const int j = e / Cq, c = e - j * Cq;
      const int key = key0 + j;
      kT[c * LD + j] = key < HW ? to_f(kb[static_cast<size_t>(key) * Cq + c]) : 0.f;
    }
    for (int e = tid; e < TK * CvP; e += NT) {
      const int j = e / CvP, c = e - j * CvP;
      const int key = key0 + j;
      float x = 0.f;
      if (key < HW) {
        x = c < Cv ? to_f(vb[static_cast<size_t>(key) * Cv + c])
                   : to_f(grid[static_cast<size_t>(key) * 2 + (c - Cv)]);
      }
      vs[j * CvP + c] = x;
    }
    __syncthreads();

    // scores of rows 4ty.. against keys 4tx.. of this tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < Cq; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[c * LD + 4 * ty]);
      const float4 bk = *reinterpret_cast<const float4*>(&kT[c * LD + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], bv[jj], s[i][jj]);
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

    // acc[rows, cols tx + 16 cc] += P[rows, tile] . [v | grid][tile, cols]
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
          const float vv = col < CvP ? vs[(j + jj) * CvP + col] : 0.f;
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
        if (col < CvP) o[col] = acc[i][cc] * inv;
      }
      if (tx == 0) o[CvP] = inv;
    }
  }
}

template <typename T, int CPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* grid,
                   float* out, int B, int HW, int Cq, int Cv, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_fwd_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 blocks((HW + TM - 1) / TM, B);
  correlation_fwd_kernel<T, CPT><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(grid), out, HW, Cq, Cv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cpt, const void* q, const void* k, const void* v,
                     const void* grid, float* out, int B, int HW, int Cq, int Cv,
                     size_t smem, cudaStream_t stream) {
  switch (cpt) {
    case 1: return launch<T, 1>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    case 2: return launch<T, 2>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    case 3: return launch<T, 3>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    case 4: return launch<T, 4>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    case 5: return launch<T, 5>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    case 6: return launch<T, 6>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    case 7: return launch<T, 7>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    case 8: return launch<T, 8>(q, k, v, grid, out, B, HW, Cq, Cv, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int correlation_fwd(const void* q, const void* k, const void* v,
                               const void* grid, void* out, int B, int HW, int Cq,
                               int Cv, int dtype, void* stream) {
  if (B <= 0 || HW <= 0) return cudaSuccess;
  if (Cq <= 0 || Cv < 0) return cudaErrorInvalidValue;
  const int cpt = (Cv + 2 + 15) / 16;
  if (cpt > MAX_CPT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(Cq) * LD +
                                       static_cast<size_t>(TK) * (Cv + 2) +
                                       static_cast<size_t>(TM) * LD);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return dispatch<float>(cpt, q, k, v, grid, o, B, HW, Cq, Cv, smem, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(cpt, q, k, v, grid, o, B, HW, Cq, Cv, smem, s);
  return cudaErrorInvalidValue;
}
