// Batched Kabsch / Procrustes alignment, one problem a thread, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package solves it in plain JAX
// (mapfree_tpu/geom/procrustes.py::procrustes, with
// mapfree_tpu/geom/smallblas.py::svd3), which XLA fuses into a few
// programs. The port's tensor version (geom/procrustes.py, geom/smallblas.py)
// runs the same fixed sweeps as some 1,090 tiny PyTorch operations, each a
// kernel of a few bytes behind some 15 us of host time: the host's enqueue,
// not the card, bounded the regression head. This kernel does all of
// procrustes in one launch for the calls that record no gradient (the sweeps,
// validation, the matching track's solvers); a training step's call keeps the
// tensor version, whose backward autograd derives.
//
// For problem i, with A, B [n, N, 3] and optional weights w [n, N] (all
// float32, row-major contiguous), it computes, as geom/procrustes.py does:
//
//   the means (weighted: sum(w x) / max(sum w, 1e-9)), the centred points
//   (A's times w), H = A_c^T B_c;
//   H = U diag(S) V^T by smallblas.svd3: SWEEPS one-sided Jacobi sweeps over
//   the column pairs (0,1), (0,2), (1,2), each rotation branch-free with the
//   TINY guard; the column norms, a descending compare-swap sort, and the
//   orthonormal completion of columns whose singular value is at most
//   RANK_TOL times the largest (e_x, then e_y or e_z, then a cross product);
//   R = V diag(1, 1, sign det(U V^T)) U^T and t = b_mean - a_mean R^T,
//
// writing R [n, 3, 3] and t [n, 1, 3]. The arithmetic is float32 throughout
// and every step is taken: no early exit, no fewer sweeps. Each operation
// rounds on its own (the __f*_rn intrinsics: IEEE division and square root,
// and no contraction into fused multiply-adds), as the tensor version's
// elementwise operations do, and the comparisons keep torch.where's and
// torch.clamp's treatment of NaN, so a non-finite input gives a non-finite
// R as it does there (the PnP solver masks such hypotheses by it).
//
// Bound: the bytes, n N 24 in (n N 28 weighted) and n 48 out, are a few KB
// at the heads' shapes (n = 64 or 576, N = 3) and 38 MB at PnP's 262,144
// problems, 11 us at 3.35 TB/s; below that the launch's few microseconds
// bound it. A thread's work is a few thousand floating-point operations on
// registers. One thread a problem keeps every sweep in registers with no
// synchronisation; blocks of THREADS cover any n.

#include <cuda_runtime.h>

namespace {

constexpr int SWEEPS = 8;           // smallblas.svd3's sweeps
constexpr float TINY = 1e-30f;      // the rotation's guard and the norms' floor
constexpr float RANK_TOL = 1e-5f;   // the completion's tolerance, relative to S[0]
constexpr float WSUM_MIN = 1e-9f;   // the weighted mean's floor on sum(w)
constexpr int THREADS = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

// torch.sign: 0 for 0 and for NaN
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float floor_at(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// smallblas._jacobi_rotation: (c, s) zeroing the (p, q) entry of b^T b; the
// identity where |a_pq| < TINY
__device__ __forceinline__ void jacobi_rotation(float app, float aqq, float apq, float& c,
                                                float& s) {
  const bool tiny = fabsf(apq) < TINY;
  const float gamma = tiny ? TINY : apq;
  const float zeta = dvd(tiny ? 0.f : sub(aqq, app), mul(2.f, gamma));
  float t = dvd(sgn(zeta), add(fabsf(zeta), root(add(1.f, mul(zeta, zeta)))));
  if (tiny) t = 0.f;
  c = dvd(1.f, root(add(1.f, mul(t, t))));
  s = mul(c, t);
}

__device__ __forceinline__ void rotate(float* x, float* y, float c, float s) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float xr = x[r], yr = y[r];
    x[r] = sub(mul(c, xr), mul(s, yr));
    y[r] = add(mul(s, xr), mul(c, yr));
  }
}

__device__ __forceinline__ void swap_if(bool swap, float* x, float* y, int len) {
#pragma unroll
  for (int r = 0; r < len; ++r) {
    const float xr = x[r], yr = y[r];
    x[r] = swap ? yr : xr;
    y[r] = swap ? xr : yr;
  }
}

__device__ __forceinline__ void scale_to_unit(float* x, float norm) {
#pragma unroll
  for (int r = 0; r < 3; ++r) x[r] = dvd(x[r], norm);
}

__global__ void __launch_bounds__(THREADS)
kabsch_kernel(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ W, float* __restrict__ R_out,
              float* __restrict__ t_out, int n, int N) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const float* a = A + i * N * 3;
  const float* b = B + i * N * 3;
  const float* w = W ? W + i * N : nullptr;

  // means
  float a_mean[3] = {0.f, 0.f, 0.f}, b_mean[3] = {0.f, 0.f, 0.f}, wsum = 0.f;
  for (int k = 0; k < N; ++k) {
    const float wk = w ? w[k] : 1.f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      a_mean[r] = add(a_mean[r], w ? mul(a[3 * k + r], wk) : a[3 * k + r]);
      b_mean[r] = add(b_mean[r], w ? mul(b[3 * k + r], wk) : b[3 * k + r]);
    }
    if (w) wsum = add(wsum, wk);
  }
  // torch's mean multiplies the sum by 1 / N
  const float scale = w ? 0.f : dvd(1.f, static_cast<float>(N));
  wsum = floor_at(wsum, WSUM_MIN);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    a_mean[r] = w ? dvd(a_mean[r], wsum) : mul(a_mean[r], scale);
    b_mean[r] = w ? dvd(b_mean[r], wsum) : mul(b_mean[r], scale);
  }

  // H = A_c^T B_c, kept as its columns: col[j][r] = H[r][j]
  float col[3][3] = {};
  for (int k = 0; k < N; ++k) {
    float ac[3], bc[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ac[r] = sub(a[3 * k + r], a_mean[r]);
      if (w) ac[r] = mul(ac[r], w[k]);
      bc[r] = sub(b[3 * k + r], b_mean[r]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j) col[j][r] = add(col[j][r], mul(ac[r], bc[j]));
  }

  // one-sided Jacobi: col -> U diag(S), v -> V (columns)
  float v[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
#pragma unroll 1
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0;
      const int q = pair == 0 ? 1 : 2;
      float c, s;
      jacobi_rotation(dot3(col[p], col[p]), dot3(col[q], col[q]), dot3(col[p], col[q]), c, s);
      rotate(col[p], col[q], c, s);
      rotate(v[p], v[q], c, s);
    }
  }

  float S[3], u[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    S[j] = root(dot3(col[j], col[j]));
    const float d = floor_at(S[j], TINY);
#pragma unroll
    for (int r = 0; r < 3; ++r) u[j][r] = dvd(col[j][r], d);
  }

  // descending compare-swap network: (0,1), (0,2), (1,2)
#pragma unroll
  for (int pair = 0; pair < 3; ++pair) {
    const int x = pair == 2 ? 1 : 0;
    const int y = pair == 0 ? 1 : 2;
    const bool swap = S[x] < S[y];
    swap_if(swap, &S[x], &S[y], 1);
    swap_if(swap, u[x], u[y], 3);
    swap_if(swap, v[x], v[y], 3);
  }

  // orthonormal completion of the near-zero columns (smallblas.
  // _complete_orthonormal): U's columns U[0], U[1], U[2]
  const float tol = mul(RANK_TOL, floor_at(S[0], TINY));
  float U[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) U[0][r] = S[0] > tol ? u[0][r] : (r == 0 ? 1.f : 0.f);
  scale_to_unit(U[0], root(dot3(U[0], U[0])));

  const int fallback = fabsf(U[0][1]) < 0.9f ? 1 : 2;
#pragma unroll
  for (int r = 0; r < 3; ++r) U[1][r] = S[1] > tol ? u[1][r] : (r == fallback ? 1.f : 0.f);
  const float d01 = dot3(U[0], U[1]);
#pragma unroll
  for (int r = 0; r < 3; ++r) U[1][r] = sub(U[1][r], mul(d01, U[0][r]));
  scale_to_unit(U[1], floor_at(root(dot3(U[1], U[1])), TINY));

  float c01[3];
  cross3(U[0], U[1], c01);
#pragma unroll
  for (int r = 0; r < 3; ++r) U[2][r] = S[2] > tol ? u[2][r] : c01[r];
  scale_to_unit(U[2], floor_at(root(dot3(U[2], U[2])), TINY));

  // det(U V^T): M[r][c] = sum_k U[k][r] v[k][c]
  float M[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      M[r][c] = add(add(mul(U[0][r], v[0][c]), mul(U[1][r], v[1][c])), mul(U[2][r], v[2][c]));
  float m12[3];
  cross3(M[1], M[2], m12);
  const float sign = sgn(dot3(M[0], m12));

  // R = V diag(1, 1, sign) U^T: R[r][c] = sum_k v[k][r] sign_k U[k][c]
#pragma unroll
  for (int r = 0; r < 3; ++r) v[2][r] = mul(v[2][r], sign);
  float* R = R_out + i * 9;
  float Rr[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Rr[r][c] = add(add(mul(v[0][r], U[0][c]), mul(v[1][r], U[1][c])), mul(v[2][r], U[2][c]));
      R[3 * r + c] = Rr[r][c];
    }
  // t = b_mean - a_mean R^T
  float* t = t_out + i * 3;
#pragma unroll
  for (int r = 0; r < 3; ++r) t[r] = sub(b_mean[r], dot3(a_mean, Rr[r]));
}

}  // namespace

// A, B: [n, N, 3] float32; W: [n, N] float32 or null (unweighted); R: [n, 3,
// 3] and t: [n, 1, 3] float32, written. Launches on `stream`; returns a
// cudaError_t (0 on success).
extern "C" int kabsch(const void* A, const void* B, const void* W, void* R, void* t, int n,
                      int N, void* stream) {
  if (n < 0 || N < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int blocks = (n + THREADS - 1) / THREADS;
  kabsch_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(W), static_cast<float*>(R), static_cast<float*>(t), n, N);
  return cudaGetLastError();
}
