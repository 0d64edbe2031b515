"""Batched small-matrix algebra as straight-line tensor arithmetic.

The port of mapfree_tpu/geom/smallblas.py: ``det3`` and ``svd3`` (a fixed
number of one-sided Jacobi sweeps, a compare-swap sort and an orthonormal
completion of rank-deficient columns), and the RANSAC solvers' pieces:
``smallest_eigvecs`` (shifted inverse iteration through a Cholesky factor,
then modified Gram-Schmidt), ``det_small``, ``qr_solve`` and
``nullspace_qr`` (unrolled Householder sweeps). Everything is batched over
leading dimensions and branch-free. No ``torch.linalg`` factorisation is
used: on CUDA those check their result on the host (a synchronisation per
call), are slow for millions of tiny matrices, and on degenerate input would
not pick the reference's vectors. The products are written as
broadcast-multiply-sums, which float32 evaluates the same whatever the
process's TF32 settings are (3x3 rotation algebra loses degrees under TF32).
:func:`tf32_off` is the port's counterpart of the JAX module's
``f32_matmuls`` scope, for the callers whose products are matmuls and
convolutions.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved = None


@contextlib.contextmanager
def tf32_off():
    """TF32 off for float32 matmuls and cuDNN convolutions (cuDNN defaults to
    on) inside the block; the process's settings are restored after it.

    The flags are process-global and blocks may overlap on several threads
    (the matching track's adaptive ladder finishes on a pool thread), so the
    blocks share one count: the first to enter saves the settings, the last
    to leave restores them, and a block that leaves early cannot switch TF32
    back on under another still running."""
    global _tf32_depth, _tf32_saved
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved



def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def det3(A):
    """Closed-form determinant of [..., 3, 3] (scalar triple product)."""
    return torch.sum(A[..., 0, :] * _cross(A[..., 1, :], A[..., 2, :]), dim=-1)


def _jacobi_rotation(a_pp, a_qq, a_pq):
    """Branch-free Givens (c, s) zeroing the (p, q) off-diagonal entry.

    Where the entry is already (near) zero the rotation is the identity. In
    that branch the numerator is zeroed too, which leaves the value as it was
    (t = 0 either way) and keeps zeta finite: otherwise zeta ~ 1e30 overflows
    in zeta * zeta and autograd multiplies the branch's zero cotangent by an
    infinite derivative, which is NaN."""
    tiny = torch.abs(a_pq) < 1e-30
    gamma_safe = torch.where(tiny, torch.full_like(a_pq, 1e-30), a_pq)
    zeta = torch.where(tiny, torch.zeros_like(a_pq), a_qq - a_pp) / (2.0 * gamma_safe)
    t = torch.sign(zeta) / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
    t = torch.where(tiny, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, c * t


def _unit(i, like):
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def _complete_orthonormal(cols, S):
    """Replace the near-zero-singular-value columns (zero vectors after the
    B / S normalisation) with an orthonormal completion, as LAPACK does on
    rank-deficient input. ``cols``: three [..., 3] columns; S: [..., 3]."""
    tol = 1e-5 * torch.clamp(S[..., :1], min=1e-30)  # relative to the largest
    ex, ey, ez = (_unit(i, cols[0]) for i in range(3))

    c0 = torch.where(S[..., 0:1] > tol, cols[0], ex)
    c0 = c0 / torch.linalg.norm(c0, dim=-1, keepdim=True)

    fallback = torch.where(torch.abs(c0[..., 1:2]) < 0.9, ey, ez)
    c1 = torch.where(S[..., 1:2] > tol, cols[1], fallback)
    c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
    c1 = c1 / torch.clamp(torch.linalg.norm(c1, dim=-1, keepdim=True), min=1e-30)

    c2 = torch.where(S[..., 2:3] > tol, cols[2], _cross(c0, c1))
    c2 = c2 / torch.clamp(torch.linalg.norm(c2, dim=-1, keepdim=True), min=1e-30)
    return torch.stack([c0, c1, c2], dim=-1)


def svd3(A, sweeps: int = 8):
    """SVD of [..., 3, 3] matrices by one-sided Jacobi with fixed sweeps.

    Returns (U, S, Vt) with A = U @ diag(S) @ Vt, S descending and
    non-negative, U and V orthogonal (not necessarily proper rotations).
    """
    b = [A[..., :, i] for i in range(3)]  # columns of the working matrix
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    v = [eye[..., :, i] for i in range(3)]  # columns of V

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha = torch.sum(b[p] * b[p], dim=-1)
            beta = torch.sum(b[q] * b[q], dim=-1)
            gamma = torch.sum(b[p] * b[q], dim=-1)
            c, s = _jacobi_rotation(alpha, beta, gamma)
            c = c[..., None]
            s = s[..., None]
            b[p], b[q] = c * b[p] - s * b[q], s * b[p] + c * b[q]
            v[p], v[q] = c * v[p] - s * v[q], s * v[p] + c * v[q]

    S = torch.stack([torch.linalg.norm(col, dim=-1) for col in b], dim=-1)
    u = [b[i] / torch.clamp(S[..., i:i + 1], min=1e-30) for i in range(3)]
    s = [S[..., i] for i in range(3)]

    # sort singular values descending (3 elements: compare-swap network)
    def cswap(i, j):
        swap = s[i] < s[j]
        s[i], s[j] = torch.where(swap, s[j], s[i]), torch.where(swap, s[i], s[j])
        sw = swap[..., None]
        u[i], u[j] = torch.where(sw, u[j], u[i]), torch.where(sw, u[i], u[j])
        v[i], v[j] = torch.where(sw, v[j], v[i]), torch.where(sw, v[i], v[j])

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    S = torch.stack(s, dim=-1)
    # after the sort, rank-deficient columns are a suffix: the completion
    # never touches a column carrying a nonzero singular value
    U = _complete_orthonormal(u, S)
    Vt = torch.stack(v, dim=-2)  # rows of Vt are the columns of V
    return U, S, Vt


def _dot(a, b, dim=-1, keepdim=False):
    return torch.sum(a * b, dim=dim, keepdim=keepdim)


def _mgs(X):
    """Modified Gram-Schmidt orthonormalisation of [..., n, k] columns."""
    cols = []
    for i in range(X.shape[-1]):
        v = X[..., i]
        for u in cols:
            v = v - _dot(u, v, keepdim=True) * u
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)
        cols.append(v)
    return torch.stack(cols, dim=-1)


def _cholesky(M):
    """Lower Cholesky factor of symmetric positive-definite [..., n, n],
    column by column (NaN where M is not positive definite, as LAPACK's
    factor in the JAX package gives)."""
    n = M.shape[-1]
    cols = []  # columns of L, [..., n], zero above the diagonal
    rows = torch.arange(n, device=M.device)
    for j in range(n):
        s = M[..., :, j]
        if cols:
            C = torch.stack(cols, dim=-1)  # [..., n, j]
            s = s - _dot(C, C[..., j:j + 1, :])
        d = torch.sqrt(s[..., j:j + 1])
        cols.append(torch.where(rows >= j, s / d, torch.zeros_like(s)))
    return torch.stack(cols, dim=-1)


def _cho_solve(L, X):
    """Solve (L L^T) Y = X for [..., n, k] by forward then back substitution."""
    n = L.shape[-1]
    Y = []
    for i in range(n):
        acc = X[..., i, :]
        if i:
            acc = acc - _dot(L[..., i, :i, None], torch.stack(Y, dim=-2), dim=-2)
        Y.append(acc / L[..., i, i, None])
    Z = [None] * n
    for i in reversed(range(n)):
        acc = Y[i]
        if i + 1 < n:
            acc = acc - _dot(L[..., i + 1:, i, None], torch.stack(Z[i + 1:], dim=-2), dim=-2)
        Z[i] = acc / L[..., i, i, None]
    return torch.stack(Z, dim=-2)


def smallest_eigvecs(M, k: int = 1, iters: int = 6, shift: float = 1e-6):
    """Orthonormal basis [..., n, k] of the k smallest-eigenvalue directions
    of symmetric positive semi-definite [..., n, n] M, by ``iters`` steps of
    inverse iteration with a Tikhonov shift of ``shift`` * trace(M) (keeps
    the Cholesky factor well-posed when M is exactly singular, the usual case
    for minimal-sample nullspaces). Not a general eigh: on a near-spherical
    spectrum the iterate may land anywhere in the bottom subspace."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    tr = M.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    L = _cholesky(M + (shift * tr + 1e-30) * eye)
    # deterministic full-rank start: the last k identity columns plus a small
    # constant on every row, so no target direction is orthogonal to it
    X0 = torch.flip(eye[:, :k], dims=(0,)) + 0.01
    X = X0.expand(M.shape[:-2] + (n, k))
    for _ in range(iters):
        X = _mgs(_cho_solve(L, X))
    return X


def smallest_eigvec(M, iters: int = 6, shift: float = 1e-6):
    """[..., n] eigenvector of the smallest eigenvalue of PSD M."""
    return smallest_eigvecs(M, 1, iters, shift)[..., 0]


def _householder(a):
    """Reflection vector v (v[0] = a0 + sign(a0) |a|), |v|^2 (floored) and
    whether the column is non-zero, for a [..., m] column."""
    norm = torch.linalg.vector_norm(a, dim=-1)
    sgn = torch.where(a[..., 0] >= 0, 1.0, -1.0).to(a.dtype)
    v = torch.cat([a[..., :1] + (sgn * norm)[..., None], a[..., 1:]], dim=-1)
    vnorm2 = torch.clamp(_dot(v, v), min=1e-38)
    return v, vnorm2, norm > 1e-30


def _reflect(v, vnorm2, active, sub):
    """Apply I - 2 v v^T / |v|^2 to [..., m, p] where ``active``."""
    w = _dot(v[..., :, None], sub, dim=-2)  # [..., p]
    new = sub - (2.0 / vnorm2)[..., None, None] * (v[..., :, None] * w[..., None, :])
    return torch.where(active[..., None, None], new, sub)


def det_small(A):
    """Batched determinant of [..., n, n] by unrolled Householder QR, no
    pivoting; each active reflection contributes a factor -1."""
    n = A.shape[-1]
    R = A.clone()
    det_sign = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    for k in range(n - 1):
        v, vnorm2, active = _householder(R[..., k:, k])
        R[..., k:, k:] = _reflect(v, vnorm2, active, R[..., k:, k:])
        det_sign = det_sign * torch.where(active, -1.0, 1.0).to(A.dtype)
    return det_sign * torch.prod(R.diagonal(dim1=-2, dim2=-1), dim=-1)


def qr_solve(A, B):
    """Solve A @ X = B for [..., n, n] A and [..., n, m] B by unrolled
    Householder QR (no pivoting) and back substitution. A singular or badly
    scaled A gives non-finite values or a large residual; the callers mask
    such hypotheses by their score (RANSAC semantics)."""
    n = A.shape[-1]
    R = A.clone()
    Y = B.clone()
    for k in range(n - 1):
        v, vnorm2, active = _householder(R[..., k:, k])
        R[..., k:, k:] = _reflect(v, vnorm2, active, R[..., k:, k:])
        Y[..., k:, :] = _reflect(v, vnorm2, active, Y[..., k:, :])
    X = [None] * n
    for i in reversed(range(n)):
        acc = Y[..., i, :]
        if i + 1 < n:
            acc = acc - _dot(R[..., i, i + 1:, None], torch.stack(X[i + 1:], dim=-2), dim=-2)
        X[i] = acc / R[..., i, i, None]
    return torch.stack(X, dim=-2)


def nullspace_qr(A):
    """Orthonormal nullspace basis [..., n, n-m] of a full-row-rank wide
    [..., m, n] A: one Householder QR of A^T, whose trailing n-m columns of Q
    are the nullspace. A rank-deficient A (a degenerate minimal sample) gives
    columns the hypothesis scoring rejects."""
    m, n = A.shape[-2], A.shape[-1]
    R = A.transpose(-1, -2).clone()  # [..., n, m]
    vs = []
    for k in range(m):
        v, vnorm2, active = _householder(R[..., k:, k])
        R[..., k:, k:] = _reflect(v, vnorm2, active, R[..., k:, k:])
        pad = torch.zeros(A.shape[:-2] + (k,), dtype=A.dtype, device=A.device)
        vs.append((torch.cat([pad, v], dim=-1), vnorm2, active))
    # Q's trailing columns: H_0 ... H_{m-1} applied to the last n-m identity
    # columns (the reflections in reverse order)
    X = torch.eye(n, dtype=A.dtype, device=A.device)[:, m:].expand(A.shape[:-2] + (n, n - m))
    for v, vnorm2, active in reversed(vs):
        X = _reflect(v, vnorm2, active, X)
    return X
