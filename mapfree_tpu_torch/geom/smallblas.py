"""Batched 3x3 determinant and SVD as straight-line tensor arithmetic.

The port of mapfree_tpu/geom/smallblas.py's ``det3`` and ``svd3``: a fixed
number of one-sided Jacobi sweeps, a compare-swap sort and an orthonormal
completion of rank-deficient columns, all branch-free. ``torch.linalg.svd``
is not used: on CUDA it may synchronise with the host, and on degenerate
input it would not pick the reference's singular vectors. Callers run it in
float32 with TF32 off (3x3 rotation algebra loses degrees under TF32).
"""

from __future__ import annotations

import torch


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
