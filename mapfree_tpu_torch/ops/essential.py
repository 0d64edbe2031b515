"""Batched essential-matrix estimation: 8- and 5-point RANSAC, cheirality,
metric scale (port of mapfree_tpu/ops/essential.py).

The replacement for OpenCV's findEssentialMat(USAC_MAGSAC) + recoverPose
(reference lib/models/matching/pose_solver.py:20-172), batched over pairs:
8-point and Nister 5-point hypotheses from the sampler's minimal samples,
MAGSAC-style scoring of every hypothesis against every correspondence,
top-K local optimisation with Gauss-Newton polish on the essential manifold,
a homography rescue for planar scenes, then metric scale from depth.

Every tensor carries the batch of pairs as its leading axis; the per-pair
functions of the JAX package (vmapped there) take any leading dimensions
here. The solvers run in float32 inside :func:`solver_context`: no autograd,
TF32 off for the matrix products (3x3 algebra and Sampson residuals lose
degrees under TF32, as under the TPU's bf16-rounded matmuls), so the result
does not depend on the process's TF32 flags.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from mapfree_tpu_torch.geom.rotation import inv_rodrigues, rodrigues
from mapfree_tpu_torch.geom.smallblas import (det3, nullspace_qr, qr_solve,
                                              smallest_eigvec, svd3, tf32_off)
from mapfree_tpu_torch.ops.ransac import (PrefixedSampler, inlier_mask, magsac_score,
                                          msac_score, pick, take_points)
from mapfree_tpu_torch.utils.data import fetch_later


@contextlib.contextmanager
def solver_context():
    """No autograd (forward-mode AD still works, unlike under inference
    mode, which the Gauss-Newton Jacobians need) and TF32 off."""
    with torch.no_grad(), tf32_off():
        yield


def normalize_keypoints(kpts, K):
    """Pixel -> normalized camera coordinates: kpts [..., N, 2], K [..., 3, 3]."""
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)[..., None, :]
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)[..., None, :]
    return (kpts - c) / f


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_rows(x0, x1):
    """Rows of the epipolar constraint x1^T E x0 = 0: [..., M, 9]."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    return torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                        torch.ones_like(u0)], dim=-1)


def _to_essential(E):
    """Project [..., 3, 3] onto the essential manifold: singular values
    (s, s, 0) with s the mean of the two largest."""
    U, S, Vt = svd3(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    diag = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * diag[..., None, :]) @ Vt


def _eight_point(x0, x1, w):
    """Weighted 8-point algorithm: x0, x1 [..., M, 2], w [..., M] -> E [..., 3, 3]."""
    A = _epipolar_rows(x0, x1) * w[..., None]
    e = smallest_eigvec(A.transpose(-1, -2) @ A)
    return _to_essential(e.reshape(e.shape[:-1] + (3, 3)))


# ------------------------------------------------------------ 5-point ------
# Nister's minimal problem by the Gauss-Jordan reduction of the JAX package
# (see mapfree_tpu/ops/essential.py for the derivation): the 10 cubic
# constraints' coefficients are interpolated from 20 fixed points, one 10x10
# QR solve expresses the high monomials through the low ones, det B(z) is a
# degree-10 polynomial from six coefficient products, its roots are
# bracketed on a tan(theta) grid and polished by 16-way subdivision, and
# (x, y) at each root is a cross product of two rows of B(z*). The constants
# below are the JAX package's, made by the same numpy calls.

_XY_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
             (1, 0), (0, 1), (0, 0)]
_XYZ_MONOS = [(a, b, c) for a, b in _XY_MONOS for c in range(0, 4 - a - b)]

_rng = np.random.default_rng(12345)
_EVAL_PTS = _rng.uniform(-1.0, 1.0, size=(20, 3))
_VANDER = np.stack([[p[0] ** a * p[1] ** b * p[2] ** c for a, b, c in _XYZ_MONOS]
                    for p in _EVAL_PTS])
_VANDER_INV = np.linalg.inv(_VANDER)
del _rng

_MAX_ROOTS = 10
_GRID = 257
_SUBDIV_ROUNDS = 4
_N_SUB = 16
_GRID_EPS = 1e-3
_GRID_THETAS = np.linspace(-np.pi / 2 + _GRID_EPS, np.pi / 2 - _GRID_EPS, _GRID)
_GRID_SC10 = np.stack([np.sin(_GRID_THETAS) ** k * np.cos(_GRID_THETAS) ** (10 - k)
                       for k in range(11)], axis=-1)  # [_GRID, 11]

_consts: dict = {}
_consts_lock = threading.Lock()


def _const(name: str, device, dtype=torch.float32):
    """The module's numpy constants as tensors, made once per device (a
    host-to-device copy each call would wait for the device)."""
    key = (name, str(device), dtype)
    t = _consts.get(key)
    if t is None:
        with _consts_lock:
            t = _consts.get(key)
            if t is None:
                arrays = {
                    "eval_pts": _EVAL_PTS, "vander_inv": _VANDER_INV,
                    "thetas": _GRID_THETAS, "sc10": _GRID_SC10,
                    "offs": np.arange(1, _N_SUB + 1) / _N_SUB,
                    "k11": np.arange(11),
                    "W": np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
                }
                t = _consts[key] = torch.as_tensor(
                    np.asarray(arrays[name]), dtype=dtype).to(device)
    return t


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _polymul(p, q):
    """Coefficient product of polynomials [..., m] x [..., n] -> [..., m+n-1]
    (``np.convolve`` per leading element)."""
    m, n = p.shape[-1], q.shape[-1]
    lead = torch.broadcast_shapes(p.shape[:-1], q.shape[:-1])
    out = torch.zeros(lead + (m + n - 1,), dtype=p.dtype, device=p.device)
    for i in range(m):
        out[..., i:i + n] += p[..., i:i + 1] * q
    return out


def _sc_eval10(p10, thetas):
    """The homogenised degree-10 polynomial p10 [..., 11] at thetas [..., R, S]."""
    k = _const("k11", p10.device, p10.dtype)
    s, c = torch.sin(thetas)[..., None], torch.cos(thetas)[..., None]
    basis = s ** k * c ** (10.0 - k)  # [..., R, S, 11]
    return torch.sum(basis * p10[..., None, None, :], dim=-1)


def _five_point_candidates(x0, x1):
    """Essential-matrix candidates from 5 normalized correspondences.

    x0, x1 [..., 5, 2] -> (Es [..., 10, 3, 3], valid [..., 10])."""
    dev, dtype = x0.device, x0.dtype
    lead = x0.shape[:-2]
    A = _epipolar_rows(x0, x1)  # [..., 5, 9]
    basis = nullspace_qr(A).transpose(-1, -2).reshape(lead + (4, 3, 3))

    # the 10 constraints at the 20 interpolation points
    p = _const("eval_pts", dev, dtype)  # [20, 3]
    E = (p[:, 0, None, None] * basis[..., None, 0, :, :]
         + p[:, 1, None, None] * basis[..., None, 1, :, :]
         + p[:, 2, None, None] * basis[..., None, 2, :, :]
         + basis[..., None, 3, :, :])  # [..., 20, 3, 3]
    EEt = E @ E.transpose(-1, -2)
    tr = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    T = 2.0 * (EEt @ E) - tr * E
    vals = torch.cat([T.reshape(T.shape[:-2] + (9,)), det3(E)[..., None]], dim=-1)  # [..., 20, 10]
    C = (_const("vander_inv", dev, dtype) @ vals).transpose(-1, -2)  # [..., 10, 20]

    # Gauss-Jordan: hi + X lo = 0 for the 10 high monomials
    X = qr_solve(C[..., :10], C[..., 10:])  # [..., 10, 10]
    hiZ = X[..., 5:10:2, :]  # rows of x^2 z, xyz, y^2 z
    hi0 = X[..., 4:9:2, :]  # rows of x^2, xy, y^2
    Bx = torch.stack([hiZ[..., 0], hiZ[..., 1] - hi0[..., 0], hiZ[..., 2] - hi0[..., 1],
                      -hi0[..., 2]], dim=-1)  # [..., 3, 4], z^0..z^3
    By = torch.stack([hiZ[..., 3], hiZ[..., 4] - hi0[..., 3], hiZ[..., 5] - hi0[..., 4],
                      -hi0[..., 5]], dim=-1)
    B1 = torch.stack([hiZ[..., 6], hiZ[..., 7] - hi0[..., 6], hiZ[..., 8] - hi0[..., 7],
                      hiZ[..., 9] - hi0[..., 8], -hi0[..., 9]], dim=-1)  # [..., 3, 5]

    pm = _polymul
    p10 = (pm(Bx[..., 0, :], pm(By[..., 1, :], B1[..., 2, :]) - pm(By[..., 2, :], B1[..., 1, :]))
           - pm(By[..., 0, :], pm(Bx[..., 1, :], B1[..., 2, :]) - pm(Bx[..., 2, :], B1[..., 1, :]))
           + pm(B1[..., 0, :], pm(Bx[..., 1, :], By[..., 2, :]) - pm(Bx[..., 2, :], By[..., 1, :])))
    p10 = p10 / torch.clamp(torch.amax(torch.abs(p10), dim=-1, keepdim=True), min=1e-30)

    thetas = _const("thetas", dev, dtype)
    f = p10 @ _const("sc10", dev, dtype).T  # [..., G]
    sign = torch.where(f >= 0, 1.0, -1.0)
    is_bracket = sign[..., :-1] * sign[..., 1:] < 0  # [..., G-1]
    # the earliest _MAX_ROOTS brackets (scores are distinct: no ties)
    order = torch.arange(_GRID - 1, device=dev, dtype=dtype) * (1.0 / _GRID)
    pick_score = is_bracket.to(dtype) * 2.0 - order
    bracket_idx = torch.topk(pick_score, _MAX_ROOTS, dim=-1).indices
    valid = torch.gather(is_bracket, -1, bracket_idx)
    lo = thetas[bracket_idx]
    hi = thetas[bracket_idx + 1]
    s_lo = torch.gather(sign, -1, bracket_idx)

    offs = _const("offs", dev, dtype)
    for _ in range(_SUBDIV_ROUNDS):
        ts = lo[..., None] + (hi - lo)[..., None] * offs  # [..., R, 16]
        signs = torch.where(_sc_eval10(p10, ts) >= 0, 1.0, -1.0)
        # the root lies before the first interior point whose sign differs
        # from s_lo; the hi end (always flipped) keeps argmax well-defined
        flipped = torch.cat([signs != s_lo[..., None], torch.ones_like(signs[..., :1], dtype=torch.bool)], dim=-1)
        ts_ext = torch.cat([ts, hi[..., None]], dim=-1)  # [..., R, 17]
        k = torch.argmax(flipped.to(torch.uint8), dim=-1)  # first flipped
        new_hi = torch.gather(ts_ext, -1, k[..., None])[..., 0]
        prev = torch.gather(ts_ext, -1, torch.clamp(k - 1, min=0)[..., None])[..., 0]
        lo = torch.where(k > 0, prev, lo)
        hi = new_hi
    theta_star = 0.5 * (lo + hi)

    # null vector of B(z*) from the most independent pair of its rows
    s, c = torch.sin(theta_star), torch.cos(theta_star)  # [..., R]
    ps3 = torch.stack([c ** 3, s * c ** 2, s ** 2 * c, s ** 3], dim=-1)  # [..., R, 4]
    ps4 = torch.stack([c ** 4, s * c ** 3, s ** 2 * c ** 2, s ** 3 * c, s ** 4], dim=-1)

    def at_roots(P, ps):  # [..., 3, d] x [..., R, d] -> [..., R, 3]
        return torch.sum(ps[..., :, None, :] * P[..., None, :, :], dim=-1)

    rows = torch.stack([c[..., None] * at_roots(Bx, ps3), c[..., None] * at_roots(By, ps3),
                        at_roots(B1, ps4)], dim=-1)  # [..., R, row, col]
    r0, r1, r2 = rows[..., 0, :], rows[..., 1, :], rows[..., 2, :]
    crosses = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
    norms = torch.linalg.vector_norm(crosses, dim=-1)  # [..., R, 3]
    v = pick(crosses, torch.argmax(norms, dim=-1))
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)

    # E ~ x E1 + y E2 + z E3 + E4, homogenised by v2 c
    coef = torch.stack([v[..., 0] * c, v[..., 1] * c, v[..., 2] * s, v[..., 2] * c], dim=-1)
    Es = torch.sum(coef[..., :, :, None, None] * basis[..., None, :, :, :], dim=-3)
    Es = _to_essential(Es)
    finite = torch.isfinite(Es).flatten(-2).all(dim=-1)
    valid = valid & finite & (torch.abs(Es).flatten(-2).amax(dim=-1) > 1e-12)
    eye = torch.eye(3, dtype=dtype, device=dev)
    return torch.where(valid[..., None, None], Es, eye), valid


def _homography_4pt(x0, x1, w):
    """Weighted DLT homography x1 ~ H x0 from [..., M, 2] points -> [..., 3, 3]."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    ones, zeros = torch.ones_like(u0), torch.zeros_like(u0)
    row_u = torch.stack([u0, v0, ones, zeros, zeros, zeros, -u1 * u0, -u1 * v0, -u1], dim=-1)
    row_v = torch.stack([zeros, zeros, zeros, u0, v0, ones, -v1 * u0, -v1 * v0, -v1], dim=-1)
    A = torch.cat([row_u * w[..., None], row_v * w[..., None]], dim=-2)
    h = smallest_eigvec(A.transpose(-1, -2) @ A)
    return h.reshape(h.shape[:-1] + (3, 3))


def homography_pose_candidates(H):
    """Faugeras decomposition of a calibrated homography [..., 3, 3] into 4
    (R, t) candidates: (Rs [..., 4, 3, 3], ts [..., 4, 3] unit, up to sign)."""
    U, S, Vt = svd3(H)
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    s = (det3(U) * det3(Vt))[..., None, None]
    denom = torch.clamp(d1 ** 2 - d3 ** 2, min=1e-12)
    x1 = torch.sqrt(torch.clamp(d1 ** 2 - d2 ** 2, min=0.0) / denom)
    x3 = torch.sqrt(torch.clamp(d2 ** 2 - d3 ** 2, min=0.0) / denom)
    d2_safe = torch.clamp(d2, min=1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    Rs, ts = [], []
    for e1, e3 in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
        sin_t = (d1 - d3) * x1 * x3 * e1 * e3 / d2_safe
        cos_t = (d1 * x3 ** 2 + d3 * x1 ** 2) / d2_safe
        Rp = torch.stack([torch.stack([cos_t, zero, -sin_t], -1),
                          torch.stack([zero, one, zero], -1),
                          torch.stack([sin_t, zero, cos_t], -1)], -2)
        tp = (d1 - d3)[..., None] * torch.stack([x1 * e1, zero, -x3 * e3], -1)
        Rs.append(s * U @ Rp @ Vt)
        t = torch.sum(U * tp[..., None, :], dim=-1)
        ts.append(t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12))
    return torch.stack(Rs, dim=-3), torch.stack(ts, dim=-2)


def sampson_sq(E, x0, x1):
    """Squared Sampson distance of the epipolar constraint: E [..., 3, 3],
    x0, x1 [..., N, 2] (leading dimensions broadcast) -> [..., N]."""
    x0h, x1h = _homogeneous(x0), _homogeneous(x1)
    Ex0 = x0h @ E.transpose(-1, -2)  # [..., N, 3]
    Etx1 = x1h @ E
    num = torch.sum(x1h * Ex0, dim=-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def sampson_sq_many(Es, x0, x1):
    """Squared Sampson distances of many hypotheses at once: Es [..., M, 3, 3],
    x0, x1 [..., N, 2] -> [..., M, N], by one [M, 9] x [9, N] product for the
    epipolar values and four [M, 3] x [3, N] products for the denominator."""
    x0h, x1h = _homogeneous(x0), _homogeneous(x1)
    cross = (x1h[..., :, :, None] * x0h[..., :, None, :]).flatten(-2).transpose(-1, -2)  # [..., 9, N]
    num = (Es.flatten(-2) @ cross) ** 2
    x0t, x1t = x0h.transpose(-1, -2), x1h.transpose(-1, -2)
    den = ((Es[..., 0, :] @ x0t) ** 2 + (Es[..., 1, :] @ x0t) ** 2
           + (Es[..., :, 0] @ x1t) ** 2 + (Es[..., :, 1] @ x1t) ** 2)
    return num / torch.clamp(den, min=1e-12)


def score_hypotheses(Es, hypo_ok, x0, x1, mask, thr_sq, chunk: int = 1024):
    """MAGSAC scores [B, M] of hypotheses Es [B, M, 3, 3], +inf where not
    ``hypo_ok``; chunked over hypotheses so the live residuals are [B, chunk, N]."""
    scores = []
    for s in range(0, Es.shape[1], chunk):
        res = sampson_sq_many(Es[:, s:s + chunk], x0, x1)
        scores.append(magsac_score(res, mask[:, None, :], thr_sq[:, None]))
    scores = torch.cat(scores, dim=1)
    return torch.where(hypo_ok, scores, torch.inf)


def _skew(v):
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def jacobian(fn, params):
    """Forward-mode Jacobian of ``fn`` [..., P] -> [..., R] at ``params``:
    [..., R, P]. The P tangent directions ride on a new leading axis, so
    ``fn`` must broadcast over leading dimensions. Needs autograd's forward
    mode, which inference mode turns off (use ``torch.no_grad``)."""
    P = params.shape[-1]
    eye = torch.eye(P, dtype=params.dtype, device=params.device)
    tangent = eye.reshape((P,) + (1,) * (params.dim() - 1) + (P,)).expand((P,) + params.shape)
    primal = params.expand((P,) + params.shape)
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(primal.contiguous(), tangent.contiguous()))
        value, J = fwAD.unpack_dual(out)
    if J is None:
        raise RuntimeError("forward-mode AD gave no tangent (inference mode is on?)")
    return value[0], torch.movedim(J, 0, -1)


def _make_E(params):
    R = rodrigues(params[..., :3])
    t = params[..., 3:]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return _skew(t) @ R


def refine_essential_gn(E0, x0, x1, weights, n_iters: int = 8, damping: float = 1e-8):
    """Gauss-Newton polish of E on the essential manifold, E = [t]x R(rvec):
    minimises the weighted Sampson residuals from the decomposition of E0
    whose [t]x R is nearest E0. E0 [..., 3, 3], x0, x1 [..., N, 2],
    weights [..., N]."""
    R1, R2, t = decompose_E(E0)

    def align(R):
        Ec = _skew(t) @ R
        scale = torch.sum(Ec * E0, dim=(-2, -1)) / torch.clamp(torch.sum(Ec * Ec, dim=(-2, -1)), min=1e-12)
        return torch.sum((scale[..., None, None] * Ec - E0) ** 2, dim=(-2, -1))

    R_init = torch.where((align(R1) < align(R2))[..., None, None], R1, R2)
    params = torch.cat([inv_rodrigues(R_init), t], dim=-1)
    eye6 = torch.eye(6, dtype=E0.dtype, device=E0.device)

    def residual(p):
        return torch.sqrt(sampson_sq(_make_E(p), x0, x1) + 1e-16) * weights

    for _ in range(n_iters):
        r, J = jacobian(residual, params)  # [..., N], [..., N, 6]
        JtJ = J.transpose(-1, -2) @ J + damping * eye6
        delta = qr_solve(JtJ, J.transpose(-1, -2) @ r[..., None])[..., 0]
        new = params - delta
        better = torch.sum(residual(new) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        params = torch.where(better[..., None], new, params)
    return _make_E(params)


def decompose_E(E):
    """E [..., 3, 3] -> (R1, R2, t) candidates via the SVD."""
    U, _, Vt = svd3(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = _const("W", E.device, E.dtype)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def _two_view_depths(R, t, x0, x1):
    """Least-squares depths (z0, z1) [..., N] of z1 f1 = z0 R f0 + t."""
    f0, f1 = _homogeneous(x0), _homogeneous(x1)
    Rf0 = f0 @ R.transpose(-1, -2)
    t = t[..., None, :]
    a = torch.sum(Rf0 * Rf0, dim=-1)
    b = -torch.sum(Rf0 * f1, dim=-1)
    d = torch.sum(f1 * f1, dim=-1)
    r0 = -torch.sum(Rf0 * t, dim=-1)
    r1 = torch.sum(f1 * t, dim=-1)
    det = a * d - b * b
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    return (d * r0 - b * r1) / det, (a * r1 - b * r0) / det


def cheirality_pose(E, x0, x1, mask, max_depth=1e9):
    """The (R, t) candidate of E with the most points in front of both
    cameras (cv.recoverPose): (R, t, count, mask of those points)."""
    R1, R2, t = decompose_E(E)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    z0, z1 = _two_view_depths(Rs, ts, x0[..., None, :, :], x1[..., None, :, :])
    ok = (z0 > 0) & (z1 > 0) & (z0 < max_depth) & (z1 < max_depth) & mask[..., None, :]
    counts = torch.sum(ok, dim=-1)
    best = torch.argmax(counts, dim=-1)
    return pick(Rs, best), pick(ts, best), pick(counts, best), pick(ok, best)


def _h_transfer_sq(H, x0, x1):
    """||x1 - proj(H x0)||^2 [..., N] for H [..., 3, 3] (componentwise, so a
    hypothesis's residuals do not depend on how many are scored at once)."""
    u, v = x0[..., 0], x0[..., 1]
    h = H[..., None, :, :]
    y0 = h[..., 0, 0] * u + h[..., 0, 1] * v + h[..., 0, 2]
    y1 = h[..., 1, 0] * u + h[..., 1, 1] * v + h[..., 1, 2]
    y2 = h[..., 2, 0] * u + h[..., 2, 1] * v + h[..., 2, 2]
    z = torch.where(torch.abs(y2) < 1e-12, 1e-12, y2)
    return (y0 / z - x1[..., 0]) ** 2 + (y1 / z - x1[..., 1]) ** 2


def estimate_homography(idx, x0, x1, mask, thr):
    """4-point homography RANSAC on normalized coords for the planar rescue.

    idx [B, It, 4] minimal samples, x0, x1 [B, N, 2], mask [B, N], thr [B].
    Returns (H [B, 3, 3], inliers [B, N], count [B])."""
    thr_sq = thr * thr
    Hs = _homography_4pt(take_points(x0, idx), take_points(x1, idx),
                         take_points(mask, idx).to(x0.dtype))  # [B, It, 3, 3]
    res = _h_transfer_sq(Hs, x0[:, None], x1[:, None])  # [B, It, N]
    scores = msac_score(res, mask[:, None, :], thr_sq[:, None])
    best = torch.argmin(scores, dim=-1)
    H_best, res_best = pick(Hs, best), pick(res, best)
    inl = inlier_mask(res_best, mask, thr_sq)
    H_ref = _homography_4pt(x0, x1, inl.to(x0.dtype))
    res_ref = _h_transfer_sq(H_ref, x0, x1)
    use = msac_score(res_ref, mask, thr_sq) < pick(scores, best)
    H_fin = torch.where(use[:, None, None], H_ref, H_best)
    inl_fin = inlier_mask(torch.where(use[:, None], res_ref, res_best), mask, thr_sq)
    return H_fin, inl_fin, torch.sum(inl_fin, dim=-1)


def homography_cheirality_pose(H, x0, x1, mask):
    """The best of H's 4 Faugeras candidates and their mirrored translations
    by two-view positive-depth count: (R, t, count)."""
    Rs, ts = homography_pose_candidates(H)
    Rs = torch.cat([Rs, Rs], dim=-3)
    ts = torch.cat([ts, -ts], dim=-2)
    z0, z1 = _two_view_depths(Rs, ts, x0[..., None, :, :], x1[..., None, :, :])
    counts = torch.sum((z0 > 0) & (z1 > 0) & mask[..., None, :], dim=-1)
    best = torch.argmax(counts, dim=-1)
    return pick(Rs, best), pick(ts, best), pick(counts, best)


FIVE_POINT_CHUNK = 512  # minimal samples per pair solved at once


def _minimal_essentials(x0, x1, mask, idx8, idx5):
    """Hypotheses [B, M, 3, 3] and their validity: one 8-point E per row of
    idx8 [B, It, 8], up to 10 five-point E's per row of idx5 [B, n5, 5]."""
    w = take_points(mask, idx8).to(x0.dtype)
    A = _epipolar_rows(take_points(x0, idx8), take_points(x1, idx8)) * w[..., None]
    e = nullspace_qr(A)[..., :, 0]  # minimal 8-point sample: nullity 1
    Es8 = _to_essential(e.reshape(e.shape[:-1] + (3, 3)))
    Es5, valid5 = [], []
    for s in range(0, idx5.shape[1], FIVE_POINT_CHUNK):
        sub = idx5[:, s:s + FIVE_POINT_CHUNK]
        E, v = _five_point_candidates(take_points(x0, sub), take_points(x1, sub))
        Es5.append(E.flatten(1, 2))
        valid5.append(v.flatten(1, 2))
    Es = torch.cat([Es8] + Es5, dim=1)
    ok8 = torch.ones(Es8.shape[:2], dtype=torch.bool, device=x0.device)
    return Es, torch.cat([ok8] + valid5, dim=1)


def _keep_better(use, new, old):
    return [torch.where(use.reshape(use.shape + (1,) * (a.dim() - use.dim())), a, b)
            for a, b in zip(new, old)]


def estimate_essential(x0, x1, mask, thr, idx8, idx5, lo_topk: int = 16):
    """Essential-matrix RANSAC for a batch of pairs.

    x0, x1 [B, N, 2] normalized, mask [B, N], thr [B] (normalized units),
    idx8 [B, It, 8] and idx5 [B, n5, 5] minimal samples. 8-point and 5-point
    hypotheses, MAGSAC-style scoring, local optimisation of the best
    ``lo_topk`` (reweighted 8-point refits, then Gauss-Newton), and an
    EM-style polish of the winner. Returns (E [B, 3, 3], inliers [B, N],
    valid [B]: at least 5 valid points)."""
    thr_sq = thr * thr
    Es, hypo_ok = _minimal_essentials(x0, x1, mask, idx8, idx5)
    scores = score_hypotheses(Es, hypo_ok, x0, x1, mask, thr_sq)

    top_idx = torch.topk(-scores, lo_topk, dim=-1).indices  # [B, K]
    E_cur = torch.gather(Es, 1, top_idx[..., None, None].expand(-1, -1, 3, 3))
    score_cur = torch.gather(scores, 1, top_idx)
    xa, xb, m = x0[:, None], x1[:, None], mask[:, None]  # broadcast over K
    ts = thr_sq[:, None]
    res_cur = sampson_sq_many(E_cur, x0, x1)  # [B, K, N]
    maskf = m.to(x0.dtype)
    for _ in range(3):
        # soft Cauchy weights with support wider than the inlier gate
        E_ref = _eight_point(xa, xb, maskf / (1.0 + res_cur / (4.0 * ts[..., None])))
        res_ref = sampson_sq(E_ref, xa, xb)
        score_ref = magsac_score(res_ref, m, ts)
        E_cur, res_cur, score_cur = _keep_better(
            score_ref < score_cur, (E_ref, res_ref, score_ref), (E_cur, res_cur, score_cur))
    for _ in range(2):
        E_gn = refine_essential_gn(E_cur, xa, xb, maskf / (1.0 + res_cur / ts[..., None]))
        res_gn = sampson_sq(E_gn, xa, xb)
        score_gn = magsac_score(res_gn, m, ts)
        E_cur, res_cur, score_cur = _keep_better(
            score_gn < score_cur, (E_gn, res_gn, score_gn), (E_cur, res_cur, score_cur))

    winner = torch.argmin(score_cur, dim=-1)
    E_fin, res_fin, score_fin = pick(E_cur, winner), pick(res_cur, winner), pick(score_cur, winner)
    maskf = mask.to(x0.dtype)
    for _ in range(2):
        E_em = refine_essential_gn(E_fin, x0, x1, maskf / (1.0 + res_fin / (4.0 * thr_sq[:, None])))
        res_em = sampson_sq(E_em, x0, x1)
        score_em = magsac_score(res_em, mask, thr_sq)
        E_fin, res_fin, score_fin = _keep_better(
            score_em < score_fin, (E_em, res_em, score_em), (E_fin, res_fin, score_fin))

    valid = torch.sum(mask, dim=-1) >= 5
    return E_fin, inlier_mask(res_fin, mask, thr_sq), valid


def _pack_outputs(R, t, inliers, adapt):
    """[B, 16] float32 = [R row-major (9) | t (3) | inliers (1) | adapt (3)]:
    everything a host consumer needs in one array, so one device-to-host copy."""
    B = R.shape[0]
    return torch.cat([R.reshape(B, 9), t.reshape(B, 3), inliers.reshape(B, 1).float(),
                      adapt.float()], dim=1)


def default_n5(n_iters: int) -> int:
    return max(n_iters // 4, 32)


def essential_pose(kpts0, kpts1, mask, K0, K1, pix_threshold, sampler,
                   n_iters: int = 512, n5: int | None = None):
    """Batched up-to-scale relative pose from 2D-2D correspondences
    (EssentialMatrixSolver.estimate_pose, reference pose_solver.py:29-61).

    kpts0, kpts1 [B, N, 2] pixels (padded), mask [B, N], K0, K1 [B, 3, 3],
    ``pix_threshold`` the RANSAC threshold in pixels, ``sampler`` the source
    of minimal samples (ops/ransac.py). Returns a dict: R [B, 3, 3], t [B, 3]
    (unit), inliers [B] (cheirality count), inlier_mask [B, N] (epipolar
    inliers), valid [B], adapt [B, 3] int32 ([epipolar inliers, valid
    correspondences, valid]) and packed [B, 16] (:func:`_pack_outputs`).
    """
    with solver_context():
        n5 = default_n5(n_iters) if n5 is None else n5
        x0 = normalize_keypoints(kpts0, K0)
        x1 = normalize_keypoints(kpts1, K1)
        f_mean = (K0[:, 0, 0] + K1[:, 1, 1] + K0[:, 1, 1] + K1[:, 0, 0]) / 4.0
        thr = pix_threshold / f_mean
        idx8 = sampler("essential8", mask, n_iters, 8)
        idx5 = sampler("essential5", mask, n5, 5)
        idxh = sampler("homography", mask, max(n_iters // 2, 64), 4)

        E, inl_e, valid = estimate_essential(x0, x1, mask, thr, idx8, idx5)
        R_e, t_e, n_e, _ = cheirality_pose(E, x0, x1, inl_e)
        # planar-degeneracy rescue (DEGENSAC's role): when one homography
        # explains almost every epipolar inlier, decompose it instead
        H, inl_h, n_h = estimate_homography(idxh, x0, x1, mask, thr)
        R_h, t_h, _ = homography_cheirality_pose(H, x0, x1, inl_h)
        overlap = torch.sum(inl_h & inl_e, dim=-1)
        planar = overlap >= 0.95 * torch.sum(inl_e, dim=-1)

        R = torch.where(planar[:, None, None], R_h, R_e)
        t = torch.where(planar[:, None], t_h, t_e)
        inl = torch.where(planar[:, None], inl_h, inl_e)
        n = torch.where(planar, n_h, n_e)
        R = torch.where(valid[:, None, None], R, torch.nan)
        t = torch.where(valid[:, None], t, torch.nan)
        n = torch.where(valid, n, 0)
        adapt = torch.stack([torch.sum(inl & mask, dim=1), torch.sum(mask, dim=1),
                             valid.long()], dim=1).to(torch.int32)
        return {"R": R, "t": t, "inliers": n, "inlier_mask": inl, "valid": valid,
                "adapt": adapt, "packed": _pack_outputs(R, t, n, adapt)}


def essential_pose_metric(kpts0, kpts1, mask, K0, K1, pix_threshold, d0, d1,
                          scale_threshold, sampler, variant: str = "ransac",
                          n_iters: int = 512, n5: int | None = None):
    """:func:`essential_pose` then metric scale from the depths d0, d1 [B, N]
    gathered at floor(kpts): ``t`` is metric, ``R`` is NaN where no inlier
    had valid depth, ``inliers`` is the scale consensus count."""
    out = essential_pose(kpts0, kpts1, mask, K0, K1, pix_threshold, sampler,
                         n_iters=n_iters, n5=n5)
    with solver_context():
        t_m, inl, ok = metric_scale_from_point_depths(
            out["R"], out["t"], kpts0, kpts1, out["inlier_mask"], d0, d1, K0, K1,
            scale_threshold, variant=variant)
        R = torch.where(ok[:, None, None], out["R"], torch.nan)
        return {"R": R, "t": t_m, "inliers": inl, "inlier_mask": out["inlier_mask"],
                "valid": out["valid"], "adapt": out["adapt"],
                "packed": _pack_outputs(R, t_m, inl, out["adapt"])}


def tier1_n5(n_iters: int) -> int:
    """Five-point samples of the adaptive ladder's first tier: n_iters / 2."""
    return max(n_iters // 2, 32)


def escalation(packed_host, n_iters: int, max_fail_prob: float = 0.01):
    """Which pairs of tier 1's packed result [B, 16] (numpy) go to tier 2:
    those whose probability of having missed every all-inlier sample at
    their observed inlier ratio w, (1 - w^5)^n5 (1 - w^8)^n8, exceeds
    ``max_fail_prob`` (USAC's adaptive termination, evaluated post hoc)."""
    n_inl = packed_host[:, 13]
    n_valid = np.maximum(packed_host[:, 14], 1)
    w = np.clip(n_inl / n_valid, 1e-3, 1 - 1e-3)
    log_fail = tier1_n5(n_iters) * np.log1p(-(w ** 5)) + n_iters * np.log1p(-(w ** 8))
    return (log_fail > np.log(max_fail_prob)) & (packed_host[:, 15] > 0)


def essential_pose_adaptive_async(kpts0, kpts1, mask, K0, K1, pix_threshold, sampler,
                                  n_iters: int = 512, max_fail_prob: float = 0.01,
                                  full_n5: int | None = None, point_depths=None):
    """Two-tier essential-matrix estimation: issues tier 1 now and returns
    ``finish() -> dict``, which waits for tier 1's packed result, decides
    which pairs escalate (:func:`escalation`), runs tier 2 on those and
    merges by epipolar-inlier count.

    Tier 1 is ``n_iters`` 8-point and ``n_iters / 2`` 5-point samples; tier
    2 is 5-point heavy (``full_n5``, default 2 ``n_iters``) on the escalated
    pairs gathered into a power-of-two sub-batch (padded with pair 0). With
    ``point_depths`` = (d0, d1, scale_threshold, variant) each tier runs
    :func:`essential_pose_metric`. Draws are tagged ``tier1/`` and
    ``tier2/``. The dict carries ``_host_packed``, the [B, 16] numpy result.

    ``finish`` may run on another thread. On the card, tier 1's result is
    copied to the host behind the solve on the stream the solve was issued
    on (the caller's current stream), ``finish`` waits on an event recorded
    there, and tier 2 is issued on that same stream.
    """
    if full_n5 is None:
        full_n5 = 2 * n_iters
    cuda = kpts0.device.type == "cuda"
    stream = torch.cuda.current_stream(kpts0.device) if cuda else None

    def solve(tier_sampler, g, n5):
        def sub(x):
            return x if g is None else x[g]
        args = tuple(sub(x) for x in (kpts0, kpts1, mask, K0, K1))
        if point_depths is None:
            return essential_pose(*args, pix_threshold, tier_sampler, n_iters=n_iters, n5=n5)
        d0, d1, scale_thr, variant = point_depths
        return essential_pose_metric(*args, pix_threshold, sub(d0), sub(d1), scale_thr,
                                     tier_sampler, variant=variant, n_iters=n_iters, n5=n5)

    B = kpts0.shape[0]
    out = solve(PrefixedSampler(sampler, "tier1/"), None, tier1_n5(n_iters))
    packed1, done1 = fetch_later(out["packed"])

    def finish():
        with (torch.cuda.stream(stream) if cuda else contextlib.nullcontext()):
            return _finish()

    def _finish():
        if done1 is not None:
            done1.synchronize()
        p1 = packed1.numpy().copy()
        need = escalation(p1, n_iters, max_fail_prob)
        out["escalated"] = int(need.sum())
        if not need.any():
            out["_host_packed"] = p1
            return out
        idx = np.nonzero(need)[0]
        bucket = min(1 << (len(idx) - 1).bit_length(), B)
        gather = np.concatenate([idx, np.zeros(bucket - len(idx), idx.dtype)])
        g = torch.as_tensor(gather, dtype=torch.long).to(kpts0.device)
        out_t = solve(PrefixedSampler(sampler, "tier2/"), g, full_n5)

        scatter = np.zeros(B, np.int64)
        scatter[idx] = np.arange(len(idx))
        s = torch.as_tensor(scatter).to(kpts0.device)
        n_inl_t = out_t["adapt"][s, 0]
        sel = (torch.as_tensor(need).to(kpts0.device)
               & (n_inl_t >= torch.as_tensor(p1[:, 13]).to(kpts0.device)))

        merged = {}
        for k in out:
            if k == "escalated":
                continue
            a, b = out[k], out_t[k][s]
            merged[k] = torch.where(sel.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)
        merged["escalated"] = out["escalated"]
        host, done = fetch_later(merged["packed"])
        if done is not None:
            done.synchronize()
        merged["_host_packed"] = host.numpy().copy()
        return merged

    return finish


def essential_pose_adaptive(*args, **kwargs):
    """Blocking form of :func:`essential_pose_adaptive_async`."""
    return essential_pose_adaptive_async(*args, **kwargs)()


def gather_depth(depth, kpts):
    """Depth maps [B, H, W] at integer keypoints [B, N, 2] (x, y; clamped
    into the image) -> [B, N]."""
    B, H, W = depth.shape
    x = torch.clamp(kpts[..., 0].long(), 0, W - 1)
    y = torch.clamp(kpts[..., 1].long(), 0, H - 1)
    return torch.gather(depth.reshape(B, H * W), 1, y * W + x)


def backproject_3d(uv, depth, K):
    """Pixels [B, N, 2] with depth [B, N] -> camera points [B, N, 3]."""
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1) * depth[..., None]


def metric_scale_from_depth(R, t_unit, kpts0, kpts1, inlier_m, depth0, depth1,
                            K0, K1, scale_threshold, variant: str = "ransac"):
    """Metric translation from depth maps [B, H, W], gathered at floor(kpts)."""
    d0 = gather_depth(depth0, torch.floor(kpts0))
    d1 = gather_depth(depth1, torch.floor(kpts1))
    return metric_scale_from_point_depths(R, t_unit, kpts0, kpts1, inlier_m, d0, d1,
                                          K0, K1, scale_threshold, variant=variant)


SCALE_CHUNK = 256  # scale hypotheses counted at once: [B, N, chunk] live


def metric_scale_from_point_depths(R, t_unit, kpts0, kpts1, inlier_m, d0, d1,
                                   K0, K1, scale_threshold, variant: str = "ransac"):
    """Metric norm of the translation from per-keypoint depths d0, d1 [B, N]
    (EssentialMatrixMetricSolver, reference pose_solver.py:64-172): back-
    project the epipolar inliers in both cameras, rotate cloud 0 into camera
    1's axes and project each correspondence's offset on the translation
    direction; aggregate by 1-D RANSAC over every correspondence's scale
    (``ransac``) or by the mean of the cloud means (``mean``).

    Returns (t_metric [B, 3], inliers [B], valid [B])."""
    kpts0_i, kpts1_i = torch.floor(kpts0), torch.floor(kpts1)
    valid_d = (d0 > 0) & (d1 > 0) & inlier_m
    xyz0 = backproject_3d(kpts0_i, d0, K0)
    xyz1 = backproject_3d(kpts1_i, d1, K1)
    xyz0r = xyz0 @ R.transpose(1, 2)

    if variant == "mean":
        w = valid_d.to(xyz0.dtype)[..., None]
        wsum = torch.clamp(w.sum(dim=1), min=1e-9)
        pmean0 = (xyz0r * w).sum(dim=1) / wsum
        pmean1 = (xyz1 * w).sum(dim=1) / wsum
        scale = torch.sum((pmean1 - pmean0) * t_unit, dim=-1)
        n_inl = torch.sum(valid_d, dim=1)
    else:
        scale_i = torch.sum((xyz1 - xyz0r) * t_unit[:, None, :], dim=-1)  # [B, N]
        counts = []
        for s in range(0, scale_i.shape[1], SCALE_CHUNK):
            diff = torch.abs(scale_i[:, :, None] - scale_i[:, None, s:s + SCALE_CHUNK])
            ok = valid_d[:, :, None] & valid_d[:, None, s:s + SCALE_CHUNK] & (diff < scale_threshold)
            counts.append(torch.sum(ok, dim=1))
        counts = torch.where(valid_d, torch.cat(counts, dim=1), -1)
        best = torch.argmax(counts, dim=-1)
        scale = pick(scale_i, best)
        n_inl = pick(counts, best)

    has_depth = torch.sum(valid_d, dim=1) >= 1
    t_metric = torch.where(has_depth[:, None], scale[:, None] * t_unit, torch.nan)
    n_inl = torch.where(has_depth, n_inl, 0)
    return t_metric, n_inl, has_depth
