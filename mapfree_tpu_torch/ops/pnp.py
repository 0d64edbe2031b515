"""Batched PnP (2D-3D) RANSAC with Gauss-Newton refinement (port of
mapfree_tpu/ops/pnp.py).

The replacement for cv.solvePnPRansac(SOLVEPNP_P3P) and the iterative
inlier refinement (reference lib/models/matching/pose_solver.py:175-235):
DLT (6-point, both bottom nullspace directions) and Lambda-Twist P3P
hypotheses from each minimal sample, reprojection scoring of every
hypothesis against every correspondence, then two rounds of damped
Gauss-Newton on the inliers; the ||t|| > 1000 guard is kept. Batched over
pairs; see ops/essential.py for the float32 context.
"""

from __future__ import annotations

import torch

from mapfree_tpu_torch.geom.procrustes import procrustes
from mapfree_tpu_torch.geom.rotation import inv_rodrigues, rodrigues
from mapfree_tpu_torch.geom.smallblas import det3, qr_solve, smallest_eigvecs, svd3
from mapfree_tpu_torch.ops.essential import (backproject_3d, gather_depth, jacobian,
                                             normalize_keypoints, solver_context)
from mapfree_tpu_torch.ops.ransac import pick, take_points

_MIN_PNP_POINTS = 4
_GN_ITERS = 10
_SAMPLE_SIZE = 6
SCORE_CHUNK = 512  # hypotheses scored at once: [B, chunk, N] live


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _pose_from_P(p, Xh, w):
    """Orthogonalise a projection estimate p [..., 12] into (R, t), its sign
    chosen so the weighted points lie in front; Xh [..., M, 4], w [..., M]."""
    P = p.reshape(p.shape[:-1] + (3, 4))
    depths = _dot(Xh, P[..., None, 2, :])
    sgn = torch.sign(torch.sum(torch.sign(depths) * w, dim=-1))
    sgn = torch.where(sgn == 0, 1.0, sgn)
    P = P * sgn[..., None, None]
    U, S, Vt = svd3(P[..., :3])
    R = U @ Vt
    R = R * torch.sign(det3(R))[..., None, None]
    scale = torch.sum(S, dim=-1) / 3.0
    return R, P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]


def _dlt_pose(X, x, w):
    """Weighted DLT for P = [R|t] from X [..., M, 3], normalized x [..., M, 2]
    and weights [..., M]: two candidates (R [..., 2, 3, 3], t [..., 2, 3]),
    one per direction of the bottom-2 subspace (coplanar points make the
    nullspace 2-dimensional; scoring picks)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    u, v = x[..., 0:1], x[..., 1:2]
    zeros = torch.zeros_like(Xh)
    row_u = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    row_v = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([row_u * w[..., None], row_v * w[..., None]], dim=-2)
    V = smallest_eigvecs(A.transpose(-1, -2) @ A, 2)
    R0, t0 = _pose_from_P(V[..., 0], Xh, w)
    R1, t1 = _pose_from_P(V[..., 1], Xh, w)
    return torch.stack([R0, R1], dim=-3), torch.stack([t0, t1], dim=-2)


def _one_real_cubic_root(c):
    """One real root of c0 x^3 + c1 x^2 + c2 x + c3 (c: [..., 4]): Cardano
    or the trigonometric form by the discriminant, then two Newton steps."""
    c0 = torch.where(torch.abs(c[..., 0]) < 1e-20, 1e-20, c[..., 0])
    a, b, d = c[..., 1] / c0, c[..., 2] / c0, c[..., 3] / c0
    p = b - a * a / 3.0
    q = 2.0 * a ** 3 / 27.0 - a * b / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    def cbrt(x):
        return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)

    t_card = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq)
    pm = torch.clamp(p, max=-1e-20)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    acos_arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    t_trig = m * torch.cos(torch.arccos(acos_arg) / 3.0)
    x = torch.where(disc > 0, t_card, t_trig) - a / 3.0
    for _ in range(2):
        f = ((c0 * x + c[..., 1]) * x + c[..., 2]) * x + c[..., 3]
        fp = (3.0 * c0 * x + 2.0 * c[..., 1]) * x + c[..., 2]
        x = x - f / torch.where(torch.abs(fp) < 1e-20, 1e-20, fp)
    return x


def _null_axis(D):
    """Unit null vector of a (near) rank-2 symmetric [..., 3, 3]: the largest
    cross product of two rows."""
    crosses = torch.stack([_cross(D[..., 0, :], D[..., 1, :]), _cross(D[..., 0, :], D[..., 2, :]),
                           _cross(D[..., 1, :], D[..., 2, :])], dim=-2)
    v = pick(crosses, torch.argmax(torch.linalg.vector_norm(crosses, dim=-1), dim=-1))
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)


def _pair_form(i, j, b):
    """The rank-2 form M with L^T M L = L_i^2 + L_j^2 - 2 b L_i L_j: [..., 3, 3]."""
    M = torch.zeros(b.shape + (3, 3), dtype=b.dtype, device=b.device)
    M[..., i, i] = 1.0
    M[..., j, j] = 1.0
    M[..., i, j] = -b
    M[..., j, i] = -b
    return M


def _quad(a, M, b):
    """a^T M b over leading dimensions."""
    return torch.sum(a[..., :, None] * M * b[..., None, :], dim=(-2, -1))


def _p3p_poses(X3, x3n):
    """Lambda-Twist P3P (Persson & Nordberg, ECCV 2018): X3 [..., 3, 3]
    points, x3n [..., 3, 2] normalized coords -> (R [..., 4, 3, 3],
    t [..., 4, 3], valid [..., 4]). One real root of the pencil's cubic, an
    eigensplit of the rank-2 form, two quadratics, two Newton steps on the
    depths, then Kabsch."""
    y = torch.cat([x3n, torch.ones_like(x3n[..., :1])], dim=-1)
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)  # bearings
    b12, b13, b23 = _dot(y[..., 0, :], y[..., 1, :]), _dot(y[..., 0, :], y[..., 2, :]), _dot(y[..., 1, :], y[..., 2, :])
    a12 = torch.sum((X3[..., 0, :] - X3[..., 1, :]) ** 2, dim=-1)
    a13 = torch.sum((X3[..., 0, :] - X3[..., 2, :]) ** 2, dim=-1)
    a23 = torch.sum((X3[..., 1, :] - X3[..., 2, :]) ** 2, dim=-1)
    M12, M13, M23 = _pair_form(0, 1, b12), _pair_form(0, 2, b13), _pair_form(1, 2, b23)
    D1 = M12 * a23[..., None, None] - M23 * a12[..., None, None]
    D2 = M13 * a23[..., None, None] - M23 * a13[..., None, None]

    def mix(which):  # det of the columns of D1 (0) or D2 (1)
        return det3(torch.stack([(D1 if w == 0 else D2)[..., :, k] for k, w in enumerate(which)], dim=-1))

    c3 = det3(D2)
    c2 = mix((0, 1, 1)) + mix((1, 0, 1)) + mix((1, 1, 0))
    c1 = mix((0, 0, 1)) + mix((0, 1, 0)) + mix((1, 0, 0))
    c0 = det3(D1)
    g = _one_real_cubic_root(torch.stack([c3, c2, c1, c0], dim=-1))
    D0 = D1 + g[..., None, None] * D2

    u3 = _null_axis(D0)
    one, zero = torch.ones_like(u3[..., 0]), torch.zeros_like(u3[..., 0])
    seed = torch.where((torch.abs(u3[..., 0]) < 0.9)[..., None],
                       torch.stack([one, zero, zero], -1), torch.stack([zero, one, zero], -1))
    w1 = _cross(u3, seed)
    w1 = w1 / torch.clamp(torch.linalg.vector_norm(w1, dim=-1, keepdim=True), min=1e-20)
    w2 = _cross(u3, w1)
    S00, S01, S11 = _quad(w1, D0, w1), _quad(w1, D0, w2), _quad(w2, D0, w2)
    tr, dif = S00 + S11, S00 - S11
    rad = torch.sqrt(torch.clamp(dif * dif + 4.0 * S01 ** 2, min=0.0))
    sig1, sig2 = (tr + rad) / 2.0, (tr - rad) / 2.0
    off = torch.abs(S01) > 1e-20 * torch.clamp(torch.abs(dif), min=1.0)
    e1 = torch.where(off[..., None], torch.stack([S01, sig1 - S00], -1),
                     torch.where((S00 >= S11)[..., None], torch.stack([one, zero], -1),
                                 torch.stack([zero, one], -1)))
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=1e-20)
    u1 = e1[..., 0:1] * w1 + e1[..., 1:2] * w2
    u2 = -e1[..., 1:2] * w1 + e1[..., 0:1] * w2

    s = torch.sqrt(torch.clamp(-sig2 / torch.where(torch.abs(sig1) < 1e-20, 1e-20, sig1), min=0.0))
    degenerate_cone = (sig2 > -1e-12 * torch.abs(sig1)) | (sig1 < 1e-12 * torch.abs(sig2))

    dirs, oks = [], []
    for sgn in (1.0, -1.0):
        n = u1 - sgn * s[..., None] * u2
        v1 = _cross(n, u3)
        v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True), min=1e-20)
        v2 = _cross(n, v1)
        v2 = v2 / torch.clamp(torch.linalg.vector_norm(v2, dim=-1, keepdim=True), min=1e-20)
        q11, q12, q22 = _quad(v1, D1, v1), _quad(v1, D1, v2), _quad(v2, D1, v2)
        disc = torch.clamp(q12 * q12 - q11 * q22, min=0.0)
        root = torch.sqrt(disc)
        q11s = torch.where(torch.abs(q11) < 1e-20, 1e-20, q11)
        dirs += [((-q12 + root) / q11s)[..., None] * v1 + v2,
                 ((-q12 - root) / q11s)[..., None] * v1 + v2]
        oks += [disc >= 0.0, disc >= 0.0]
    dirs = torch.stack(dirs, dim=-2)  # [..., 4, 3]
    ok = torch.stack(oks, dim=-1) & ~degenerate_cone[..., None]

    quad = _quad(dirs, M12[..., None, :, :], dirs)
    rho = torch.sqrt(a12[..., None] / torch.clamp(quad, min=1e-20))
    L = rho[..., None] * dirs
    L = L * torch.sign(torch.sum(L, dim=-1, keepdim=True))
    valid = ok & (quad > 1e-12) & (torch.amin(L, dim=-1) > 0)

    # two Newton steps on the three distance residuals
    a_vec = torch.stack([a12, a13, a23], dim=-1)[..., None, :]  # [..., 1, 3]
    Ms = torch.stack([M12, M13, M23], dim=-3)[..., None, :, :, :]  # [..., 1, 3, 3, 3]

    def resid(L):
        return _quad(L[..., None, :], Ms, L[..., None, :]) - a_vec

    for _ in range(2):
        r = resid(L)
        J = 2.0 * torch.sum(Ms * L[..., None, None, :], dim=-1)  # [..., 4, 3, 3]
        L_new = L - qr_solve(J, r[..., None])[..., 0]
        better = torch.sum(resid(L_new) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        L = torch.where(better[..., None], L_new, L)

    Z = L[..., None] * y[..., None, :, :]  # [..., 4, 3, 3] camera-frame points
    lead = Z.shape[:-2]
    R, t = procrustes(X3[..., None, :, :].expand(Z.shape).reshape(-1, 3, 3), Z.reshape(-1, 3, 3))
    R = R.reshape(lead + (3, 3))
    t = t.reshape(lead + (3,))
    valid = valid & torch.isfinite(R).flatten(-2).all(dim=-1) & torch.isfinite(t).all(dim=-1)
    return R, t, valid


def _camera_points(R, t, X):
    """X @ R^T + t componentwise: R [..., 3, 3], t [..., 3], X [..., N, 3]
    (a hypothesis's values do not depend on how many are computed at once)."""
    R = R[..., None, :, :]
    t = t[..., None, :]
    return [R[..., i, 0] * X[..., 0] + R[..., i, 1] * X[..., 1] + R[..., i, 2] * X[..., 2]
            + t[..., i] for i in range(3)]


def _reproj_residual_sq(R, t, X, x_norm):
    """Squared reprojection residual in normalized coords, [..., N]; 1e12
    behind the camera."""
    xc, yc, zc = _camera_points(R, t, X)
    z = torch.where(torch.abs(zc) < 1e-9, 1e-9, zc)
    err = (xc / z - x_norm[..., 0]) ** 2 + (yc / z - x_norm[..., 1]) ** 2
    return torch.where(zc <= 0, 1e12, err)


def _gauss_newton(R0, t0, X, x_norm, w, n_iters=_GN_ITERS, damping=1e-6):
    """Damped Gauss-Newton on (rvec, t) minimising the weighted reprojection
    error; a step is kept only if it lowers the cost."""
    params = torch.cat([inv_rodrigues(R0), t0], dim=-1)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)

    def residual(p):
        xc, yc, zc = _camera_points(rodrigues(p[..., :3]), p[..., 3:], X)
        z = torch.where(torch.abs(zc) < 1e-9, 1e-9, zc)
        r = torch.stack([(xc / z - x_norm[..., 0]) * w, (yc / z - x_norm[..., 1]) * w], dim=-1)
        return r.flatten(-2)  # [..., 2N], (u, v) interleaved as the reference

    for _ in range(n_iters):
        r, J = jacobian(residual, params)
        JtJ = J.transpose(-1, -2) @ J + damping * eye6
        delta = qr_solve(JtJ, J.transpose(-1, -2) @ r[..., None])[..., 0]
        new = params - delta
        better = torch.sum(residual(new) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        params = torch.where(better[..., None], new, params)
    return rodrigues(params[..., :3]), params[..., 3:]


def pnp_pose(pts0, pts1, mask, depth0, K0, K1, reproj_threshold, sampler,
             n_iters: int = 512, point_depths: bool = False):
    """Batched metric pose by PnP RANSAC + Gauss-Newton
    (PnPSolver.estimate_pose, reference pose_solver.py:184-235): back-project
    the map keypoints with the map depth, then find camera 1's pose of those
    points from their pixels in the query.

    pts0, pts1 [B, N, 2] pixels, mask [B, N], depth0 [B, H, W] (or [B, N]
    depths at floor(pts0) with ``point_depths``), K0, K1 [B, 3, 3],
    ``reproj_threshold`` in pixels, ``sampler`` the minimal samples. Returns
    a dict: R [B, 3, 3], t [B, 3], inliers [B], valid [B].
    """
    with solver_context():
        B, N, _ = pts0.shape
        pts0_i = torch.floor(pts0)
        d0 = depth0 if point_depths else gather_depth(depth0, pts0_i)
        valid = mask & (d0 > 0)
        X = backproject_3d(pts0_i, d0, K0)
        x1n = normalize_keypoints(pts1, K1)
        f_mean = (K1[:, 0, 0] + K1[:, 1, 1]) / 2.0
        thr_sq = (reproj_threshold / f_mean) ** 2  # [B]

        idx = sampler("pnp", valid, n_iters, _SAMPLE_SIZE)  # [B, It, 6]
        Xs, xs = take_points(X, idx), take_points(x1n, idx)
        Rs, ts = _dlt_pose(Xs, xs, take_points(valid, idx).to(X.dtype))
        R3, t3, ok3 = _p3p_poses(Xs[..., :3, :], xs[..., :3, :])
        eye = torch.eye(3, dtype=X.dtype, device=X.device)
        R3 = torch.where(ok3[..., None, None], R3, eye)
        t3 = torch.where(ok3[..., None], t3, 1e9)
        Rs = torch.cat([Rs.flatten(1, 2), R3.flatten(1, 2)], dim=1)  # [B, 6 It, 3, 3]
        ts = torch.cat([ts.flatten(1, 2), t3.flatten(1, 2)], dim=1)

        ts_ = thr_sq[:, None, None]
        scores = []
        for s in range(0, Rs.shape[1], SCORE_CHUNK):
            res = _reproj_residual_sq(Rs[:, s:s + SCORE_CHUNK], ts[:, s:s + SCORE_CHUNK],
                                      X[:, None], x1n[:, None])
            scores.append(torch.sum(torch.where(valid[:, None], torch.minimum(res, ts_), ts_), dim=-1))
        best = torch.argmin(torch.cat(scores, dim=1), dim=-1)
        R_fin, t_fin = pick(Rs, best), pick(ts, best)
        inl = valid & (_reproj_residual_sq(R_fin, t_fin, X, x1n) < thr_sq[:, None])

        for _ in range(2):
            R_ref, t_ref = _gauss_newton(R_fin, t_fin, X, x1n, inl.to(X.dtype))
            inl_ref = valid & (_reproj_residual_sq(R_ref, t_ref, X, x1n) < thr_sq[:, None])
            n_fin, n_ref = torch.sum(inl, dim=-1), torch.sum(inl_ref, dim=-1)
            ok = (n_fin >= 6) & (n_ref >= n_fin)
            R_fin = torch.where(ok[:, None, None], R_ref, R_fin)
            t_fin = torch.where(ok[:, None], t_ref, t_fin)
            inl = torch.where(ok[:, None], inl_ref, inl)

        ok = (torch.sum(valid, dim=1) >= _MIN_PNP_POINTS) & (
            torch.linalg.vector_norm(t_fin, dim=-1) <= 1000.0)
        R = torch.where(ok[:, None, None], R_fin, torch.nan)
        t = torch.where(ok[:, None], t_fin, torch.nan)
        n = torch.where(ok, torch.sum(inl, dim=-1), 0)
        return {"R": R, "t": t, "inliers": n, "valid": ok}
