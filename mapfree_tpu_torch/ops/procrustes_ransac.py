"""Batched 3D-3D registration: correspondence RANSAC over Kabsch, then
point-to-point ICP (port of mapfree_tpu/ops/procrustes_ransac.py).

The replacement for Open3D's registration_ransac_based_on_correspondence and
registration_icp (reference lib/models/matching/pose_solver.py:238-320):
3-point Kabsch hypotheses from the sampler's minimal samples, Euclidean
inlier counting, IRLS Kabsch refits of the best, and optionally 30 ICP
iterations with brute-force nearest neighbours over fixed-size subsampled
clouds (chunked: [B, 4096, 4096] float32 would be 4.3 GB). Batched over
pairs; see ops/essential.py for the float32 context.
"""

from __future__ import annotations

import numpy as np
import torch

from mapfree_tpu_torch.geom.procrustes import procrustes
from mapfree_tpu_torch.geom.projection import backproject_3d as backproject_3d_np
from mapfree_tpu_torch.ops.essential import backproject_3d, gather_depth, solver_context
from mapfree_tpu_torch.ops.ransac import pick, take_points

_MIN_POINTS = 3
_ICP_ITERS = 30
NN_CHUNK = 1024  # cloud-0 points matched at once: [B, chunk, N1] live


def _transform(R, t, X):
    """X @ R^T + t componentwise: R [..., 3, 3], t [..., 3], X [..., N, 3]."""
    R = R[..., None, :, :]
    t = t[..., None, :]
    return torch.stack([R[..., i, 0] * X[..., 0] + R[..., i, 1] * X[..., 1]
                        + R[..., i, 2] * X[..., 2] + t[..., i] for i in range(3)], dim=-1)


def _kabsch(A, B, w):
    """Weighted Kabsch over any leading dimensions: (R [..., 3, 3], t [..., 3])."""
    lead = A.shape[:-2]
    R, t = procrustes(A.reshape((-1,) + A.shape[-2:]), B.reshape((-1,) + B.shape[-2:]),
                      w.reshape((-1, w.shape[-1])))
    return R.reshape(lead + (3, 3)), t.reshape(lead + (3,))


def procrustes_ransac(idx, xyz0, xyz1, mask, max_corr_dist):
    """Rigid registration with known correspondences for a batch of pairs:
    idx [B, It, 3] minimal samples, xyz0, xyz1 [B, N, 3], mask [B, N].
    Returns (R [B, 3, 3], t [B, 3], inlier count [B], inliers [B, N])."""
    thr_sq = max_corr_dist * max_corr_dist
    Rs, ts = _kabsch(take_points(xyz0, idx), take_points(xyz1, idx),
                     take_points(mask, idx).to(xyz0.dtype))  # [B, It, ...]
    res = torch.sum((_transform(Rs, ts, xyz0[:, None]) - xyz1[:, None]) ** 2, dim=-1)
    inliers = (res < thr_sq) & mask[:, None]
    best = torch.argmax(torch.sum(inliers, dim=-1), dim=-1)

    # IRLS Kabsch refits of the best (Cauchy weights, sigma = thr / 3)
    sigma_sq = thr_sq / 9.0
    R_fin, t_fin = pick(Rs, best), pick(ts, best)
    res_fin, inl_fin = pick(res, best), pick(inliers, best)
    for _ in range(3):
        w = inl_fin.to(xyz0.dtype) / (1.0 + res_fin / sigma_sq)
        R_ref, t_ref = _kabsch(xyz0, xyz1, w)
        res_ref = torch.sum((_transform(R_ref, t_ref, xyz0) - xyz1) ** 2, dim=-1)
        inl_ref = (res_ref < thr_sq) & mask
        better = torch.sum(inl_ref, dim=-1) >= torch.sum(inl_fin, dim=-1)
        R_fin = torch.where(better[:, None, None], R_ref, R_fin)
        t_fin = torch.where(better[:, None], t_ref, t_fin)
        res_fin = torch.where(better[:, None], res_ref, res_fin)
        inl_fin = torch.where(better[:, None], inl_ref, inl_fin)
    return R_fin, t_fin, torch.sum(inl_fin, dim=-1), inl_fin


def _nearest(moved, cloud1, mask1):
    """Index and squared distance [B, N0] of each moved point's nearest valid
    point of cloud1, chunked over the moved points."""
    big = 1e12
    sq1 = torch.sum(cloud1 ** 2, dim=-1)[:, None, :]
    nn, nn_d2 = [], []
    for s in range(0, moved.shape[1], NN_CHUNK):
        m = moved[:, s:s + NN_CHUNK]
        d2 = torch.sum(m ** 2, dim=-1)[:, :, None] - 2.0 * (m @ cloud1.transpose(1, 2)) + sq1
        d2 = torch.where(mask1[:, None, :], d2, big)
        d, i = torch.min(d2, dim=-1)
        nn.append(i)
        nn_d2.append(d)
    return torch.cat(nn, dim=1), torch.cat(nn_d2, dim=1)


def icp_point_to_point(R0, t0, cloud0, mask0, cloud1, mask1, max_corr_dist,
                       n_iters: int = _ICP_ITERS):
    """Fixed-iteration point-to-point ICP with brute-force nearest neighbours
    (Open3D registration_icp, max_iteration=30): clouds [B, N, 3] with masks
    [B, N]; a step with fewer than 3 matches keeps the pose."""
    thr_sq = max_corr_dist * max_corr_dist
    R, t = R0, t0
    for _ in range(n_iters):
        nn, nn_d2 = _nearest(_transform(R, t, cloud0), cloud1, mask1)
        w = (mask0 & (nn_d2 < thr_sq)).to(cloud0.dtype)
        target = take_points(cloud1, nn)
        R_new, t_new = _kabsch(cloud0, target, w)
        ok = torch.sum(w, dim=-1) >= 3
        R = torch.where(ok[:, None, None], R_new, R)
        t = torch.where(ok[:, None], t_new, t)
    return R, t


def procrustes_pose(pts0, pts1, mask, depth0, depth1, K0, K1, max_corr_dist, sampler,
                    n_iters: int = 256, refine: bool = False, icp_cloud0=None,
                    icp_mask0=None, icp_cloud1=None, icp_mask1=None):
    """Batched metric pose from 3D-3D correspondences
    (ProcrustesSolver.estimate_pose, reference pose_solver.py:247-320).

    pts0, pts1 [B, N, 2] pixels, mask [B, N], depth0, depth1 [B, H, W],
    K0, K1 [B, 3, 3], ``max_corr_dist`` in metres, ``sampler`` the minimal
    samples. With ``refine``, ICP from the RANSAC pose over the clouds
    ``icp_cloud0/1`` [B, M, 3] with masks ``icp_mask0/1`` (built on the host
    from the full depth maps, :func:`dense_cloud_from_depth`). Returns a
    dict: R [B, 3, 3], t [B, 3], inliers [B], valid [B].
    """
    with solver_context():
        pts0_i, pts1_i = torch.floor(pts0), torch.floor(pts1)
        d0 = gather_depth(depth0, pts0_i)
        d1 = gather_depth(depth1, pts1_i)
        valid = mask & (d0 > 0) & (d1 > 0)
        xyz0 = backproject_3d(pts0_i, d0, K0)
        xyz1 = backproject_3d(pts1_i, d1, K1)
        idx = sampler("procrustes", valid, n_iters, 3)
        R, t, n, _ = procrustes_ransac(idx, xyz0, xyz1, valid, max_corr_dist)
        if refine:
            if icp_cloud0 is None:
                raise ValueError("refine=True requires the dense clouds")
            R, t = icp_point_to_point(R, t, icp_cloud0, icp_mask0, icp_cloud1, icp_mask1,
                                      max_corr_dist)
        ok = torch.sum(valid, dim=1) >= _MIN_POINTS
        return {"R": torch.where(ok[:, None, None], R, torch.nan),
                "t": torch.where(ok[:, None], t, torch.nan),
                "inliers": torch.where(ok, n, 0), "valid": ok}


def dense_cloud_from_depth(depth, K, max_points: int, seed: int = 0):
    """Host helper: a fixed-size cloud [max_points, 3] and its mask from a
    depth map [H, W] (numpy), subsampled without replacement by
    ``np.random.default_rng(seed)`` where it has more valid pixels."""
    H, W = depth.shape
    vv, uu = np.mgrid[0:H, 0:W]
    uv = np.stack([uu.reshape(-1), vv.reshape(-1)], axis=-1).astype(np.float32)
    d = depth.reshape(-1)
    valid = d > 0
    uv, d = uv[valid], d[valid]
    n = uv.shape[0]
    rng = np.random.default_rng(seed)
    if n > max_points:
        sel = rng.choice(n, size=max_points, replace=False)
        uv, d = uv[sel], d[sel]
        n = max_points
    cloud = np.zeros((max_points, 3), np.float32)
    maskv = np.zeros((max_points,), bool)
    if n > 0:
        cloud[:n] = backproject_3d_np(uv, d, K)
        maskv[:n] = True
    return cloud, maskv
