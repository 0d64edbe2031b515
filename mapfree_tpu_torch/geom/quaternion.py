"""Quaternion algebra: numpy for pose extraction (``mat2quat``) and the
datasets' relative poses, torch for the models and losses.

The port's copy of mapfree_tpu/geom/quaternion.py, whose functions take
numpy or jax arrays alike: the numpy branch (``qinverse``, ``qconjugate``,
``qmult``, ``rotate_vector``, ``quat2mat``, ``mat2quat``, ``axangle2quat``,
``euler2quat``, ``relative_pose_wxyz``, ``convert_world2cam_to_cam2world``)
and, for torch
tensors, ``quat2mat_torch`` and ``mat2quat_torch`` (the multi-frame fusion
and the quaternion losses). Every
function takes a batch of leading axes. Convention: (w, x, y, z), scalar
first, as in the MapFree pose-file format.
"""

from __future__ import annotations

import numpy as np
import torch


def qinverse(q):
    """Inverse of quaternion(s) ``[..., 4]`` (conjugate / squared norm)."""
    conj = q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)
    return conj / np.sum(q * q, axis=-1, keepdims=True)


def qconjugate(q):
    return q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def qmult(q1, q2):
    """Hamilton product of quaternions ``[..., 4] x [..., 4] -> [..., 4]``."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def rotate_vector(v, q):
    """Rotate vector(s) ``[..., 3]`` by quaternion(s) ``[..., 4]``:
    v' = v + 2 r x (s v + r x v) / m, where q = (s, r) and m = |q|^2."""
    s = q[..., :1]
    r = q[..., 1:]
    m = np.sum(q * q, axis=-1, keepdims=True)
    cross1 = np.cross(r, v)
    cross2 = np.cross(r, s * v + cross1)
    return v + 2.0 * cross2 / m


def quat2mat(q):
    """Unit-normalised quaternion(s) ``[..., 4]`` -> rotation matrix ``[..., 3, 3]``."""
    q = np.asarray(q)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = np.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], axis=-1
    )
    row1 = np.stack(
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], axis=-1
    )
    row2 = np.stack(
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], axis=-1
    )
    return np.stack([row0, row1, row2], axis=-2)


def mat2quat(R):
    """Rotation matrix ``[..., 3, 3]`` -> quaternion ``[..., 4]`` with w >= 0.

    Computes all four Shepperd candidates and picks the largest pivot.
    """
    R = np.asarray(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(v):
        return np.sqrt(np.maximum(v, 1e-24))

    sw = _safe_sqrt(qw2) * 2.0
    cand_w = np.stack(
        [0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], axis=-1
    )
    sx = _safe_sqrt(qx2) * 2.0
    cand_x = np.stack(
        [(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], axis=-1
    )
    sy = _safe_sqrt(qy2) * 2.0
    cand_y = np.stack(
        [(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], axis=-1
    )
    sz = _safe_sqrt(qz2) * 2.0
    cand_z = np.stack(
        [(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], axis=-1
    )

    pivots = np.stack([qw2, qx2, qy2, qz2], axis=-1)
    choice = np.argmax(pivots, axis=-1)
    cands = np.stack([cand_w, cand_x, cand_y, cand_z], axis=-2)
    q = np.take_along_axis(cands, choice[..., None, None], axis=-2)[..., 0, :]
    sign = np.where(q[..., :1] < 0, -1.0, 1.0)  # canonical hemisphere: w >= 0
    q = q * sign
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def axangle2quat(vector, theta, is_normalized=False):
    """Axis-angle (3-vector, scalar angle) -> quaternion [4]."""
    vector = np.asarray(vector)
    if not is_normalized:
        vector = vector / np.linalg.norm(vector, axis=-1, keepdims=True)
    half = theta / 2.0
    return np.concatenate([np.atleast_1d(np.cos(half)), vector * np.sin(half)], axis=-1)


def euler2quat(ai, aj, ak):
    """Intrinsic sxyz Euler angles -> quaternion (as transforms3d.euler.euler2quat)."""
    ai, aj, ak = ai / 2.0, aj / 2.0, ak / 2.0
    ci, si = np.cos(ai), np.sin(ai)
    cj, sj = np.cos(aj), np.sin(aj)
    ck, sk = np.cos(ak), np.sin(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return np.array([cj * cc + sj * ss, cj * sc - sj * cs, cj * ss + sj * cc, cj * cs - sj * sc])


def relative_pose_wxyz(q1_wxyz, t1, q2_wxyz, t2):
    """Relative pose of world-to-camera poses (q1, t1) and (q2, t2): (q12,
    t12) with X_c2 = R(q12) X_c1 + t12 (reference:
    lib/utils/rotationutils.py:58-61)."""
    q12 = qmult(q2_wxyz, qinverse(q1_wxyz))
    t12 = t2 - rotate_vector(t1, q12)
    return q12, t12


def convert_world2cam_to_cam2world(q, t):
    """World-to-camera (q, t) -> camera-to-world (reference:
    benchmark/utils.py:12-15)."""
    qinv = qinverse(q)
    tinv = -rotate_vector(t, qinv)
    return qinv, tinv


def quat2mat_torch(q):
    """:func:`quat2mat` on a torch tensor ``[..., 4]`` (normalised first, so a
    zero quaternion gives NaN, as it does in the JAX package)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1)
    row1 = torch.stack(
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1)
    row2 = torch.stack(
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def mat2quat_torch(R):
    """:func:`mat2quat` on a torch tensor ``[..., 3, 3]``: the four Shepperd
    candidates, the largest pivot by ``argmax`` (the first of equal pivots,
    as in numpy and JAX), then w >= 0. Differentiable through the chosen
    candidate."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-24))

    sw = _safe_sqrt(qw2) * 2.0
    cand_w = torch.stack(
        [0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    sx = _safe_sqrt(qx2) * 2.0
    cand_x = torch.stack(
        [(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    sy = _safe_sqrt(qy2) * 2.0
    cand_y = torch.stack(
        [(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], dim=-1)
    sz = _safe_sqrt(qz2) * 2.0
    cand_z = torch.stack(
        [(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], dim=-1)

    choice = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4, 4]
    q = torch.take_along_dim(cands, choice[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)  # canonical hemisphere: w >= 0
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
