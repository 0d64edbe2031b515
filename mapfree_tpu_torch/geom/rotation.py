"""Rotation representations on torch tensors: 6D-ortho, axis-angle
(Rodrigues) and extrinsic xyz Euler angles (port of
mapfree_tpu/geom/rotation.py).

- ``rotation_matrix_from_ortho6d``: the direct head's 6D rotation
  (reference lib/utils/rotationutils.py:34-55);
- ``rodrigues`` / ``inv_rodrigues``: axis-angle and back;
- ``euler_xyz_to_matrix`` / ``matrix_to_euler_xyz``: scipy's lowercase
  'xyz' (extrinsic) Euler angles in degrees, used by the angular-bins head
  and the bin losses (reference head.py:302-305, loss.py:47-56).

Everything is batched over leading axes and branch-free: the small-angle and
gimbal-lock cases are picked per element by ``torch.where``.
"""

from __future__ import annotations

import torch


def _normalize(x, eps):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def rotation_matrix_from_ortho6d(poses):
    """6D continuous rotation representation -> R.

    Args:
        poses: [B, 6], the raw x axis then the raw y axis.
    Returns:
        R: [B, 3, 3] with columns (x, y, z).
    """
    x_raw = poses[..., 0:3]
    y_raw = poses[..., 3:6]
    x = _normalize(x_raw, 1e-8)
    z = _normalize(torch.linalg.cross(x, y_raw, dim=-1), 1e-8)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def _skew(k):
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    return torch.stack([
        torch.stack([zero, -kz, ky], dim=-1),
        torch.stack([kz, zero, -kx], dim=-1),
        torch.stack([-ky, kx, zero], dim=-1),
    ], dim=-2)


def rodrigues(rvec):
    """Axis-angle vector(s) [..., 3] -> rotation matrix [..., 3, 3]; the
    identity where the angle is below 1e-12."""
    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True)  # [..., 1]
    K = _skew(rvec / torch.clamp(theta, min=1e-12))
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th > 1e-12, R, eye)


def inv_rodrigues(R):
    """Rotation matrix [..., 3, 3] -> axis-angle vector [..., 3]."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)[..., None]
    th = theta[..., None]
    scale = torch.where(sin_theta > 1e-7,
                        th / torch.clamp(2.0 * sin_theta, min=1e-12),
                        torch.full_like(th, 0.5))  # theta / (2 sin theta) -> 1/2
    return v * scale


def euler_xyz_to_matrix(angles_deg):
    """Extrinsic xyz Euler angles in degrees [..., 3] -> R [..., 3, 3]:
    R = Rz(c) @ Ry(b) @ Rx(a), as scipy's ``from_euler('xyz', ...,
    degrees=True)``."""
    a = torch.deg2rad(angles_deg)
    cx, sx = torch.cos(a[..., 0]), torch.sin(a[..., 0])
    cy, sy = torch.cos(a[..., 1]), torch.sin(a[..., 1])
    cz, sz = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rx = mat([(one, zero, zero), (zero, cx, -sx), (zero, sx, cx)])
    Ry = mat([(cy, zero, sy), (zero, one, zero), (-sy, zero, cy)])
    Rz = mat([(cz, -sz, zero), (sz, cz, zero), (zero, zero, one)])
    return Rz @ Ry @ Rx


def matrix_to_euler_xyz(R):
    """R [..., 3, 3] -> extrinsic xyz Euler angles in degrees [..., 3], the
    inverse of :func:`euler_xyz_to_matrix`. Where |cos(ay)| <= 1e-6 (gimbal
    lock) az is 0 and ax takes the whole in-plane angle."""
    ay = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    safe = torch.abs(torch.cos(ay)) > 1e-6
    ax = torch.where(safe, torch.atan2(R[..., 2, 1], R[..., 2, 2]),
                     torch.atan2(-R[..., 1, 2], R[..., 1, 1]))
    az = torch.where(safe, torch.atan2(R[..., 1, 0], R[..., 0, 0]),
                     torch.zeros_like(ay))
    return torch.rad2deg(torch.stack([ax, ay, az], dim=-1))
