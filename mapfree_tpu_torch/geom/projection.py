"""Pinhole projection and back-projection on numpy (the port's copy of the
numpy branch of mapfree_tpu/geom/projection.py). The datasets rescale their
intrinsics with :func:`correct_intrinsic_scale`."""

from __future__ import annotations

import numpy as np


def project(pts, K, img_size=None):
    """Project 3D points in camera coordinates to the image plane.

    Args:
        pts: [..., N, 3 or 4] points (homogeneous coordinate ignored).
        K: [..., 3, 3] intrinsics.
        img_size: optional (width, height) for border clamping.
    Returns:
        uv: [..., N, 2]
    """
    xyz = pts[..., :3]
    uv_h = xyz @ np.swapaxes(K, -1, -2)
    uv = uv_h[..., :2] / uv_h[..., 2:3]
    if img_size is not None:
        w, h = img_size
        uv = np.stack([np.clip(uv[..., 0], 0, w), np.clip(uv[..., 1], 0, h)], axis=-1)
    return uv


def backproject_3d(uv, depth, K):
    """Back-project pixel coordinates with depth to 3D camera coordinates.

    Args:
        uv: [..., N, 2] pixel coordinates.
        depth: [..., N] metric depth.
        K: [..., 3, 3] intrinsics.
    Returns:
        xyz: [..., N, 3]
    """
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    return rays * depth[..., None]


def correct_intrinsic_scale(K, scale_x, scale_y):
    """Rescale a 3x3 intrinsic matrix for resized images, including the
    half-pixel centre shift (reference: lib/datasets/utils.py:117-130)."""
    transform = np.asarray(
        [
            [scale_x, 0.0, scale_x / 2.0 - 0.5],
            [0.0, scale_y, scale_y / 2.0 - 0.5],
            [0.0, 0.0, 1.0],
        ],
        dtype=K.dtype,
    )
    return transform @ K
