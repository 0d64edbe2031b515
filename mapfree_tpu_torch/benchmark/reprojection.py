"""Virtual Correspondence Reprojection Error (VCRE; the port's copy of
mapfree_tpu/benchmark/reprojection.py).

Host-side float64 equivalent of reference benchmark/reprojection.py:32-87:
a fixed 7x4x7 virtual-object grid (0.3 m step, z offset 1.8 m) is projected
with GT pose and with the residual estimated-vs-GT transform; the metric is
the mean pixel displacement.
"""

from __future__ import annotations

import numpy as np

from mapfree_tpu_torch.geom.projection import project
from mapfree_tpu_torch.geom.quaternion import quat2mat


def get_grid_multipleheight() -> np.ndarray:
    ar_grid_step = 0.3
    ar_grid_num_x = 7
    ar_grid_num_y = 4
    ar_grid_num_z = 7
    ar_grid_z_offset = 1.8
    ar_grid_y_offset = 0

    ar_grid_x_pos = (np.arange(0, ar_grid_num_x) - (ar_grid_num_x - 1) / 2) * ar_grid_step

    ar_grid_y_pos = (np.arange(0, ar_grid_num_y) - (ar_grid_num_y - 1) / 2) * ar_grid_step
    ar_grid_y_pos += ar_grid_y_offset

    ar_grid_z_pos = np.arange(0, ar_grid_num_z).astype(float) * ar_grid_step
    ar_grid_z_pos += ar_grid_z_offset

    xx, yy, zz = np.meshgrid(ar_grid_x_pos, ar_grid_y_pos, ar_grid_z_pos)
    ones = np.ones(xx.size)
    eye_coords = np.concatenate(
        [c.reshape(-1, 1) for c in (xx, yy, zz, ones)], axis=-1
    )
    return eye_coords


# module-level singleton, mirrors the reference (benchmark/reprojection.py:60)
eye_coords_glob = get_grid_multipleheight()


def reprojection_error(q_est, t_est, q_gt, t_gt, K, W, H) -> float:
    eye_coords = eye_coords_glob

    uv_gt = project(eye_coords[:, :3], K, (W, H))

    cam2w_est = np.eye(4)
    cam2w_est[:3, :3] = quat2mat(np.asarray(q_est, dtype=np.float64))
    cam2w_est[:3, -1] = t_est
    cam2w_gt = np.eye(4)
    cam2w_gt[:3, :3] = quat2mat(np.asarray(q_gt, dtype=np.float64))
    cam2w_gt[:3, -1] = t_gt

    # residual reprojection
    eyes_residual = (np.linalg.inv(cam2w_est) @ cam2w_gt @ eye_coords.T).T
    uv_pred = project(eyes_residual[:, :3], K, (W, H))

    repr_err = np.linalg.norm(uv_gt - uv_pred, ord=2, axis=1)
    return float(repr_err.mean())
