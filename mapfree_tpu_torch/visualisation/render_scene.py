"""Per-scene render of GT vs estimated camera frustums (port of
mapfree_tpu/visualisation/render_scene.py), on the rasterizer of
:mod:`mapfree_tpu_torch.visualisation.raster`:

- solid shaded frustum meshes: reference camera (blue), GT query (green),
  estimate colored by pose error through a retro colormap and dimmed below
  the confidence threshold (reference render_scene.py:239-370);
- the query photo textured onto the GT frustum's image plane and blended
  picture-in-picture (reference render_util.py:32-105, render_scene.py:172);
- trajectory cuboids along the visited GT path + position markers
  (reference render_util.py:113-162);
- checkerboard ground plane (reference render_util.py:165-227);
- LazyCamera-smoothed observer.

:func:`render_frames` yields each frame as a tensor on the render device with
its title; :func:`render_scene` writes them to an MP4 with cv2, as the JAX
function does. Where cv2 does not import (the card's machine has none),
every frame is still rendered and counted, no MP4 is written, and one line
says so.
"""

from __future__ import annotations

import numpy as np
import torch

from mapfree_tpu_torch.data.io import _cv2
from mapfree_tpu_torch.geom.quaternion import quat2mat
from mapfree_tpu_torch.visualisation.lazy_camera import LazyCamera
from mapfree_tpu_torch.visualisation.raster import (
    Rasterizer,
    cuboid_from_line,
    frustum_corners,
    frustum_image_plane,
    frustum_mesh,
    ground_grid,
    position_marker,
    retro_colormap,
)

REF_COLOR = (90, 140, 235)
GT_COLOR = (80, 200, 120)
TRAJ_COLOR = (120, 120, 140)


def frustum_points(R_c2w, c, scale=0.2, aspect=0.75):
    """5 corner points (apex + 4 image-plane corners) of a camera frustum in
    world coordinates (kept as the public geometry helper)."""
    return frustum_corners(R_c2w, c, size=scale, aspect=aspect)


def error_color(t_err_m, r_err_deg, t_thresh=0.25, r_thresh=5.0):
    """Green at zero error -> red at/beyond the acceptance thresholds
    (matplotlib-style float RGB, kept for API compatibility)."""
    frac = _error_frac(t_err_m, r_err_deg, t_thresh, r_thresh)
    return (frac, 1.0 - frac, 0.1)


def _error_frac(t_err_m, r_err_deg, t_thresh=0.25, r_thresh=5.0):
    return max(min(t_err_m / t_thresh, 1.0), min(r_err_deg / r_thresh, 1.0))


def _meshes(parts):
    """Concatenate (tris, colors) pairs into one draw call: a draw call draws
    its triangles in order, so one call over the concatenation draws what
    the calls one after another draw."""
    return (np.concatenate([t for t, _ in parts]), np.concatenate([c for _, c in parts]))


def render_frames(scene_gt: dict, scene_est: dict, confidence_threshold: float = 0.0,
                  size=(960, 720), scene_images: dict | None = None, device="cuda"):
    """Yield ``(frame, title)`` per GT frame in frame order: ``frame`` the
    rendered uint8 [H, W, 3] RGB tensor on ``device`` (a copy), ``title`` the
    line the writer puts on it. Arguments as :func:`render_scene`'s."""
    frames = sorted(scene_gt.keys())
    if not frames:
        return

    W, H = size
    r = Rasterizer(W, H, device=device)
    cam = LazyCamera()

    # reference camera = identity (MapFree convention: seq0 frame is anchor)
    R_ref = np.eye(3)
    c_ref = np.zeros(3)

    centers = np.stack([np.asarray(scene_gt[f][1], np.float64) for f in frames])
    span = max(float(np.ptp(centers, axis=0).max()), 1.0)
    mid = centers.mean(axis=0)
    floor_y = float(centers[:, 1].max()) + 0.4
    grid_tris, grid_cols = ground_grid(mid, span * 1.6, floor_y)

    visited_gt = []
    visited_est = []

    for frame_num in frames:
        q_gt, t_gt, _ = scene_gt[frame_num]
        t_gt = np.asarray(t_gt, np.float64)
        R_gt = quat2mat(np.asarray(q_gt, np.float64))

        r.clear()
        cam.update(0.5 * (t_gt + c_ref))
        eye = cam.position
        r.set_view(eye, cam.center)

        r.draw_triangles(grid_tris, grid_cols, shade=False)

        # trajectory so far, markers at earlier estimate positions, and the
        # reference and GT frustums: one shaded draw call
        parts = [cuboid_from_line(a, b, TRAJ_COLOR)
                 for a, b in zip(visited_gt[:-1], visited_gt[1:])]
        parts += [position_marker(c_prev, retro_colormap(frac_prev))
                  for c_prev, frac_prev in visited_est]
        parts.append(frustum_mesh(R_ref, c_ref, REF_COLOR, size=0.35))
        parts.append(frustum_mesh(R_gt, t_gt, GT_COLOR))
        r.draw_triangles(*_meshes(parts))

        image = None if scene_images is None else scene_images.get(frame_num)
        if image is not None:
            image = torch.as_tensor(image, device=r.device)
            plane, uv = frustum_image_plane(R_gt, t_gt)
            r.draw_triangles(plane, np.zeros((2, 3)), shade=False,
                             texture=image, uvs=uv)

        if frame_num in scene_est:
            q_est, t_est, conf = scene_est[frame_num]
            t_est = np.asarray(t_est, np.float64)
            R_est = quat2mat(np.asarray(q_est, np.float64))
            t_err = float(np.linalg.norm(t_est - t_gt))
            cos = np.clip((np.trace(R_est.T @ R_gt) - 1) / 2, -1, 1)
            r_err = float(np.degrees(np.arccos(cos)))
            frac = _error_frac(t_err, r_err)
            col = retro_colormap(frac)
            if (conf or 0.0) < confidence_threshold:
                col = 0.35 * col + 0.65 * np.asarray(r.background, np.float64)
            tris, cols = frustum_mesh(R_est, t_est, col)
            r.draw_triangles(tris, cols)
            visited_est.append((t_est, frac))
            title = f"frame {frame_num}: terr={t_err:.2f}m rerr={r_err:.1f}deg"
        else:
            title = f"frame {frame_num}: no estimate"
        visited_gt.append(t_gt)

        if image is not None:
            r.blend_overlay(image)

        yield r.color.clone(), title


def render_scene(scene_gt: dict, scene_est: dict, output_path,
                 confidence_threshold: float = 0.0, fps: int = 5,
                 size=(960, 720), scene_images: dict | None = None,
                 figsize=None, device="cuda"):
    """Render one scene's estimates to MP4.

    Args:
        scene_gt: frame_num -> (q_c2w, t_c2w, _) ground truth (benchmark
            loader format).
        scene_est: frame_num -> (q_c2w, t_c2w, confidence) estimates.
        output_path: .mp4 path.
        scene_images: optional frame_num -> RGB uint8 query photo (numpy or
            a tensor), textured onto the GT frustum and blended
            picture-in-picture.
        figsize: accepted for backwards compatibility (inches at 120 dpi).
        device: where the frames are rendered (default: the card).
    Returns the number of frames rendered.
    """
    if figsize is not None:
        size = (int(figsize[0] * 120), int(figsize[1] * 120))
    frames = render_frames(scene_gt, scene_est, confidence_threshold, size,
                           scene_images, device)
    cv2 = _cv2()
    if cv2 is None:
        n_rendered = sum(1 for _ in frames)
        print(f"render_scene: cv2 is not installed: rendered {n_rendered} frames, "
              f"no MP4 written to {output_path}")
        return n_rendered

    W, H = size
    writer = None
    n_rendered = 0
    for frame, title in frames:
        if writer is None:
            writer = cv2.VideoWriter(
                str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
        frame = frame.cpu().numpy()
        cv2.putText(frame, title, (12, H - 16), cv2.FONT_HERSHEY_SIMPLEX,
                    0.7, (235, 235, 235), 1, cv2.LINE_AA)
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        n_rendered += 1
    if writer is not None:
        writer.release()
    return n_rendered
