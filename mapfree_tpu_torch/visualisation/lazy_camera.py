"""Smoothed observer camera for scene renders.

The port's own copy of mapfree_tpu/visualisation/lazy_camera.py (host
numpy), the equivalent of reference visualisation/lazy_camera.py: the
observer viewpoint follows the moving estimate trajectory with exponential
smoothing so renders don't jitter.
"""

from __future__ import annotations

import numpy as np


class LazyCamera:
    """Exponentially-smoothed look-at camera."""

    def __init__(self, smoothing: float = 0.9, back_off: float = 2.0,
                 elevation: float = 1.0):
        self.smoothing = smoothing
        self.back_off = back_off
        self.elevation = elevation
        self._center = None
        self._position = None

    def update(self, target_center: np.ndarray, view_dir: np.ndarray | None = None):
        """Update with the current point of interest (e.g. camera cluster
        centroid). view_dir optionally biases where the observer sits."""
        target_center = np.asarray(target_center, np.float64)
        if view_dir is None:
            view_dir = np.array([0.0, 0.0, 1.0])
        view_dir = view_dir / (np.linalg.norm(view_dir) + 1e-9)
        target_pos = (
            target_center - view_dir * self.back_off
            + np.array([0.0, -self.elevation, 0.0])
        )
        if self._center is None:
            self._center = target_center
            self._position = target_pos
        else:
            a = self.smoothing
            self._center = a * self._center + (1 - a) * target_center
            self._position = a * self._position + (1 - a) * target_pos

    @property
    def center(self):
        return self._center

    @property
    def position(self):
        return self._position

    def elev_azim(self):
        """Matplotlib 3D view angles for the smoothed pose."""
        d = self._center - self._position
        azim = np.degrees(np.arctan2(d[0], d[2]))
        elev = -np.degrees(np.arctan2(d[1], np.linalg.norm([d[0], d[2]])))
        return float(elev), float(azim)
