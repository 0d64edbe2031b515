"""Per-frame metric computation for the MapFree benchmark (the port's copy
of mapfree_tpu/benchmark/metrics.py).

Numerically equivalent to reference benchmark/metrics.py:10-67 (translation
L2, sin-variant quaternion angle, VCRE, confidence) with the same public
names (``Inputs``, ``MetricManager``), but organised as explicit metric
functions evaluated in a fixed order rather than a decorator registry.
"""

from __future__ import annotations

import numpy as np

from mapfree_tpu_torch.benchmark.reprojection import reprojection_error
from mapfree_tpu_torch.benchmark.utils import VARIANTS_ANGLE_SIN, quat_angle_error

METRIC_NAMES = ("trans_err", "rot_err", "reproj_err", "confidence")


class Inputs:
    """Validated per-frame inputs: GT/estimated pose, confidence, intrinsics."""

    __slots__ = ("q_gt", "t_gt", "q_est", "t_est", "confidence", "K", "W", "H")

    def __init__(self, q_gt, t_gt, q_est, t_est, confidence, K, W, H):
        checks = (
            (q_gt.shape == (4,), "invalid gt quaternion shape"),
            (t_gt.shape == (3,), "invalid gt translation shape"),
            (q_est.shape == (4,), "invalid estimated quaternion shape"),
            (t_est.shape == (3,), "invalid estimated translation shape"),
            (confidence >= 0, "confidence must be non negative"),
            (K.shape == (3, 3), "invalid K shape"),
            (W > 0, "invalid image width"),
            (H > 0, "invalid image height"),
        )
        for ok, msg in checks:
            assert ok, msg
        self.q_gt, self.t_gt = q_gt, t_gt
        self.q_est, self.t_est = q_est, t_est
        self.confidence = confidence
        self.K, self.W, self.H = K, W, H


def compute_translation_error(inputs: Inputs) -> np.float64:
    return np.linalg.norm(inputs.t_est - inputs.t_gt)


def compute_rotation_error(inputs: Inputs,
                           variant: str = VARIANTS_ANGLE_SIN) -> np.float64:
    return quat_angle_error(label=inputs.q_est, pred=inputs.q_gt,
                            variant=variant)[0, 0]


def compute_reprojection_error(inputs: Inputs) -> float:
    return reprojection_error(
        q_est=inputs.q_est, t_est=inputs.t_est,
        q_gt=inputs.q_gt, t_gt=inputs.t_gt,
        K=inputs.K, W=inputs.W, H=inputs.H,
    )


def compute_frame_metrics(inputs: Inputs) -> dict:
    """All four per-frame metrics in evaluation order."""
    return {
        "trans_err": compute_translation_error(inputs),
        "rot_err": compute_rotation_error(inputs),
        "reproj_err": compute_reprojection_error(inputs),
        "confidence": inputs.confidence,
    }


class MetricManager:
    """Appends every metric of a frame into a results dict of lists
    (same call contract as the reference's registry-driven manager)."""

    # kept as staticmethods so callers (and the ported reference test suite)
    # can invoke individual metrics directly: MetricManager.rot_err(inputs)
    trans_err = staticmethod(compute_translation_error)
    rot_err = staticmethod(compute_rotation_error)
    reproj_err = staticmethod(compute_reprojection_error)

    @staticmethod
    def confidence(inputs: Inputs) -> float:
        return inputs.confidence

    def __call__(self, inputs: Inputs, results: dict) -> None:
        for name, value in compute_frame_metrics(inputs).items():
            results[name].append(value)
