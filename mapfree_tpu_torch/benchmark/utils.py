"""Benchmark pose-file IO and quaternion error metrics (host-side, float64;
the port's copy of mapfree_tpu/benchmark/utils.py).

Behavioural equivalent of reference benchmark/utils.py:12-182, rebuilt on the
framework's own quaternion library (no transforms3d dependency).
"""

from __future__ import annotations

import logging
import typing
from pathlib import Path

import numpy as np

from mapfree_tpu_torch.geom.quaternion import (
    convert_world2cam_to_cam2world,
    qinverse,
    qmult,
)

VARIANTS_ANGLE_SIN = "sin"
VARIANTS_ANGLE_COS = "cos"


class _BadPoseLine(ValueError):
    """Raised by the per-line parser; carries the skip reason."""


def _parse_pose_line(parts, want_confidence: bool):
    """One submission/GT line -> (frame_num, q_w2c, t_w2c, confidence).

    Raises _BadPoseLine for anything malformed. Line format:
    ``imgpath qw qx qy qz tx ty tz [confidence]`` with the frame number
    embedded as ``.../frame_XXXXX.jpg``.
    """
    n_fields = 9 if want_confidence else 8
    if len(parts) != n_fields:
        raise _BadPoseLine(f"expected {n_fields} fields, got {len(parts)}")

    name = parts[0]
    try:
        frame_num = int(name[-9:-4])
    except ValueError:
        raise _BadPoseLine(
            'frame number not parseable (expected ".../frame_00000.jpg")'
        ) from None

    try:
        values = np.array([float(v) for v in parts[1:]], dtype=np.float64)
    except ValueError:
        raise _BadPoseLine("non-numeric pose field") from None
    if not np.isfinite(values).all():
        raise _BadPoseLine("non-finite pose field")

    q, t = values[:4], values[4:7]
    if np.isclose(np.linalg.norm(q), 0):
        raise _BadPoseLine("zero-norm quaternion")
    confidence = values[7] if want_confidence else None
    return frame_num, q, t, confidence


def load_poses(file: typing.IO, load_confidence: bool = False):
    """Load poses from a text file, converting w2c -> c2w.

    Malformed lines are skipped with a warning — the evaluator must survive
    arbitrary user submissions (reference: benchmark/utils.py:18-74).
    Returns dict: frame_num -> (q_c2w, t_c2w, confidence).
    """
    poses = {}
    for line_number, line in enumerate(file.readlines()):
        parts = line.strip().split(" ")
        if parts and "#" in parts[0]:
            continue
        try:
            frame_num, q, t, confidence = _parse_pose_line(parts, load_confidence)
        except _BadPoseLine as reason:
            logging.warning(
                f"Skipping line {line_number} of "
                f"{getattr(file, 'name', '?')}: {reason}."
            )
            continue
        q, t = convert_world2cam_to_cam2world(q, t)
        poses[frame_num] = (q, t, confidence)
    return poses


def subsample_poses(poses: dict, subsample: int = 1):
    return {k: v for i, (k, v) in enumerate(poses.items()) if i % subsample == 0}


def load_K(file_path: Path):
    """Load per-frame intrinsics from ``intrinsics.txt``."""
    K = {}
    W = H = None
    with Path(file_path).open("r", encoding="utf-8") as f:
        for line in f.readlines():
            if "#" in line:
                continue
            line = line.strip().split(" ")
            frame_num = int(line[0][-9:-4])
            fx, fy, cx, cy, W, H = map(float, line[1:])
            K[frame_num] = np.array(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32
            )
    return K, W, H


def _unit(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def quat_angle_error(label, pred, variant: str = VARIANTS_ANGLE_SIN) -> np.ndarray:
    """Angle between two quaternions, degrees, shape [1, 1].

    'sin' variant (the evaluator default): 2*arcsin of the vector-part norm
    of the residual quaternion pred * label^-1 — numerically precise for the
    small angles the pose threshold cares about, where the cos variant loses
    precision to cancellation (reference: benchmark/utils.py:95-129).
    """
    assert variant in (VARIANTS_ANGLE_SIN, VARIANTS_ANGLE_COS)
    label = np.atleast_2d(np.asarray(label, dtype=np.float64))
    pred = np.atleast_2d(np.asarray(pred, dtype=np.float64))
    if label.shape != (1, 4) or pred.shape != (1, 4):
        raise RuntimeError(
            f"Unexpected shapes label {label.shape}, pred {pred.shape}; expected (1, 4)"
        )
    q_est, q_gt = _unit(pred[0]), _unit(label[0])

    if variant == VARIANTS_ANGLE_COS:
        d = np.clip(np.abs(np.dot(q_est, q_gt)), -1.0, 1.0)
        angle = 2.0 * np.degrees(np.arccos(d))
    else:
        residual = qmult(q_est, qinverse(q_gt))
        half_sin = np.clip(np.linalg.norm(residual[1:]), -1.0, 1.0)
        angle = 2.0 * np.degrees(np.arcsin(half_sin))
    return np.full((1, 1), angle, dtype=np.float64)


def precision_recall(inliers, tp, failures):
    """Confidence-ranked precision/recall sweep with failure-aware recall.

    The numerics are the leaderboard contract (reference:
    benchmark/utils.py:132-182): one operating point per distinct confidence
    value (accept every frame at least that confident), recall denominator
    includes frames with no estimate, AP = sum of d_recall x precision.
    Returned curves run from highest recall to the (precision 1, recall 0)
    anchor — the format the PR plots consume.
    """
    confidence = np.asarray(inliers, np.float64).reshape(-1)
    hits = np.asarray(tp, np.float64).reshape(-1)
    assert confidence.shape == hits.shape, "unequal shapes"

    order = np.argsort(confidence)[::-1]
    confidence = confidence[order]
    hits = hits[order]

    # a threshold sits after the last member of each equal-confidence group
    group_end = np.append(confidence[1:] != confidence[:-1], True)
    n_accepted = np.flatnonzero(group_end) + 1.0
    tp_accepted = np.cumsum(hits)[group_end]

    prec_pts = tp_accepted / n_accepted
    rec_pts = n_accepted / (hits.size + float(failures))

    ap = float(np.sum(np.diff(np.concatenate([[0.0], rec_pts])) * prec_pts))

    prec = np.concatenate([prec_pts[::-1], [1.0]])
    rec = np.concatenate([rec_pts[::-1], [0.0]])
    return prec, rec, ap
