"""Train/val pose-error metrics (port of mapfree_tpu/metrics.py; reference
lib/utils/metrics.py:6-132). ``pose_error`` runs on tensors, on the device,
inside the validation step; the aggregation helpers (AUC, A-metrics,
accumulator) are numpy on the host, as in the reference.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch


def pose_error(R, t, Tgt):
    """Angular/scale/euclidean translation errors + rotation angle error.

    Args:
        R: [B, 3, 3] estimated rotation.
        t: [B, 1, 3] estimated translation.
        Tgt: [B, 4, 4] ground-truth relative pose.
    Returns dict of per-sample errors (degrees / ratios / meters), shape [B, 1]
    mirroring reference metrics.py:6-47.
    """
    Rgt = Tgt[:, :3, :3]
    tgt = Tgt[:, :3, 3:].transpose(1, 2)  # [B, 1, 3]

    scale_t = torch.linalg.norm(t, dim=-1)
    scale_tgt = torch.linalg.norm(tgt, dim=-1)

    cosine = torch.sum(t * tgt, dim=-1) / (scale_t * scale_tgt + 1e-9)
    cosine = torch.clamp(cosine, -1.0, 1.0)
    t_ang_err = torch.rad2deg(torch.acos(cosine))
    t_ang_err = torch.minimum(t_ang_err, 180 - t_ang_err)

    t_scale_err = scale_t / scale_tgt
    t_scale_err_sym = torch.maximum(scale_t / scale_tgt, scale_tgt / scale_t)
    t_euclidean_err = torch.linalg.norm(t - tgt, dim=-1)

    residual = R.transpose(1, 2) @ Rgt
    trace = residual.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    cosine = torch.clamp((trace - 1) / 2, -1.0, 1.0)
    R_err = torch.rad2deg(torch.acos(cosine))[:, None]

    return {
        "t_err_ang": t_ang_err,
        "t_err_scale": t_scale_err,
        "t_err_scale_sym": t_scale_err_sym,
        "t_err_euc": t_euclidean_err,
        "R_err": R_err,
    }


def error_auc(errors, thresholds):
    """Area under the recall-vs-error curve, normalised per threshold
    (reference metrics.py:50-67)."""
    errors = np.nan_to_num(np.asarray(errors, np.float64), nan=float("inf"))
    errors = [0] + sorted(errors.tolist())
    recall = list(np.linspace(0, 1, len(errors)))

    aucs = []
    for thr in thresholds:
        last_index = np.searchsorted(errors, thr)
        y = recall[:last_index] + [recall[last_index - 1]]
        x = errors[:last_index] + [thr]
        aucs.append(np.trapezoid(y, x) / thr)

    return {f"auc@{t}": auc for t, auc in zip(thresholds, aucs)}


def ecdf(x):
    cd = np.linspace(0, 1, x.shape[0])
    v = np.sort(x)
    return v, cd


def precision(agg_metrics, rot_threshold, trans_threshold):
    """Ratio of samples within both thresholds (reference metrics.py:94-99)."""
    mask_rot = agg_metrics["R_err"] <= rot_threshold
    mask_trans = agg_metrics["t_err_euc"] <= trans_threshold
    return (mask_rot * mask_trans).mean()


def A_metrics(t_scale_err_sym):
    """A1/A2/A3 scale-accuracy buckets at 1.25^k (reference metrics.py:102-115)."""
    thresh = np.asarray(t_scale_err_sym)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()
    return a1, a2, a3


def print_auc_table(agg_metrics):
    pose_err = np.maximum(agg_metrics["R_err"], agg_metrics["t_err_ang"])
    auc_pose = error_auc(pose_err, (5, 10, 20))
    print("Pose error AUC @ 5/10/20deg: {0:.3f}/{1:.3f}/{2:.3f}".format(*auc_pose.values()))
    auc_rotation = error_auc(agg_metrics["R_err"], (5, 10, 20))
    print("Rotation error AUC @ 5/10/20deg: {0:.3f}/{1:.3f}/{2:.3f}".format(
        *auc_rotation.values()))
    auc_tang = error_auc(agg_metrics["t_err_ang"], (5, 10, 20))
    print("Translation angular error AUC @ 5/10/20deg: {0:.3f}/{1:.3f}/{2:.3f}".format(
        *auc_tang.values()))
    auc_teuc = error_auc(agg_metrics["t_err_euc"], (0.1, 0.5, 1))
    print("Translation Euclidean error AUC @ 0.1/0.5/1m: {0:.3f}/{1:.3f}/{2:.3f}".format(
        *auc_teuc.values()))


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class MetricsAccumulator:
    """Accumulates per-batch metric arrays, aggregates to flat numpy
    (reference metrics.py:118-132)."""

    def __init__(self):
        self.data = defaultdict(list)

    def accumulate(self, data):
        for key, value in data.items():
            self.data[key].append(_to_numpy(value))

    def aggregate(self):
        return {
            key: np.concatenate([v.reshape(-1) for v in values])
            for key, values in self.data.items()
        }
