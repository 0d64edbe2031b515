"""Official MapFree leaderboard evaluator CLI (the port's copy of
mapfree_tpu/benchmark/mapfree.py: host numpy, so it gives the JAX scorer's
JSON on the same zip and tree).

Numerically equivalent to reference benchmark/mapfree.py:17-160 (same
aggregate definitions: average-of-scene-medians, Precision/AUC at the pose
and VCRE thresholds with missing frames as failures), organised around a
``SceneScorer`` that owns the GT for one scene.

Run: ``python -m mapfree_tpu_torch.benchmark.mapfree submission.zip --split val``.
"""

from __future__ import annotations

import argparse
import json
import logging
from collections import defaultdict
from io import TextIOWrapper
from pathlib import Path
from zipfile import ZipFile

import numpy as np

import mapfree_tpu_torch.benchmark.config as config
from mapfree_tpu_torch.benchmark.metrics import Inputs, MetricManager
from mapfree_tpu_torch.benchmark.utils import (
    load_K,
    load_poses,
    precision_recall,
    subsample_poses,
)

# the evaluated split keeps every 5th query frame (reference mapfree.py:50)
_EVAL_SUBSAMPLE = 5


class SceneScorer:
    """Scores one scene's estimated poses against its ground truth."""

    def __init__(self, scene_dir: Path):
        self.K, self.W, self.H = load_K(scene_dir / "intrinsics.txt")
        with (scene_dir / "poses.txt").open("r", encoding="utf-8") as f:
            gt = load_poses(f, load_confidence=False)
        self.gt_poses = subsample_poses(gt, subsample=_EVAL_SUBSAMPLE)
        self.total_gt = len(gt)

    def score(self, estimated_poses: dict):
        """Returns (results dict of metric lists, failure count)."""
        manager = MetricManager()
        results = defaultdict(list)
        failures = 0
        for frame_num, (q_gt, t_gt, _) in self.gt_poses.items():
            est = estimated_poses.get(frame_num)
            if est is None:
                failures += 1
                continue
            q_est, t_est, conf = est
            manager(
                Inputs(q_gt=q_gt, t_gt=t_gt, q_est=q_est, t_est=t_est,
                       confidence=conf, K=self.K[frame_num], W=self.W, H=self.H),
                results,
            )
        return results, failures


def _read_submission_scene(submission_zip: ZipFile, scene: str):
    try:
        with submission_zip.open(f"pose_{scene}.txt") as f:
            return load_poses(TextIOWrapper(f, encoding="utf-8"),
                              load_confidence=True)
    except KeyError:
        logging.warning(f"Submission does not have estimates for scene {scene}.")
        return None
    except UnicodeDecodeError:
        logging.error("Unsupported file encoding: please use UTF-8")
        raise


def compute_scene_metrics(dataset_path: Path, submission_zip: ZipFile, scene: str):
    try:
        scorer = SceneScorer(dataset_path / scene)
    except FileNotFoundError as e:
        logging.error(f"Could not find ground-truth dataset files: {e}")
        raise
    logging.info(f"Loaded ground-truth intrinsics and poses for scene {scene}")

    estimated = _read_submission_scene(submission_zip, scene)
    if estimated is None:
        return dict(), scorer.total_gt
    logging.info(f"Loaded estimated poses for scene {scene}")
    return scorer.score(estimated)


def aggregate_results(all_results: dict, all_failures: int) -> dict:
    """Average-of-scene-medians + dataset-level precision / confidence-AUC."""
    scene_medians = defaultdict(list)
    pooled = defaultdict(list)
    for scene_results in all_results.values():
        for metric, values in scene_results.items():
            scene_medians[metric].append(np.median(values))
            pooled[metric].extend(values)
    pooled = {k: np.array(v) for k, v in pooled.items()}
    assert all(v.ndim == 1 for v in pooled.values()), "invalid metrics shape"

    avg_median = {m: np.mean(v) for m, v in scene_medians.items()}

    good_pose = (pooled["trans_err"] < config.t_threshold) & (
        pooled["rot_err"] < config.R_threshold
    )
    good_vcre = pooled["reproj_err"] < config.vcre_threshold
    n_total = len(next(iter(pooled.values()))) + all_failures

    _, _, auc_pose = precision_recall(
        inliers=pooled["confidence"], tp=good_pose, failures=all_failures)
    _, _, auc_vcre = precision_recall(
        inliers=pooled["confidence"], tp=good_vcre, failures=all_failures)

    pose_label = f"Pose Error < ({config.t_threshold*100}cm, {config.R_threshold}deg)"
    vcre_label = f"VCRE < {config.vcre_threshold}px"
    return {
        "Average Median Translation Error": avg_median["trans_err"],
        "Average Median Rotation Error": avg_median["rot_err"],
        "Average Median Reprojection Error": avg_median["reproj_err"],
        f"Precision @ {pose_label}": np.sum(good_pose) / n_total,
        f"AUC @ {pose_label}": auc_pose,
        f"Precision @ {vcre_label}": np.sum(good_vcre) / n_total,
        f"AUC @ {vcre_label}": auc_vcre,
        "Estimates for % of frames": len(pooled["trans_err"]) / n_total,
    }


def count_unexpected_scenes(scenes: tuple, submission_zip: ZipFile) -> int:
    in_submission = {
        name[5:-4] for name in submission_zip.namelist() if name.startswith("pose_")
    }
    return len(in_submission - set(scenes))


def run(submission_path: Path, dataset_path: Path):
    scenes = tuple(f.name for f in dataset_path.iterdir() if f.is_dir())

    try:
        submission_zip = ZipFile(submission_path, "r")
    except FileNotFoundError:
        logging.error(f"Could not find ZIP file in path {submission_path}")
        return None

    all_results = {}
    all_failures = 0
    with submission_zip:
        for scene in scenes:
            metrics, failures = compute_scene_metrics(dataset_path, submission_zip, scene)
            all_results[scene] = metrics
            all_failures += failures
        unexpected = count_unexpected_scenes(scenes, submission_zip)

    if all_failures > 0:
        logging.warning(
            f"Submission is missing pose estimates for {all_failures} frames")
    if unexpected > 0:
        logging.warning(
            f"Submission contains estimates for {unexpected} scenes outside the split")
    if all(len(m) == 0 for m in all_results.values()):
        logging.error("Submission does not have any valid pose estimates")
        return None

    return aggregate_results(all_results, all_failures)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        "eval", description="Evaluate submissions for the MapFree dataset benchmark")
    parser.add_argument("submission_path", type=Path, help="Path to the submission ZIP")
    parser.add_argument("--split", choices=("val", "test"), default="test")
    parser.add_argument("--log", choices=("warning", "info", "error"),
                        default="warning")
    parser.add_argument("--dataset_path", type=Path, default=None)
    args = parser.parse_args(argv)
    if args.dataset_path is None:
        from mapfree_tpu_torch.config import cfg as default_cfg

        cfg = default_cfg.clone()
        cfg.merge_from_file("configs/mapfree.yaml")
        args.dataset_path = Path(cfg.DATASET.DATA_ROOT)
    return args


def main(argv=None):
    """Parse ``argv`` (default: the command line), score the submission and
    print the metrics as JSON; returns them (None where nothing scored)."""
    args = parse_args(argv)
    logging.basicConfig(level=args.log.upper())
    output_metrics = run(args.submission_path, args.dataset_path / args.split)
    if output_metrics is not None:
        print(json.dumps(output_metrics, indent=2))
    return output_metrics


if __name__ == "__main__":
    main()
