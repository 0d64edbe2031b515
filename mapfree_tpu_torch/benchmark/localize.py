"""Multi-reference visual-localization toolkit (7Scenes-style evaluation; the
port's copy of mapfree_tpu/benchmark/localize.py, on the port's quaternion
helpers).

Capability equivalent of reference lib/utils/localize.py:14-1020, designed
around vectorised per-query arrays instead of the reference's per-pair Python
loops, and built on the framework's quaternion library (no
transforms3d/scipy-Rotation):

- pose wrapper classes (AbsPose / RelaPose / RelaPosePair / EssPair) — the
  data contract with benchmark/sevenscenes.py;
- multi-NN fusion: Weiszfeld geometric median of positions + chordal-L2
  rotation mean (largest eigenvector of the quaternion outer-product sum);
- pose-graph RANSAC over reference-pair combinations with DLT triangulation,
  a translation-direction inlier test, and local optimisation — the inlier
  test and model estimation run as single numpy expressions over a
  :class:`_QueryArrays` view of all pairs of one query;
- DSAC-style pass rates, AP, per-scene result dumps and PR plots.

Host-side numpy float64 throughout (this is evaluation, not the hot path).
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass

import numpy as np

from mapfree_tpu_torch.benchmark.utils import precision_recall
from mapfree_tpu_torch.geom.quaternion import mat2quat, quat2mat

# ---------------------------------------------------------------- errors ----


def cal_vec_angle_error(label, pred, eps=1e-10):
    """Angle in degrees between vectors; zero/degenerate cases give 0.

    The dot product is rounded to 4 decimals before arccos — the reference
    evaluator does this (localize.py:24-25) and the pass-rate numerics depend
    on it, so it is part of the metric contract."""
    label = np.atleast_2d(label)
    pred = np.atleast_2d(pred)
    v1 = pred / np.linalg.norm(pred, axis=1, keepdims=True)
    v2 = label / np.linalg.norm(label, axis=1, keepdims=True)
    d = np.clip(np.around(np.sum(v1 * v2, axis=1, keepdims=True), 4), -1, 1)
    error = np.degrees(np.arccos(d))
    return np.nan_to_num(error, nan=0.0)


def cal_quat_angle_error(label, pred):
    """Angle in degrees between two (batches of) quaternions, cos variant."""
    label = np.atleast_2d(label)
    pred = np.atleast_2d(pred)
    q1 = pred / np.linalg.norm(pred, axis=1, keepdims=True)
    q2 = label / np.linalg.norm(label, axis=1, keepdims=True)
    d = np.clip(np.abs(np.sum(q1 * q2, axis=1, keepdims=True)), -1, 1)
    return 2 * np.degrees(np.arccos(d))


# ------------------------------------------------------------- averaging ----


def geometric_median(points, eps=1e-5, axis=0, max_iter=1000):
    """Weiszfeld iteration for the point minimising the sum of Euclidean
    distances, with Ostresh's modification so iterates that land exactly on
    an input point do not stall (same estimator as reference
    localize.py:228-254). Returns shape [1, D]."""
    points = np.asarray(points, np.float64)
    y = points.mean(axis=0)
    for _ in range(max_iter):
        dist = np.linalg.norm(points - y, axis=1)
        off = dist > 0
        n_hits = len(points) - int(off.sum())
        if n_hits == len(points):  # y coincides with every point
            break

        w = 1.0 / dist[off]
        w_sum = w.sum()
        t_step = (w[:, None] * points[off]).sum(axis=0) / w_sum

        if n_hits == 0:
            y_next = t_step
        else:
            # Ostresh: pull the pure Weiszfeld step back toward y in
            # proportion to the multiplicity of coincident points
            r = np.linalg.norm((t_step - y) * w_sum)
            gamma = 0.0 if r == 0 else min(1.0, n_hits / r)
            y_next = (1.0 - gamma) * t_step + gamma * y

        if np.linalg.norm(y - y_next) < eps:
            y = y_next
            break
        y = y_next
    return y.reshape(1, -1)


def chordal_l2_mean_rotation(Rs) -> np.ndarray:
    """Chordal-L2 mean of rotation matrices: the quaternion maximising
    sum_i (q . q_i)^2 is the top eigenvector of sum_i q_i q_i^T. Equivalent to
    scipy Rotation.mean() used by the reference (localize.py:395-397)."""
    qs = np.stack([mat2quat(R) for R in Rs])  # [N, 4], w >= 0 hemisphere
    M = qs.T @ qs
    eigvals, eigvecs = np.linalg.eigh(M)
    q_mean = eigvecs[:, -1]
    if q_mean[0] < 0:
        q_mean = -q_mean
    return quat2mat(q_mean)


# ------------------------------------------------------------ PR helpers ----


def precision_recall_pose_error(inliers, terr, rerr, failures, pose_threshold):
    assert len(inliers) == len(terr) == len(rerr), "unequal shapes"
    assert len(pose_threshold) == 2, "invalid pose_threshold"
    tp = (np.array(terr).reshape(-1) <= pose_threshold[0]) * (
        np.array(rerr).reshape(-1) <= pose_threshold[1]
    )
    return precision_recall(inliers, tp, failures)


def precision_recall_repr_error(inliers, reprerr, failures, repr_threshold):
    assert len(inliers) == len(reprerr), "unequal shapes"
    tp = np.array(reprerr).reshape(-1) < repr_threshold
    return precision_recall(inliers, tp, failures)


# --------------------------------------------------------------- algebra ----


def hat(vec):
    a1, a2, a3 = list(vec)
    return np.array([[0, -a3, a2], [a3, 0, -a1], [-a2, a1, 0]])


def compose_projection_matrix(R, t):
    return np.hstack([R, np.expand_dims(t, axis=1)])


def project_onto_essential_space(F):
    u, s, vh = np.linalg.svd(F)
    a = (s[0] + s[1]) / 2
    return u @ np.diag([a, a, 0]) @ vh


def essential_matrix_from_pose(R, t):
    t = t / np.linalg.norm(t)
    return (hat(t) @ R).astype(np.float32)


def decompose_essential_matrix(E):
    """E -> (t, R1, R2); other translation is -t (reference
    localize.py:872-889, the OpenCV-matching variant)."""
    u, s, vh = np.linalg.svd(E)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vh) < 0:
        vh = -vh
    t = u[:, 2]
    w = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]])
    R1 = u @ w @ vh
    R2 = u @ w.T @ vh
    return t, R1, R2


def triangulate_multi_views(correspondence):
    """DLT triangulation of one 3D point from >= 2 (pixel, P-matrix) views:
    the null vector of the stacked epipolar constraint rows (reference
    localize.py:787-806). Rows are built in one vectorised pass."""
    x = np.stack([np.asarray(xi, np.float64) for xi, _ in correspondence])
    P = np.stack([np.asarray(pi, np.float64) for _, pi in correspondence])
    A = np.concatenate(
        [x[:, 0:1] * P[:, 2] - P[:, 0], x[:, 1:2] * P[:, 2] - P[:, 1]]
    )  # [2N, 4]
    _, _, vh = np.linalg.svd(A)
    X = vh[-1]
    return X[:3] / X[3]


def triangulate_two_views(x1, p1, x2, p2):
    return triangulate_multi_views([(x1, p1), (x2, p2)])


# --------------------------------------------------------- pose wrappers ----


class AbsPose:
    """World-to-camera pose given as (q, camera-center c)."""

    def __init__(self, q, c, init_proj=True):
        q = np.asarray(q, np.float64).reshape(-1)
        c = np.asarray(c, np.float64).reshape(-1)
        assert q.shape == (4,) and c.shape == (3,)
        self.q = q
        self.r = quat2mat(self.q)
        self.c = c
        self.t = -self.r @ self.c
        if init_proj:
            self.p = compose_projection_matrix(self.r, self.t)


class RelaPose:
    def __init__(self, q, t):
        q = np.asarray(q, np.float64).reshape(-1)
        t = np.asarray(t, np.float64).reshape(-1)
        assert q.shape == (4,) and t.shape == (3,)
        self.q = q
        self.r = quat2mat(self.q)
        self.t = t


class RelaPosePair:
    """One (reference, query) pair for metric relative-pose models.

    Derived fields (same math as reference localize.py:939-964): the absolute
    query rotation/center implied by this reference, and the homogeneous
    image-plane point x_te of the query center seen from the reference."""

    def __init__(self, test_im, train_abs_pose, rela_pose_lbl, rela_pose_pred, sim):
        self.test_im = test_im
        self.train_abs_pose = train_abs_pose
        self.rela_pose_lbl = rela_pose_lbl
        self.rela_pose_pred = rela_pose_pred
        x_te = -self.rela_pose_pred.r.T @ self.rela_pose_pred.t
        self.x_te = x_te[:2] / (x_te[2] if x_te[2] != 0 else 1)
        self.abs_r_pred = self.rela_pose_pred.r @ self.train_abs_pose.r
        self.abs_q_pred = mat2quat(self.abs_r_pred)
        self.abs_c_pred = (
            train_abs_pose.c
            - self.train_abs_pose.r.T @ self.rela_pose_pred.r.T @ self.rela_pose_pred.t
        )
        self.sim = sim
        self.inliers = 0


class EssPair:
    """One (reference, query) pair for essential-matrix models: the rotation
    is one of two candidates and the translation sign is undetermined until
    RANSAC disambiguates (same contract as reference localize.py:967-1020)."""

    def __init__(self, test_im, train_im, train_abs_pose, rela_pose_lbl, t, R0, R1):
        t = np.asarray(t, np.float64).reshape(-1)
        assert t.shape == (3,)
        assert R0.shape == R1.shape == (3, 3)
        self.train_im = train_im
        self.test_im = test_im
        self.train_abs_pose = train_abs_pose
        self.rela_pose_lbl = rela_pose_lbl
        self.rela_pose_pred = None
        self.t = t
        self.R = [R0, R1]
        self.abs_r_pred = []
        self.abs_q_pred = []
        self.x_te = []
        for R in self.R:
            x_te = -R.T @ self.t
            if x_te[2] == 0:
                self.x_te.append(np.array([np.inf, np.inf]))
            else:
                self.x_te.append(x_te[:2] / x_te[2])
            abs_r = R @ self.train_abs_pose.r
            self.abs_r_pred.append(abs_r)
            self.abs_q_pred.append(mat2quat(abs_r))
        self.inliers = 0

    def set_rid(self, rid):
        self.rid = rid

    def set_opposite_trans_pred(self):
        self.t = -self.t

    def get_rela_q(self):
        return mat2quat(self.R[self.rid])

    def is_invalid(self):
        return np.any(np.isinf(self.x_te))


# ----------------------------------------------- vectorised query arrays ----


class _QueryArrays:
    """Array view of one query's (reference, query) pairs.

    Gathers the per-pair fields the RANSAC inner loop touches into [N, ...]
    arrays once, so the inlier test and model estimation are single numpy
    expressions instead of per-pair Python loops."""

    def __init__(self, pairs, pair_type):
        self.pairs = pairs
        self.ess = pair_type == "ess"
        self.train_c = np.stack([p.train_abs_pose.c for p in pairs])      # [N,3]
        self.train_r = np.stack([p.train_abs_pose.r for p in pairs])      # [N,3,3]
        self.train_p = np.stack([p.train_abs_pose.p for p in pairs])      # [N,3,4]
        if self.ess:
            self.q_cand = np.stack([p.abs_q_pred for p in pairs])         # [N,2,4]
            self.R_cand = np.stack([p.R for p in pairs])                  # [N,2,3,3]
            self.x_cand = np.stack([p.x_te for p in pairs])               # [N,2,2]
            self.t_rel = np.stack([p.t for p in pairs])                   # [N,3]
            self.rid = np.zeros(len(pairs), np.int64)
        else:
            self.q_pred = np.stack([p.abs_q_pred for p in pairs])         # [N,4]
            self.r_rel = np.stack([p.rela_pose_pred.r for p in pairs])    # [N,3,3]
            self.t_rel = np.stack([p.rela_pose_pred.t for p in pairs])    # [N,3]
            self.x_te = np.stack([p.x_te for p in pairs])                 # [N,2]

    def select_rotations(self, hypo_q):
        """For essential pairs: pick, per pair, the rotation candidate closer
        to the hypothesis rotation; record it on the pair objects."""
        flat = self.q_cand.reshape(-1, 4)
        err = cal_quat_angle_error(hypo_q[None], flat).reshape(-1, 2)
        self.rid = np.argmin(err, axis=1)
        for p, r in zip(self.pairs, self.rid):
            p.set_rid(int(r))

    def inlier_mask(self, hypo: AbsPose, thres, update_trans=False):
        """Translation-direction inlier test against a pose hypothesis,
        vectorised over all pairs (same decisions as reference
        localize.py:667-731)."""
        n = np.arange(len(self.pairs))
        # direction reference -> hypothesised query position, in ref frame
        t_est = np.einsum("nij,nj->ni", self.train_r, hypo.c - self.train_c)

        if self.ess:
            self.select_rotations(hypo.q)
            R_opt = self.R_cand[n, self.rid]                              # [N,3,3]
        else:
            R_opt = self.r_rel
        t_opt = -np.einsum("nji,nj->ni", R_opt, self.t_rel)               # R^T t

        est_zero = np.linalg.norm(t_est, axis=1) == 0.0
        opt_zero = np.linalg.norm(t_opt, axis=1) == 0.0
        # silence the 0/0 normalisations; their rows are overridden below
        with np.errstate(invalid="ignore", divide="ignore"):
            err = cal_vec_angle_error(t_est, t_opt).reshape(-1)
            if self.ess:
                err_neg = cal_vec_angle_error(t_est, -t_opt).reshape(-1)
                flip = err_neg < err
                err = np.where(flip, err_neg, err)
                if update_trans:
                    for p, f in zip(self.pairs, flip):
                        if f:
                            p.set_opposite_trans_pred()
        # degenerate pairs are never inliers; a query at the reference's
        # exact position is always an inlier (reference localize.py:700-704)
        err = np.where(opt_zero & ~est_zero, np.inf, err)
        err = np.where(est_zero, 0.0, err)
        return err < thres

    def estimate(self, inlier_idx) -> AbsPose:
        """Absolute pose from an inlier set: DLT triangulation of the query
        position + mean quaternion (reference localize.py:734-756)."""
        idx = np.asarray(inlier_idx)
        if self.ess:
            x = self.x_cand[idx, self.rid[idx]]
            q = self.q_cand[idx, self.rid[idx]]
        else:
            x = self.x_te[idx]
            q = self.q_pred[idx]
        P = self.train_p[idx]
        c = triangulate_multi_views(list(zip(x, P)))
        return AbsPose(q.mean(axis=0), c)


def find_inliers(hypo_abs_pose, test_pair_list, thres, pair_type="ess",
                 update_trans=False):
    """Indices of pairs whose predicted translation direction agrees with the
    hypothesis within ``thres`` degrees."""
    arrays = _QueryArrays(test_pair_list, pair_type)
    mask = arrays.inlier_mask(hypo_abs_pose, thres, update_trans=update_trans)
    return list(np.flatnonzero(mask))


def estimate_model(test_pair_list, inliers, pair_type):
    """Absolute pose from an inlier subset of pairs (object-list API)."""
    arrays = _QueryArrays(test_pair_list, pair_type)
    if arrays.ess:
        arrays.rid = np.array([p.rid for p in test_pair_list])
    return arrays.estimate(list(inliers))


# ------------------------------------------------- direct (no-RANSAC) eval --


def cal_rela_pose_err(pair_data):
    """Median relative translation/rotation angle errors over all pairs."""
    t_pred, t_lbl, q_pred, q_lbl = [], [], [], []
    for entry in pair_data.values():
        for pair in entry["test_pairs"]:
            t_pred.append(pair.rela_pose_pred.t)
            t_lbl.append(pair.rela_pose_lbl.t)
            q_pred.append(pair.rela_pose_pred.q)
            q_lbl.append(pair.rela_pose_lbl.q)
    t_err = cal_vec_angle_error(np.stack(t_lbl), np.stack(t_pred))
    q_err = cal_quat_angle_error(np.stack(q_lbl), np.stack(q_pred))
    return np.median(t_err), np.median(q_err)


def cal_abs_pose_err_metric(pair_data, err_thres=(2, 5), loc_results=None):
    """Per-query absolute pose by fusing metric relative poses from all
    reference images: geometric median of positions + chordal-L2 rotation
    mean; DSAC pass rates and AP (reference localize.py:352-421)."""
    abs_c_dist_err, abs_c_ang_err, abs_q_err, inliers = [], [], [], []
    passed = [0] * len(err_thres)
    failures = 0
    for test_im, entry in pair_data.items():
        test_abs_pose = entry["test_abs_pose"]
        pairs = entry["test_pairs"]

        if not pairs:
            failures += 1
            if loc_results is not None:
                loc_results[test_im] = None
            continue

        train_abs_c = np.stack([p.train_abs_pose.c for p in pairs])
        abs_c_pred = geometric_median(np.stack([p.abs_c_pred for p in pairs]))
        cerr = np.linalg.norm(test_abs_pose.c - abs_c_pred, axis=1)
        abs_c_dist_err.append(cerr)
        abs_c_ang_err.append(
            np.median(
                cal_vec_angle_error(
                    test_abs_pose.c - train_abs_c, abs_c_pred - train_abs_c
                )
            )
        )
        inliers.append(pairs[0].inliers)  # assumes a single keyframe

        abs_r_pred = chordal_l2_mean_rotation([quat2mat(p.abs_q_pred) for p in pairs])
        abs_q_pred = mat2quat(abs_r_pred)
        qerr = cal_quat_angle_error(test_abs_pose.q, abs_q_pred)
        abs_q_err.append(qerr)

        for i_e, err_t in enumerate(err_thres):
            if cerr < err_t[0] and qerr < err_t[1]:
                passed[i_e] += 1

        if loc_results is not None:
            loc_results[test_im] = {
                "abs_pose_lbl": test_abs_pose,
                "abs_pose_pred": AbsPose(abs_q_pred.reshape(-1), abs_c_pred.reshape(-1)),
                "abs_t_err": cerr.item(),
                "abs_r_err": qerr.item(),
                "inliers": pairs[0].inliers,
            }

    _, _, average_precision = precision_recall_pose_error(
        inliers, abs_c_dist_err, abs_q_err, failures, pose_threshold=err_thres[1]
    )
    passed = np.array(passed)
    return (
        np.median(abs_c_dist_err),
        np.median(abs_c_ang_err),
        np.median(abs_q_err),
        100.0 * passed / len(pair_data),
        average_precision,
    )


@dataclass
class SceneEval:
    """One scene's evaluation row — the unit both eval pipelines aggregate.

    rela_* are median relative-pose errors; abs_* are median fused absolute
    errors; ``passed`` holds the DSAC pass rate (%) per error threshold."""

    name: str
    rela_t_deg: float
    rela_q_deg: float
    abs_t_m: float
    abs_t_deg: float
    abs_r_deg: float
    passed: np.ndarray
    ap: float = float("nan")

    def errors(self) -> np.ndarray:
        return np.array([self.rela_t_deg, self.rela_q_deg, self.abs_t_m,
                         self.abs_t_deg, self.abs_r_deg])

    def summary(self) -> str:
        return (
            f"rela_err (t{self.rela_t_deg:.2f}deg, r{self.rela_q_deg:.2f}deg)"
            f" abs err: (t{self.abs_t_m:.2f}m/{self.abs_t_deg:.2f}deg, "
            f"r{self.abs_r_deg:.2f}deg), "
            "Recall: " + "/".join(f"{v:.2f}%" for v in self.passed)
            + f". AP: {self.ap:.2f}"
        )


def _aggregate(rows):
    """Mean of per-scene error vectors and pass rates."""
    errs = tuple(np.mean(np.stack([r.errors() for r in rows]), axis=0))
    passed = np.mean(np.stack([np.asarray(r.passed) for r in rows]), axis=0)
    return errs, passed


def eval_pipeline_without_ransac(result_dict, err_thres=(2, 5), log=None,
                                 save_res_path=None):
    """Multi-reference fusion eval, no RANSAC: per query, geometric median of
    positions + chordal-L2 rotation mean over all reference pairs (printed
    numerics match reference localize.py:164-208; the flow is one SceneEval
    row per scene aggregated by :func:`_aggregate`)."""
    rows = []
    saved = {}
    for name, data in result_dict.items():
        loc = {} if save_res_path else None
        print(f">>Testing dataset: {name}, "
              f"testing samples: {len(data['pair_data'])}, "
              f"failures {len(data['no_pt_pairs'])}")
        rela_t, rela_q = cal_rela_pose_err(data["pair_data"])
        abs_t, abs_t_ang, abs_r, passed, ap = cal_abs_pose_err_metric(
            data["pair_data"], err_thres, loc)
        row = SceneEval(name, rela_t, rela_q, abs_t, abs_t_ang, abs_r,
                        np.asarray(passed), ap)
        rows.append(row)
        saved[name] = loc
        print(row.summary())

    if save_res_path:
        np.save(save_res_path, saved)

    eval_val, avg_passed = _aggregate(rows)
    print(
        ">>avg_rela_err (t{v[0]:.2f}deg, r{v[1]:.2f}deg) avg_abs_err "
        "(t{v[2]:.2f}m/{v[3]:.2f}deg, r{v[4]:.2f}deg). Pass:".format(v=eval_val)
        + "/".join(f"{v:.2f}%" for v in avg_passed)
    )
    return eval_val, avg_passed


# ------------------------------------------------------------ RANSAC eval ---


def local_optimisation(test_pair_list, abs_pose_best, thres_multiplier, thres,
                       in_iter, pair_type):
    """Refine a promising hypothesis: re-collect inliers at a widened
    threshold, re-estimate, then try ``in_iter`` random inlier subsamples and
    keep whichever candidate pose gathers the most base-threshold inliers
    (reference localize.py:638-664)."""
    arrays = _QueryArrays(test_pair_list, pair_type)

    wide = np.flatnonzero(
        arrays.inlier_mask(abs_pose_best, thres_multiplier * thres))
    pose_wide = arrays.estimate(wide)
    base = list(np.flatnonzero(arrays.inlier_mask(pose_wide, thres)))

    candidates = [abs_pose_best, pose_wide]
    n_sub = min(14, len(base) // 2)
    if n_sub > 2:
        pool = list(base)
        for _ in range(in_iter):
            np.random.shuffle(pool)
            candidates.append(arrays.estimate(pool[:n_sub]))

    best_inliers, best_pose = [], None
    for pose in candidates:
        found = list(np.flatnonzero(arrays.inlier_mask(pose, thres)))
        if len(found) > len(best_inliers):
            best_inliers, best_pose = found, pose
    return best_inliers, best_pose


def _ess_two_view_hypothesis(pair0, pair1):
    """Minimal hypothesis from two essential pairs: pick the rotation
    candidates that agree best, average them, triangulate the position."""
    errs = np.array([
        [cal_quat_angle_error(pair0.abs_q_pred[i], pair1.abs_q_pred[j]).item()
         for j in range(2)]
        for i in range(2)
    ])
    id0, id1 = np.unravel_index(np.argmin(errs), errs.shape)
    q = np.mean([pair0.abs_q_pred[id0], pair1.abs_q_pred[id1]], axis=0)
    c = triangulate_two_views(
        pair0.x_te[id0], pair0.train_abs_pose.p,
        pair1.x_te[id1], pair1.train_abs_pose.p)
    return AbsPose(q, c)


def ransac(pair_data, inlier_thres, thres_multiplier=1.414, in_iter=10,
           pair_type="ess", err_thres=((0.25, 2), (0.5, 5), (5, 10)),
           loc_results=None):
    """Pose-graph RANSAC over reference-pair combinations
    (reference localize.py:471-635)."""
    abs_c_dist_err, abs_c_ang_err, abs_q_err = [], [], []
    rela_t_err, rela_q_err = [], []
    passed = [0 for _ in err_thres]
    approx_queries = []
    for test_im, entry in pair_data.items():
        test_abs_pose = entry["test_abs_pose"]
        test_pair_list = entry["test_pairs"]
        num_pair = len(test_pair_list)

        if num_pair == 0:
            # no valid pairs: sentinel errors; medians are robust to them
            cerr, qerr = 1000, 180
            abs_c_dist_err.append(cerr)
            abs_c_ang_err.append(qerr)
            abs_q_err.append(qerr)
            rela_t_err.append(qerr)
            rela_q_err.append(qerr)
            if loc_results is not None:
                loc_results[test_im] = None
        else:
            arrays = _QueryArrays(test_pair_list, pair_type)
            inlier_best = []
            abs_pose_best = None
            approximated = False
            for i0, i1 in itertools.combinations(range(num_pair), 2):
                if arrays.ess:
                    abs_pose_hypo = _ess_two_view_hypothesis(
                        test_pair_list[i0], test_pair_list[i1])
                else:
                    abs_pose_hypo = arrays.estimate([i0, i1])
                inlier_hypo = list(np.flatnonzero(
                    arrays.inlier_mask(abs_pose_hypo, inlier_thres)))

                if len(inlier_hypo) >= 2 and len(inlier_hypo) > len(inlier_best):
                    inlier_best = inlier_hypo
                    abs_pose_best = abs_pose_hypo
                    inlier_lo, pose_lo = local_optimisation(
                        test_pair_list, abs_pose_best, thres_multiplier,
                        inlier_thres, in_iter, pair_type)
                    if len(inlier_lo) > len(inlier_best):
                        inlier_best = inlier_lo
                        abs_pose_best = pose_lo

            if abs_pose_best is None or len(inlier_best) == 0:
                # fall back to the first reference's pose
                abs_pose_best = test_pair_list[0].train_abs_pose
                inlier_best = [0]
                approx_queries.append(test_im)
                approximated = True

            if arrays.ess:
                # final pass fixes each pair's rotation id and translation sign
                arrays.inlier_mask(abs_pose_best, inlier_thres, update_trans=True)

            t_err, q_err = [], []
            cumulative_correspondences_inliers = 0
            for i in inlier_best:
                pair = test_pair_list[i]
                if arrays.ess:
                    t_err.append(cal_vec_angle_error(pair.t, pair.rela_pose_lbl.t))
                    q_err.append(cal_quat_angle_error(pair.get_rela_q(),
                                                      pair.rela_pose_lbl.q))
                else:
                    t_err.append(cal_vec_angle_error(pair.rela_pose_pred.t,
                                                     pair.rela_pose_lbl.t))
                    q_err.append(cal_quat_angle_error(pair.rela_pose_pred.q,
                                                      pair.rela_pose_lbl.q))
                cumulative_correspondences_inliers += pair.inliers
            rela_t_err.append(np.mean(t_err))
            rela_q_err.append(np.mean(q_err))

            train_abs_c = arrays.train_c[inlier_best]
            cerr = np.linalg.norm(test_abs_pose.c - abs_pose_best.c)
            abs_c_dist_err.append(cerr)

            if approximated:
                abs_c_ang_err.append(0.0)
            else:
                with np.errstate(invalid="ignore", divide="ignore"):
                    abs_c_ang_err.append(np.mean(cal_vec_angle_error(
                        test_abs_pose.c - train_abs_c,
                        abs_pose_best.c - train_abs_c)))

            qerr = cal_quat_angle_error(test_abs_pose.q, abs_pose_best.q).squeeze()
            abs_q_err.append(qerr)

            if loc_results is not None:
                loc_results[test_im] = {
                    "abs_pose_lbl": test_abs_pose,
                    "abs_pose_pred": abs_pose_best,
                    "relv_pose_list": test_pair_list,
                    "inliers": cumulative_correspondences_inliers,
                    "approximated": approximated,
                    "abs_t_err": float(cerr),
                    "abs_r_err": float(qerr),
                }

        for i, thres in enumerate(err_thres):
            cerr_thres, qerr_thres = thres
            if cerr < cerr_thres and qerr < qerr_thres:
                passed[i] += 1

    num_tested = len(abs_c_dist_err)
    pass_rate = [100.0 * count / num_tested for count in passed]
    return num_tested, approx_queries, pass_rate, (
        np.median(rela_t_err), np.median(rela_q_err), np.median(abs_c_dist_err),
        np.median(abs_c_ang_err), np.median(abs_q_err),
    )


def _ransac_scene_row(name, pair_data, thres, ransac_iter, pair_type,
                      err_thres, loc_results):
    """Run pose-graph RANSAC for one scene -> (SceneEval, Bad/All string)."""
    tested_num, approx_queries, pass_rate, err_res = ransac(
        pair_data, thres, in_iter=ransac_iter, pair_type=pair_type,
        err_thres=err_thres, loc_results=loc_results)
    row = SceneEval(name, *err_res, np.asarray(pass_rate))
    return row, f"{len(approx_queries)}/{tested_num}"


def _ransac_summary(prefix, errs, passed) -> str:
    return (
        f"{prefix}Rela:(t{errs[0]:.2f}deg, r{errs[1]:.2f}deg) "
        f"Abs:(t{errs[2]:.2f}m/{errs[3]:.2f}deg, r{errs[4]:.2f}deg) "
        "Pass:" + "/".join(f"{v:.2f}%" for v in passed)
    )


def eval_pipeline_with_ransac(result_dict, log, ransac_thres, ransac_iter,
                              ransac_miu, pair_type, err_thres, save_res_path=None):
    """Pose-graph RANSAC eval over one or more inlier thresholds (printed
    numerics match reference localize.py:120-161; structured as one
    :func:`_ransac_scene_row` per scene, aggregated by :func:`_aggregate`,
    best threshold tracked by mean absolute position error)."""
    print(
        f">>>>Evaluate model with Ransac(iter={ransac_iter}, miu={ransac_miu}) "
        f"Error thres:{err_thres})"
    )
    t_start = time.time()
    pair_type = "relapose" if pair_type == "angess" else pair_type
    best_abs_err = None
    avg_pass = ()
    for thres in ransac_thres:
        print(f"\n>>Ransac threshold:{thres}")
        rows = []
        saved = {}
        for name, data in result_dict.items():
            loc = {} if save_res_path else None
            row, bad_all = _ransac_scene_row(
                name, data["pair_data"], thres, ransac_iter, pair_type,
                err_thres, loc)
            rows.append(row)
            saved[name] = loc
            print(f"Dataset:{name[:10]} Bad/All:{bad_all}, "
                  + _ransac_summary("", row.errors(), row.passed))

        avg_err, mean_pass = _aggregate(rows)
        # single-threshold runs keep the reference's tuple-of-arrays shape
        avg_pass = (tuple(mean_pass) if len(err_thres) > 1
                    else tuple(np.asarray(r.passed) for r in rows))
        if best_abs_err is None or best_abs_err[0] > avg_err[2]:
            best_abs_err = (avg_err[2], avg_err[4])
        print(_ransac_summary("Avg: ", avg_err, mean_pass))
        if save_res_path:
            np.save(save_res_path, saved)
    print(f"Ransac testing time: {time.time() - t_start}s\n")
    return best_abs_err, avg_pass


# ------------------------------------------------------- result reporting ---


def save_results_visualisation(file_path):
    """Per-scene txt of predicted absolute query poses, in the submission
    line format (same output as reference localize.py:51-69; the formatting
    is the framework's own submission Pose writer)."""
    from mapfree_tpu_torch.utils.submission import Pose

    results_dict = np.load(file_path, allow_pickle=True).item()
    out_dir = os.path.split(file_path)[0]
    for scene, scene_res in results_dict.items():
        lines = [
            str(Pose(test_im, res["abs_pose_pred"].q, res["abs_pose_pred"].t,
                     res["inliers"])) + " \n"
            for test_im, res in scene_res.items() if res is not None
        ]
        with open(os.path.join(out_dir, f"pose_{scene}.txt"), "w") as f:
            f.writelines(lines)


@dataclass
class _SceneErrors:
    """Flat error arrays of one scene (or the pooled dataset)."""

    inliers: np.ndarray
    t_err: np.ndarray
    r_err: np.ndarray
    failures: int

    @classmethod
    def from_results(cls, scene_res):
        ok = [r for r in scene_res.values() if r is not None]
        return cls(
            inliers=np.array([r["inliers"] for r in ok]),
            t_err=np.array([r["abs_t_err"] for r in ok]),
            r_err=np.array([r["abs_r_err"] for r in ok]),
            failures=sum(1 for r in scene_res.values() if r is None),
        )

    @classmethod
    def pooled(cls, parts):
        return cls(
            inliers=np.concatenate([p.inliers for p in parts]),
            t_err=np.concatenate([p.t_err for p in parts]),
            r_err=np.concatenate([p.r_err for p in parts]),
            failures=sum(p.failures for p in parts),
        )

    def pr_curve(self, pose_threshold):
        return precision_recall_pose_error(
            self.inliers, self.t_err, self.r_err, self.failures, pose_threshold)


def generate_precision_recall_plots(file_path, pose_threshold):
    """Per-scene + whole-dataset PR-curve JPGs (reference localize.py:72-118;
    one divergence: the dataset-level curve uses the TOTAL failure count —
    the reference accidentally reuses the last scene's).

    Where matplotlib does not import (the machine with the card has none),
    no JPG is written and one line says so: ``results.npy`` and the
    ``pose_*.txt`` files, written before, hold every number the evaluation
    computes."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: no precision-recall plots written "
              f"(the numbers are in {file_path})")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results_dict = np.load(file_path, allow_pickle=True).item()
    out_dir = os.path.split(file_path)[0]

    def save_curve(errs, title, out_name):
        prec, rec, ap = errs.pr_curve(pose_threshold)
        plt.figure()
        plt.plot(rec, prec, drawstyle="steps-post")
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.xlim(0, 1)
        plt.ylim(0, 1.1)
        plt.title(f"{title}. AP={ap:.2f}")
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, out_name))
        plt.close()

    per_scene = {
        scene: _SceneErrors.from_results(scene_res)
        for scene, scene_res in results_dict.items()
    }
    for scene, errs in per_scene.items():
        save_curve(errs, f"Scene {scene}", f"pr_{scene}.jpg")
    save_curve(_SceneErrors.pooled(list(per_scene.values())), "Dataset",
               "pr_all.jpg")
