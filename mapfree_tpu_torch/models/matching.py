"""Feature-matching pose model: correspondences -> batched RANSAC solvers
(port of mapfree_tpu/models/matching.py).

Batches of padded correspondences go through one batched solve per batch
(every pair's hypotheses, scores and refinements at once), where the
reference loops over OpenCV one pair at a time (reference
lib/models/matching/model.py:7-40, feature_matching.py:5-118).

- ``PrecomputedMatching`` reads the NaN-padded ``correspondences`` of an npz
  (LoFTR, SuperGlue or SIFT matches made offline), per scene through the
  ``{scene_root}`` path template.
- ``SIFT`` and ``SIFT_TPU`` matching are not ported yet (``ROADMAP.md`` item
  11b): such a config builds, and its first batch raises.

:meth:`FeatureMatchingModel.transfer_batch` (a worker thread) fetches the
correspondences, gathers the file depth at the keypoints on the host (the
maps stay uncollated: [B, N] depths cross the bus, not [B, H, W] maps),
packs every array into one pinned buffer and copies it to the device on a
side stream. :meth:`FeatureMatchingModel.dispatch_device` (the calling
thread) unpacks it on the device, draws the batch's minimal samples and
issues the solve; its ``finalize()`` returns (R, t, inliers) as numpy after
one device-to-host copy. The adaptive essential ladder's ``finish`` (tier
1's fetch, the escalation decision, tier 2) runs on a pool of two threads.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mapfree_tpu_torch.ops.essential import (essential_pose, essential_pose_adaptive_async,
                                             essential_pose_metric)
from mapfree_tpu_torch.ops.pnp import pnp_pose
from mapfree_tpu_torch.ops.procrustes_ransac import dense_cloud_from_depth, procrustes_pose
from mapfree_tpu_torch.ops.ransac import device_sampler
from mapfree_tpu_torch.models.builder import fetch_later, receive_packed, ship_packed
from mapfree_tpu_torch.utils.packing import spec_of
from mapfree_tpu_torch.utils.timing import NULL_TIMES

SOLVERS = ("EssentialMatrix", "EssentialMatrixMetric", "EssentialMatrixMetricMean",
           "Procrustes", "PNP")
SIFT_ITEM = "ROADMAP.md item 11b"
ICP_POINTS = 4096  # points of each dense cloud ICP registers


def pad_correspondences(corr_list, max_n: int):
    """Stack variable-length [Ni, 4] correspondence arrays into fixed-shape
    (pts0 [B, max_n, 2], pts1 [B, max_n, 2], mask [B, max_n])."""
    B = len(corr_list)
    pts0 = np.zeros((B, max_n, 2), np.float32)
    pts1 = np.zeros((B, max_n, 2), np.float32)
    mask = np.zeros((B, max_n), bool)
    for i, corr in enumerate(corr_list):
        n = min(len(corr), max_n)
        if n > 0:
            pts0[i, :n] = corr[:n, :2]
            pts1[i, :n] = corr[:n, 2:]
            mask[i, :n] = True
    return pts0, pts1, mask


class PrecomputedMatching:
    """Correspondences from a precomputed npz (reference
    feature_matching.py:5-50), a small per-scene cache: a batch may straddle
    a scene boundary."""

    CACHE_SCENES = 4

    def __init__(self, cfg):
        self.max_n = int(cfg.TPU.MAX_CORRESPONDENCES)
        self._cache: dict = {}
        self._lock = threading.Lock()  # transfer_batch runs on worker threads
        if "{" in cfg.MATCHES_FILE_PATH:
            self.matches_file_path = cfg.MATCHES_FILE_PATH
            self.pairs_txt = cfg.DATASET.PAIRS_TXT.TEST
            self.fixed = None
        else:
            self.matches_file_path = None
            self.fixed = self._load(cfg.MATCHES_FILE_PATH)

    @staticmethod
    def _load(file_path):
        data = np.load(file_path, allow_pickle=True)
        return data["correspondences"].astype(np.float32)

    def _scene_correspondences(self, scene_id, scene_root):
        if self.fixed is not None:
            return self.fixed
        with self._lock:
            table = self._cache.get(scene_id)
            if table is None:
                path = self.matches_file_path.format(scene_root=scene_root,
                                                     pairs_txt=self.pairs_txt)
                table = self._cache[scene_id] = self._load(path)
                while len(self._cache) > self.CACHE_SCENES:
                    self._cache.pop(next(iter(self._cache)))
            return table

    def get_correspondences(self, batch):
        corr_list = []
        for i in range(len(batch["pair_id"])):
            table = self._scene_correspondences(batch["scene_id"][i], batch["scene_root"][i])
            corr = table[int(batch["pair_id"][i])]
            corr_list.append(corr[~np.isnan(corr)].reshape(-1, 4))
        return pad_correspondences(corr_list, self.max_n)


class UnportedMatching:
    """``SIFT`` (OpenCV on the host) and ``SIFT_TPU`` (on-device SIFT): not
    ported yet. The config builds; fetching correspondences raises."""

    def __init__(self, cfg):
        self.kind = cfg.FEATURE_MATCHING

    def get_correspondences(self, batch):
        raise NotImplementedError(
            f"FEATURE_MATCHING {self.kind} is not ported to the PyTorch package yet "
            f"({SIFT_ITEM}); precompute the correspondences and use Precomputed")


class FeatureMatchingModel:
    """cfg.FEATURE_MATCHING x cfg.POSE_SOLVER on ``device``, batched.

    ``sampler_for_step(step)`` gives the minimal-sample source of the
    ``step``-th batch dispatched (ops/ransac.py); the default draws from a
    ``torch.Generator`` on ``device`` seeded with ``step``. The step is
    taken under a lock in :meth:`dispatch_device`, so it follows the order
    in which batches are dispatched.
    """

    def __init__(self, cfg, device, sampler_for_step=None):
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.FEATURE_MATCHING == "Precomputed":
            self.feature_matching = PrecomputedMatching(cfg)
        elif cfg.FEATURE_MATCHING in ("SIFT", "SIFT_TPU"):
            self.feature_matching = UnportedMatching(cfg)
        else:
            raise NotImplementedError(f"Invalid feature matching {cfg.FEATURE_MATCHING}")
        self.solver = cfg.POSE_SOLVER
        if self.solver not in SOLVERS:
            raise NotImplementedError(f"Invalid pose solver {self.solver}")
        self.n_iters = int(cfg.TPU.RANSAC_ITERATIONS)
        self.sampler_for_step = sampler_for_step or (
            lambda step: device_sampler(self.device, step))
        self._step = 0
        self._step_lock = threading.Lock()
        self.escalated_pairs = 0  # pairs the adaptive ladder sent to tier 2
        self._tls = threading.local()
        # the adaptive ladder's finish (tier 1's fetch, the decision, tier 2)
        # runs here, so batch i's escalation overlaps batch i+1's solve
        self._finish_pool = ThreadPoolExecutor(max_workers=2)
        self.depth_net = None
        if bool(cfg.DEPTH_NET.ENABLED):
            from mapfree_tpu_torch.models.depth import DepthPredictor

            self.depth_net = DepthPredictor(cfg, self.device)

    @property
    def metric(self) -> bool:
        return self.solver.startswith("EssentialMatrix") and self.solver != "EssentialMatrix"

    @staticmethod
    def _gather_depth_host(depth, kpts):
        """Depth maps (a stacked [B, H, W] array or a list of [H, W] maps) at
        floor(kpts) [B, N, 2] -> [B, N] float32 on the host."""
        out = np.zeros((len(depth), kpts.shape[1]), np.float32)
        for i in range(len(depth)):
            d = np.asarray(depth[i])
            H, W = d.shape
            x = np.clip(np.floor(kpts[i, :, 0]).astype(np.int64), 0, W - 1)
            y = np.clip(np.floor(kpts[i, :, 1]).astype(np.int64), 0, H - 1)
            out[i] = d[y, x]
        return out

    def _depth_map_host(self, batch, key):
        d = batch.get(key)
        ok = (d is not None and len(d) > 0
              and all(np.ndim(m) == 2 and np.size(m) for m in d))
        if not ok:
            raise ValueError(f"solver {self.solver} requires depth maps; set "
                             "DATASET.ESTIMATED_DEPTH or DEPTH_NET.ENABLED")
        return d

    def _named_arrays(self, batch, times):
        """[(name, array)] to ship, float32 first (aligned views on the
        device), then the masks and uint8 images; and the pair count."""
        cfg = self.cfg
        with times.stage("correspondences"):
            pts0, pts1, mask = self.feature_matching.get_correspondences(batch)
        named = [("pts0", pts0), ("pts1", pts1),
                 ("K0", np.asarray(batch["K_color0"], np.float32)),
                 ("K1", np.asarray(batch["K_color1"], np.float32))]
        tail = [("mask", mask)]
        if self.depth_net is not None and self.solver != "EssentialMatrix":
            # in-graph depth: ship the images, the net runs on the device
            images = ["image0"] if self.solver == "PNP" else ["image0", "image1"]
            for name in images:
                a = np.asarray(batch[name])
                (named if a.dtype == np.float32 else tail).append((name, a))
        elif self.metric:
            with times.stage("depth_gather"):
                named.append(("d0", self._gather_depth_host(self._depth_map_host(batch, "depth0"), pts0)))
                named.append(("d1", self._gather_depth_host(self._depth_map_host(batch, "depth1"), pts1)))
        elif self.solver == "PNP":
            with times.stage("depth_gather"):
                named.append(("d0", self._gather_depth_host(self._depth_map_host(batch, "depth0"), pts0)))
        elif self.solver == "Procrustes":
            d0 = np.stack([np.asarray(m, np.float32) for m in self._depth_map_host(batch, "depth0")])
            d1 = np.stack([np.asarray(m, np.float32) for m in self._depth_map_host(batch, "depth1")])
            named += [("depth0", d0), ("depth1", d1)]
            if bool(cfg.PROCRUSTES.REFINE):
                with times.stage("depth_gather"):
                    clouds = [[], [], [], []]
                    for i in range(pts0.shape[0]):
                        c0, m0 = dense_cloud_from_depth(
                            d0[i], np.asarray(batch["K_color0"][i]), ICP_POINTS, seed=i)
                        c1, m1 = dense_cloud_from_depth(
                            d1[i], np.asarray(batch["K_color1"][i]), ICP_POINTS, seed=i + 1)
                        for lst, a in zip(clouds, (c0, m0, c1, m1)):
                            lst.append(a)
                named += [("icp_cloud0", np.stack(clouds[0])), ("icp_cloud1", np.stack(clouds[2]))]
                tail += [("icp_mask0", np.stack(clouds[1])), ("icp_mask1", np.stack(clouds[3]))]
        return named + tail, pts0.shape[0]

    def transfer_batch(self, batch, times=None):
        """Host stage (safe on a worker thread): correspondences, host depth
        gather, then one packed, pinned host-to-device copy."""
        times = times or NULL_TIMES
        named, B = self._named_arrays(batch, times)
        spec = spec_of(named)
        arrays = [a for _, a in named]
        with times.stage("h2d"):
            dev, ready, host = ship_packed(arrays, self.device, self._tls)
        return dev, ready, host, B, spec

    def _next_step(self) -> int:
        with self._step_lock:
            step = self._step
            self._step += 1
        return step

    def _solve(self, d, sampler, times):
        """Issue the batch's solve; returns (packed [B, 13] tensor, None) or
        (None, the adaptive ladder's finish)."""
        cfg = self.cfg
        pts0, pts1, mask, K0, K1 = d["pts0"], d["pts1"], d["mask"], d["K0"], d["K1"]
        if self.solver.startswith("EssentialMatrix"):
            variant = "mean" if self.solver == "EssentialMatrixMetricMean" else "ransac"
            scale_thr = float(cfg.EMAT_RANSAC.SCALE_THRESHOLD)
            pix_thr = float(cfg.EMAT_RANSAC.PIX_THRESHOLD)
            point_depths = None
            if self.metric:
                if "d0" in d:
                    d0, d1 = d["d0"], d["d1"]
                else:
                    with times.stage("depth_net"):
                        d0 = self.depth_net.point_depths(d["image0"], pts0)
                        d1 = self.depth_net.point_depths(d["image1"], pts1)
                point_depths = (d0, d1, scale_thr, variant)
            if bool(cfg.TPU.ADAPTIVE_RANSAC):
                return None, essential_pose_adaptive_async(
                    pts0, pts1, mask, K0, K1, pix_thr, sampler, n_iters=self.n_iters,
                    point_depths=point_depths)
            if self.metric:
                out = essential_pose_metric(pts0, pts1, mask, K0, K1, pix_thr, d0, d1,
                                            scale_thr, sampler, variant=variant,
                                            n_iters=self.n_iters)
            else:
                out = essential_pose(pts0, pts1, mask, K0, K1, pix_thr, sampler,
                                     n_iters=self.n_iters)
        elif self.solver == "PNP":
            if "d0" in d:
                d0 = d["d0"]
            else:
                with times.stage("depth_net"):
                    d0 = self.depth_net.point_depths(d["image0"], pts0)
            out = pnp_pose(pts0, pts1, mask, d0, K0, K1,
                           float(cfg.PNP.REPROJECTION_INLIER_THRESHOLD), sampler,
                           n_iters=self.n_iters, point_depths=True)
        else:  # Procrustes
            if "depth0" in d:
                depth0, depth1 = d["depth0"], d["depth1"]
            else:
                with times.stage("depth_net"):
                    depth0, depth1 = self.depth_net(d["image0"]), self.depth_net(d["image1"])
            clouds = {k: d[k] for k in ("icp_cloud0", "icp_mask0", "icp_cloud1", "icp_mask1")
                      if k in d}
            out = procrustes_pose(pts0, pts1, mask, depth0, depth1, K0, K1,
                                  float(cfg.PROCRUSTES.MAX_CORR_DIST), sampler,
                                  n_iters=self.n_iters, refine=bool(cfg.PROCRUSTES.REFINE),
                                  **clouds)
        B = out["R"].shape[0]
        packed = torch.cat([out["R"].reshape(B, 9), out["t"].reshape(B, 3),
                            out["inliers"].reshape(B, 1).float()], dim=1)
        return packed, None

    def dispatch_device(self, transferred, times=None):
        """Device stage: unpack, the batch's minimal samples, the solve.
        Returns finalize() -> (R [B, 3, 3], t [B, 1, 3], inliers [B]) numpy."""
        times = times or NULL_TIMES
        dev, ready, _host, B, spec = transferred
        with times.stage("solve"):
            d = receive_packed(dev, ready, spec)
            sampler = self.sampler_for_step(self._next_step())
            packed, finish = self._solve(d, sampler, times)
            fut = host_out = done = None
            if finish is not None:
                fut = self._finish_pool.submit(finish)
            else:
                host_out, done = fetch_later(packed)

        def finalize():
            with times.stage("d2h_wait"):
                if fut is not None:
                    result = fut.result()
                    p = result["_host_packed"]
                    with self._step_lock:
                        self.escalated_pairs += result["escalated"]
                else:
                    if done is not None:
                        done.synchronize()
                    p = host_out.numpy()
            return p[:, :9].reshape(B, 3, 3), p[:, 9:12].reshape(B, 1, 3), p[:, 12].copy()

        return finalize

    def __call__(self, batch):
        """batch: a collated dict of numpy arrays -> (R [B, 3, 3], t [B, 1, 3],
        inliers [B]) numpy; NaN pose where estimation failed."""
        return self.dispatch_device(self.transfer_batch(batch))()
