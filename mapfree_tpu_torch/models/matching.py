"""Feature-matching pose model: correspondences -> batched RANSAC solvers
(port of mapfree_tpu/models/matching.py).

Batches of padded correspondences go through one batched solve per batch
(every pair's hypotheses, scores and refinements at once), where the
reference loops over OpenCV one pair at a time (reference
lib/models/matching/model.py:7-40, feature_matching.py:5-118).

Correspondence sources (``FEATURE_MATCHING``):
- ``Precomputed``: the NaN-padded ``correspondences`` of an npz (LoFTR,
  SuperGlue or SIFT matches made offline), per scene through the
  ``{scene_root}`` path template;
- ``SIFT``: OpenCV's SIFT on the host, as the reference drives it, and the
  exact 2-NN ratio matcher (ops/matching.py) on the model's device. It needs
  cv2, which the machine with the card lacks: there the config raises when
  the model is built, naming ``SIFT_TPU``;
- ``SIFT_TPU``: the on-device SIFT of ops/sift.py and the same matcher, on
  the card. The JAX class runs its detector inside ``transfer_batch`` and
  pulls the keypoints to the host to pad them; here the images go to the
  device in the batch's one packed copy, and detection, matching and the
  padding (a stable compaction of the matches to the front, as
  ``pad_correspondences`` lays them out) run in ``dispatch_device``, before
  the solve, with no round trip. File depth for the metric and PnP solvers
  then travels as whole maps and is gathered at the keypoints on the device
  (the same floor-indexing as the host gather).

:meth:`FeatureMatchingModel.transfer_batch` (a worker thread) fetches the
correspondences (host sources), gathers the file depth at the keypoints on
the host (the maps stay uncollated: [B, N] depths cross the bus, not [B, H,
W] maps), packs every array into one pinned buffer and copies it to the
device on a side stream. :meth:`FeatureMatchingModel.dispatch_device` (the
calling thread) unpacks it on the device, runs the on-device matcher if
there is one, draws the batch's minimal samples and issues the solve; its
``finalize()`` returns (R, t, inliers) as numpy after one device-to-host
copy. The adaptive essential ladder's ``finish`` (tier 1's fetch, the
escalation decision, tier 2) runs on a pool of two threads.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mapfree_tpu_torch.ops.essential import (essential_pose, essential_pose_adaptive_async,
                                             essential_pose_metric)
from mapfree_tpu_torch.ops.matching import mutual_2nn_ratio_match
from mapfree_tpu_torch.ops.pnp import pnp_pose
from mapfree_tpu_torch.ops.procrustes_ransac import dense_cloud_from_depth, procrustes_pose
from mapfree_tpu_torch.ops.ransac import device_sampler
from mapfree_tpu_torch.models.builder import fetch_later, receive_packed, ship_packed
from mapfree_tpu_torch.utils.packing import spec_of
from mapfree_tpu_torch.utils.timing import NULL_TIMES, stage

SOLVERS = ("EssentialMatrix", "EssentialMatrixMetric", "EssentialMatrixMetricMean",
           "Procrustes", "PNP")
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
            # a fixed table (the ScanNet configs) needs no scene root, and
            # ScanNet's samples carry none (the JAX package asks for it and
            # raises a KeyError there: ROADMAP.md section 3)
            table = (self.fixed if self.fixed is not None else
                     self._scene_correspondences(batch["scene_id"][i], batch["scene_root"][i]))
            corr = table[int(batch["pair_id"][i])]
            corr_list.append(corr[~np.isnan(corr)].reshape(-1, 4))
        return pad_correspondences(corr_list, self.max_n)


class SIFTMatching:
    """OpenCV's SIFT keypoints and descriptors on the host (reference
    feature_matching.py:53-118: the reference's detector is the same OpenCV
    kernel) and the exact 2-NN ratio matcher on ``device``."""

    on_device = False

    def __init__(self, cfg, device):
        try:
            import cv2
        except ImportError:
            raise RuntimeError(
                "FEATURE_MATCHING SIFT detects with OpenCV (cv2) on the host, and this host "
                "has no cv2: use FEATURE_MATCHING SIFT_TPU, the on-device SIFT "
                "(ops/sift.py)") from None
        self.device = device
        self.ratio_threshold = float(cfg.SIFT.RATIO_THRESHOLD)
        self.num_features = int(cfg.SIFT.NUM_FEATURES)
        self.sift = cv2.SIFT_create(self.num_features)
        self.max_n = int(cfg.TPU.MAX_CORRESPONDENCES)
        self._cv2 = cv2
        # transfer_batch runs on worker threads; one shared cv2 detector is
        # not documented thread-safe
        self._lock = threading.Lock()

    @staticmethod
    def _root_sift(descs):
        """Hellinger kernel: L1-normalise then sqrt."""
        descs = descs / (descs.sum(axis=1, keepdims=True) + 1e-7)
        return np.sqrt(descs)

    def _detect(self, image_nhwc):
        if image_nhwc.dtype == np.uint8:
            img = np.asarray(image_nhwc)
        else:
            img = (image_nhwc * 255).astype(np.uint8)
        gray = self._cv2.cvtColor(img, self._cv2.COLOR_RGB2GRAY)
        with self._lock:
            kp, des = self.sift.detectAndCompute(gray, None)
        if des is None or len(kp) == 0:
            return np.zeros((0, 2), np.float32), np.zeros((0, 128), np.float32)
        pts = np.array([k.pt for k in kp], np.float32)
        return pts, self._root_sift(des.astype(np.float32))

    def get_correspondences(self, batch):
        B = batch["image0"].shape[0]
        N = self.num_features
        kp0 = np.zeros((B, N, 2), np.float32)
        kp1 = np.zeros((B, N, 2), np.float32)
        d0 = np.zeros((B, N, 128), np.float32)
        d1 = np.zeros((B, N, 128), np.float32)
        m0 = np.zeros((B, N), bool)
        m1 = np.zeros((B, N), bool)
        for i in range(B):
            p0, dd0 = self._detect(batch["image0"][i])
            p1, dd1 = self._detect(batch["image1"][i])
            n0, n1 = min(len(p0), N), min(len(p1), N)
            kp0[i, :n0], d0[i, :n0], m0[i, :n0] = p0[:n0], dd0[:n0], True
            kp1[i, :n1], d1[i, :n1], m1[i, :n1] = p1[:n1], dd1[:n1], True
        idx1, ok = mutual_2nn_ratio_match(
            *(torch.as_tensor(a).to(self.device) for a in (d0, d1, m0, m1)),
            self.ratio_threshold)
        idx1, ok = idx1.cpu().numpy(), ok.cpu().numpy()
        corr_list = [np.concatenate([kp0[i][ok[i]], kp1[i][idx1[i][ok[i]]]], axis=-1)
                     for i in range(B)]
        return pad_correspondences(corr_list, self.max_n)


def compact_matches(kp0, kp1, ok, max_n: int):
    """The device counterpart of :func:`pad_correspondences`: the matched
    rows of kp0 [B, N, 2] and kp1 [B, N, 2] (ok [B, N]) moved to the front
    in their order, cut or zero-padded to ``max_n`` -> (pts0, pts1, mask)."""
    B, N = ok.shape
    order = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)[:, :max_n]
    mask = torch.gather(ok, 1, order)
    keep = mask[..., None].to(kp0.dtype)
    pts0 = torch.gather(kp0, 1, order[..., None].expand(-1, -1, 2)) * keep
    pts1 = torch.gather(kp1, 1, order[..., None].expand(-1, -1, 2)) * keep
    if max_n > N:
        pad = max_n - N
        pts0, pts1 = (torch.nn.functional.pad(p, (0, 0, 0, pad)) for p in (pts0, pts1))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return pts0, pts1, mask


def gather_depth_device(depth, kpts):
    """Depth maps [B, H, W] at floor(kpts) [B, N, 2], clamped to the map:
    [B, N]. The device counterpart of the host gather
    (:meth:`FeatureMatchingModel._gather_depth_host`)."""
    H, W = depth.shape[-2:]
    x = torch.clamp(torch.floor(kpts[..., 0]).long(), 0, W - 1)
    y = torch.clamp(torch.floor(kpts[..., 1]).long(), 0, H - 1)
    return torch.gather(depth.reshape(depth.shape[0], -1), 1, y * W + x)


class TPUSIFTMatching:
    """On-device SIFT (ops/sift.py) and the exact 2-NN ratio matcher: one
    pass over both views of the batch on the device, no host OpenCV."""

    on_device = True

    def __init__(self, cfg):
        self.ratio_threshold = float(cfg.SIFT.RATIO_THRESHOLD)
        self.num_features = int(cfg.SIFT.NUM_FEATURES)
        self.max_n = int(cfg.TPU.MAX_CORRESPONDENCES)

    def correspond(self, image0, image1):
        """RGB images [B, H, W, 3] (uint8, or float in [0, 1]) on the device
        -> (pts0 [B, max_n, 2], pts1 [B, max_n, 2], mask [B, max_n])."""
        from mapfree_tpu_torch.ops.sift import rgb_to_gray, root_sift, sift_detect_describe

        B = image0.shape[0]
        out = sift_detect_describe(rgb_to_gray(torch.cat([image0, image1])),  # both views
                                   num_features=self.num_features)
        out0 = {k: v[:B] for k, v in out.items()}
        out1 = {k: v[B:] for k, v in out.items()}
        idx1, ok = mutual_2nn_ratio_match(
            root_sift(out0["descriptors"]), root_sift(out1["descriptors"]),
            out0["mask"], out1["mask"], self.ratio_threshold)
        kp1 = torch.gather(out1["keypoints"], 1, idx1[..., None].expand(-1, -1, 2))
        return compact_matches(out0["keypoints"], kp1, ok, self.max_n)


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
        elif cfg.FEATURE_MATCHING == "SIFT":
            self.feature_matching = SIFTMatching(cfg, self.device)
        elif cfg.FEATURE_MATCHING == "SIFT_TPU":
            self.feature_matching = TPUSIFTMatching(cfg)
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
    def _matches_on_device(self) -> bool:
        """Whether the source finds correspondences on the device
        (``correspond``) rather than on the host (``get_correspondences``,
        the interface any other source keeps)."""
        return getattr(self.feature_matching, "on_device", False)

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
        device), then the masks and uint8 images; and the pair count. An
        on-device matcher gets the images, and the file depth it needs as
        whole maps (its keypoints are found on the device)."""
        cfg = self.cfg
        on_device = self._matches_on_device
        named = [("K0", np.asarray(batch["K_color0"], np.float32)),
                 ("K1", np.asarray(batch["K_color1"], np.float32))]
        tail = []
        B = named[0][1].shape[0]
        if not on_device:
            with stage(times, "correspondences"):
                pts0, pts1, mask = self.feature_matching.get_correspondences(batch)
            named = [("pts0", pts0), ("pts1", pts1)] + named
            tail.append(("mask", mask))
        depth_net = self.depth_net is not None and self.solver != "EssentialMatrix"
        images = []
        if on_device:
            images = ["image0", "image1"]
        elif depth_net:
            # in-graph depth: ship the images, the net runs on the device
            images = ["image0"] if self.solver == "PNP" else ["image0", "image1"]
        for name in images:
            a = np.asarray(batch[name])
            (named if a.dtype == np.float32 else tail).append((name, a))
        if depth_net:
            pass
        elif self.metric or self.solver == "PNP":
            maps = ["depth0", "depth1"] if self.metric else ["depth0"]
            if on_device:
                named += [(m, np.stack([np.asarray(d, np.float32)
                                        for d in self._depth_map_host(batch, m)]))
                          for m in maps]
            else:
                with stage(times, "depth_gather"):
                    for key, m, pts in zip(("d0", "d1"), maps, (pts0, pts1)):
                        named.append((key, self._gather_depth_host(self._depth_map_host(batch, m),
                                                                   pts)))
        elif self.solver == "Procrustes":
            d0 = np.stack([np.asarray(m, np.float32) for m in self._depth_map_host(batch, "depth0")])
            d1 = np.stack([np.asarray(m, np.float32) for m in self._depth_map_host(batch, "depth1")])
            named += [("depth0", d0), ("depth1", d1)]
            if bool(cfg.PROCRUSTES.REFINE):
                with stage(times, "depth_gather"):
                    clouds = [[], [], [], []]
                    for i in range(B):
                        c0, m0 = dense_cloud_from_depth(
                            d0[i], np.asarray(batch["K_color0"][i]), ICP_POINTS, seed=i)
                        c1, m1 = dense_cloud_from_depth(
                            d1[i], np.asarray(batch["K_color1"][i]), ICP_POINTS, seed=i + 1)
                        for lst, a in zip(clouds, (c0, m0, c1, m1)):
                            lst.append(a)
                named += [("icp_cloud0", np.stack(clouds[0])), ("icp_cloud1", np.stack(clouds[2]))]
                tail += [("icp_mask0", np.stack(clouds[1])), ("icp_mask1", np.stack(clouds[3]))]
        return named + tail, B

    def _match_on_device(self, d, times):
        """The on-device matcher's correspondences into ``d``, and the file
        depth gathered at them where the solver takes point depths."""
        with stage(times, "correspondences"):
            d["pts0"], d["pts1"], d["mask"] = self.feature_matching.correspond(
                d["image0"], d["image1"])
        if (self.metric or self.solver == "PNP") and "depth0" in d:
            with stage(times, "depth_gather"):
                d["d0"] = gather_depth_device(d["depth0"], d["pts0"])
                if self.metric:
                    d["d1"] = gather_depth_device(d["depth1"], d["pts1"])

    def transfer_batch(self, batch, times=None):
        """Host stage (safe on a worker thread): correspondences, host depth
        gather, then one packed, pinned host-to-device copy."""
        times = times or NULL_TIMES
        named, B = self._named_arrays(batch, times)
        spec = spec_of(named)
        arrays = [a for _, a in named]
        with stage(times, "h2d"):
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
                    with stage(times, "depth_net"):
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
                with stage(times, "depth_net"):
                    d0 = self.depth_net.point_depths(d["image0"], pts0)
            out = pnp_pose(pts0, pts1, mask, d0, K0, K1,
                           float(cfg.PNP.REPROJECTION_INLIER_THRESHOLD), sampler,
                           n_iters=self.n_iters, point_depths=True)
        else:  # Procrustes
            if "depth0" in d:
                depth0, depth1 = d["depth0"], d["depth1"]
            else:
                with stage(times, "depth_net"):
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
        with stage(times, "solve"):
            d = receive_packed(dev, ready, spec)
            if self._matches_on_device:
                self._match_on_device(d, times)
            sampler = self.sampler_for_step(self._next_step())
            packed, finish = self._solve(d, sampler, times)
            fut = host_out = done = None
            if finish is not None:
                fut = self._finish_pool.submit(finish)
            else:
                host_out, done = fetch_later(packed)

        def finalize():
            with stage(times, "d2h_wait"):
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
