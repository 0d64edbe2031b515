"""Offline correspondence precompute CLI (port of
mapfree_tpu/tools/precompute_correspondences.py).

Equivalent of reference etc/feature_matching_baselines/compute.py:10-102:
runs a matcher over every evaluation pair of MapFree/7Scenes/ScanNet and
writes NaN-padded ``[N_pairs, maxN, 4]`` npz files in the exact layout the
``Precomputed`` source consumes.

Matchers:
- SIFT: OpenCV's detector and descriptor on the host (cv2, as the JAX tool
  reads and detects) and the exact 2-NN ratio matcher (ops/matching.py) on
  ``--device`` (replaces the reference's FLANN KD-tree). Without cv2 the
  matcher raises when it is built;
- LoFTR / SuperGlue require their external pretrained weights (inputs, not
  in-repo components — SURVEY.md §2.9); pass precomputed npz through, or plug
  a matcher callable with the same interface.

Run: ``python -m mapfree_tpu_torch.tools.precompute_correspondences -ds Mapfree -m SIFT``
(``--device cpu`` to match on the CPU; the default is the card).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np


def stack_pts(pts_list):
    """[Ni, D] arrays -> [N, max(Ni), D] NaN-padded stack
    (reference etc/feature_matching_baselines/utils.py:59-69)."""
    assert len(pts_list) > 0, "list must not be empty"
    N = len(pts_list)
    max_npts = max(p.shape[0] for p in pts_list)
    D = pts_list[0].shape[1]
    out = np.full((N, max(max_npts, 1), D), np.nan)
    for i, pts in enumerate(pts_list):
        out[i, : pts.shape[0]] = pts
    return out


def parse_mapfree_query_frames(pose_path: Path):
    query_paths = []
    with pose_path.open("r") as f:
        for line in f.readlines():
            if "#" in line or "seq0" in line:
                continue
            query_paths.append(line.strip().split(" ")[0])
    return query_paths


def parse_7scenes_matching_pairs(pair_txt):
    """pair line: image1 image2 sim qw qx qy qz tx ty tz [ess 9]"""
    im_pairs = {}
    with open(pair_txt) as f:
        for line in f:
            cur = line.split()
            q = np.array([float(i) for i in cur[3:7]], np.float32)
            t = np.array([float(i) for i in cur[7:10]], np.float32)
            ess = (np.array([float(i) for i in cur[10:19]], np.float32).reshape(3, 3)
                   if len(cur) >= 19 else None)
            im_pairs[(cur[0], cur[1])] = (q, t, ess)
    return im_pairs


def load_scannet_imgpaths(npz_path, root_dir):
    data_names = np.load(npz_path)["name"]
    pair_paths = []
    for scene_name, scene_sub_name, stem0, stem1 in data_names:
        scene = f"scene{scene_name:04d}_{scene_sub_name:02d}"
        pair_paths.append((
            os.path.join(root_dir, scene, "sensor_data", f"frame-{stem0:06}.color.jpg"),
            os.path.join(root_dir, scene, "sensor_data", f"frame-{stem1:06}.color.jpg"),
        ))
    return pair_paths


class SIFTMatcherBatched:
    """SIFT over image pairs with the exact 2-NN ratio matcher on
    ``device``."""

    def __init__(self, resize, num_features: int = 2048, ratio: float = 0.8,
                 device="cuda"):
        try:
            import cv2
        except ImportError:
            raise RuntimeError("the SIFT matcher reads and detects with OpenCV (cv2) on the "
                               "host, and this host has no cv2") from None

        from mapfree_tpu_torch.models.builder import resolve_device

        self.device = resolve_device(device)
        self.cv2 = cv2
        self.resize = resize  # (w, h)
        self.sift = cv2.SIFT_create(num_features)
        self.num_features = num_features
        self.ratio = ratio

    def _detect(self, path):
        img = self.cv2.imread(str(path), self.cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        img = self.cv2.resize(img, tuple(self.resize))
        kp, des = self.sift.detectAndCompute(img, None)
        if des is None or len(kp) == 0:
            return np.zeros((0, 2), np.float32), np.zeros((0, 128), np.float32)
        des = des / (des.sum(axis=1, keepdims=True) + 1e-7)  # rootSIFT
        des = np.sqrt(des)
        return np.array([k.pt for k in kp], np.float32), des.astype(np.float32)

    def match(self, pair):
        import torch

        from mapfree_tpu_torch.ops.matching import mutual_2nn_ratio_match

        p0, d0 = self._detect(pair[0])
        p1, d1 = self._detect(pair[1])
        if len(p0) == 0 or len(p1) == 0:
            return np.zeros((0, 4), np.float32)
        N = self.num_features
        dd0 = np.zeros((1, N, 128), np.float32)
        dd1 = np.zeros((1, N, 128), np.float32)
        m0 = np.zeros((1, N), bool)
        m1 = np.zeros((1, N), bool)
        n0, n1 = min(len(p0), N), min(len(p1), N)
        dd0[0, :n0], m0[0, :n0] = d0[:n0], True
        dd1[0, :n1], m1[0, :n1] = d1[:n1], True
        idx1, ok = mutual_2nn_ratio_match(
            *(torch.as_tensor(a).to(self.device) for a in (dd0, dd1, m0, m1)), self.ratio)
        sel = ok[0].cpu().numpy()
        idx = idx1[0].cpu().numpy()
        rows = np.where(sel[:n0])[0]
        return np.concatenate([p0[rows], p1[idx[rows]]], axis=-1).astype(np.float32)


MATCHERS = {"SIFT": SIFTMatcherBatched}


def run_mapfree(args, matcher):
    data_root = Path(args.data_root)
    scenes = [f for split in ("test", "val") if (data_root / split).exists()
              for f in sorted((data_root / split).iterdir()) if f.is_dir()]
    if args.scenes:
        scenes = [s for s in scenes if s.name in args.scenes]
    for scene_dir in scenes:
        queries = parse_mapfree_query_frames(scene_dir / "poses.txt")
        pairs = [(str(scene_dir / "seq0" / "frame_00000.jpg"), str(scene_dir / q))
                 for q in queries]
        print(f"Started {scene_dir.name} ({len(pairs)} pairs)")
        pts_stack = stack_pts([matcher.match(p) for p in pairs])
        np.savez_compressed(scene_dir / f"correspondences_{args.matcher}.npz",
                            correspondences=pts_stack)
        print(f"Finished {scene_dir.name}")


def run_7scenes(args, matcher):
    scenes = args.scenes or ["chess", "fire", "heads", "office", "pumpkin",
                             "redkitchen", "stairs"]
    for scene in scenes:
        scene_dir = Path(args.data_root) / scene
        im_pairs = parse_7scenes_matching_pairs(str(scene_dir / args.pair_txt))
        pairs = [(str(scene_dir / a), str(scene_dir / b)) for (a, b) in im_pairs]
        print(f"Started {scene} ({len(pairs)} pairs)")
        pts_stack = stack_pts([matcher.match(p) for p in pairs])
        np.savez_compressed(
            scene_dir / f"correspondences_{args.matcher}_{args.pair_txt}.npz",
            correspondences=pts_stack,
        )
        print(f"Finished {scene}")


def run_scannet(args, matcher):
    pairs = load_scannet_imgpaths(args.pair_npz, args.data_root)
    print(f"Started Scannet ({len(pairs)} pairs)")
    pts_stack = stack_pts([matcher.match(p) for p in pairs])
    out = Path(args.data_root).parent / "scannet_misc"
    out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out / f"correspondences_{args.matcher}_scannet_test.npz",
                        correspondences=pts_stack)
    print("Finished Scannet")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m mapfree_tpu_torch.tools.precompute_correspondences")
    parser.add_argument("--dataset", "-ds", default="Mapfree",
                        choices=["Scannet", "7Scenes", "Mapfree"])
    parser.add_argument("--matcher", "-m", default="SIFT", choices=MATCHERS.keys())
    parser.add_argument("--scenes", "-sc", type=str, nargs="*", default=None)
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--pair_txt", default="test_pairs.5nn.5cm10m.vlad.minmax.txt")
    parser.add_argument("--pair_npz",
                        default="data/scannet_indices/scene_data/test/test.npz")
    parser.add_argument("--num_features", type=int, default=2048)
    parser.add_argument("--ratio_threshold", type=float, default=0.8)
    parser.add_argument("--device", default="cuda",
                        help="torch device the matcher runs on (default: cuda)")
    args = parser.parse_args(argv)

    defaults = {"Mapfree": ("data/mapfree", (540, 720)),
                "7Scenes": ("data/sevenscenes", (640, 480)),
                "Scannet": ("data/scannet/scans_test", (640, 480))}
    root, resize = defaults[args.dataset]
    args.data_root = args.data_root or root

    matcher = MATCHERS[args.matcher](resize, args.num_features, args.ratio_threshold,
                                     device=args.device)
    {"Mapfree": run_mapfree, "7Scenes": run_7scenes, "Scannet": run_scannet}[
        args.dataset
    ](args, matcher)


if __name__ == "__main__":
    main()
