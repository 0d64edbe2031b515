"""7Scenes dataset (visloc-relapose pair format; port of
mapfree_tpu/data/sevenscenes.py).

Behavioural equivalent of reference lib/datasets/sevenscenes.py:14-196:
(reference, query) pairs with relative pose + DVLAD similarity from a pair
txt, absolute poses from dataset_{train,test}.txt, fixed f=525 intrinsics,
optional one-NN filtering and estimated-depth suffixes. Its colour frames
and depth maps are PNGs, read on every host by the port's own reader
(data/io.py); the 640x480 frames at configs/sevenscenes.yaml's size need no
resize, so no image library either.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from mapfree_tpu_torch.data.io import read_color_image, read_depth_image
from mapfree_tpu_torch.data.mapfree import ConcatDataset
from mapfree_tpu_torch.geom.projection import correct_intrinsic_scale
from mapfree_tpu_torch.geom.quaternion import quat2mat


class SceneDataset:
    def __init__(self, scene_root, pair_txt, resize, transforms=None, one_nn=False,
                 estimated_depth=None):
        self.scene_root = scene_root
        self.transforms = transforms
        self.resize = resize
        self.estimated_depth = estimated_depth

        self.im_pairs, self.relv_poses, _, self.sim = self.parse_relv_pose_txt(
            os.path.join(scene_root, pair_txt)
        )
        self.original_idxs = list(range(len(self.im_pairs)))
        if one_nn:
            self.filter_one_nn()
        self.num = len(self.im_pairs)

        self.abs_poses = self.parse_abs_pose_txt(
            os.path.join(scene_root, "dataset_test.txt"))
        self.abs_poses.update(
            self.parse_abs_pose_txt(os.path.join(scene_root, "dataset_train.txt")))

        # static intrinsics of the 7Scenes Kinect (f=525, 640x480)
        K = np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]], np.float32)
        self.K = correct_intrinsic_scale(
            K, resize[0] / 640, resize[1] / 480
        ).astype(np.float32)

    @staticmethod
    def parse_relv_pose_txt(fpath, with_ess=False):
        """Pair line format: image1 image2 sim qw qx qy qz tx ty tz [ess..]."""
        im_pairs, relv_poses, sim = [], [], []
        ess_vecs = [] if with_ess else None
        with open(fpath) as f:
            for line in f:
                cur = line.split()
                im_pairs.append((cur[0], cur[1]))
                sim.append(float(cur[2]))
                q = np.array([float(i) for i in cur[3:7]], dtype=np.float64)
                t = np.array([float(i) for i in cur[7:10]], dtype=np.float32)
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = quat2mat(q)
                T[:3, -1] = t
                relv_poses.append(T)
                if with_ess:
                    ess_vecs.append(
                        np.array([float(i) for i in cur[10:19]], dtype=np.float32))
        return im_pairs, relv_poses, ess_vecs, sim

    @staticmethod
    def parse_abs_pose_txt(fpath):
        """3 header lines, then: image x y z qw qx qy qz (c2w center + quat)."""
        pose_dict = {}
        with open(fpath) as f:
            for line in f.readlines()[3:]:
                cur = line.split(" ")
                c = np.array([float(v) for v in cur[1:4]], dtype=np.float32)
                q = np.array([float(v) for v in cur[4:8]], dtype=np.float32)
                pose_dict[cur[0]] = (c, q)
        return pose_dict

    def filter_one_nn(self):
        """Keep only the highest-similarity reference per query
        (reference sevenscenes.py:93-112)."""
        kept_idx, kept_sim = {}, {}
        for i, ((ref, query), sim) in enumerate(zip(self.im_pairs, self.sim)):
            if query in kept_sim and sim < kept_sim[query]:
                continue
            kept_idx[query] = i
            kept_sim[query] = sim
        keep = list(kept_idx.values())
        self.im_pairs = [self.im_pairs[i] for i in keep]
        self.relv_poses = [self.relv_poses[i] for i in keep]
        self.sim = [self.sim[i] for i in keep]
        self.original_idxs = keep

    def __len__(self):
        return self.num

    def __getitem__(self, index):
        im1_path, im2_path = [
            os.path.join(self.scene_root, p) for p in self.im_pairs[index]
        ]
        image1 = read_color_image(im1_path, self.resize, augment_fn=self.transforms)
        image2 = read_color_image(im2_path, self.resize, augment_fn=self.transforms)

        suffix = ".depth." if self.estimated_depth is None else f".depth.{self.estimated_depth}."
        depth1 = read_depth_image(im1_path.replace(".color.", suffix))
        depth2 = read_depth_image(im2_path.replace(".color.", suffix))

        im1ref, im2ref = self.im_pairs[index]
        c1, q1 = self.abs_poses[im1ref]
        c2, q2 = self.abs_poses[im2ref]

        return {
            "image0": image1,
            "depth0": depth1,
            "image1": image2,
            "depth1": depth2,
            "T_0to1": self.relv_poses[index],
            "abs_q_0": q1,
            "abs_c_0": c1,
            "abs_q_1": q2,
            "abs_c_1": c2,
            "sim": self.sim[index],
            "K_color0": self.K.copy(),
            "K_color1": self.K.copy(),
            "K_depth": self.K.copy(),
            "dataset_name": "7Scenes",
            "scene_id": str(self.scene_root).rstrip("/").split("/")[-1],
            "scene_root": str(self.scene_root),
            "pair_id": self.original_idxs[index],
            "pair_names": self.im_pairs[index],
        }


class SevenScenesDataset(ConcatDataset):
    def __init__(self, cfg, mode, transforms=None, device="cuda"):
        assert mode in ("train", "val", "test"), "Invalid dataset mode"
        scenes = cfg.DATASET.SCENES
        data_root = cfg.DATASET.DATA_ROOT
        resize = (cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT)
        estimated_depth = cfg.DATASET.ESTIMATED_DEPTH
        pair_txt = {
            "train": cfg.DATASET.PAIRS_TXT.TRAIN,
            "val": cfg.DATASET.PAIRS_TXT.VAL,
            "test": cfg.DATASET.PAIRS_TXT.TEST,
        }[mode]
        one_nn = cfg.DATASET.PAIRS_TXT.ONE_NN

        if scenes is None:
            scenes = self.glob_scenes(data_root, pair_txt)

        super().__init__([
            SceneDataset(
                os.path.join(data_root, scene), pair_txt, resize, transforms,
                one_nn, estimated_depth,
            )
            for scene in scenes
        ], device=device)

    @staticmethod
    def glob_scenes(data_root, pair_txt):
        scenes = []
        for sdir in glob.iglob(f"{data_root}/*/{pair_txt}"):
            scenes.append(sdir.split("/")[-2])
        return sorted(scenes)
