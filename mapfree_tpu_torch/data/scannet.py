"""ScanNet dataset (LoFTR-style pair indices; port of
mapfree_tpu/data/scannet.py).

Behavioural equivalent of reference lib/datasets/scannet.py:19-163: pair lists
+ overlap scores from npz index files, c2w poses converted to w2c relative
transforms, intrinsics from ``_info.txt``, GT pgm depth or precomputed-depth
npz. Samples use the framework's NHWC numpy contract. The 16-bit pgm depth
maps are read on every host by the port's own reader (data/io.py).
"""

from __future__ import annotations

import os.path as osp
from os import listdir
from pathlib import Path

import numpy as np

from mapfree_tpu_torch.data.io import read_color_image, read_depth_image
from mapfree_tpu_torch.data.mapfree import ConcatDataset
from mapfree_tpu_torch.geom.projection import correct_intrinsic_scale


def read_scannet_pose(path) -> np.ndarray:
    """Camera2World pose file -> World2Camera 4x4
    (reference lib/datasets/utils.py:84-92)."""
    cam2world = np.loadtxt(path, delimiter=" ")
    return np.linalg.inv(cam2world)


def read_scannet_intrinsic(path, color: bool = True) -> np.ndarray:
    """3x3 intrinsics from a ScanNet _info.txt
    (reference lib/datasets/utils.py:95-114)."""
    key = "m_calibrationColorIntrinsic" if color else "m_calibrationDepthIntrinsic"
    with open(path, "r") as f:
        for line in f.readlines():
            if key in line:
                mat = line.split(" = ")[1].strip().split(" ")
                return np.array([float(m) for m in mat]).reshape(4, 4)[:-1, :-1]
    raise Exception(f"Invalid key {key}")


class ScanNetScene:
    def __init__(self, root_dir, npz_path, mode="train", min_overlap_score=0.4,
                 augment_fn=None, resize=(640, 480), estimated_depth=None):
        self.root_dir = root_dir
        self.mode = mode
        self.resize = resize

        with np.load(npz_path) as data:
            self.data_names = data["name"]
            if "score" in data.keys() and mode not in ("val", "test"):
                kept_mask = data["score"] > min_overlap_score
                self.data_names = self.data_names[kept_mask]

        self.augment_fn = augment_fn if mode == "train" else None
        self.transforms = self.augment_fn  # batch-decode protocol alias
        self.depthmaps = (
            np.load(estimated_depth) if estimated_depth is not None else None
        )

    def __len__(self):
        return len(self.data_names)

    def _read_abs_pose(self, scene_name, name):
        return read_scannet_pose(
            osp.join(self.root_dir, scene_name, "sensor_data",
                     f"frame-{name:06}.pose.txt")
        )

    def _compute_rel_pose(self, scene_name, name0, name1):
        pose0 = self._read_abs_pose(scene_name, name0)
        pose1 = self._read_abs_pose(scene_name, name1)
        return pose1 @ np.linalg.inv(pose0)

    def _names(self, idx):
        scene_name, scene_sub_name, stem_name_0, stem_name_1 = self.data_names[idx]
        return f"scene{scene_name:04d}_{scene_sub_name:02d}", stem_name_0, stem_name_1

    def image_paths(self, idx):
        """Batch-decode protocol (see ConcatDataset.getitems)."""
        scene_name, s0, s1 = self._names(idx)
        sensor = osp.join(self.root_dir, scene_name, "sensor_data")
        return [osp.join(sensor, f"frame-{s0:06}.color.jpg"),
                osp.join(sensor, f"frame-{s1:06}.color.jpg")]

    def __getitem__(self, idx):
        images = [
            read_color_image(p, resize=self.resize)
            for p in self.image_paths(idx)
        ]
        return self.getitem_decoded(idx, images)

    def getitem_decoded(self, idx, images):
        from mapfree_tpu_torch.data.mapfree import _as_float01

        scene_name, stem_name_0, stem_name_1 = self._names(idx)
        sensor = osp.join(self.root_dir, scene_name, "sensor_data")

        image0, image1 = images
        if self.augment_fn is not None:
            image0 = self.augment_fn(_as_float01(image0))
            image1 = self.augment_fn(_as_float01(image1))

        if self.mode == "test":
            if self.depthmaps is None:
                depth0 = read_depth_image(
                    osp.join(sensor, f"frame-{stem_name_0:06}.depth.pgm"))
                depth1 = read_depth_image(
                    osp.join(sensor, f"frame-{stem_name_1:06}.depth.pgm"))
            else:
                def key(i):
                    return f"{scene_name[5:]}_frame_{i:06}"

                depth0 = self.depthmaps[key(stem_name_0)].astype(np.float32)
                depth1 = self.depthmaps[key(stem_name_1)].astype(np.float32)
        else:
            depth0 = depth1 = np.zeros((0,), np.float32)

        info = osp.join(sensor, "_info.txt")
        K_color = read_scannet_intrinsic(info, color=True)
        K_color = correct_intrinsic_scale(
            K_color, self.resize[0] / 1296, self.resize[1] / 968
        ).astype(np.float32)
        K_depth = read_scannet_intrinsic(info, color=False).astype(np.float32)

        T_0to1 = self._compute_rel_pose(scene_name, stem_name_0, stem_name_1).astype(
            np.float32
        )

        return {
            "image0": image0,
            "depth0": depth0,
            "image1": image1,
            "depth1": depth1,
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "K_color0": K_color,
            "K_color1": K_color,
            "K_depth": K_depth,
            "dataset_name": "ScanNet",
            "scene_id": scene_name,
            "pair_id": idx,
            "pair_names": (
                osp.join(scene_name, "color", f"{stem_name_0}.jpg"),
                osp.join(scene_name, "color", f"{stem_name_1}.jpg"),
            ),
        }


class ScanNetDataset(ConcatDataset):
    def __init__(self, cfg, mode: str, transforms=None, device="cuda"):
        assert mode in ("train", "val", "test"), "Invalid dataset mode"

        root_dir = cfg.DATASET.DATA_ROOT
        index_npz_dir = cfg.DATASET.NPZ_ROOT
        min_overlap_score = cfg.DATASET.MIN_OVERLAP_SCORE
        resize = (cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT)
        estimated_depth = cfg.DATASET.ESTIMATED_DEPTH

        root_dir = osp.join(root_dir, "scans_test" if mode == "test" else "scans")
        npz_path = osp.join(index_npz_dir, mode)
        npz_list = sorted(
            osp.join(npz_path, f) for f in listdir(npz_path) if f.endswith("npz")
        )

        super().__init__([
            ScanNetScene(
                root_dir=root_dir,
                npz_path=p,
                mode=mode,
                min_overlap_score=min_overlap_score,
                augment_fn=transforms,
                resize=resize,
                estimated_depth=estimated_depth,
            )
            for p in npz_list
        ], device=device)
