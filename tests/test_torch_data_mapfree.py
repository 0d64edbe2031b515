"""PyTorch port, the MapFree data layer (mapfree_tpu_torch/data/mapfree.py,
loader.py, datamodule.py) against mapfree_tpu.data on the CPU.

The same synthetic scene trees (tests/fixtures.py::make_scene, in tmp_path)
go through the JAX package's and the port's datasets and loaders: the same
keys in the same order, uint8 and YUV420 images bit-equal, float images and
poses within 1e-6, the same metadata. Both decode on the host with cv2 (the
JAX package's branch where its C++ decoder is not built), so both loaders
take the per-item path; ``getitems`` and the unique-ref ``getbatch`` are
called directly."""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("cv2")

import mapfree_tpu.data.io as jax_io  # noqa: E402
from fixtures import make_device_poses, make_scene  # noqa: E402
from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.data import DataModule as JaxDataModule  # noqa: E402
from mapfree_tpu.data import MapFreeDataset as JaxMapFreeDataset  # noqa: E402

from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.data import DataModule, MapFreeDataset  # noqa: E402

from torch_batches import assert_same_batches  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

REPO = Path(__file__).resolve().parents[1]
H, W = 48, 36  # resized from make_scene's 64x48 frames


@pytest.fixture(autouse=True)
def jax_cv2_branch(monkeypatch):
    """The JAX package as it runs where its C++ decoder is not built."""
    monkeypatch.setattr(jax_io, "_HAS_NATIVE", False)
    monkeypatch.setattr(jax_io, "HAS_NATIVE_DECODER", False)


def make_cfgs(root, **overrides):
    """The JAX and the port's config, both with the same overrides."""
    out = []
    for default in (jax_default_cfg, pt_default_cfg):
        c = default.clone()
        c.merge_from_file(str(REPO / "configs/mapfree.yaml"))
        c.DATASET.DATA_ROOT = str(root)
        c.DATASET.HEIGHT, c.DATASET.WIDTH = H, W
        c.DATASET.MIN_OVERLAP_SCORE, c.DATASET.MAX_OVERLAP_SCORE = 0.2, 0.8
        c.TRAINING.BATCH_SIZE = 3
        c.TRAINING.N_SAMPLES_SCENE = 4
        c.TRAINING.NUM_WORKERS = 2
        for key, value in overrides.items():
            node = c
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = value
        out.append(c)
    return out


def write_tree(root, multi_frame=False):
    for split, train, n in (("train", True, 8), ("val", False, 12), ("test", False, 16)):
        for i in range(2):
            scene = root / split / f"s{i:05}"
            poses = make_scene(scene, n_queries=n, img_hw=(64, 48), train=train,
                               seed=10 * i + len(split))
            if multi_frame:
                make_device_poses(scene, poses, noise=0.01, seed=i)


@pytest.mark.parametrize("split", ["train", "train_colorjitter", "val", "test"])
def test_loader_batches_match_jax(tmp_path, split):
    write_tree(tmp_path)
    overrides = {}
    if split == "train_colorjitter":  # host jitter: one worker keeps the draws in order
        overrides = {"TPU.DEVICE_AUGMENT": False, "DATASET.AUGMENTATION_TYPE": "colorjitter",
                     "TRAINING.NUM_WORKERS": 1}
    jcfg, pcfg = make_cfgs(tmp_path, **overrides)
    jdm, pdm = JaxDataModule(jcfg), DataModule(pcfg, device="cpu")
    if split.startswith("train"):
        loaders = jdm.train_dataloader(), pdm.train_dataloader()
    elif split == "val":
        loaders = jdm.val_dataloader(), pdm.val_dataloader()
    else:
        loaders = jdm.test_dataloader(batch_size=5), pdm.test_dataloader(batch_size=5)
    assert len(loaders[0]) == len(loaders[1])
    assert_same_batches(list(loaders[0]), list(loaders[1]))


@pytest.mark.parametrize("yuv", [False, True])
def test_getbatch_matches_jax(tmp_path, yuv):
    """The unique-ref batch path, called directly on both packages: the same
    image0_unique / ref_idx / ref_names / image1 and metadata, also when the
    16-entry decode cache serves the refs of a later call."""
    write_tree(tmp_path)
    jcfg, pcfg = make_cfgs(tmp_path, **{"TPU.YUV420_TRANSFER": yuv})
    jds, pds = JaxMapFreeDataset(jcfg, "test"), MapFreeDataset(pcfg, "test", device="cpu")
    assert len(jds) == len(pds) == 8
    for indices in ([0, 1, 2], [3, 4, 5, 6], [2, 7], [7]):  # the last calls hit the cache
        a, b = jds.getbatch(indices), pds.getbatch(indices)
        assert a is not None and b is not None
        assert_same_batches([a], [b])
    assert jds.getbatch([0, 0]) is None and pds.getbatch([0, 0]) is None  # repeated query
    assert len(pds._decode_cache) == len(jds._decode_cache)


@pytest.mark.parametrize("yuv", [False, True])
def test_getitems_matches_jax(tmp_path, yuv):
    write_tree(tmp_path)
    jcfg, pcfg = make_cfgs(tmp_path)
    jds, pds = JaxMapFreeDataset(jcfg, "train"), MapFreeDataset(pcfg, "train", device="cpu")
    jds.yuv420_getitems = pds.yuv420_getitems = yuv
    n = len(jds)
    assert len(pds) == n >= 6
    for indices in ([0, 1, 2], [5, n - 1, 1, 5], [n - 1]):
        assert_same_batches([dict(enumerate(jds.getitems(indices)))],
                            [dict(enumerate(pds.getitems(indices)))])


def test_multi_frame_matches_jax(tmp_path):
    """MapFreeSceneMultiFrame: query windows and device-tracking poses."""
    write_tree(tmp_path, multi_frame=True)
    jcfg, pcfg = make_cfgs(tmp_path, **{"DATASET.QUERY_FRAME_COUNT": 3})
    for mode in ("train", "val"):
        jds = JaxMapFreeDataset(jcfg, mode)
        pds = MapFreeDataset(pcfg, mode, device="cpu")
        assert len(jds) == len(pds) > 0 and pds.datasets[0].multi_frame
        idx = list(range(min(len(jds), 4)))
        assert_same_batches([dict(enumerate(jds.getitems(idx)))],
                            [dict(enumerate(pds.getitems(idx)))])
        assert jds.getbatch(idx) is None and pds.getbatch(idx) is None  # single-frame only
    jdm, pdm = JaxDataModule(jcfg), DataModule(pcfg, device="cpu")
    assert_same_batches(list(jdm.val_dataloader()), list(pdm.val_dataloader()))
