"""PyTorch port, the ScanNet and 7Scenes datasets and the scene-balance
sampler (mapfree_tpu_torch/data/{scannet,sevenscenes,sampler}.py) against
mapfree_tpu.data on the CPU: the same collated batches (images, depth maps,
poses, intrinsics, metadata) from the same synthetic trees, and the same
sampler indices from the same seed."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.data import DataLoader as JaxDataLoader  # noqa: E402
from mapfree_tpu.data import RandomConcatSampler as JaxSampler  # noqa: E402
from mapfree_tpu.data import ScanNetDataset as JaxScanNet  # noqa: E402
from mapfree_tpu.data import SevenScenesDataset as JaxSevenScenes  # noqa: E402
from mapfree_tpu.geom import mat2quat, quat2mat  # noqa: E402

from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.data import DataLoader, DataModule, RandomConcatSampler  # noqa: E402
from mapfree_tpu_torch.data import ScanNetDataset, SevenScenesDataset  # noqa: E402

from torch_batches import assert_same_batches  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

H, W = 48, 64


def write_scannet(root, mode, n_frames=6, seed=0):
    """One ScanNet scene (colour JPEGs, pgm depth, c2w poses, _info.txt)
    and its LoFTR-style pair index."""
    rng = np.random.default_rng(seed)
    sensor = root / ("scans_test" if mode == "test" else "scans") / "scene0000_00" / "sensor_data"
    sensor.mkdir(parents=True)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 80.0, 82.0, W / 2, H / 2
    flat = " ".join(str(v) for v in K.reshape(-1))
    (sensor / "_info.txt").write_text(f"m_calibrationColorIntrinsic = {flat}\n"
                                      f"m_calibrationDepthIntrinsic = {flat}\n")
    for i in range(n_frames):
        cv2.imwrite(str(sensor / f"frame-{i:06}.color.jpg"),
                    rng.integers(0, 255, (H * 2, W * 2, 3), np.uint8))
        cv2.imwrite(str(sensor / f"frame-{i:06}.depth.pgm"),
                    rng.integers(500, 4000, (H, W)).astype(np.uint16))
        c2w = np.eye(4)
        c2w[:3, :3] = quat2mat(rng.normal(size=4))
        c2w[:3, 3] = rng.normal(size=3)
        np.savetxt(sensor / f"frame-{i:06}.pose.txt", c2w, delimiter=" ")
    names = np.array([(0, 0, i, i + 1) for i in range(n_frames - 1)])
    npz_dir = root / "indices" / mode
    npz_dir.mkdir(parents=True)
    np.savez(npz_dir / "pairs.npz", name=names, score=rng.uniform(0.3, 0.9, len(names)))


def write_7scenes(root, scene, n_refs=3, n_queries=3, seed=0):
    """One 7Scenes scene: PNG colour frames and depth maps, absolute poses,
    and a pair file of every (ref, query) with its relative pose."""
    rng = np.random.default_rng(seed)
    sdir = root / scene
    (sdir / "seq-01").mkdir(parents=True)
    poses = {}
    refs = [f"seq-01/frame-{i:06}" for i in range(n_refs)]
    queries = [f"seq-01/frame-{100 + i:06}" for i in range(n_queries)]
    for name in refs + queries:
        cv2.imwrite(str(sdir / f"{name}.color.png"), rng.integers(0, 255, (H, W, 3), np.uint8))
        cv2.imwrite(str(sdir / f"{name}.depth.png"),
                    rng.integers(500, 4000, (H, W)).astype(np.uint16))
        q = rng.normal(size=4)
        poses[name] = (rng.normal(size=3), q / np.linalg.norm(q))
    for fname, names in (("dataset_train.txt", refs), ("dataset_test.txt", queries)):
        lines = ["header"] * 3 + [
            f"{n}.color.png " + " ".join(f"{v:.8f}" for v in np.concatenate(poses[n]))
            for n in names]
        (sdir / fname).write_text("\n".join(lines) + "\n")
    lines = []
    for qn in queries:
        for i, rn in enumerate(refs):
            (c_r, q_r), (c_q, q_q) = poses[rn], poses[qn]
            R_r, R_q = quat2mat(q_r), quat2mat(q_q)
            rel = np.concatenate([mat2quat(R_q @ R_r.T), R_q @ (c_r - c_q)])
            lines.append(f"{rn}.color.png {qn}.color.png {1.0 - 0.1 * i:.4f} "
                         + " ".join(f"{v:.8f}" for v in rel))
    (sdir / "test_pairs.txt").write_text("\n".join(lines) + "\n")


def make_cfgs(source, **values):
    out = []
    for default in (jax_default_cfg, pt_default_cfg):
        c = default.clone()
        c.DATASET.DATA_SOURCE = source
        c.DATASET.HEIGHT, c.DATASET.WIDTH = H, W
        c.TRAINING.BATCH_SIZE = 2
        c.TRAINING.NUM_WORKERS = 2
        for key, value in values.items():
            node = c
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = value
        out.append(c)
    return out


@pytest.mark.parametrize("mode", ["train", "test"])
def test_scannet_batches_match_jax(tmp_path, mode):
    """Train mode: the per-epoch pair filter and no depth; test mode: the pgm
    depth maps; val uses the scene-balance sampler through the DataModule."""
    write_scannet(tmp_path, mode)
    jcfg, pcfg = make_cfgs("ScanNet", **{"DATASET.DATA_ROOT": str(tmp_path),
                                         "DATASET.NPZ_ROOT": str(tmp_path / "indices"),
                                         "DATASET.MIN_OVERLAP_SCORE": 0.4})
    jds, pds = JaxScanNet(jcfg, mode), ScanNetDataset(pcfg, mode, device="cpu")
    assert len(jds) == len(pds) > 0
    assert_same_batches(list(JaxDataLoader(jds, batch_size=2, num_workers=2)),
                        list(DataLoader(pds, batch_size=2, num_workers=2)))
    if mode == "train":
        write_scannet(tmp_path / "v", "val", seed=1)
        for c in (jcfg, pcfg):
            c.DATASET.DATA_ROOT = str(tmp_path / "v")
            c.DATASET.NPZ_ROOT = str(tmp_path / "v" / "indices")
            c.TRAINING.N_SAMPLES_SCENE = 3
        from mapfree_tpu.data import DataModule as JaxDataModule

        assert_same_batches(list(JaxDataModule(jcfg).val_dataloader()),
                            list(DataModule(pcfg, device="cpu").val_dataloader()))


def test_sevenscenes_batches_match_jax(tmp_path):
    """PNG colour frames and depth maps, one-NN filtering, both scenes."""
    for i, scene in enumerate(("chess", "fire")):
        write_7scenes(tmp_path, scene, seed=i)
    for one_nn in (False, True):
        jcfg, pcfg = make_cfgs("7Scenes", **{"DATASET.DATA_ROOT": str(tmp_path),
                                             "DATASET.PAIRS_TXT.TEST": "test_pairs.txt",
                                             "DATASET.PAIRS_TXT.ONE_NN": one_nn})
        jds, pds = JaxSevenScenes(jcfg, "test"), SevenScenesDataset(pcfg, "test", device="cpu")
        assert len(jds) == len(pds) == (6 if one_nn else 18)
        assert_same_batches(list(JaxDataLoader(jds, batch_size=4, num_workers=2)),
                            list(DataLoader(pds, batch_size=4, num_workers=2)))


class _Sizes:
    def __init__(self, sizes):
        self.cumulative_sizes = np.cumsum(sizes).tolist()


@pytest.mark.parametrize("replacement,repeat,reset", [(True, 1, False), (False, 1, False),
                                                      (False, 3, False), (True, 2, True)])
def test_sampler_draws_the_jax_indices(replacement, repeat, reset):
    """The same numpy draws: the same indices from the same seed, epoch
    after epoch (and again after a reset), and the same length."""
    source = _Sizes([5, 1, 12, 3])
    kwargs = dict(n_samples_per_subset=4, subset_replacement=replacement, shuffle=True,
                  repeat=repeat, reset_on_iter=reset)
    jax_sampler, pt_sampler = JaxSampler(source, **kwargs), RandomConcatSampler(source, **kwargs)
    assert len(pt_sampler) == len(jax_sampler) == 16 * repeat
    for _ in range(3):
        assert list(pt_sampler) == list(jax_sampler)


def test_loader_length_does_not_draw_from_the_sampler():
    """len() reads the sampler's length: the first epoch is the sampler's
    first draw, as for a loader whose length was never asked."""
    class _Data(_Sizes):
        def __len__(self):
            return self.cumulative_sizes[-1]

        def __getitem__(self, i):
            return {"pair_id": np.int64(i)}

    data = _Data([6, 6])
    fresh = list(JaxSampler(data, 5))
    loader = DataLoader(data, batch_size=3, sampler=RandomConcatSampler(data, 5))
    assert len(loader) == 4
    assert [int(i) for b in loader for i in b["pair_id"]] == fresh


class _Raising(_Sizes):
    """Four items; loading raises as a decoder that does not build would."""
    def __init__(self, device=None):
        super().__init__([4])
        self.device = device

    def __len__(self):
        return 4

    def __getitem__(self, i):
        raise RuntimeError("the decoder did not build")

    def getbatch(self, indices):
        raise RuntimeError("the decoder did not build")


@pytest.mark.parametrize("path", ["items", "getbatch"])
def test_loader_raises_what_loading_raised(path):
    """An exception on the loader's producer thread reaches the consumer,
    which would otherwise wait for a batch that never comes. The batch path
    (getbatch) is taken for a dataset that decodes on a CUDA device; naming
    one needs no card."""
    import torch

    if path == "items":
        loader = DataLoader(_Raising(), batch_size=2)
    else:
        loader = DataLoader(_Raising(torch.device("cuda")), batch_size=2, unique_refs=True)
    with pytest.raises(RuntimeError, match="did not build"):
        next(iter(loader))
