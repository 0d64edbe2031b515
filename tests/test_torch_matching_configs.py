"""Every config under configs/matching/ builds in the port and solves one
tiny batch on the CPU (its solver, its REFINE and DEPTH_NET settings, with
budgets cut to 32 hypotheses over 64 correspondences and the depth net to
one block a stage at random weights). Correspondences come with the batch;
for the SIFT configs the config's own matcher (OpenCV's SIFT on the host,
cv2 is installed here) first matches the batch's images, padded to the
config's correspondence budget."""

from pathlib import Path

import numpy as np
import pytest

from torch_solvers import IMG_H, IMG_W, K, depth_maps, synth_pairs
from torch_threads import one_torch_thread  # noqa: F401

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.builder import MatchingPredictor, build_model
from mapfree_tpu_torch.models.matching import SIFTMatching

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs/matching").rglob("*.yaml"))
DATASET = {"mapfree": "mapfree.yaml", "scannet": "scannet.yaml", "sevenscenes": "sevenscenes.yaml"}


class _Carried:
    @staticmethod
    def get_correspondences(batch):
        return batch["pts0"], batch["pts1"], batch["mask"]


def test_there_are_matching_configs():
    assert len(CONFIGS) == 58


@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_and_solves_a_tiny_batch(path, tmp_path):
    cfg = pt_default_cfg.clone()
    cfg.merge_from_file(str(REPO / "configs" / DATASET[Path(path).parent.name]))
    cfg.merge_from_file(str(REPO / path))
    cfg.TPU.RANSAC_ITERATIONS, cfg.TPU.MAX_CORRESPONDENCES, cfg.TPU.INFER_BATCH = 32, 64, 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DEPTH_NET.NUM_BLOCKS, cfg.DEPTH_NET.ALLOW_RANDOM = "1-1-1", True
    if cfg.MATCHES_FILE_PATH and "{" not in cfg.MATCHES_FILE_PATH:
        # one npz for the whole split (the ScanNet configs), read at build time
        cfg.MATCHES_FILE_PATH = str(tmp_path / Path(cfg.MATCHES_FILE_PATH).name)
        np.savez(cfg.MATCHES_FILE_PATH, correspondences=np.zeros((1, 8, 4), np.float32))
    model = build_model(cfg, device="cpu")
    assert isinstance(model, MatchingPredictor)
    p = synth_pairs(1, n_points=60, n_outliers=6, seed=len(path), pad=4)
    d0, d1 = depth_maps(p)
    rng = np.random.default_rng(0)
    batch = {"pts0": p["k0"], "pts1": p["k1"], "mask": p["mask"],
             "K_color0": K[None], "K_color1": K[None], "depth0": list(d0), "depth1": list(d1),
             "image0": rng.integers(0, 256, (1, IMG_H, IMG_W, 3)).astype(np.uint8),
             "image1": rng.integers(0, 256, (1, IMG_H, IMG_W, 3)).astype(np.uint8)}
    if cfg.FEATURE_MATCHING != "Precomputed":
        assert cfg.FEATURE_MATCHING == "SIFT"
        assert type(model.model.feature_matching) is SIFTMatching
        pts0, pts1, mask = model.model.feature_matching.get_correspondences(batch)
        assert pts0.shape == pts1.shape == (1, 64, 2) and mask.shape == (1, 64)
    model.model.feature_matching = _Carried()
    if cfg.PROCRUSTES.REFINE and cfg.DEPTH_NET.ENABLED:
        return  # the JAX package refuses this pair of settings too (ROADMAP.md section 3)
    R, t, inliers = model.predict_batch(batch)
    assert R.shape == (1, 3, 3) and t.shape == (1, 1, 3) and inliers.shape == (1,)
    assert np.isfinite(R).all() and np.isfinite(t).all() and inliers[0] > 0
