"""The port's matching track end to end on the CPU against the JAX package:
``build_model`` + ``predict`` over a tiny consistent scene (ground-truth
correspondences, file depth) for the PnP and Procrustes solvers, the port's
predictor handed the samples the JAX model draws from its key [0, step]
(mapfree_tpu/models/matching.py:305-306; the JAX sweep runs with one
transfer worker, so its steps follow the loader's order, as the port's
do): R within 1e-3 rad, t within 1e-3 of |t|, equal inlier counts; the
submission CLI against the JAX package's submission.py at 1e-3 per q and
t; and the rules around the predictor (a matching config on a machine
without a card raises; SIFT matching without cv2 raises naming SIFT_TPU). The
essential solver's case is tests/test_torch_matching_emat.py."""

import importlib.util
import types
from pathlib import Path
from zipfile import ZipFile

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("cv2")

from torch_batches import matching_case, predictions  # noqa: E402
from torch_solvers import rot_diff_rad, step_sampler  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402

import mapfree_tpu.utils.submission as jax_sub  # noqa: E402
from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.data import DataLoader as JaxDataLoader  # noqa: E402
from mapfree_tpu.data import MapFreeDataset as JaxMapFreeDataset  # noqa: E402
from mapfree_tpu.models.builder import build_model as jax_build_model  # noqa: E402
from mapfree_tpu_torch import submission as pt_submission  # noqa: E402
from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.data import DataLoader, MapFreeDataset  # noqa: E402
from mapfree_tpu_torch.models.builder import MatchingPredictor, build_model  # noqa: E402
from mapfree_tpu_torch.utils.submission import predict  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def jax_predictions(cfg, batch):
    model = jax_build_model(cfg)
    loader = JaxDataLoader(JaxMapFreeDataset(cfg, "val"), batch_size=batch, num_workers=1)
    return predictions(jax_sub.predict(loader, model, transfer_workers=1))


def port_predictions(cfg, batch):
    model = MatchingPredictor(cfg, device="cpu", sampler_for_step=step_sampler)
    loader = DataLoader(MapFreeDataset(cfg, "val", device="cpu"), batch_size=batch, num_workers=1)
    return predictions(predict(loader, model))


def assert_same_predictions(got, want):
    assert sorted(got) == sorted(want) and len(want) >= 3
    for key in want:
        (Rg, tg, ng), (Rw, tw, nw) = got[key], want[key]
        assert rot_diff_rad(Rg[None], Rw[None])[0] < 1e-3, key
        assert np.linalg.norm(tg - tw) <= 1e-3 * np.linalg.norm(tw), key
        assert ng == nw, key


@pytest.mark.parametrize("solver", ["PNP", "Procrustes"])
def test_predict_matches_jax(tmp_path, solver):
    pcfg, poses = matching_case(tmp_path, solver, pt_default_cfg)
    jcfg, _ = matching_case(tmp_path / "jax", solver, jax_default_cfg)
    jcfg.DATASET.DATA_ROOT = pcfg.DATASET.DATA_ROOT  # both read the same files
    jcfg.MATCHES_FILE_PATH = pcfg.MATCHES_FILE_PATH
    got, want = port_predictions(pcfg, 2), jax_predictions(jcfg, 2)
    assert_same_predictions(got, want)
    for (scene, frame), (R, t, _) in got.items():  # and the truth
        from mapfree_tpu_torch.geom.quaternion import quat2mat
        q, t_gt = poses[frame]
        assert np.degrees(rot_diff_rad(R[None], quat2mat(q)[None])[0]) < 1.5
        assert np.linalg.norm(t - t_gt) < 0.08


def _zip_lines(path):
    with ZipFile(path) as z:
        return {n: z.read(n).decode().splitlines() for n in sorted(z.namelist())}


def test_submission_cli_matches_jax_submission_py(tmp_path, monkeypatch):
    pcfg, _ = matching_case(tmp_path, "PNP", pt_default_cfg)
    # the scene is the test split: both CLIs sweep it
    (tmp_path / "val").rename(tmp_path / "test")
    dataset = tmp_path / "dataset.yaml"
    dataset.write_text(yaml.safe_dump({"DATASET": {
        "DATA_SOURCE": "MapFree", "DATA_ROOT": str(tmp_path), "HEIGHT": 64, "WIDTH": 48,
        "ESTIMATED_DEPTH": "gt"}, "TRAINING": {"NUM_WORKERS": 1}}))
    model = tmp_path / "model.yaml"
    model.write_text(yaml.safe_dump({
        "MODEL": "FeatureMatching", "FEATURE_MATCHING": "Precomputed", "POSE_SOLVER": "PNP",
        "MATCHES_FILE_PATH": "{scene_root}/correspondences.npz",
        "PNP": {"REPROJECTION_INLIER_THRESHOLD": 3.0},
        "TPU": {"INFER_BATCH": 2, "COMPUTE_DTYPE": "float32", "RANSAC_ITERATIONS": 256,
                "MAX_CORRESPONDENCES": 512}}))
    path = pt_submission.main([str(model), "--dataset_config", str(dataset),
                               "-o", str(tmp_path / "port"), "--device", "cpu"])
    spec = importlib.util.spec_from_file_location("jax_submission_cli", REPO / "submission.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(jax_cli, "cfg", jax_default_cfg.clone())
    jax_cli.eval(types.SimpleNamespace(
        config=str(model), dataset_config=str(dataset), checkpoint="",
        output_root=tmp_path / "jax", split="test", num_hosts=None, host_id=None))
    port, ref = _zip_lines(path), _zip_lines(tmp_path / "jax" / "submission.zip")
    assert list(port) == list(ref) == ["pose_s00000.txt"]
    assert len(ref["pose_s00000.txt"]) >= 3
    for a, b in zip(port["pose_s00000.txt"], ref["pose_s00000.txt"]):
        a, b = a.split(" "), b.split(" ")
        assert a[0] == b[0] and a[8] == b[8]  # the frame and the inlier count (confidence)
        np.testing.assert_allclose(np.array(a[1:8], float), np.array(b[1:8], float),
                                   rtol=0, atol=1e-3)


def test_a_matching_config_without_a_card_raises(tmp_path):
    cfg, _ = matching_case(tmp_path, "PNP", pt_default_cfg)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)


def test_sift_matching_raises_naming_its_roadmap_item(tmp_path, monkeypatch):
    """SIFT matching is ported (its item, 11b, is done): ``SIFT`` needs cv2
    and, without it, raises when the model is built, naming ``SIFT_TPU``,
    the on-device source, which builds and predicts with no library (blank
    frames: no keypoints, so no estimate)."""
    import sys

    cfg, _ = matching_case(tmp_path, "PNP", pt_default_cfg)
    cfg.FEATURE_MATCHING, cfg.SIFT.NUM_FEATURES, cfg.SIFT.RATIO_THRESHOLD = "SIFT", 64, 0.8
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="use FEATURE_MATCHING SIFT_TPU"):
        build_model(cfg, device="cpu")
    cfg.FEATURE_MATCHING = "SIFT_TPU"
    model = build_model(cfg, device="cpu")
    blank = np.zeros((1, 64, 48, 3), np.uint8)
    R, t, inliers = model.predict_batch({
        "image0": blank, "image1": blank, "depth0": [np.ones((64, 48), np.float32)],
        "K_color0": np.eye(3, dtype=np.float32)[None], "K_color1": np.eye(3, dtype=np.float32)[None]})
    assert np.isnan(R).all() and inliers[0] == 0


def test_tf32_off_blocks_on_two_threads_restore_the_flags():
    """The adaptive ladder's finish runs a solve on a pool thread while the
    caller may be inside another: the blocks share one count, so the flags
    stay off until the last block leaves and are then put back as they were
    (a save-and-restore per block would leave them off, or switch them on
    under a running solve)."""
    import threading

    from mapfree_tpu_torch.models.builder import tf32_off

    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32, torch.backends.cudnn.allow_tf32
    inside, release = threading.Event(), threading.Event()
    seen = []

    def other():
        with tf32_off():
            inside.set()
            release.wait(10)
            seen.append(flags.allow_tf32)

    try:
        flags.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with tf32_off():
            t = threading.Thread(target=other)
            t.start()
            inside.wait(10)
        seen.append(flags.allow_tf32)  # the first block left, the other runs on
        release.set()
        t.join(10)
        assert seen == [False, False]
        assert flags.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        flags.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
