"""PyTorch port, the ScanNet evaluation CLI (``python -m
mapfree_tpu_torch.benchmark.scannet``, its ``main(argv)`` with ``--device
cpu``) against the JAX package's (mapfree_tpu/benchmark/scannet.py) on the
same ScanNet tree, on the CPU.

The tree: the textured room of the ScanNet fixtures (tests/data/torch_port/
room.py) as 160x120 JPEG frames of four views, with rendered ``.pgm`` depth
and camera-to-world poses, eight pairs. Two configs:
- ``configs/regression/scannet/3d3d.yaml`` at small depth (one block a
  stage, 8 channels, float32), the JAX predictor given the port's weights;
- ``configs/matching/scannet/loftr_procrustes_gt.yaml``: its precomputed
  correspondences (one table for the split) made from the known geometry,
  Procrustes on the ``.pgm`` depth, the port handed the JAX model's minimal
  samples (one batch: the JAX sweep takes its RANSAC keys in dispatch order
  only with one batch in flight). The JAX package's ``PrecomputedMatching``
  looks up ``batch["scene_root"]``, which ScanNet's samples lack (a KeyError
  in the JAX CLI, ROADMAP.md section 3): its model reads the same table
  through the same padding here, without the lookup. Noise-free correspondences: with SIFT's
  (tests/test_torch_sift_matching.py holds both SIFT sources), the JAX
  package's own Procrustes solve moves by 3e-4 rad between two fresh models
  of one process on the same batch and key, more than this comparison's
  limit.
Every metric the CLI saves (``results/scannet/<config>.npz``) agrees, NaN
where the other is NaN, within 1e-4; the two angles (``R_err``,
``t_err_ang``, degrees) within 1e-4 or, failing that, through their
cosines within 1e-6. Both packages take them as the arccos of a float32
cosine, which
near zero error resolves the angle no finer than about 0.03 degree
(arccos(1 - 6e-8)): a pose that differs by float32 round-off (the Kabsch
refit's t is a difference of means some 3 m long) moves R_err by 5e-3
degrees in this tree while its cosine moves by 1e-7."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import yaml

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

import mapfree_tpu.benchmark.scannet as jax_scannet  # noqa: E402
from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.models.builder import build_model as jax_build_model  # noqa: E402
from mapfree_tpu.models.matching import pad_correspondences as jax_pad  # noqa: E402
from torch_batches import model_yaml, room_module  # noqa: E402
from torch_solvers import step_sampler  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

import mapfree_tpu_torch.benchmark.scannet as pt_scannet  # noqa: E402
from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.models.builder import MatchingPredictor  # noqa: E402
from mapfree_tpu_torch.models.builder import build_model as pt_build_model  # noqa: E402
from mapfree_tpu_torch.tools.convert_weights import to_jax_variables  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
METRIC_TOL = 1e-4
ANGLES = ("R_err", "t_err_ang")
ANGLE_COS_TOL = 1e-6
W, H = 160, 120
FRAMES = [0, 1, 2, 3, 0, 2]
PAIRS = [(0, 1), (1, 2), (2, 3), (0, 2), (3, 4), (1, 5), (4, 1), (5, 3)]
SMALL_RPR = {"ENCODER": {"NUM_BLOCKS": "1-1-1", "NUM_OUT_LAYERS": 8},
             "TPU": {"COMPUTE_DTYPE": "float32", "INFER_BATCH": 4, "MESH_SHAPE": [1]}}
MATCHING = {"TPU": {"INFER_BATCH": 8, "RANSAC_ITERATIONS": 256, "MAX_CORRESPONDENCES": 512,
                    "COMPUTE_DTYPE": "float32", "MESH_SHAPE": [1]}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    room = room_module()
    K = room.correct_intrinsic_scale(room.SCANNET_K, W / room.SCANNET_W, H / room.SCANNET_H)
    views = room.scannet_views(max(FRAMES) + 1)

    def write_color(k, path):
        rgb, _ = room.render_view(K, *views[FRAMES[k]], W, H)
        cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 95])

    room.write_scannet_room(root, W, H, FRAMES, PAIRS, write_color,
                            matches_file=root / "correspondences.npz")
    dataset = yaml.safe_load((REPO / "configs/scannet.yaml").read_text())
    dataset["DATASET"].update({"DATA_ROOT": str(root), "NPZ_ROOT": str(root / "indices"),
                               "HEIGHT": H, "WIDTH": W})
    (root / "dataset.yaml").write_text(yaml.safe_dump(dataset))
    return root


def merged(default, dataset, model):
    c = default.clone()
    c.merge_from_file(str(dataset))
    c.merge_from_file(str(model))
    return c


def run_both(tmp_path, monkeypatch, tree, model, port_model, jax_model):
    """Both CLIs from directories of their own; their saved metrics."""
    dataset = tree / "dataset.yaml"
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # set_log / tee_stdout swap it
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr(pt_scannet, "build_model", lambda cfg, ckpt, device: port_model(cfg))
    got = pt_scannet.main([str(model), "--dataset_config", str(dataset), "--device", "cpu"])
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(jax_scannet, "cfg", jax_default_cfg.clone())
    monkeypatch.setattr(jax_scannet, "build_model", lambda cfg, ckpt: jax_model(cfg))
    jax_scannet.main(types.SimpleNamespace(config=str(model), dataset_config=str(dataset),
                                           checkpoint=""))
    name = model.stem
    port = dict(np.load(tmp_path / "port" / "results" / "scannet" / f"{name}.npz"))
    ref = dict(np.load(tmp_path / "jax" / "results" / "scannet" / f"{name}.npz"))
    assert (tmp_path / "port" / "results" / "scannet" / f"{name}.txt").read_text().startswith(
        "Median Rotation error [deg]: ")
    assert sorted(port) == sorted(ref) == sorted(got)
    for key in ref:
        assert port[key].shape == ref[key].shape == (len(PAIRS),), key
        np.testing.assert_array_equal(port[key], got[key])
        assert (np.isnan(port[key]) == np.isnan(ref[key])).all(), key
        close = np.abs(port[key] - ref[key]) <= METRIC_TOL
        if key in ANGLES:  # or as the float32 cosines they are the arccos of
            close |= np.abs(np.cos(np.radians(port[key])) - np.cos(np.radians(ref[key]))) \
                <= ANGLE_COS_TOL
        assert (close | np.isnan(ref[key])).all(), (key, port[key], ref[key])
    return port


def test_rpr_config_matches_jax(tmp_path, monkeypatch, tree):
    model = model_yaml(tmp_path, "configs/regression/scannet/3d3d.yaml", SMALL_RPR)
    pcfg = merged(pt_default_cfg, tree / "dataset.yaml", model)
    net = pt_build_model(pcfg, device="cpu").net

    def jax_model(cfg):
        m = jax_build_model(cfg)
        m.variables = jax.device_put(to_jax_variables(net))
        return m

    port = run_both(tmp_path, monkeypatch, tree, model,
                    lambda cfg: pt_build_model(cfg, device="cpu"), jax_model)
    assert np.isfinite(port["R_err"]).all()


class _FixedTable:
    """The JAX package's PrecomputedMatching for one fixed table, without
    its scene-root lookup."""

    def __init__(self, path, max_n):
        self.table, self.max_n = np.load(path)["correspondences"].astype(np.float32), max_n

    def get_correspondences(self, batch):
        rows = [self.table[int(i)] for i in batch["pair_id"]]
        return jax_pad([r[~np.isnan(r)].reshape(-1, 4) for r in rows], self.max_n)


def test_procrustes_config_matches_jax(tmp_path, monkeypatch, tree):
    matches = tree / "correspondences.npz"
    model = model_yaml(tmp_path, "configs/matching/scannet/loftr_procrustes_gt.yaml",
                       dict(MATCHING, MATCHES_FILE_PATH=str(matches)))

    def jax_model(cfg):
        m = jax_build_model(cfg)
        m.model.feature_matching = _FixedTable(matches, int(cfg.TPU.MAX_CORRESPONDENCES))
        return m

    port = run_both(tmp_path, monkeypatch, tree, model,
                    lambda cfg: MatchingPredictor(cfg, device="cpu", sampler_for_step=step_sampler),
                    jax_model)
    # the geometry's own correspondences: the poses are right too
    assert np.nanmax(port["R_err"]) < 1.0 and np.nanmax(port["t_err_euc"]) < 0.02
