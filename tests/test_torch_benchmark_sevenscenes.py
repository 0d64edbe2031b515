"""PyTorch port, the 7Scenes evaluation CLI (``python -m
mapfree_tpu_torch.benchmark.sevenscenes``, its ``main(argv)`` with
``--device cpu``) against the JAX package's
(mapfree_tpu/benchmark/sevenscenes.py) on the same 7Scenes tree, on the CPU.

The tree: one scene of the textured room of the ScanNet fixtures
(tests/data/torch_port/room.py) as 160x120 PNG frames, three reference
frames and three queries, every (reference, query) pair in the pair file,
``.depth.prcnn.png`` depth, and ``correspondences_SIFT_<pairs>.npz`` from the
known geometry. Configs:
- ``configs/matching/sevenscenes/sift_pnp_planercnn.yaml`` (precomputed
  correspondences, PnP on the ``prcnn`` depth; the port handed the JAX
  model's minimal samples, one batch), without and with ``--triang``
  (``np.random`` seeded alike before each run: the pose-graph RANSAC
  shuffles);
- ``configs/regression/scannet/3d3d.yaml`` at small depth over
  sevenscenes.yaml, the JAX predictor given the port's weights.
Held: the saved per-query results (``results.npy``: predicted absolute
poses, errors, inliers) within 1e-4 (metres, degrees: float64 evaluation of
float32 poses), equal pass/fail per query, the report's lines (timings
aside) equal where they print numbers to two decimals, and the per-scene
``pose_*.txt`` files."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import yaml

pytest.importorskip("cv2")

import jax  # noqa: E402

import mapfree_tpu.benchmark.sevenscenes as jax_7s  # noqa: E402
from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.models.builder import build_model as jax_build_model  # noqa: E402
from torch_batches import model_yaml, room_module  # noqa: E402
from torch_solvers import step_sampler  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

import mapfree_tpu_torch.benchmark.sevenscenes as pt_7s  # noqa: E402
from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.models.builder import MatchingPredictor  # noqa: E402
from mapfree_tpu_torch.models.builder import build_model as pt_build_model  # noqa: E402
from mapfree_tpu_torch.tools.convert_weights import to_jax_variables  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
W, H = 160, 120
PAIRS_TXT = "test_pairs.txt"
TOL = 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sevenscenes")
    truth = room_module().write_7scenes_room(root, "chess", W, H, n_refs=3, n_queries=3,
                                             pairs_txt=PAIRS_TXT, depth_suffix="prcnn")
    dataset = yaml.safe_load((REPO / "configs/sevenscenes.yaml").read_text())
    dataset["DATASET"].update({"DATA_ROOT": str(root), "HEIGHT": H, "WIDTH": W})
    dataset["DATASET"]["PAIRS_TXT"]["TEST"] = PAIRS_TXT
    (root / "dataset.yaml").write_text(yaml.safe_dump(dataset))
    return root, truth


def run_both(tmp_path, monkeypatch, dataset, model, port_model, jax_model, extra=()):
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # set_log / tee_stdout swap it
    monkeypatch.setattr(pt_7s, "build_model", lambda cfg, ckpt, device: port_model(cfg))
    np.random.seed(3)
    pt_7s.main([str(model), str(dataset), "-odir", str(tmp_path / "port"), "--device", "cpu",
                *extra])
    monkeypatch.setattr(jax_7s, "cfg", jax_default_cfg.clone())
    monkeypatch.setattr(jax_7s, "build_model", lambda cfg, ckpt: jax_model(cfg))
    np.random.seed(3)
    jax_7s.eval(types.SimpleNamespace(
        config=str(model), dataset_config=str(dataset), checkpoint="", test_pair_txt=None,
        output_root=tmp_path / "jax", one_nn=False, triang="--triang" in extra,
        triang_ransac_thres=[15]))
    sys.stdout.flush()  # the JAX package's tee (set_log) is never closed
    got = np.load(tmp_path / "port" / "results.npy", allow_pickle=True).item()
    ref = np.load(tmp_path / "jax" / "results.npy", allow_pickle=True).item()
    assert list(got) == list(ref) == ["chess"]
    for query, r in ref["chess"].items():
        g = got["chess"][query]
        for key in ("abs_t_err", "abs_r_err"):
            assert abs(g[key] - r[key]) <= TOL, (query, key, g[key], r[key])
        assert g["inliers"] == r["inliers"]
        np.testing.assert_allclose(g["abs_pose_pred"].c, r["abs_pose_pred"].c, rtol=0, atol=TOL)
    strip = lambda p: [ln for ln in p.read_text().splitlines() if "time" not in ln]
    assert strip(tmp_path / "port" / "test_results.txt") == strip(tmp_path / "jax" / "test_results.txt")
    for f in sorted((tmp_path / "jax").glob("pose_*.txt")):
        for a, b in zip((tmp_path / "port" / f.name).read_text().split(), f.read_text().split()):
            assert a == b or abs(float(a) - float(b)) <= TOL
    return got


MATCHING = {"TPU": {"INFER_BATCH": 16, "RANSAC_ITERATIONS": 256, "MAX_CORRESPONDENCES": 512,
                    "COMPUTE_DTYPE": "float32", "MESH_SHAPE": [1]}}


@pytest.mark.parametrize("triang", [False, True])
def test_matching_config_matches_jax(tmp_path, monkeypatch, tree, triang):
    root, truth = tree
    model = model_yaml(tmp_path, "configs/matching/sevenscenes/sift_pnp_planercnn.yaml", MATCHING)
    got = run_both(tmp_path, monkeypatch, root / "dataset.yaml", model,
                   lambda cfg: MatchingPredictor(cfg, device="cpu", sampler_for_step=step_sampler),
                   jax_build_model, ("--triang",) if triang else ())
    # the geometry's own correspondences: the queries are localised
    errs = [r["abs_t_err"] for r in got["chess"].values()]
    assert len(errs) == 3 and max(errs) < 0.05


def test_rpr_config_matches_jax(tmp_path, monkeypatch, tree):
    root, _ = tree
    model = model_yaml(tmp_path, "configs/regression/scannet/3d3d.yaml",
                       {"ENCODER": {"NUM_BLOCKS": "1-1-1", "NUM_OUT_LAYERS": 8},
                        "DATASET": {"ESTIMATED_DEPTH": "prcnn"},
                        "TPU": {"COMPUTE_DTYPE": "float32", "INFER_BATCH": 4,
                                "MESH_SHAPE": [1]}})
    c = pt_default_cfg.clone()
    c.merge_from_file(str(root / "dataset.yaml"))
    c.merge_from_file(str(model))
    net = pt_build_model(c, device="cpu").net

    def jax_model(cfg):
        m = jax_build_model(cfg)
        m.variables = jax.device_put(to_jax_variables(net))
        return m

    run_both(tmp_path, monkeypatch, root / "dataset.yaml", model,
             lambda cfg: pt_build_model(cfg, device="cpu"), jax_model)
