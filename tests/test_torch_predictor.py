"""PyTorch port, end to end on the CPU: the submission sweep of
tests/test_integration.py (make_scene scenes -> predict -> submission.zip ->
evaluator), run by the JAX predictor and by the port's predictor on the
same weights, fed by one JAX DataLoader (unique refs, YUV420 transfer on).

Both zips must hold the same scenes and frames, every frame's q and t must
agree to 1e-4 (float32 throughout; the frameworks sum in different orders),
and the MapFree evaluator must score both alike.
"""

from zipfile import ZipFile

import numpy as np
import pytest
import torch

import jax

from fixtures import make_scene

from mapfree_tpu.benchmark.mapfree import run as run_benchmark
from mapfree_tpu.config import cfg as jax_default_cfg
from mapfree_tpu.data import DataLoader, MapFreeDataset
from mapfree_tpu.models.builder import build_model as jax_build_model
from mapfree_tpu.utils.submission import predict as jax_predict
from mapfree_tpu.utils.submission import save_submission as jax_save

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.builder import build_model as pt_build_model
from mapfree_tpu_torch.models.builder import tf32_off
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables
from mapfree_tpu_torch.utils.submission import predict as pt_predict
from mapfree_tpu_torch.utils.submission import save_submission as pt_save

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H, W = 64, 48

# tests/test_integration.py's _TINY_RPR with the flagship's bottleneck block
TINY_RPR = {
    "MODEL": "Regression",
    "ENCODER.TYPE": "ResUNet", "ENCODER.BLOCK_TYPE": 1,
    "ENCODER.NUM_BLOCKS": "1-1-1", "ENCODER.NUM_OUT_LAYERS": 8,
    "AGGREGATOR.TYPE": "CorrelationVolumeWarping",
    "AGGREGATOR.POSITION_ENCODER": True,
    "AGGREGATOR.MAX_SCORE_CHANNEL": True,
    "HEAD.TYPE": "ProcrustesDeepResBlock", "HEAD.ADD_BASIS": True,
    "HEAD.AVG_POOL": True,
    "DATASET.DATA_SOURCE": "MapFree",
    "DATASET.HEIGHT": H, "DATASET.WIDTH": W,
    "TRAINING.NUM_WORKERS": 2,
    "TPU.INFER_BATCH": 4,
    "TPU.COMPUTE_DTYPE": "float32",
    "TPU.YUV420_TRANSFER": True,
}


def make_cfg(default, root=None):
    c = default.clone()
    for key, value in TINY_RPR.items():
        node = c
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    if root is not None:
        c.DATASET.DATA_ROOT = str(root)
    return c


def _zip_lines(path):
    with ZipFile(path) as z:
        return {n: z.read(n).decode().splitlines() for n in sorted(z.namelist())}


def test_sweep_matches_jax_predictor(tmp_path):
    for i in range(2):
        make_scene(tmp_path / "val" / f"s{i:05}", n_queries=10, img_hw=(H, W), seed=i)
    jcfg = make_cfg(jax_default_cfg, tmp_path)
    loader = DataLoader(MapFreeDataset(jcfg, "val"), batch_size=3, num_workers=2,
                        unique_refs=True)

    jmodel = jax_build_model(jcfg)
    pmodel = pt_build_model(make_cfg(pt_default_cfg), device="cpu")
    load_jax_variables(pmodel.net, jax.tree.map(np.asarray, dict(jmodel.variables)))

    results = {"jax": jax_predict(loader, jmodel), "torch": pt_predict(loader, pmodel)}
    assert set(results["jax"]) == set(results["torch"]) == {"s00000", "s00001"}
    for scene, poses in results["jax"].items():
        assert [p.image_name for p in poses] == \
            [p.image_name for p in results["torch"][scene]]
        for a, b in zip(poses, results["torch"][scene]):
            np.testing.assert_allclose(b.q, a.q, atol=1e-4)
            np.testing.assert_allclose(b.t, a.t, atol=1e-4)

    zips, metrics = {}, {}
    for name, save in (("jax", jax_save), ("torch", pt_save)):
        zips[name] = tmp_path / f"submission_{name}.zip"
        save(results[name], zips[name])
        metrics[name] = run_benchmark(zips[name], tmp_path / "val")
    lines = {k: _zip_lines(v) for k, v in zips.items()}
    assert lines["jax"].keys() == lines["torch"].keys()
    for name in lines["jax"]:
        assert [ln.split(" ")[0] for ln in lines["jax"][name]] == \
            [ln.split(" ")[0] for ln in lines["torch"][name]]
    # poses are written with 6 decimals and agree to 1e-4: the evaluator's
    # aggregate metrics agree to the same order
    assert metrics["jax"].keys() == metrics["torch"].keys()
    for key, value in metrics["jax"].items():
        assert metrics["torch"][key] == pytest.approx(value, rel=1e-3, abs=1e-3), key
    assert metrics["torch"]["Estimates for % of frames"] == 1.0


def _batch(rng, B=3, U=2):
    return {
        "image0_unique": rng.integers(0, 256, (U, H * 3 // 2, W), dtype=np.uint8),
        "ref_idx": np.sort(rng.integers(0, U, B)).astype(np.int32),
        "image1": rng.integers(0, 256, (B, H * 3 // 2, W), dtype=np.uint8),
    }


def test_unique_ref_and_per_pair_paths_agree():
    """Too many unique refs fall back to a per-pair image0 stack; a final
    partial batch is padded. Both must give the poses of the gather path."""
    model = pt_build_model(make_cfg(pt_default_cfg), device="cpu")
    rng = np.random.default_rng(0)
    batch = _batch(rng, B=3, U=2)
    R, t, inliers = model.predict_batch(batch)
    assert R.shape == (3, 3, 3) and t.shape == (3, 1, 3) and inliers.shape == (3,)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)

    model.u_max = 1  # two refs no longer fit: the per-pair path
    R2, t2, _ = model.predict_batch(batch)
    np.testing.assert_allclose(R2, R, atol=1e-5)
    np.testing.assert_allclose(t2, t, atol=1e-5)


def test_checkpoint_loads_state_dict_with_lightning_prefix(tmp_path):
    src = pt_build_model(make_cfg(pt_default_cfg), device="cpu")
    state = {f"model.{k}": v for k, v in src.net.state_dict().items()}
    path = tmp_path / "weights.ckpt"
    torch.save({"state_dict": state}, path)

    cfg = make_cfg(pt_default_cfg)
    cfg.TPU.SEED = 7  # different random init: only the checkpoint can match
    loaded = pt_build_model(cfg, checkpoint=str(path), device="cpu")
    for k, v in src.net.state_dict().items():
        assert torch.equal(loaded.net.state_dict()[k], v), k

    del state["model.encoder.firstconv.weight"]
    torch.save({"state_dict": state}, path)
    with pytest.raises(KeyError, match="encoder.firstconv.weight"):
        pt_build_model(cfg, checkpoint=str(path), device="cpu")


def test_tf32_off_is_scoped_and_restores(monkeypatch):
    """The float32 forward turns TF32 off only around itself: the process's
    own settings hold before and after it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with tf32_off():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError), tf32_off():
        raise ValueError
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32

    model = pt_build_model(make_cfg(pt_default_cfg), device="cpu")
    model.predict_batch(_batch(np.random.default_rng(1)))
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_build_model_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_build_model(make_cfg(pt_default_cfg))
    pt_build_model(make_cfg(pt_default_cfg), device="cpu")  # the CPU on request
