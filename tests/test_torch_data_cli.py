"""PyTorch port, the user's entry points on the CPU: ``fit(cfg)``, the train
CLI (``python -m mapfree_tpu_torch.train``) and the submission CLI
(``python -m mapfree_tpu_torch.submission``), each with ``--device cpu`` on a
tiny MapFree tree (tests/fixtures.py::make_scene in tmp_path) at a small
resize set by YAML files in tmp_path.

- ``fit(cfg)`` trains from its DataModule, and its first batch is the batch
  the JAX package's ``fit`` draws from its loader;
- the train CLI takes 2 steps and writes its checkpoints; the submission CLI
  sweeps the test split on that run's ``last.pt``, and its lines agree with
  the JAX package's ``submission.py`` on the same weights within 1e-4
  (float32, the frameworks sum in other orders);
- the loader's unique-ref batch form (``getbatch``: deduplicated refs,
  ``ref_idx``, planar YUV420) gives both predictors the same poses within
  1e-4;
- the same for the multi-frame fusion model over a tree with device poses
  (``poses_device.txt``): windows of 9 frames through the train CLI and the
  submission CLI, against the JAX package's fit and ``submission.py``.
"""

import importlib.util
import types
from pathlib import Path
from zipfile import ZipFile

import numpy as np
import pytest
import yaml

pytest.importorskip("cv2")

import jax  # noqa: E402

import mapfree_tpu.data.io as jax_io  # noqa: E402
import mapfree_tpu.train.fit as jax_fit  # noqa: E402
from fixtures import make_device_poses, make_scene  # noqa: E402
from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.data import MapFreeDataset as JaxMapFreeDataset  # noqa: E402
from mapfree_tpu.models.builder import build_model as jax_build_model  # noqa: E402

import mapfree_tpu_torch.train.fit as pt_fit  # noqa: E402
from mapfree_tpu_torch import submission as pt_submission  # noqa: E402
from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.data import MapFreeDataset  # noqa: E402
from mapfree_tpu_torch.models.builder import build_model as pt_build_model  # noqa: E402
from mapfree_tpu_torch.tools.convert_weights import to_jax_variables  # noqa: E402
from mapfree_tpu_torch.train.__main__ import main as train_main  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

REPO = Path(__file__).resolve().parents[1]
MODEL_CFG = REPO / "configs/regression/mapfree/3d3d.yaml"
# 3d3d.yaml cut to a CPU test: one block per stage, 8 output channels, 48x36
# frames, float32, one device for the JAX package
SMALL = """ENCODER:
  NUM_BLOCKS: 1-1-1
  NUM_OUT_LAYERS: 8
DATASET:
  HEIGHT: 48
  WIDTH: 36
  MIN_OVERLAP_SCORE: 0.2
  MAX_OVERLAP_SCORE: 0.8
TRAINING:
  BATCH_SIZE: 2
  N_SAMPLES_SCENE: 2
  NUM_WORKERS: 2
  EPOCHS: 1
  VAL_INTERVAL: 1.0
  VAL_BATCHES: 1
  LOG_INTERVAL: 1
TPU:
  COMPUTE_DTYPE: float32
  INFER_BATCH: 4
  MESH_SHAPE: [1]
"""


@pytest.fixture(autouse=True)
def jax_cv2_branch(monkeypatch):
    """The JAX package as it runs where its C++ decoder is not built."""
    monkeypatch.setattr(jax_io, "_HAS_NATIVE", False)
    monkeypatch.setattr(jax_io, "HAS_NATIVE_DECODER", False)


def write_tree(root: Path) -> tuple:
    """Scenes of 64x48 frames for every split, the dataset config (DATA_ROOT
    set) and the model config (3d3d.yaml, then the cuts above)."""
    for split, train, n in (("train", True, 6), ("val", False, 10), ("test", False, 10)):
        for i in range(2):
            make_scene(root / split / f"s{i:05}", n_queries=n, img_hw=(64, 48), train=train,
                       seed=7 * i + len(split), max_angle=0.5)
    text = (REPO / "configs/mapfree.yaml").read_text()
    dataset = root / "dataset.yaml"
    dataset.write_text(text.replace("DATA_ROOT: 'data/mapfree/'", f"DATA_ROOT: '{root}'"))
    model_cfg = yaml.safe_load(MODEL_CFG.read_text())
    for node, values in yaml.safe_load(SMALL).items():
        model_cfg.setdefault(node, {}).update(values)
    model = root / "model.yaml"
    model.write_text(yaml.safe_dump(model_cfg))
    return dataset, model


def merged(default, dataset, model):
    c = default.clone()
    c.merge_from_file(str(dataset))
    c.merge_from_file(str(model))
    return c


def test_fit_trains_from_its_datamodule_on_the_jax_first_batch(tmp_path, monkeypatch):
    dataset, model = write_tree(tmp_path)
    seen = []
    real_fit_loaders = pt_fit.fit_loaders

    def spying_fit_loaders(cfg, train_loader, val_loader, **kwargs):
        class Recording:
            def __len__(self):
                return len(train_loader)

            def __iter__(self):
                for batch in train_loader:
                    seen.append(batch)
                    yield batch
        return real_fit_loaders(cfg, Recording(), val_loader, **kwargs)

    monkeypatch.setattr(pt_fit, "fit_loaders", spying_fit_loaders)
    state = pt_fit.fit(merged(pt_default_cfg, dataset, model), weights_dir=str(tmp_path / "w"),
                       device="cpu")
    assert state.step == 2 and len(seen) == 2
    assert (tmp_path / "w" / "default" / "last.pt").is_file()

    class Drawn(Exception):
        pass

    def first_batch(net, cfg, rng, init_batch):
        raise Drawn(init_batch)

    monkeypatch.setattr(jax_fit, "init_state", first_batch)
    with pytest.raises(Drawn) as drawn:
        jax_fit.fit(merged(jax_default_cfg, dataset, model), weights_dir=str(tmp_path / "j"))
    ref = drawn.value.args[0]
    for key in ("image0", "image1", "T_0to1"):
        np.testing.assert_allclose(np.asarray(seen[0][key], np.float32), ref[key],
                                   rtol=0, atol=1e-6, err_msg=key)


def _zip_lines(path):
    with ZipFile(path) as z:
        return {n: z.read(n).decode().splitlines() for n in sorted(z.namelist())}


def _jax_predictor_with(cfg, net):
    """The JAX package's predictor carrying the port net's weights."""
    model = jax_build_model(cfg)
    model.variables = jax.device_put(to_jax_variables(net))
    return model


def test_train_cli_then_submission_cli_match_jax(tmp_path, monkeypatch, capsys):
    dataset, model = write_tree(tmp_path)
    monkeypatch.chdir(tmp_path)  # the train CLI writes weights/<experiment>/ here
    state = train_main([str(MODEL_CFG), str(dataset), "--config", str(model),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"config merge order (later overrides earlier): {dataset} -> {MODEL_CFG} -> " \
           f"{model}" in out
    ckpt = tmp_path / "weights" / "default" / "last.pt"
    assert state.step == 2 and ckpt.is_file() and (ckpt.parent / "step_2.pt").is_file()

    argv = [str(model), "--dataset_config", str(dataset), "--checkpoint", str(ckpt),
            "-o", str(tmp_path / "port"), "--device", "cpu"]
    path = pt_submission.main(argv)
    assert path == tmp_path / "port" / "submission.zip"

    # the JAX package's CLI (submission.py) on the same weights: its
    # predictor is given the checkpoint's weights, its config is a copy
    spec = importlib.util.spec_from_file_location("jax_submission_cli", REPO / "submission.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    pcfg = merged(pt_default_cfg, dataset, model)
    net = pt_build_model(pcfg, checkpoint=str(ckpt), device="cpu").net
    monkeypatch.setattr(jax_cli, "cfg", jax_default_cfg.clone())
    monkeypatch.setattr(jax_cli, "build_model", lambda cfg, checkpoint: _jax_predictor_with(cfg, net))
    jax_cli.eval(types.SimpleNamespace(
        config=str(model), dataset_config=str(dataset), checkpoint="",
        output_root=tmp_path / "jax", split="test", num_hosts=None, host_id=None))

    port, ref = _zip_lines(path), _zip_lines(tmp_path / "jax" / "submission.zip")
    assert list(port) == list(ref) == ["pose_s00000.txt", "pose_s00001.txt"]
    for name in ref:
        assert len(port[name]) == len(ref[name]) == 2
        for a, b in zip(port[name], ref[name]):
            a, b = a.split(" "), b.split(" ")
            assert a[0] == b[0] and a[8] == b[8]
            np.testing.assert_allclose(np.array(a[1:8], float), np.array(b[1:8], float),
                                       rtol=0, atol=1e-4)


def test_unique_ref_batches_give_both_predictors_the_same_poses(tmp_path):
    """getbatch's form (image0_unique, ref_idx, ref_names, YUV420 image1) from
    the real datasets, through each package's predictor."""
    dataset, model = write_tree(tmp_path)
    pcfg = merged(pt_default_cfg, dataset, model)
    jcfg = merged(jax_default_cfg, dataset, model)
    pmodel = pt_build_model(pcfg, device="cpu")
    jmodel = _jax_predictor_with(jcfg, pmodel.net)
    pds, jds = MapFreeDataset(pcfg, "test", device="cpu"), JaxMapFreeDataset(jcfg, "test")
    assert pds.yuv420_transfer and jds.yuv420_transfer
    for indices in ([0, 1, 2], [1, 2, 3]):  # one scene's ref, then two scenes' refs
        pb, jb = pds.getbatch(indices), jds.getbatch(indices)
        assert pb["image1"].shape == (len(indices), 72, 36)
        R, t, _ = pmodel.predict_batch(pb)
        Rj, tj, _ = jmodel.predict_batch(jb)
        np.testing.assert_allclose(R, np.asarray(Rj), rtol=0, atol=1e-4)
        np.testing.assert_allclose(t, np.asarray(tj), rtol=0, atol=1e-4)


FUSION_CFG = REPO / "configs/regression/mapfree/multiframe/3d3d_multi_fusion.yaml"


def write_multiframe_tree(root: Path) -> tuple:
    """Scenes with device-tracking poses (poses_device.txt, the tracked poses
    moved by noise of 0.01): train 2 scenes of 16 queries, val 1 and test 2
    of 20 (two windows of 9 frames each at the sample factor of 10); the
    dataset config with QUERY_FRAME_COUNT 9 (configs/mapfree_multi.yaml's)
    and the fusion model config cut as SMALL cuts 3d3d.yaml."""
    for split, train, n, count in (("train", True, 16, 2), ("val", False, 20, 1),
                                   ("test", False, 20, 2)):
        for i in range(count):
            scene = root / split / f"s{i:05}"
            poses = make_scene(scene, n_queries=n, img_hw=(64, 48), train=train,
                               seed=11 * i + len(split), max_angle=0.5)
            make_device_poses(scene, poses, noise=0.01, seed=i + len(split))
    text = (REPO / "configs/mapfree.yaml").read_text()
    dataset = root / "dataset.yaml"
    dataset.write_text(text.replace("DATA_ROOT: 'data/mapfree/'", f"DATA_ROOT: '{root}'")
                       .replace("QUERY_FRAME_COUNT: 1", "QUERY_FRAME_COUNT: 9"))
    model_cfg = yaml.safe_load(FUSION_CFG.read_text())
    for node, values in yaml.safe_load(SMALL).items():
        model_cfg.setdefault(node, {}).update(values)
    model = root / "model.yaml"
    model.write_text(yaml.safe_dump(model_cfg))
    return dataset, model


def test_fusion_train_cli_then_submission_cli_match_jax(tmp_path, monkeypatch):
    """The fusion model (3d3d_multi_fusion.yaml over QUERY_FRAME_COUNT 9) on
    a tree with device poses: the port's fit trains on the JAX fit's first
    batch, device poses included; the train CLI takes 2 steps; the
    submission CLI on its last.pt writes one line per window's query frame,
    and agrees with the JAX package's submission.py on the same weights
    within 1e-4 per q and t."""
    dataset, model = write_multiframe_tree(tmp_path)
    seen = []
    real_fit_loaders = pt_fit.fit_loaders

    def spying_fit_loaders(cfg, train_loader, val_loader, **kwargs):
        class Recording:
            def __len__(self):
                return len(train_loader)

            def __iter__(self):
                for batch in train_loader:
                    seen.append(batch)
                    yield batch
        return real_fit_loaders(cfg, Recording(), val_loader, **kwargs)

    monkeypatch.setattr(pt_fit, "fit_loaders", spying_fit_loaders)
    monkeypatch.chdir(tmp_path)  # the train CLI writes weights/<experiment>/ here
    state = train_main([str(FUSION_CFG), str(dataset), "--config", str(model),
                        "--device", "cpu"])
    ckpt = tmp_path / "weights" / "default" / "last.pt"
    assert state.step == 2 and ckpt.is_file() and len(seen) == 2

    class Drawn(Exception):
        pass

    def first_batch(net, cfg, rng, init_batch):
        raise Drawn(init_batch)

    monkeypatch.setattr(jax_fit, "init_state", first_batch)
    with pytest.raises(Drawn) as drawn:
        jax_fit.fit(merged(jax_default_cfg, dataset, model), weights_dir=str(tmp_path / "j"))
    ref = drawn.value.args[0]
    assert set(ref) == {"image0", "image1", "T_0to1", "abs_q_1_w2c_device",
                        "abs_c_1_c2w_device"}
    assert seen[0]["image1"].shape[1] == 9
    for key in ref:
        np.testing.assert_allclose(np.asarray(seen[0][key], np.float32), ref[key],
                                   rtol=0, atol=1e-6, err_msg=key)

    argv = [str(model), "--dataset_config", str(dataset), "--checkpoint", str(ckpt),
            "-o", str(tmp_path / "port"), "--device", "cpu"]
    path = pt_submission.main(argv)
    spec = importlib.util.spec_from_file_location("jax_submission_cli", REPO / "submission.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    net = pt_build_model(merged(pt_default_cfg, dataset, model), checkpoint=str(ckpt),
                         device="cpu").net
    monkeypatch.setattr(jax_cli, "cfg", jax_default_cfg.clone())
    monkeypatch.setattr(jax_cli, "build_model", lambda cfg, checkpoint: _jax_predictor_with(cfg, net))
    jax_cli.eval(types.SimpleNamespace(
        config=str(model), dataset_config=str(dataset), checkpoint="",
        output_root=tmp_path / "jax", split="test", num_hosts=None, host_id=None))

    port, ref = _zip_lines(path), _zip_lines(tmp_path / "jax" / "submission.zip")
    assert list(port) == list(ref) == ["pose_s00000.txt", "pose_s00001.txt"]
    for name in ref:
        frames = [line.split(" ")[0] for line in port[name]]
        assert frames == ["seq1/frame_00009.jpg", "seq1/frame_00019.jpg"]
        for a, b in zip(port[name], ref[name]):
            a, b = a.split(" "), b.split(" ")
            assert a[0] == b[0] and a[8] == b[8]
            np.testing.assert_allclose(np.array(a[1:8], float), np.array(b[1:8], float),
                                       rtol=0, atol=1e-4)
