"""PyTorch port, the multi-host scene-sharded sweep
(mapfree_tpu_torch/parallel/multihost.py) and the submission CLI's
``--num_hosts``/``--host_id``, on the CPU.

- ``shard_scenes`` and ``merge_submissions`` give what the JAX package's
  functions give;
- a 3-host dry run (the hosts run one after another in this process, host 0
  last, as the barrier orders them on a real run) merges into the zip of the
  single-host sweep, byte for byte per scene file;
- the CLI with ``--num_hosts 3 --host_id 2, 1, 0`` and ``--checkpoint``
  writes the single-host CLI's poses on that checkpoint, byte for byte: the
  checkpoint reaches every host (the JAX package's sharded branch builds its
  model without it).
"""

import zipfile
from pathlib import Path

import pytest
import torch
import yaml

pytest.importorskip("cv2")  # tests/fixtures.py writes the JPEGs with cv2

from fixtures import make_scene  # noqa: E402
from mapfree_tpu.parallel import merge_submissions as jax_merge  # noqa: E402
from mapfree_tpu.parallel import shard_scenes as jax_shard  # noqa: E402

import mapfree_tpu_torch.parallel.multihost as multihost  # noqa: E402
from mapfree_tpu_torch import submission  # noqa: E402
from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.models.blocks import init_weights  # noqa: E402
from mapfree_tpu_torch.models.builder import build_model  # noqa: E402
from mapfree_tpu_torch.models.regression import build_regression_net  # noqa: E402
from mapfree_tpu_torch.parallel import merge_submissions, run_sharded_sweep, shard_scenes  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

REPO = Path(__file__).resolve().parents[1]
# 3d3d.yaml cut to a CPU test (tests/test_multihost.py's cuts)
SMALL = {"ENCODER": {"NUM_BLOCKS": "1-1-1", "NUM_OUT_LAYERS": 8},
         "DATASET": {"HEIGHT": 48, "WIDTH": 36},
         "TPU": {"COMPUTE_DTYPE": "float32", "INFER_BATCH": 4},
         "TRAINING": {"NUM_WORKERS": 1}}


def test_shard_scenes_matches_jax():
    scenes = [f"s{i:03d}" for i in (7, 3, 10, 0, 5, 1, 9, 2, 8, 4, 6)]
    for n in (1, 2, 3, 8, 16):
        shards = [shard_scenes(scenes, n, h) for h in range(n)]
        assert shards == [jax_shard(scenes, n, h) for h in range(n)]
        assert sorted(x for s in shards for x in s) == sorted(scenes)
    with pytest.raises(ValueError):
        shard_scenes(scenes, 3, 3)


def _write_part(path, entries):
    with zipfile.ZipFile(path, "w") as z:
        for name, data in entries.items():
            z.writestr(name, data)


def _zip_bytes(path):
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def test_merge_submissions_matches_jax(tmp_path):
    parts = [tmp_path / f"p{i}.zip" for i in range(3)]
    _write_part(parts[0], {"pose_s2.txt": b"c 1", "pose_s0.txt": b"a 2"})
    _write_part(parts[1], {})
    _write_part(parts[2], {"pose_s1.txt": b"b 3\nb 4"})
    merge_submissions(parts, tmp_path / "pt.zip")
    jax_merge(parts, tmp_path / "jax.zip")
    assert _zip_bytes(tmp_path / "pt.zip") == _zip_bytes(tmp_path / "jax.zip")
    assert [n for n, _ in _zip_bytes(tmp_path / "pt.zip")] == [
        "pose_s0.txt", "pose_s1.txt", "pose_s2.txt"]

    _write_part(parts[1], {"pose_s0.txt": b"again"})
    with pytest.raises(ValueError, match="pose_s0.txt"):
        merge_submissions(parts, tmp_path / "dup.zip")


def test_host_topology_and_barrier(monkeypatch):
    # no process group: one host; injected values win
    assert multihost.host_topology() == (1, 0)
    assert multihost.host_topology(4, 2) == (4, 2)
    assert multihost.default_barrier() is None
    # a process group of 3: its size and rank, and a barrier
    monkeypatch.setattr(multihost, "_world", lambda: (3, 1))
    assert multihost.host_topology() == (3, 1)
    assert multihost.host_topology(None, 0) == (3, 0)
    assert callable(multihost.default_barrier())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Five test scenes of 48x36 frames, the dataset config and the model
    config (3d3d.yaml with the cuts above) in one directory."""
    root = tmp_path_factory.mktemp("mhtree")
    for i in range(5):
        make_scene(root / "test" / f"s{i:05d}", n_queries=10, img_hw=(48, 36),
                   seed=i, max_angle=0.3, t_scale=0.2)
    dataset = root / "dataset.yaml"
    dataset.write_text((REPO / "configs/mapfree.yaml").read_text()
                       .replace("DATA_ROOT: 'data/mapfree/'", f"DATA_ROOT: '{root}'"))
    model_cfg = yaml.safe_load((REPO / "configs/regression/mapfree/3d3d.yaml").read_text())
    for node, values in SMALL.items():
        model_cfg.setdefault(node, {}).update(values)
    model = root / "model.yaml"
    model.write_text(yaml.safe_dump(model_cfg))
    return root, dataset, model


def _cfg(dataset, model):
    c = pt_default_cfg.clone()
    c.merge_from_file(str(dataset))
    c.merge_from_file(str(model))
    return c


def _files(path):
    return dict(_zip_bytes(path))


def test_sharded_dry_run_matches_single_host(tree, tmp_path):
    _, dataset, model_cfg = tree
    cfg = _cfg(dataset, model_cfg)
    model = build_model(cfg, device="cpu")
    single = run_sharded_sweep(cfg, "test", tmp_path / "single", model=model,
                               n_hosts=1, host_id=0, device="cpu")
    barriers = []
    for host in (1, 2, 0):
        out = run_sharded_sweep(cfg, "test", tmp_path / "multi", model=model,
                                n_hosts=3, host_id=host, device="cpu",
                                barrier=barriers.append)
    assert out == tmp_path / "multi" / "submission.zip"
    assert len(barriers) == 3
    assert sorted(p.name for p in (tmp_path / "multi").iterdir()) == [
        "submission.part000.zip", "submission.part001.zip", "submission.part002.zip",
        "submission.zip"]
    a, b = _files(single), _files(out)
    assert len(a) == 5 and a == b


def test_cli_hosts_with_checkpoint_match_single_host_cli(tree, tmp_path):
    _, dataset, model_cfg = tree
    net = build_regression_net(_cfg(dataset, model_cfg))
    init_weights(net, torch.Generator().manual_seed(123))
    ckpt = tmp_path / "weights.pt"
    torch.save(net.state_dict(), ckpt)
    common = [str(model_cfg), "--dataset_config", str(dataset), "--device", "cpu"]

    single = submission.main(common + ["--checkpoint", str(ckpt), "-o", str(tmp_path / "one")])
    for host in (2, 1, 0):
        out = submission.main(common + ["--checkpoint", str(ckpt), "--num_hosts", "3",
                                        "--host_id", str(host), "-o", str(tmp_path / "three")])
    assert out == tmp_path / "three" / "submission.zip"
    assert _files(out) == _files(single)

    # without the checkpoint the poses are the config's random weights'
    random = submission.main(common + ["--num_hosts", "1", "-o", str(tmp_path / "random")])
    assert _files(random).keys() == _files(single).keys()
    assert _files(random) != _files(single)
