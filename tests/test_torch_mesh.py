"""PyTorch port, the data mesh (``parallel/mesh.py``) against the JAX
package's, on the CPU.

- One train step of tests/test_train.py::tiny_cfg's model over gloo in 4
  processes of 2 rows each (``make_train_step(..., mesh=make_mesh(devices=
  [cpu] * 4))``: synced BatchNorm, gradients averaged over the ranks) against
  the JAX ``make_train_step`` on a 4-device mesh on the same global batch of
  8, from the same weights (carried over with ``load_jax_variables``): the
  loss within 1e-4 relative, every gradient (JAX: read back from Adam's
  first moment) and every parameter after Adam within 1e-3 of its tensor's
  largest entry (at least LR / 10: the test says why), the BatchNorm
  statistics within 1e-5. The JAX step runs
  flax's two-pass variance, as tests/test_torch_train_step_fusion_vs_jax.py
  says why.
- The same 4 ranks against the port's single-process step on the whole
  batch: the losses within 1e-5 relative, every gradient and buffer within
  1e-5 of its tensor's largest entry (or of 1), every parameter after Adam
  as above; the validation and predict steps over the ranks (before the
  train step) give every rank the whole batch's outputs within 1e-5; with colour jitter on, the ranks draw the global batch's
  augmentation and take their rows, so that holds too. The batches are
  well-conditioned points, as tests/test_torch_train_step_fusion_vs_jax.py
  says such a comparison needs: at make_batch's seed 0 the translation loss
  moves by 3e-5 relative between 1 and 4 ranks, at seed 2 (and with the
  jittered frames of seed 3) a ReLU input within round-off of zero flips a
  gradient element by 1e-4 of its tensor; seed 1 and the frames of seed 4
  stay within 6e-6.
- The predictor over 4 CPU devices rounds INFER_BATCH 10 up to 12, as the
  JAX predictor does on a 4-device mesh, and gives the single-device poses
  within 1e-6, with and without the unique-reference batch form.
- ``fit`` on 4 ranks rounds its batch of 2 up to 4, says so once (rank 0),
  decodes one row per rank, validates and writes its checkpoint from rank 0.

Each rank is a process of its own (tests/torch_ranks.py: a free port per
test, collectives time out after 60 s, the wait for the ranks after 120 s).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax.linen import normalization as flax_normalization

from mapfree_tpu.models.builder import RegressionPredictor as JaxPredictor
from mapfree_tpu.models.regression import build_regression_net as jax_build_net
from mapfree_tpu.parallel import make_mesh as jax_make_mesh
from mapfree_tpu.parallel import shard_batch as jax_shard_batch
from mapfree_tpu.train import init_state as jax_init_state
from mapfree_tpu.train import make_train_step as jax_make_train_step

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.models.regression import build_regression_net
from mapfree_tpu_torch.parallel import make_mesh
from mapfree_tpu_torch.tools.convert_weights import to_jax_variables

from fixtures import make_scene
from test_train import H, W, make_batch, tiny_cfg
from torch_configs import flat
from torch_ranks import fit_rank, run_ranks, steps, train_step_rank
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
CPUS = ["cpu"] * WORLD
# the keys tiny_cfg sets, copied from the JAX config into the port's
TINY_KEYS = ("MODEL", "ENCODER.TYPE", "ENCODER.BLOCK_TYPE", "ENCODER.NUM_BLOCKS",
             "ENCODER.NUM_OUT_LAYERS", "AGGREGATOR.TYPE", "AGGREGATOR.POSITION_ENCODER",
             "AGGREGATOR.MAX_SCORE_CHANNEL", "HEAD.TYPE", "HEAD.ADD_BASIS", "HEAD.AVG_POOL",
             "TRAINING.LR", "TRAINING.ROT_LOSS", "TRAINING.TRANS_LOSS", "TRAINING.LAMBDA",
             "TRAINING.GRAD_CLIP", "TPU.COMPUTE_DTYPE")


def _get(cfg, key):
    for part in key.split("."):
        cfg = cfg[part]
    return cfg


def _set(cfg, key, value):
    *path, last = key.split(".")
    for part in path:
        cfg = cfg[part]
    cfg[last] = value


def port_cfg(jcfg):
    """The port's config of tiny_cfg's model, at make_batch's frame size."""
    c = pt_default_cfg.clone()
    for key in TINY_KEYS:
        _set(c, key, _get(jcfg, key))
    c.DATASET.HEIGHT, c.DATASET.WIDTH = H, W
    return c


@pytest.fixture
def two_pass_variance(monkeypatch):
    """flax's BatchNorm statistics with ``use_fast_variance=False``."""
    compute_stats = flax_normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    monkeypatch.setattr(flax_normalization, "_compute_stats", two_pass)


def numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny model's config, initial variables (numpy) and a global
    batch of 8 (numpy)."""
    jcfg = tiny_cfg()
    batch = {k: np.asarray(v) for k, v in make_batch(B=8).items()}
    jnet = jax_build_net(jcfg)
    jstate = jax_init_state(jnet, jcfg, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    variables = {"params": numpy_tree(jstate.params),
                 "batch_stats": numpy_tree(jstate.batch_stats)}
    return jcfg, jnet, jstate, variables, batch


def _port_net_from(cfg, state: dict):
    """A port net holding a rank's numpy_state (parameters, gradients,
    buffers)."""
    net = build_regression_net(cfg)
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(torch.from_numpy(state[f"param/{k}"]))
            if f"grad/{k}" in state:
                p.grad = torch.from_numpy(state[f"grad/{k}"])
        for k, b in net.named_buffers():
            b.copy_(torch.from_numpy(state[f"buffer/{k}"]))
    return net


def _assert_states_close(got: dict, ref: dict, rtol: float, kinds=("param", "grad", "buffer")):
    assert set(got) == set(ref)
    for name, r in ref.items():
        if name.split("/")[0] in kinds:
            tol = rtol * max(1.0, float(np.abs(r).max())) if r.size else 0.0
            np.testing.assert_allclose(got[name], r, rtol=0, atol=tol, err_msg=name)


def _assert_adam_step_close(got, ref, cfg, name):
    """A parameter after one Adam step: within 1e-3 of its tensor's largest
    entry, and at least LR / 10. A tensor that starts at zero (a bias) ends
    the step within LR of zero, and Adam's first step moves an element by
    LR g / (|g| + eps): where |g| is near eps (1e-6) the gradients' float32
    round-off is amplified up to LR / eps = 1e3 times (measured: 2.3e-5 here
    against the JAX step, 4.2e-5 between 1 and 4 ranks)."""
    tol = max(1e-3 * float(np.abs(ref).max()), 0.1 * float(cfg.TRAINING.LR)) if ref.size else 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=name)


def test_four_ranks_match_the_jax_step_on_a_four_device_mesh(tiny, two_pass_variance):
    jcfg, jnet, jstate, variables, batch = tiny
    mesh = jax_make_mesh(devices=jax.devices()[:WORLD])
    jnew, jlogs = jax_make_train_step(jnet, jcfg, mesh=mesh, donate=False)(
        jstate, jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    adam = [s for s in jax.tree.leaves(jnew.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
    jgrads = flat(jax.tree.map(lambda m: np.asarray(m, np.float32) / (1.0 - 0.9), adam.mu))
    jparams = flat(numpy_tree(jnew.params))
    jstats = flat(numpy_tree(jnew.batch_stats))

    pcfg = port_cfg(jcfg)
    ranks = run_ranks(train_step_rank, WORLD, pcfg, variables, batch, CPUS)
    (logs, state, _), _ = ranks[0]
    for key in ("train/loss", "train/R_loss", "train/t_loss"):
        np.testing.assert_allclose(logs[key], float(jlogs[key]), rtol=1e-4, err_msg=key)
    net = _port_net_from(pcfg, state)
    pg = flat(to_jax_variables(net, grads=True)["params"])
    pp = flat(to_jax_variables(net)["params"])
    pstats = flat(to_jax_variables(net)["batch_stats"])
    assert set(pg) == set(jgrads) and set(pp) == set(jparams) and set(pstats) == set(jstats)
    for name in jgrads:
        # a conv bias before a BatchNorm has a zero gradient: round-off on
        # both sides, hence the floor (as torch_configs.check_train_step)
        np.testing.assert_allclose(pg[name], jgrads[name], rtol=0,
                                   atol=max(1e-3 * np.abs(jgrads[name]).max(), 2e-6),
                                   err_msg=name)
        _assert_adam_step_close(pp[name], jparams[name], jcfg, name)
    for name, ref in jstats.items():
        np.testing.assert_allclose(pstats[name], ref, rtol=0, atol=1e-5, err_msg=name)
    # every rank ends the step with the same weights and statistics
    for (_, other, _), _ in ranks[1:]:
        _assert_states_close(other, state, 0.0)


@pytest.mark.parametrize("jitter", [False, True], ids=["plain", "colorjitter"])
def test_four_ranks_match_one_process(tiny, jitter):
    jcfg, _, _, variables, _ = tiny
    pcfg = port_cfg(jcfg)
    batch = {k: np.asarray(v) for k, v in make_batch(B=8, seed=1).items()}
    if jitter:
        pcfg.DATASET.AUGMENTATION_TYPE = "colorjitter"
        # images the jitter takes: uint8 frames
        rng = np.random.default_rng(4)
        batch = dict(batch, **{k: rng.integers(0, 256, batch[k].shape, dtype=np.uint8)
                               for k in ("image0", "image1")})
    ref_logs, ref_state, ref_val = steps(pcfg, variables, {k: torch.from_numpy(v.copy())
                                                           for k, v in batch.items()})
    ranks = run_ranks(train_step_rank, WORLD, pcfg, variables, batch, CPUS)
    logs, state, _ = ranks[0][0]
    for key, value in ref_logs.items():
        np.testing.assert_allclose(logs[key], value, rtol=1e-5, err_msg=key)
    _assert_states_close(state, ref_state, 1e-5, kinds=("grad", "buffer"))
    for name, ref in ref_state.items():
        if name.startswith("param/"):
            _assert_adam_step_close(state[name], ref, pcfg, name)
    # the validation and predict steps: every rank holds the whole batch's
    # outputs (per-sample errors and poses gathered in rank order, the
    # losses averaged)
    for (_, _, val), _ in ranks:
        assert set(val) == set(ref_val)
        for key, ref in ref_val.items():
            assert val[key].shape == ref.shape, key
            np.testing.assert_allclose(val[key], ref, rtol=1e-5, atol=1e-5, err_msg=key)


def _predictor_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    H, W = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH
    image0 = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    image1 = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    unique = {"image0_unique": image0[:2], "ref_idx": (np.arange(n) % 2).astype(np.int32),
              "image1": image1}
    return {"image0": image0, "image1": image1}, unique


def test_predictor_over_four_devices_rounds_its_batch_and_matches_one_device(tiny):
    jcfg = tiny[0].clone()
    jcfg.DATASET.HEIGHT, jcfg.DATASET.WIDTH = H, W
    jcfg.TPU.INFER_BATCH = 10
    jcfg.TPU.MESH_SHAPE = [WORLD]
    assert JaxPredictor(jcfg).batch_size == 12
    pcfg = port_cfg(jcfg)
    for key in ("DATASET.HEIGHT", "DATASET.WIDTH", "TPU.INFER_BATCH", "TPU.MESH_SHAPE"):
        _set(pcfg, key, _get(jcfg, key))
    four = build_model(pcfg, device="cpu", devices=CPUS)
    one = build_model(pcfg, device="cpu")
    assert four.mesh is not None and four.mesh.size == WORLD and four.batch_size == 12
    assert one.mesh is None and one.batch_size == 10
    for batch in _predictor_batches(pcfg, 10, seed=5):
        R4, t4, _ = four.predict_batch(batch)
        R1, t1, _ = one.predict_batch(batch)
        assert R4.shape == (10, 3, 3) and t4.shape == (10, 1, 3)
        np.testing.assert_allclose(R4, R1, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t4, t1, rtol=0, atol=1e-6)


def test_mesh_blocks_and_one_device_mesh():
    mesh = make_mesh(devices=CPUS)
    assert mesh.shape == {"data": WORLD} and mesh.group is None
    from mapfree_tpu_torch.parallel import batch_sharding, pad_to_multiple, replicated, shard_batch

    assert batch_sharding(mesh).blocks(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert replicated(mesh).blocks(8) == [(0, 8)] * WORLD
    assert pad_to_multiple(10, WORLD) == 12
    shards = shard_batch({"x": np.arange(8)}, mesh)
    assert [s["x"].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="equal blocks"):
        batch_sharding(mesh).blocks(10)
    cfg = pt_default_cfg.clone()
    cfg.TPU.MESH_SHAPE = [2]
    assert make_mesh(cfg, devices=CPUS).size == 2  # the first prod(shape) devices


def _write_tree(root: Path):
    for split, train, n in (("train", True, 6), ("val", False, 6)):
        for i in range(2):
            make_scene(root / split / f"s{i:05}", n_queries=n, img_hw=(64, 48), train=train,
                       seed=7 * i + len(split), max_angle=0.5)
    cfg = pt_default_cfg.clone()
    cfg.merge_from_file(str(REPO / "configs/mapfree.yaml"))
    cfg.merge_from_file(str(REPO / "configs/regression/mapfree/3d3d.yaml"))
    small = yaml.safe_load("""
ENCODER: {NUM_BLOCKS: 1-1-1, NUM_OUT_LAYERS: 8}
DATASET: {HEIGHT: 48, WIDTH: 36, MIN_OVERLAP_SCORE: 0.2, MAX_OVERLAP_SCORE: 0.8}
TRAINING: {BATCH_SIZE: 2, N_SAMPLES_SCENE: 2, NUM_WORKERS: 1, EPOCHS: 1, VAL_INTERVAL: 1.0,
           VAL_BATCHES: 1, LOG_INTERVAL: 1}
TPU: {COMPUTE_DTYPE: float32}
""")
    for node, values in small.items():
        for k, v in values.items():
            cfg[node][k] = v
    cfg.DATASET.DATA_ROOT = str(root)
    return cfg


def test_fit_on_four_ranks_rounds_the_batch_and_rank_zero_writes(tmp_path):
    pytest.importorskip("cv2")  # the CPU decode of the tree's JPEGs
    cfg = _write_tree(tmp_path / "tree")
    ranks = run_ranks(fit_rank, WORLD, cfg, str(tmp_path / "w"))
    line = f"[fit] rounding batch size up to 4 for {WORLD} devices"
    assert line in ranks[0][1]
    assert all(steps == 1 for steps, _ in ranks)
    assert all(line not in out and "val_loss" not in out for _, out in ranks[1:])
    assert "val_loss=" in ranks[0][1]
    assert (tmp_path / "w" / "default" / "last.pt").is_file()
