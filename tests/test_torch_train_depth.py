"""PyTorch port, the depth net's training tool
(mapfree_tpu_torch/tools/train_depth.py) against the JAX package's
(mapfree_tpu/tools/train_depth.py) on the CPU, float32:

- ``depth_loss`` with invalid GT pixels within 1e-6, and ``fold_batch``
  equal;
- 1 and 3 train steps of ``MonoDepthNet`` (one block per stage, 32x32,
  batch 2, both views folded) from the JAX package's initial variables
  against the JAX ``make_step`` with ``optax.adam``: the loss of every step
  within 1e-5 relative, Adam's moments per tensor within 1e-3 of the
  tensor's largest entry, the BatchNorm statistics within 1e-5, and the
  parameters after Adam (``test_train_steps_match_jax`` says why the
  ConvBnElu biases and the running means after them get looser bounds);
- ``train()`` feeds its steps the JAX tool's batches, in the JAX tool's
  order (its one extra draw of the loader's generator included);
- ``train()`` end to end on a ``make_scene`` tree writes a ``.pt`` that
  ``DepthPredictor`` loads; the trained net fits the GT depth better than
  its initial weights (the JAX package's own test asserts the same).

The JAX ``train`` is never run to its end: it saves with orbax, which fails
here (``ROADMAP.md`` section 3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

pytest.importorskip("cv2")  # tests/fixtures.py writes the JPEGs with cv2

import mapfree_tpu.data.io as jax_io  # noqa: E402
import mapfree_tpu.tools.train_depth as jax_td  # noqa: E402
from fixtures import make_scene  # noqa: E402
from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.models.depth import MonoDepthNet as JaxDepthNet  # noqa: E402

import mapfree_tpu_torch.tools.train_depth as pt_td  # noqa: E402
from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.data import MapFreeDataset  # noqa: E402
from mapfree_tpu_torch.models.depth import DepthPredictor, MonoDepthNet  # noqa: E402
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables, to_jax_variables  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

LR = 1e-3


@pytest.fixture(autouse=True)
def jax_cv2_branch(monkeypatch):
    """The JAX package as it runs where its C++ decoder is not built."""
    monkeypatch.setattr(jax_io, "_HAS_NATIVE", False)
    monkeypatch.setattr(jax_io, "HAS_NATIVE_DECODER", False)


def _pairs(seed, B=2, H=32, W=32, uint8=True):
    """A loader batch of B pairs: images, GT depth with invalid pixels."""
    rng = np.random.default_rng(seed)
    batch = {}
    for k in ("0", "1"):
        img = rng.integers(0, 256, (B, H, W, 3))
        batch["image" + k] = (img.astype(np.uint8) if uint8
                              else (img / 255.0).astype(np.float64))
        depth = rng.uniform(0.5, 5.0, (B, H, W)).astype(np.float32)
        depth[:, : H // 8] = 0.0  # no GT
        depth[:, -1] = 5e-4       # below the validity threshold
        batch["depth" + k] = [d for d in depth]  # the loader's uncollated list
    return batch


def test_depth_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(-0.5, 8.0, (3, 17, 23)).astype(np.float32)
    gt = rng.uniform(0.0, 6.0, (3, 17, 23)).astype(np.float32)
    gt[gt < 1.0] = 0.0
    gt[0, 0, :5] = 1e-3  # at the threshold: invalid
    want = float(jax_td.depth_loss(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(pt_td.depth_loss(torch.from_numpy(pred), torch.from_numpy(gt)))
    assert abs(got - want) <= 1e-6 * abs(want)
    # no valid pixel: 0 / max(0, 1)
    zero = np.zeros_like(gt)
    assert float(pt_td.depth_loss(torch.from_numpy(pred), torch.from_numpy(zero))) == \
        float(jax_td.depth_loss(jnp.asarray(pred), jnp.asarray(zero))) == 0.0


@pytest.mark.parametrize("uint8", [True, False])
def test_fold_batch_matches_jax(uint8):
    batch = _pairs(1, uint8=uint8)
    got, want = pt_td.fold_batch(batch), jax_td.fold_batch(batch)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == (np.uint8 if uint8 else np.float32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _feeds_batchnorm(path) -> bool:
    """The convolution biases of ConvBnElu: a BatchNorm follows, so their
    gradient is zero in exact arithmetic and round-off in float32."""
    return path[-1] == "bias" and path[-2] == "conv" and path[0] != "head"


def _moments(net, opt, key):
    for p in net.parameters():
        p.grad = opt.state[p][key].clone()
    return to_jax_variables(net, grads=True)["params"]


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps):
    """Adam moves an element by about LR a step whatever its gradient's
    size, so an element whose gradient is round-off at some step (the
    ConvBnElu biases always, a few others at a step) moves either way: every
    parameter lies within 2 LR per step of the JAX package's, and all but
    1e-4 of the other elements within 1e-2 LR."""
    batches = [pt_td.fold_batch(_pairs(10 + s)) for s in range(steps)]
    jnet = JaxDepthNet(num_blocks=(1, 1, 1))
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(batches[0][0][:1])))
    tx = optax.adam(LR)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    jstep = jax_td.make_step(jnet, tx)

    net = MonoDepthNet((1, 1, 1))
    load_jax_variables(net, variables)
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    step = pt_td.make_step(net, opt)

    for images, gt in batches:
        params, stats, opt_state, want = jstep(params, stats, opt_state,
                                               jnp.asarray(images), jnp.asarray(gt))
        got = step(torch.from_numpy(images), torch.from_numpy(gt))
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))

    adam = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
    moments = {"exp_avg": jax.tree.map(np.asarray, adam.mu),
               "exp_avg_sq": jax.tree.map(np.asarray, adam.nu)}
    largest_mu = max(np.abs(v).max() for _, v in _leaves(moments["exp_avg"]))
    for key, want_tree in moments.items():
        got_tree = _moments(net, opt, key)
        for path, want in _leaves(want_tree):
            got = _get(got_tree, path)
            if _feeds_batchnorm(path):
                if key == "exp_avg":
                    assert np.abs(want).max() <= 1e-6 * largest_mu, path
                    assert np.abs(got).max() <= 1e-6 * largest_mu, path
                continue
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), (key, path)

    ported = to_jax_variables(net)
    for path, want in _leaves(jax.tree.map(np.asarray, stats)):
        # a ConvBnElu's running mean takes in its conv's bias, which Adam
        # moves either way (the bias's bound, scaled by the momentum 0.1)
        atol = 0.1 * 2 * LR * steps if path[-2:] == ("bn", "mean") else 1e-5
        np.testing.assert_allclose(_get(ported["batch_stats"], path), want, atol=atol,
                                   err_msg=str(path))
    off, total = 0, 0
    for path, want in _leaves(jax.tree.map(np.asarray, params)):
        diff = np.abs(_get(ported["params"], path) - want)
        assert diff.max() <= 2 * LR * steps, path
        if not _feeds_batchnorm(path):
            off += int((diff > 1e-2 * LR).sum())
            total += diff.size
    assert off <= 1e-4 * total, (off, total)


def _tree(tmp_path):
    for i in range(2):
        make_scene(tmp_path / "train" / f"s{i}", n_queries=6, img_hw=(32, 32),
                   train=True, seed=i, depth_suffix="gt")


def _cfg(default):
    cfg = default.clone()
    cfg.DATASET.DATA_SOURCE = "MapFree"
    cfg.DATASET.HEIGHT = 32
    cfg.DATASET.WIDTH = 32
    cfg.DATASET.MIN_OVERLAP_SCORE = 0.0
    cfg.DATASET.MAX_OVERLAP_SCORE = 1.0
    cfg.DEPTH_NET.NUM_BLOCKS = "1-1-1"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAINING.NUM_WORKERS = 1
    return cfg


class _Enough(Exception):
    pass


def _record(monkeypatch, module, n):
    """Record the batches ``module``'s train() folds; stop after n."""
    seen = []
    real = module.fold_batch

    def recording(batch):
        if len(seen) == n:
            raise _Enough
        seen.append(real(batch))
        return seen[-1]

    monkeypatch.setattr(module, "fold_batch", recording)
    return seen


def test_train_takes_the_jax_tools_batches_in_its_order(tmp_path, monkeypatch):
    _tree(tmp_path)
    jax_seen = _record(monkeypatch, jax_td, 4)
    with pytest.raises(_Enough):
        jax_td.train(_cfg(jax_default_cfg), str(tmp_path), "gt", str(tmp_path / "j"),
                     steps=12, batch=4)
    pt_seen = _record(monkeypatch, pt_td, 3)
    with pytest.raises(_Enough):
        pt_td.train(_cfg(pt_default_cfg), str(tmp_path), "gt", str(tmp_path / "p.pt"),
                    steps=12, batch=4, device="cpu")
    # the JAX tool's first fold is its init draw; its steps take the next
    assert len(jax_seen) == 4 and len(pt_seen) == 3
    for (gi, gd), (wi, wd) in zip(pt_seen, jax_seen[1:]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)


def test_train_end_to_end_writes_a_checkpoint_the_predictor_loads(tmp_path):
    _tree(tmp_path)
    cfg = _cfg(pt_default_cfg)
    (tmp_path / "ckpt.pt").mkdir()  # an orbax directory in the way is replaced
    out, final_loss = pt_td.train(cfg, str(tmp_path), "gt", str(tmp_path / "ckpt.pt"),
                                  steps=12, batch=4, lr=1e-2, log_every=4, device="cpu")
    assert out.is_file() and np.isfinite(final_loss)

    cfg.DEPTH_NET.ENABLED = True
    cfg.DEPTH_NET.CHECKPOINT = str(out)
    pred = DepthPredictor(cfg, "cpu")
    imgs = np.random.default_rng(1).integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    d = pred(torch.from_numpy(imgs)).numpy()
    assert d.shape == (2, 32, 32)
    assert np.isfinite(d).all() and (d > 0).all()

    # the trained weights fit the GT depth better than the initial ones
    cfg2 = cfg.clone()
    cfg2.DATASET.DATA_ROOT = str(tmp_path)
    cfg2.DATASET.ESTIMATED_DEPTH = "gt"
    s = MapFreeDataset(cfg2, "train", device="cpu")[0]
    gt = torch.from_numpy(s["depth0"][None])
    img = torch.from_numpy(np.asarray(s["image0"])[None])
    initial = pt_td.build_net(cfg).eval()
    with torch.no_grad():
        loss_init = float(pt_td.depth_loss(initial(img), gt))
    loss_trained = float(pt_td.depth_loss(pred(img), gt))
    assert loss_trained < loss_init
