"""The in-graph depth net of the matching track (mapfree_tpu_torch/models/depth.py)
against the JAX package's (mapfree_tpu/models/depth.py) on carried-over
weights: ``MonoDepthNet`` and the keypoint depths at 1e-4 of the largest
depth, at a size the /16 round trip keeps and at odd sizes it does not
(jax.image.resize's antialiased bilinear weights); and the predictor's
checkpoint rules: a ``.pt`` written by tools/convert_weights.py loads, an
orbax directory and an empty checkpoint without ALLOW_RANDOM raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_configs import random_variables
from torch_threads import one_torch_thread  # noqa: F401

from mapfree_tpu.models.depth import MonoDepthNet as JaxDepthNet
from mapfree_tpu.ops.essential import gather_depth as jax_gather_depth
from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.depth import DepthPredictor, MonoDepthNet, resize_weights
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables, save_jax_variables

TOL = 1e-4
BLOCKS = (1, 1, 1)


@pytest.fixture(scope="module")
def jax_net():
    net = JaxDepthNet(num_blocks=BLOCKS)
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 32, 3)))
    variables = random_variables(jax.tree.map(np.asarray, variables), 7)
    apply = jax.jit(lambda v, x: net.apply(v, x))
    return variables, apply


def _images(B, H, W, seed, uint8=True):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    return rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("H,W,uint8", [(48, 32, True), (52, 36, True), (45, 37, False)])
def test_depth_net_matches_jax(jax_net, H, W, uint8):
    variables, apply = jax_net
    imgs = _images(2, H, W, H + W, uint8)
    want = np.asarray(apply(variables, jnp.asarray(imgs)))
    net = MonoDepthNet(BLOCKS)
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, H, W)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("n_in,n_out", [(544, 540), (68, 67), (40, 45), (16, 16)])
def test_resize_weights_match_jax_image_resize(n_in, n_out):
    x = np.random.default_rng(n_in).standard_normal(n_in).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out,), "bilinear"))
    # float32 weights and sums in another order: 1e-4 of the largest value
    np.testing.assert_allclose(resize_weights(n_in, n_out) @ x, want, atol=TOL * np.abs(x).max())


def _cfg(**dnet):
    cfg = pt_default_cfg.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DEPTH_NET.ENABLED = True
    cfg.DEPTH_NET.NUM_BLOCKS = "1-1-1"
    for k, v in dnet.items():
        cfg.DEPTH_NET[k] = v
    return cfg


def test_point_depths_from_a_converted_checkpoint_match_jax(jax_net, tmp_path):
    variables, apply = jax_net
    path = tmp_path / "depth.pt"
    save_jax_variables(MonoDepthNet(BLOCKS), variables, path)
    predictor = DepthPredictor(_cfg(CHECKPOINT=str(path)), "cpu")
    imgs = _images(3, 48, 32, 5)
    pts = np.random.default_rng(6).uniform(0, [32, 48], (3, 20, 2)).astype(np.float32)
    want = np.asarray(jax_gather_depth(apply(variables, jnp.asarray(imgs)), jnp.asarray(pts)))
    got = predictor.point_depths(torch.from_numpy(imgs), torch.from_numpy(pts)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_checkpoint_rules(tmp_path):
    with pytest.raises(ValueError, match="CHECKPOINT is empty"):
        DepthPredictor(_cfg(), "cpu")
    with pytest.raises(ValueError, match="convert_weights"):
        DepthPredictor(_cfg(CHECKPOINT=str(tmp_path)), "cpu")  # a directory: orbax
    a = DepthPredictor(_cfg(ALLOW_RANDOM=True), "cpu")
    b = DepthPredictor(_cfg(ALLOW_RANDOM=True), "cpu")
    imgs = torch.from_numpy(_images(1, 32, 32, 9))
    assert torch.equal(a(imgs), b(imgs))  # random weights from TPU.SEED


def test_bf16_depth_net_runs_in_bf16_and_returns_float32():
    cfg = _cfg(ALLOW_RANDOM=True)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    pred = DepthPredictor(cfg, "cpu")
    out = pred(torch.from_numpy(_images(2, 32, 48, 10)))
    assert out.dtype == torch.float32 and out.shape == (2, 32, 48)
    assert torch.isfinite(out).all() and (out > 0).all() and (out < 20).all()
