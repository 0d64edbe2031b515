"""Configs and random weights for the PyTorch port's model-level tests.

- :func:`load_cfg` merges a model YAML under ``configs/regression/`` into
  either package's schema over its dataset config (``scannet.yaml`` for the
  ScanNet configs, ``mapfree.yaml`` then ``mapfree_multi.yaml`` for the
  multi-frame ones, ``mapfree.yaml`` otherwise), then dotted overrides.
- :func:`random_variables` fills a flax-layout variables tree (the port's
  :func:`to_jax_variables` gives one) with seeded random values: kernels
  as flax's default (LeCun normal) draws them, and BatchNorm statistics, scales and biases away from their
  identity values, so that a mapping error shows.
- :func:`model_inputs` draws the images (and, for the fusion model, the
  device-tracking poses) a config's network takes.
- :func:`check_variant` holds one config of the port against the JAX
  package (tests/test_torch_variants.py says how).
"""

from pathlib import Path

import numpy as np
import torch

import jax

from mapfree_tpu.config import cfg as jax_default_cfg
from mapfree_tpu.models.regression import build_regression_net as jax_build_net

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables, to_jax_variables

REPO = Path(__file__).resolve().parents[1]
REGRESSION_CONFIGS = sorted(str(p.relative_to(REPO))
                            for p in (REPO / "configs/regression").rglob("*.yaml"))
# the regression configs by the test file that holds them against the JAX
# package: each file compiles the JAX network of each of its configs, so the
# groups keep a file near a minute (test workers schedule whole files)
_M, _S = "configs/regression/mapfree/", "configs/regression/scannet/"
VARIANT_GROUPS = {
    "test_torch_variants.py": [_M + n + ".yaml" for n in (
        "3d3d", "3d3d_lowoverlap", "3d3d_no_posencoder", "3d3d_no_warping",
        "3d3d_weighted_loss")],
    "test_torch_variants_heads.py": [_M + n + ".yaml" for n in (
        "rot6d_trans", "rotbin_trans", "rotbin_transdirectionbin_scale",
        "rotbin_transdirectionbin_scale_lowoverlap", "rotbin_transdirectionbin_scale_qkv",
        "rotquat_trans", "rotquat_transdirection_scale", "multiframe/3d3d_multi",
        "multiframe/3d3d_multi_fusion")],
    "test_torch_variants_scannet.py": [_S + n + ".yaml" for n in (
        "3d3d", "3d3d_lowoverlap", "3d3d_no_avgpool", "3d3d_qkv",
        "rotbin_transdirectionbin_scale")],
    "test_torch_variants_scannet_cv.py": [_S + n + ".yaml" for n in (
        "3d3d_dual_posenc", "3d3d_dual_posenc_upsampling", "3d3d_half_cv",
        "3d3d_with_dustbin")],
}


def load_cfg(default, model_yaml, **overrides):
    c = default.clone()
    c.merge_from_file(str(REPO / ("configs/scannet.yaml" if "/scannet/" in model_yaml
                                  else "configs/mapfree.yaml")))
    if "/multiframe/" in model_yaml:
        c.merge_from_file(str(REPO / "configs/mapfree_multi.yaml"))
    c.merge_from_file(str(REPO / model_yaml))
    for key, value in overrides.items():
        node = c
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return c


def small_cfg(default, model_yaml, H=96, W=72, **overrides):
    """The config cut to a CPU test: one block per stage, H x W frames,
    float32. 96 x 72 leaves the head's trunk a 2 x 2 grid, so that ravelling
    (AVG_POOL false) differs from pooling."""
    return load_cfg(default, model_yaml, **{
        "ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": H, "DATASET.WIDTH": W,
        "TPU.COMPUTE_DTYPE": "float32", **overrides})


def random_variables(tree, seed):
    """A tree of the same structure and shapes with seeded random float32
    values (nested dicts of numpy arrays, flax names)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, value in node.items():
            if hasattr(value, "items"):
                out[key] = walk(value)
                continue
            shape = np.shape(value)
            if key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.normal(0.0, np.sqrt(1.0 / fan_in), shape)
            elif key == "var":
                a = rng.uniform(0.5, 2.0, shape)
            elif key == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            elif key in ("mean", "bias"):
                a = rng.normal(0.0, 0.1, shape)
            else:  # bin_score, s_r, s_t
                a = rng.normal(0.0, 0.5, shape)
            out[key] = a.astype(np.float32)
        return out

    return {collection: walk(node) for collection, node in tree.items()}


def flat(tree, prefix=""):
    """{"a/b/leaf": leaf} of a nested dict tree."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if hasattr(value, "items"):
            out.update(flat(value, name))
        else:
            out[name] = value
    return out


def model_inputs(cfg, B, seed, uint8=False):
    """(image0, image1, extra keyword inputs) for ``cfg``'s network: image1
    is a window [B, F, H, W, 3] for the multi-frame models; the fusion model
    also takes unit w2c quaternions and translations of the tracked frames."""
    rng = np.random.default_rng(seed)
    H, W = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH
    F = int(cfg.DATASET.QUERY_FRAME_COUNT)
    shape1 = (B, F, H, W, 3) if cfg.MODEL != "Regression" else (B, H, W, 3)
    if uint8:
        image0 = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
        image1 = rng.integers(0, 256, shape1, dtype=np.uint8)
    else:
        image0 = rng.random((B, H, W, 3)).astype(np.float32)
        image1 = rng.random(shape1).astype(np.float32)
    extra = {}
    if cfg.MODEL == "RegressionMultiFrameFusion":
        q = rng.normal(size=(B, F, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        extra = {"q_device": q.astype(np.float32),
                 "t_device": rng.normal(size=(B, F, 3)).astype(np.float32)}
    return image0, image1, extra


def check_variant(model_yaml, seed=0, H=96, W=72, atol=1e-4, uint8=False, **overrides):
    """The weight bridge both ways and the forward of one config against the
    JAX package (tests/test_torch_variants.py), on float or ``uint8`` frames.
    Returns the port's net."""
    pcfg = small_cfg(pt_default_cfg, model_yaml, H, W, **overrides)
    jcfg = small_cfg(jax_default_cfg, model_yaml, H, W, **overrides)
    net = pt_build_net(pcfg).eval()
    tree = random_variables(to_jax_variables(net), seed)
    image0, image1, extra = model_inputs(pcfg, 2, seed, uint8=uint8)

    jnet = jax_build_net(jcfg)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), image0, image1,
                                              train=False, **extra))
    assert {k: v.shape for k, v in flat(shapes).items()} == \
        {k: v.shape for k, v in flat(tree).items()}

    load_jax_variables(net, tree)
    back, ref_leaves = flat(to_jax_variables(net)), flat(tree)
    assert list(back) == list(ref_leaves)
    for name, value in ref_leaves.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)

    apply = jax.jit(lambda v, a, b, kw: jnet.apply(v, a, b, train=False, **kw))
    R_ref, t_ref, _ = apply(tree, image0, image1, extra)
    with torch.no_grad():
        R, t, _ = net(torch.from_numpy(image0), torch.from_numpy(image1),
                      **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert R.shape == (2, 3, 3) and t.shape == (2, 1, 3)
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), rtol=0, atol=atol)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=0, atol=atol)
    return net


def check_train_step(model_yaml, batch, **overrides):
    """One float32 train step of a config (cut by :func:`small_cfg` and
    ``overrides``) in both packages from the JAX package's initial weights
    and on the same numpy batch: the loss within 1e-4 relative, every
    gradient within 1e-3 of its tensor's largest entry (the JAX gradients
    read back from Adam's first moment, mu = (1 - 0.9) g after one step),
    and the BatchNorm running statistics within 1e-5."""
    import jax.numpy as jnp

    from mapfree_tpu.train import init_state as jax_init_state
    from mapfree_tpu.train import make_train_step as jax_make_train_step

    from mapfree_tpu_torch.train import init_state, make_train_step

    jcfg = small_cfg(jax_default_cfg, model_yaml, **overrides)
    pcfg = small_cfg(pt_default_cfg, model_yaml, **overrides)
    jnet = jax_build_net(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jax_init_state(jnet, jcfg, jax.random.PRNGKey(0), jbatch)
    jnew, jlogs = jax_make_train_step(jnet, jcfg, donate=False)(jstate, jbatch)
    adam = [s for s in jax.tree.leaves(jnew.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
    jgrads = flat(jax.tree.map(lambda m: np.asarray(m, np.float32) / (1.0 - 0.9), adam.mu))

    def numpy_tree(tree):
        return jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))

    net = pt_build_net(pcfg)
    load_jax_variables(net, {"params": numpy_tree(jstate.params),
                             "batch_stats": numpy_tree(jstate.batch_stats)})
    state = init_state(net, pcfg, device="cpu")
    state, logs = make_train_step(net, pcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("train/loss", "train/R_loss", "train/t_loss"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=1e-4, err_msg=key)

    pg = flat(to_jax_variables(net, grads=True)["params"])
    assert set(pg) == set(jgrads)
    for name, g in jgrads.items():
        # a conv bias before a BatchNorm has a zero gradient: both sides hold
        # float32 round-off there, hence the absolute floor
        tol = max(1e-3 * np.abs(g).max(), 2e-6)
        np.testing.assert_allclose(pg[name], g, rtol=0, atol=tol, err_msg=name)

    new_stats = flat(numpy_tree(jnew.batch_stats))
    port_stats = flat(to_jax_variables(net)["batch_stats"])
    assert set(port_stats) == set(new_stats)
    for name, ref in new_stats.items():
        np.testing.assert_allclose(port_stats[name], ref, rtol=0, atol=1e-5, err_msg=name)
    return float(logs["train/loss"])


def train_batch(cfg, B, seed):
    """A float32 training batch for ``cfg``: :func:`model_inputs` and a
    random relative pose ``T_0to1``, plus the fusion model's device poses
    under their batch keys."""
    from mapfree_tpu.geom import quat2mat

    image0, image1, extra = model_inputs(cfg, B, seed)
    rng = np.random.default_rng(seed + 1)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = np.asarray(quat2mat(q))
    T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.5
    batch = {"image0": image0, "image1": image1, "T_0to1": T}
    if extra:
        batch["abs_q_1_w2c_device"] = extra["q_device"]
        batch["abs_c_1_c2w_device"] = extra["t_device"]
    return batch
