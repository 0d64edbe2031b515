"""PyTorch port, the multi-frame models against the JAX package on the CPU
at float32: ``fuse_frame_poses`` (its consistency, and its values and
gradients on random inputs), the fusion net's forward on uint8 windows, the
predictor's unit-quaternion padding of a final partial batch, and the
training keys. One train step of the fusion net against the JAX
``make_train_step`` is tests/test_torch_train_step_fusion_vs_jax.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapfree_tpu.geom import quat2mat as jax_quat2mat
from mapfree_tpu.models.regression import build_regression_net as jax_build_net
from mapfree_tpu.models.regression import fuse_frame_poses as jax_fuse
from mapfree_tpu.train.fit import _train_keys as jax_train_keys

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.models.regression import fuse_frame_poses
from mapfree_tpu_torch.train.fit import _device_batch, _train_keys

from torch_configs import check_variant, jax_default_cfg, model_inputs, small_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FUSION = "configs/regression/mapfree/multiframe/3d3d_multi_fusion.yaml"
MULTI = "configs/regression/mapfree/multiframe/3d3d_multi.yaml"


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _poses(rng, B, F):
    """Device-tracking poses (w2c) and per-frame predictions T_ref->f."""
    q_dev = _unit(rng.normal(size=(B, F, 4))).astype(np.float32)
    t_dev = rng.normal(size=(B, F, 3)).astype(np.float32)
    R_f = np.asarray(jax_quat2mat(_unit(rng.normal(size=(B, F, 4)))), np.float32)
    t_f = rng.normal(size=(B, F, 3)).astype(np.float32)
    w = rng.random((B, F)).astype(np.float32)
    return R_f, t_f, q_dev, t_dev, w / w.sum(axis=1, keepdims=True)


def test_fusion_is_exact_on_consistent_frames():
    """Per-frame predictions that, chained through exact tracking, all name
    the same T_ref->last fuse to it, whatever the weights."""
    rng = np.random.default_rng(0)
    B, F = 3, 9
    _, _, q_dev, t_dev, w = _poses(rng, B, F)
    R_true = np.asarray(jax_quat2mat(_unit(rng.normal(size=(B, 4)))), np.float64)
    t_true = rng.normal(size=(B, 3))
    R_dev = np.asarray(jax_quat2mat(q_dev.astype(np.float64)))
    # T_f->last = T_last o T_f^-1, so T_ref->f = (T_f->last)^-1 o T_ref->last
    R_rel = R_dev[:, -1:] @ np.swapaxes(R_dev, -1, -2)
    t_rel = t_dev[:, -1:] - np.einsum("bfij,bfj->bfi", R_rel, t_dev)
    R_f = np.swapaxes(R_rel, -1, -2) @ R_true[:, None]
    t_f = np.einsum("bfji,bfj->bfi", R_rel, t_true[:, None] - t_rel)
    R, t, R_est, t_est = fuse_frame_poses(
        *(torch.from_numpy(np.asarray(a, np.float32)) for a in (R_f, t_f, q_dev, t_dev, w)))
    np.testing.assert_allclose(R_est.numpy(), np.broadcast_to(R_true[:, None], R_est.shape),
                               atol=2e-5)
    np.testing.assert_allclose(t_est.numpy(), np.broadcast_to(t_true[:, None], t_est.shape),
                               atol=2e-5)
    np.testing.assert_allclose(R.numpy(), R_true, atol=2e-5)
    np.testing.assert_allclose(t.numpy(), t_true, atol=2e-5)


def test_fuse_frame_poses_matches_jax_in_value_and_gradient():
    """Random frames: R, t and the chained estimates within 1e-5; the
    gradient of a random linear function of (R, t) with respect to the
    per-frame poses and the weights within 1e-3 of its largest entry (the
    top eigenvector's gradient, through eigh in both)."""
    rng = np.random.default_rng(1)
    args = _poses(rng, 4, 9)
    wR, wt = rng.normal(size=(4, 3, 3)), rng.normal(size=(4, 3))
    ref = jax_fuse(*(jnp.asarray(a) for a in args))
    pt_args = [torch.from_numpy(a).requires_grad_(i in (0, 1, 4)) for i, a in enumerate(args)]
    out = fuse_frame_poses(*pt_args)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=0, atol=1e-5)

    def jf(R_f, t_f, w):
        R, t, _, _ = jax_fuse(R_f, t_f, jnp.asarray(args[2]), jnp.asarray(args[3]), w)
        return jnp.sum(R * wR) + jnp.sum(t * wt)

    g_ref = jax.grad(jf, argnums=(0, 1, 2))(*(jnp.asarray(args[i]) for i in (0, 1, 4)))
    ((out[0] * torch.from_numpy(wR)).sum() + (out[1] * torch.from_numpy(wt)).sum()).backward()
    for arg, g in zip((pt_args[0], pt_args[1], pt_args[4]), g_ref):
        g = np.asarray(g)
        np.testing.assert_allclose(arg.grad.numpy(), g, rtol=0, atol=1e-3 * np.abs(g).max())


@pytest.mark.parametrize("model_yaml", [FUSION, MULTI])
def test_net_on_uint8_windows_of_three_matches_jax(model_yaml):
    """The forward on uint8 frames (/255 in both), F = 3 by override."""
    check_variant(model_yaml, seed=5, uint8=True, **{"DATASET.QUERY_FRAME_COUNT": 3})


def _window_batch(cfg, B, seed):
    image0, image1, extra = model_inputs(cfg, B, seed, uint8=True)
    F = image1.shape[1]
    return {"image0": image0, "image1": image1,
            "abs_q_1_w2c_device": extra["q_device"].astype(np.float64),
            "abs_c_1_c2w_device": extra["t_device"].astype(np.float64),
            "scene_id": ["s"] * B,
            "pair_names": [("seq0/frame_00000.jpg",
                            tuple(f"seq1/frame_{i * F + f:05d}.jpg" for f in range(F)))
                           for i in range(B)]}


def test_predictor_pads_a_final_partial_batch_with_unit_quaternions():
    """3 windows in a batch of 4: the padded row's device quaternion is
    (1, 0, 0, 0) (a zero one would put NaN into eigh), and the poses of the
    real rows equal the net's on those rows alone."""
    cfg = small_cfg(pt_default_cfg, FUSION, H=64, W=48,
                    **{"TPU.INFER_BATCH": 4, "DATASET.QUERY_FRAME_COUNT": 3})
    model = build_model(cfg, device="cpu")
    assert model.needs_device_poses and model.u_max == 0
    batch = _window_batch(cfg, 3, seed=6)
    named, B = model._named_arrays(batch)
    fields = dict(named)
    assert B == 3 and fields["q_device"].shape == (4, 3, 4)
    np.testing.assert_array_equal(fields["q_device"][3], np.tile([1.0, 0, 0, 0], (3, 1)))
    np.testing.assert_array_equal(fields["t_device"][3], np.zeros((3, 3)))
    R, t, inliers = model.predict_batch(batch)
    assert R.shape == (3, 3, 3) and t.shape == (3, 1, 3) and inliers.shape == (3,)
    with torch.no_grad():
        R_ref, t_ref, _ = model.net(
            torch.from_numpy(batch["image0"]), torch.from_numpy(batch["image1"]),
            q_device=torch.from_numpy(fields["q_device"][:3]),
            t_device=torch.from_numpy(fields["t_device"][:3]))
    np.testing.assert_allclose(R, R_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(t, t_ref.numpy(), atol=1e-5)


def test_train_keys_and_the_padded_device_batch():
    """The fusion net trains on the device poses as well, and a partial
    batch is padded with unit quaternions, as the JAX package's fit does;
    the two-view and multi-frame nets take the three keys."""
    pt_keys, jax_keys = {}, {}
    for model_yaml in (FUSION, MULTI, "configs/regression/mapfree/3d3d.yaml"):
        pt_keys[model_yaml] = _train_keys(pt_build_net(small_cfg(pt_default_cfg, model_yaml)))
        jax_keys[model_yaml] = jax_train_keys(jax_build_net(small_cfg(jax_default_cfg,
                                                                      model_yaml)))
    assert pt_keys == jax_keys
    assert pt_keys[FUSION] == ("image0", "image1", "T_0to1", "abs_q_1_w2c_device",
                               "abs_c_1_c2w_device")
    assert pt_keys[MULTI] == ("image0", "image1", "T_0to1")

    cfg = small_cfg(pt_default_cfg, FUSION, **{"DATASET.QUERY_FRAME_COUNT": 3})
    batch = _window_batch(cfg, 3, seed=7)
    batch["T_0to1"] = np.tile(np.eye(4), (3, 1, 1))
    dev = _device_batch(batch, torch.device("cpu"), 5, pt_keys[FUSION])
    assert set(dev) == set(pt_keys[FUSION])
    assert dev["abs_q_1_w2c_device"].dtype == torch.float32
    np.testing.assert_array_equal(dev["abs_q_1_w2c_device"][3:].numpy(),
                                  np.tile([1.0, 0, 0, 0], (2, 3, 1)))
    np.testing.assert_array_equal(dev["abs_c_1_c2w_device"][3:].numpy(), 0.0)
    np.testing.assert_array_equal(dev["image1"][3:].numpy(), 0)
    assert dev["image1"].shape == (5, 3, cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, 3)
