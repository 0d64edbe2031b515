"""PyTorch port, training: the optimizer against optax, the BatchNorm
running statistics, and train steps of the port alone; the helpers the other
training tests share.

The configuration is the tiny one of tests/test_train.py (ResUNet 1-1-1
basic blocks, 8 output channels, 32x32 images, Procrustes head, Frobenius +
L2 losses, clip 1.0). One train step against the JAX package's
``make_train_step`` is in tests/test_torch_train_step_vs_jax.py, a file of
its own so that test workers can run it beside this one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapfree_tpu.config import cfg as jax_default_cfg
from mapfree_tpu.geom import quat2mat
from mapfree_tpu.train import make_optimizer as jax_make_optimizer

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models import blocks as pt_blocks
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.tools.convert_weights import _leaves
from mapfree_tpu_torch.train import (
    clip_by_global_norm_,
    init_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H = W = 32


def tiny_cfg(default, **overrides):
    """tests/test_train.py::tiny_cfg on either package's config schema."""
    c = default.clone()
    c.MODEL = "Regression"
    c.ENCODER.TYPE = "ResUNet"
    c.ENCODER.BLOCK_TYPE = 0
    c.ENCODER.NUM_BLOCKS = "1-1-1"
    c.ENCODER.NUM_OUT_LAYERS = 8
    c.AGGREGATOR.TYPE = "CorrelationVolumeWarping"
    c.AGGREGATOR.POSITION_ENCODER = True
    c.AGGREGATOR.MAX_SCORE_CHANNEL = True
    c.HEAD.TYPE = "ProcrustesDeepResBlock"
    c.HEAD.ADD_BASIS = True
    c.HEAD.AVG_POOL = True
    c.DATASET.HEIGHT, c.DATASET.WIDTH = H, W
    c.TRAINING.LR = 1e-3
    c.TRAINING.ROT_LOSS = "rot_frobenius_loss"
    c.TRAINING.TRANS_LOSS = "trans_l2_loss"
    c.TRAINING.LAMBDA = 1.0
    c.TRAINING.GRAD_CLIP = 1.0
    c.TPU.COMPUTE_DTYPE = "float32"
    for k, v in overrides.items():
        node = c
        parts = k.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = v
    return c


def make_batch(B=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = quat2mat(q)
    T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.1
    return {
        "image0": rng.normal(size=(B, H, W, 3)).astype(np.float32),
        "image1": rng.normal(size=(B, H, W, 3)).astype(np.float32),
        "T_0to1": T,
    }


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def flat(tree):
    return {"/".join(path): np.asarray(leaf) for path, leaf in _leaves(tree)}


def numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


def test_batchnorm_running_var_takes_the_biased_variance():
    """n = 2*3*3 = 18 values per channel: torch's own update would fold in
    var * 18/17, 6% more than flax does."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 3, 3)).astype(np.float32) * 3.0
    bn = pt_blocks.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    ref = torch.nn.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    y, y_ref = bn(torch.from_numpy(x)), ref(torch.from_numpy(x))
    assert torch.equal(y, y_ref)  # the normalisation itself is torch's
    var = x.transpose(1, 0, 2, 3).reshape(4, -1).var(axis=1)  # biased
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var, rtol=1e-6)
    np.testing.assert_allclose(ref.running_var.numpy(), 0.9 + 0.1 * var * 18 / 17,
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), ref.running_mean.numpy())
    assert set(bn.state_dict()) == set(ref.state_dict())
    # eval mode leaves the statistics alone
    before = bn.running_var.clone()
    bn.eval()(torch.from_numpy(x))
    assert torch.equal(bn.running_var, before)


def test_optimizer_matches_optax():
    """Adam(eps=1e-6) + clip 1.0 + an LR step every 2 steps, fed the same
    numpy gradients for 5 steps: parameters agree at rtol 1e-6."""
    import optax

    tcfg = tiny_cfg(jax_default_cfg, **{"TRAINING.LR_STEP_INTERVAL": 2,
                                        "TRAINING.LR_STEP_GAMMA": 0.5}).TRAINING
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # global norms on both sides of the clip threshold
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.01, 1.0, 0.05, 10.0)]

    tx = jax_make_optimizer(tcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    optimizer, scheduler = make_optimizer(tcfg, tparams.values())
    schedule = make_lr_schedule(tcfg)
    clipped = []
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

        assert optimizer.param_groups[0]["lr"] == pytest.approx(schedule(i))
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_by_global_norm_(list(tparams.values()), float(tcfg.GRAD_CLIP))
        clipped.append(float(norm) > 1.0)
        optimizer.step()
        scheduler.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {k}")
    assert clipped == [True, False, True, False, True]
    assert [schedule(i) for i in range(5)] == pytest.approx(
        [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4])


def test_clip_leaves_small_gradients_untouched():
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([0.1, -0.2, 0.3, 0.0])
    before = p.grad.clone()
    clip_by_global_norm_([p], 1.0)
    assert torch.equal(p.grad, before)
    p.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])
    clip_by_global_norm_([p], 1.0)
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.8, 0.0, 0.0], rtol=1e-6)


def test_loss_decreases_and_state_changes():
    cfg = tiny_cfg(pt_default_cfg)
    net = pt_build_net(cfg)
    state = init_state(net, cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    step = make_train_step(net, cfg)
    batch = to_torch(make_batch())
    losses = []
    for _ in range(8):
        state, logs = step(state, batch)
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in logs.values())
        losses.append(float(logs["train/loss"]))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert state.step == 8
    after = net.state_dict()
    assert not torch.equal(after["encoder.firstconv.weight"], before["encoder.firstconv.weight"])
    assert not torch.equal(after["encoder.firstbn.running_var"],
                           before["encoder.firstbn.running_var"])


def test_kendall_logging():
    cfg = tiny_cfg(pt_default_cfg, **{"TRAINING.LAMBDA": 0.0})
    net = pt_build_net(cfg)
    state = init_state(net, cfg, torch.Generator().manual_seed(0), device="cpu")
    state, logs = make_train_step(net, cfg)(state, to_torch(make_batch(B=4)))
    assert set(logs) == {"train/R_loss", "train/t_loss", "train/loss",
                         "train/s_R", "train/s_t"}
    # the logged weights are the ones the step was taken with (zeros); the
    # step then moved them
    assert float(logs["train/s_R"]) == 0.0 and float(logs["train/s_t"]) == 0.0
    assert float(net.s_r.detach().abs()) > 0.0


def test_bf16_train_step_keeps_float32_parameters():
    cfg = tiny_cfg(pt_default_cfg, **{"TPU.COMPUTE_DTYPE": "bfloat16"})
    net = pt_build_net(cfg)
    state = init_state(net, cfg, torch.Generator().manual_seed(0), device="cpu")
    state, logs = make_train_step(net, cfg)(state, to_torch(make_batch(B=4)))
    assert np.isfinite(float(logs["train/loss"]))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in net.parameters())
