"""PyTorch port: the quaternion, 6D and angular-bin heads and their six
losses against the JAX package on the CPU at float32, values and gradients.

The heads hold random weights carried across in flax layout
(``to_jax_variables`` of the port's head, filled with seeded values, then
``load_jax_variables``); R, t and every aux entry must agree within 1e-4,
and the gradient of a random linear function of the differentiable outputs
with respect to the input volume within 1e-3 of its largest entry. The
losses take random predictions a little off the ground truth: values within
1e-5 relative, gradients within 1e-4 of their largest entry. The bin
targets round half to even (``jnp.round`` and ``torch.round`` alike), are
clipped to their bins, and phi's 360 wraps to 0: checked at exact half
degrees and at phi just below 360 degrees.
"""

import math

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mapfree_tpu import losses as jax_losses
from mapfree_tpu.geom import quat2mat
from mapfree_tpu.models import heads as jax_heads

from mapfree_tpu_torch import losses as pt_losses
from mapfree_tpu_torch.models import heads as pt_heads
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables, to_jax_variables

from torch_configs import random_variables
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, H, W, C = 3, 12, 10, 19
HEADS = {
    "quat_separate_scale": (lambda: jax_heads.QuatHead(separate_scale=True),
                            lambda: pt_heads.QuatHead(C, (H, W), separate_scale=True)),
    "quat_translation_avgpool": (
        lambda: jax_heads.QuatHead(separate_scale=False, avg_pool=True),
        lambda: pt_heads.QuatHead(C, (H, W), separate_scale=False, avg_pool=True)),
    "direct_deep_no_bn": (lambda: jax_heads.DirectHead(deep=True, batch_norm=False),
                          lambda: pt_heads.DirectHead(C, (H, W), deep=True, batch_norm=False)),
    "direct_shallow": (lambda: jax_heads.DirectHead(deep=False),
                       lambda: pt_heads.DirectHead(C, (H, W), deep=False)),
    "bins_separate_scale": (
        lambda: jax_heads.AngularBinsHead(separate_scale=True, avg_pool=True),
        lambda: pt_heads.AngularBinsHead(C, (H, W), separate_scale=True, avg_pool=True)),
    "bins_translation": (lambda: jax_heads.AngularBinsHead(separate_scale=False),
                         lambda: pt_heads.AngularBinsHead(C, (H, W), separate_scale=False)),
}


def _carried_weights(pt_head, seed):
    """The port's head and the JAX head's variables holding the same random
    weights: the port's tree, under a ``head`` container so that its trunk
    takes the flax name ``trunk``."""
    holder = nn.ModuleDict({"head": pt_head})
    tree = random_variables(to_jax_variables(holder), seed)
    load_jax_variables(holder, tree)
    return {c: t["head"] for c, t in tree.items() if "head" in t}


@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name):
    make_jax, make_pt = HEADS[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    head = make_pt().eval()
    variables = _carried_weights(head, len(name))
    jhead = make_jax()

    def outputs(R, t, aux):
        # the differentiable outputs; the bins head's R comes from an argmax
        keep = {k: v for k, v in aux.items()}
        if "R_bins" not in aux:
            keep["R"] = R
        keep["t"] = t
        return keep

    R_ref, t_ref, aux_ref = jhead.apply(variables, jnp.asarray(x), False)
    xt = torch.from_numpy(x).requires_grad_(True)
    R, t, aux = head(xt)
    assert set(aux) == set(aux_ref)
    np.testing.assert_allclose(R.detach().numpy(), np.asarray(R_ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(t_ref), rtol=0, atol=1e-4)
    for key in aux_ref:
        np.testing.assert_allclose(aux[key].detach().numpy(), np.asarray(aux_ref[key]),
                                   rtol=0, atol=1e-4, err_msg=key)

    weights = {k: rng.normal(size=np.shape(v)).astype(np.float32)
               for k, v in outputs(R_ref, t_ref, aux_ref).items()}

    def jfun(a):
        out = outputs(*jhead.apply(variables, a, False))
        return sum(jnp.sum(out[k] * w) for k, w in weights.items())

    g_ref = np.asarray(jax.grad(jfun)(jnp.asarray(x)))
    out = outputs(R, t, aux)
    sum((out[k] * torch.from_numpy(w)).sum() for k, w in weights.items()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=0, atol=1e-3 * np.abs(g_ref).max())


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _case(seed=0, n=12):
    """T_0to1 and predictions near it for every head's aux entries."""
    rng = np.random.default_rng(seed)
    q = _unit(rng.normal(size=(n, 4)))
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = np.asarray(quat2mat(q))
    T[:, :3, 3] = rng.normal(size=(n, 3))
    tgt = T[:, :3, 3]
    preds = {
        "q": _unit(q * np.sign(q[:, :1]) + rng.normal(size=(n, 4)) * 0.1),
        "scale": (np.linalg.norm(tgt, axis=1) * rng.uniform(0.7, 1.3, n)).reshape(n, 1, 1),
        "t_direction": _unit(tgt + rng.normal(size=(n, 3)) * 0.2).reshape(n, 1, 3),
        "R_bins": rng.normal(size=(n, 900)) * 2.0,
        "t_sph_phi": rng.normal(size=(n, 360)) * 2.0,
        "t_sph_theta": rng.normal(size=(n, 180)) * 2.0,
    }
    return {k: np.asarray(v, np.float32) for k, v in preds.items()}, T


LOSSES = ["rot_bin_loss", "quat_l1_loss", "robust_quat_l1_loss",
          "trans_scale_direction_loss", "trans_scale_l1_loss", "trans_sphbin_loss"]


def _both(name, preds, T):
    """(JAX value, JAX gradients, port value, port gradients) by pred key."""
    keys = sorted(preds)

    def jloss(*vals):
        return jax_losses.get_loss(name)(dict(zip(keys, vals)), {"T_0to1": jnp.asarray(T)})

    ref, grads = jax.value_and_grad(jloss, argnums=tuple(range(len(keys))))(
        *[jnp.asarray(preds[k]) for k in keys])
    pt = {k: torch.from_numpy(preds[k]).requires_grad_(True) for k in keys}
    out = pt_losses.get_loss(name)(pt, {"T_0to1": torch.from_numpy(T)})
    out.backward()
    return (float(ref), {k: np.asarray(g) for k, g in zip(keys, grads)},
            float(out.detach()), {k: (np.zeros(preds[k].shape, np.float32) if v.grad is None
                                      else v.grad.numpy()) for k, v in pt.items()}, out)


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax_in_value_and_gradient(name):
    preds, T = _case(seed=len(name))
    ref, grads_ref, value, grads, out = _both(name, preds, T)
    assert out.shape == () and out.dtype == torch.float32
    np.testing.assert_allclose(value, ref, rtol=1e-5)
    moved = 0
    for key, g_ref in grads_ref.items():
        np.testing.assert_allclose(grads[key], g_ref, rtol=0,
                                   atol=1e-4 * max(np.abs(g_ref).max(), 1e-3), err_msg=key)
        moved += int(np.abs(g_ref).max() > 0)
    assert moved >= 1


def test_rot_bin_targets_round_half_to_even_and_clip(monkeypatch):
    """Ground-truth angles at exact half degrees (and at the ends of their
    ranges) given to both packages' rot_bin_loss: the loss is the
    cross-entropy at numpy's rounding (half to even) clipped to the bins."""
    angles = np.array([[-179.5, -89.5, 0.5], [0.5, 1.5, 2.5], [179.5, 89.5, 179.5],
                       [-180.0, -90.0, 180.0], [-0.5, 0.5, -178.5]], np.float32)
    monkeypatch.setattr(jax_losses, "matrix_to_euler_xyz", lambda R: jnp.asarray(angles))
    monkeypatch.setattr(pt_losses, "matrix_to_euler_xyz", lambda R: torch.from_numpy(angles))
    n = len(angles)
    preds, T = _case(seed=5, n=n)
    target = np.round(angles + np.array([180.0, 90.0, 180.0], np.float32)).astype(int)
    target = np.clip(target, 0, [359, 179, 359])
    assert target.tolist()[0] == [0, 0, 180] and target.tolist()[2] == [359, 179, 359]
    logits = preds["R_bins"].astype(np.float64)

    def ce(lg, labels):
        lg = lg - lg.max(axis=1, keepdims=True)
        logp = lg - np.log(np.exp(lg).sum(axis=1, keepdims=True))
        return -logp[np.arange(len(labels)), labels].mean()

    expected = (ce(logits[:, :360], target[:, 0]) + ce(logits[:, 360:540], target[:, 1])
                + ce(logits[:, 540:], target[:, 2])) / 3
    ref, _, value, _, _ = _both("rot_bin_loss", {"R_bins": preds["R_bins"]}, T)
    np.testing.assert_allclose([value, ref], [expected, expected], rtol=1e-5)


def test_sphbin_phi_just_below_360_wraps_to_bin_0():
    """A direction a hair below the +x axis (phi just under 360 degrees)
    takes phi bin 0 in both packages: with all of phi's logit mass on bin 0,
    the scale exact and theta's logits flat, the loss is log(180) / 2."""
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[:, :3, 3] = [[1.0, -1e-7, 0.2], [2.0, -3e-7, -0.5]]
    phi = np.zeros((2, 360), np.float32)
    phi[:, 0] = 60.0
    preds = {"scale": np.linalg.norm(T[:, :3, 3], axis=1).reshape(2, 1, 1).astype(np.float32),
             "t_sph_phi": phi, "t_sph_theta": np.zeros((2, 180), np.float32)}
    ref, _, value, _, _ = _both("trans_sphbin_loss", preds, T)
    np.testing.assert_allclose([value, ref], [math.log(180) / 2] * 2, rtol=1e-5, atol=1e-6)
