"""PyTorch port, bfloat16: how far one bf16 train step's gradient moves when
the correlation aggregator's output moves by 1e-5 relative, in the JAX
package and in the port, on the same weights and batch.

On the card, the bf16 train step with K1 and the same step with K1's plain
version (whose outputs agree to some 1e-5) give gradients 8-19% apart in L2
(``chip_smoke.py`` phase 6). This test asks whether that is the model's
behaviour or the port's: each package takes the gradient of one bf16 train
step of phase 6's small model (3d3d.yaml, one block per stage, 96 x 72,
batch 4) with its dense correlation on the CPU, then again with the
correlation channels of the aggregator's float32 output (warped features,
soft-argmax position, max score) scaled by 1 + 1e-5 r (r a fixed standard
normal draw) before the aggregator rounds them to bf16. Both packages get
the JAX package's initial weights and one numpy batch.

The JAX step moves its gradient by the same order as the port's, layer by
layer from the loss back (0.13 and 0.16 of the whole gradient here; the
head's MLP about 1e-2 in both, every convolution layer 0.07-0.31): the
amplification is the bf16 model's (a 1e-5 change flips the bf16 rounding of
some aggregated channels, and every bf16 layer after them rounds the flips
on), not a fault of the port. The test pins it: both moves above 1e-2 of the
gradient, and within a factor of 4 of each other for the whole gradient, the
median tensor and each layer.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import mapfree_tpu.models.aggregators as jax_agg
from mapfree_tpu.train import init_state as jax_init_state
from mapfree_tpu.train.state import _forward_loss as jax_forward_loss

import mapfree_tpu_torch.models.aggregators as pt_agg
from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.encoders import encoder_out_hw
from mapfree_tpu_torch.train.state import _forward_loss as pt_forward_loss

from torch_configs import (flat, jax_build_net, jax_default_cfg, load_jax_variables,
                           pt_build_net, small_cfg, to_jax_variables)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL_YAML = "configs/regression/mapfree/3d3d.yaml"
PHASE_6 = {"TPU.COMPUTE_DTYPE": "bfloat16", "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3,
           "TRAINING.GRAD_CLIP": 1.0}
MOVE = 1e-5
# the two packages' moves of the gradient agree within this factor
FACTOR = 4.0
# and each is at least this share of the gradient: the amplification is there
AMPLIFIED = 1e-2


def _batch(cfg, B, seed):
    """Float images in [0, 1) (the same bf16 values in both packages; uint8
    would be scaled in bf16 by the JAX package and in float32 by the port)
    and random relative poses."""
    from mapfree_tpu.geom import quat2mat

    rng = np.random.default_rng(seed)
    H, W = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = np.asarray(quat2mat(q))
    T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.1
    return {"image0": rng.random((B, H, W, 3)).astype(np.float32),
            "image1": rng.random((B, H, W, 3)).astype(np.float32), "T_0to1": T}


class _MovedConcat:
    """Stands for the aggregator module's ``jnp`` or ``torch``: its last
    concatenation (the aggregated float32 volume [B, HW, C']) comes out
    scaled by 1 + ``move``, where ``move`` is set; every other name is the
    library's own."""

    def __init__(self, lib, cat_name):
        self._lib, self._cat_name, self.move = lib, cat_name, None

    def __getattr__(self, name):
        if name != self._cat_name:
            return getattr(self._lib, name)

        def cat(parts, *args, **kwargs):
            out = getattr(self._lib, self._cat_name)(parts, *args, **kwargs)
            if self.move is not None and tuple(out.shape) == tuple(self.move.shape):
                out = out * (1 + self.move)
            return out

        return cat


def _move_pattern(shape, channels, seed=3):
    """1e-5 r on the correlation channels (after the view-0 features' first
    ``channels``), 0 on the features."""
    move = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * MOVE
    move[..., :channels] = 0.0
    return move


def _jax_grads(jnet, jcfg, jstate, batch, proxy, move):
    """The bf16 step's gradients (before clipping) with the aggregated
    volume moved by ``move`` (zeros: not moved), one compile for both."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def grads(params, move):
        proxy.move = move

        def loss(p):
            return jax_forward_loss(jnet, jcfg, p, jstate.batch_stats, jbatch, True)[0]

        return jax.grad(loss)(params)

    try:
        return [flat(jax.tree.map(lambda g: np.asarray(g, np.float32), grads(jstate.params, m)))
                for m in (np.zeros_like(move), move)]
    finally:
        proxy.move = None


def _port_grads(net, pcfg, batch, proxy, move):
    out = []
    for m in (np.zeros_like(move), move):
        proxy.move = torch.from_numpy(m)
        net.zero_grad(set_to_none=True)
        net.train()
        loss, _ = pt_forward_loss(net, pcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        out.append(flat(to_jax_variables(net, grads=True)["params"]))
    proxy.move = None
    return out


def _moves(base, moved):
    """The relative L2 move of the whole gradient, and of each tensor."""
    diff = np.sqrt(sum(float(((moved[k] - g).astype(np.float64) ** 2).sum())
                       for k, g in base.items()))
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in base.values()))
    per = {k: float(np.linalg.norm(moved[k] - g) / max(np.linalg.norm(g), 1e-30))
           for k, g in base.items()}
    return diff / norm, per


def test_bf16_gradient_moves_alike_in_both_packages(monkeypatch, capsys):
    jcfg = small_cfg(jax_default_cfg, MODEL_YAML, **PHASE_6)
    pcfg = small_cfg(pt_default_cfg, MODEL_YAML, **PHASE_6)
    batch = _batch(pcfg, 4, seed=21)
    jnet = jax_build_net(jcfg)
    jstate = jax_init_state(jnet, jcfg, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    net = pt_build_net(pcfg)
    load_jax_variables(net, {c: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
                             for c, t in (("params", jstate.params),
                                          ("batch_stats", jstate.batch_stats))})
    C = pcfg.ENCODER.NUM_OUT_LAYERS
    h, w = encoder_out_hw(pcfg.ENCODER, pcfg.DATASET.HEIGHT, pcfg.DATASET.WIDTH)
    move = _move_pattern((4, h * w, 2 * C + 3), C)

    jproxy = _MovedConcat(jnp, "concatenate")
    monkeypatch.setattr(jax_agg, "jnp", jproxy)
    jbase, jmoved = _jax_grads(jnet, jcfg, jstate, batch, jproxy, move)
    pproxy = _MovedConcat(torch, "cat")
    monkeypatch.setattr(pt_agg, "torch", pproxy)
    pbase, pmoved = _port_grads(net, pcfg, batch, pproxy, move)

    assert set(jbase) == set(pbase)
    j_whole, j_per = _moves(jbase, jmoved)
    p_whole, p_per = _moves(pbase, pmoved)
    names = [k for k in jbase if np.linalg.norm(jbase[k]) > 1e-6]  # not the zero biases
    j_median = float(np.median([j_per[k] for k in names]))
    p_median = float(np.median([p_per[k] for k in names]))
    # layer by layer, from the loss back: the median move of each layer's
    # tensors in each package
    layers = {}
    for k in names:
        layers.setdefault("/".join(k.split("/")[:-2]), []).append(k)
    rows = [(layer, float(np.median([j_per[k] for k in ks])),
             float(np.median([p_per[k] for k in ks]))) for layer, ks in layers.items()]
    rows.sort(key=lambda r: (not r[0].startswith("head"), not r[0].startswith("aggregator"),
                             r[0]), reverse=False)
    with capsys.disabled():
        print(f"\nbf16 step, aggregated volume moved by {MOVE:g}: whole gradient moved "
              f"{j_whole:.3g} (JAX) and {p_whole:.3g} (port); median tensor {j_median:.3g} "
              f"and {p_median:.3g}")
        for layer, j, p in rows:
            print(f"  {layer:40s} JAX {j:.3g}  port {p:.3g}")
    for whole in (j_whole, p_whole, j_median, p_median):
        assert whole > AMPLIFIED
    assert 1 / FACTOR < p_whole / j_whole < FACTOR
    assert 1 / FACTOR < p_median / j_median < FACTOR
    for layer, j, p in rows:  # the two part at no layer
        assert 1 / FACTOR < p / j < FACTOR, layer
