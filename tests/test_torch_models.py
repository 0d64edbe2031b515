"""PyTorch port, module level: blocks, ResUNet, the correlation aggregator
(fused and dense routes), the Procrustes head and the whole RegressionNet,
each holding JAX-initialised weights carried over by
``mapfree_tpu_torch.tools.convert_weights.load_jax_variables``.

Everything runs in float32 on the CPU, on a narrow configuration
(BLOCK_TYPE 1, 1-1-1 blocks, 8 output channels, 64x48 images). Tolerance
1e-4: the two frameworks sum convolutions and softmaxes in different orders.
The JAX aggregator's fused route runs the Pallas kernel under the
interpreter (``INTERPRET_FALLBACK``), as tests/test_correlation.py does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mapfree_tpu.ops.correlation as jax_corr
from mapfree_tpu.config import cfg as jax_default_cfg
from mapfree_tpu.models import aggregators as jax_agg
from mapfree_tpu.models import blocks as jax_blocks
from mapfree_tpu.models import encoders as jax_enc
from mapfree_tpu.models import heads as jax_heads
from mapfree_tpu.models.regression import build_regression_net as jax_build_net
from mapfree_tpu.ops.image import yuv420_pack_host

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models import aggregators as pt_agg
from mapfree_tpu_torch.models import blocks as pt_blocks
from mapfree_tpu_torch.models import encoders as pt_enc
from mapfree_tpu_torch.models import heads as pt_heads
from mapfree_tpu_torch.models.builder import build_model as pt_build_model
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4


def _randomize(variables, seed):
    """JAX init, with BatchNorm statistics, scales and biases drawn at
    random (init leaves them at identity/zero, which would hide a mapping
    error)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for key, value in tree.items():
            if hasattr(value, "items"):
                out[key] = walk(value)
                continue
            a = np.asarray(value, np.float32)
            if key == "var":
                a = rng.uniform(0.5, 2.0, a.shape)
            elif key == "mean":
                a = rng.normal(0.0, 0.1, a.shape)
            elif key == "scale":
                a = rng.uniform(0.5, 1.5, a.shape)
            elif key == "bias":
                a = rng.normal(0.0, 0.1, a.shape)
            out[key] = a.astype(np.float32)
        return out

    return {c: walk(t) for c, t in variables.items()}


def _jax_init(module, *args, seed=0, jit=False):
    init = lambda key, *a: module.init(key, *a, False)  # noqa: E731
    init = jax.jit(init) if jit else init
    return _randomize(init(jax.random.PRNGKey(seed), *args), seed)


def _jax_apply(module, *inputs, seed=0, jit=False):
    """``jit`` compiles the whole module once, which is quicker than eager
    op-by-op dispatch for the large ones and slower for the small ones."""
    args = [jnp.asarray(x) for x in inputs]
    variables = _jax_init(module, *args, seed=seed, jit=jit)
    apply = lambda v, *a: module.apply(v, *a, False)  # noqa: E731
    out = (jax.jit(apply) if jit else apply)(variables, *args)
    return variables, out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


BLOCK_CASES = {
    "preact_stride2": (lambda: jax_blocks.PreActBlock(16, stride=2),
                       lambda: pt_blocks.PreActBlock(8, 16, 2), 8),
    "preact_identity": (lambda: jax_blocks.PreActBlock(8),
                        lambda: pt_blocks.PreActBlock(8, 8, 1), 8),
    "preact_no_bn": (lambda: jax_blocks.PreActBlock(16, stride=2, bn=False),
                     lambda: pt_blocks.PreActBlock(8, 16, 2, bn=False), 8),
    "bottleneck_stride2": (lambda: jax_blocks.PreActBottleneck(4, stride=2),
                           lambda: pt_blocks.PreActBottleneck(8, 4, 2), 8),
    "bottleneck_identity": (lambda: jax_blocks.PreActBottleneck(4),
                            lambda: pt_blocks.PreActBottleneck(16, 4, 1), 16),
    "conv_bn_elu": (lambda: jax_blocks.ConvBnElu(12, 3),
                    lambda: pt_blocks.ConvBnElu(8, 12, 3), 8),
    "upconv": (lambda: jax_blocks.UpConv(12),
               lambda: pt_blocks.UpConv(8, 12), 8),
}


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_block_parity(name):
    make_jax, make_pt, cin = BLOCK_CASES[name]
    x = np.random.default_rng(1).normal(size=(2, 9, 11, cin)).astype(np.float32)
    variables, ref = _jax_apply(make_jax(), x)
    block = make_pt().eval()
    load_jax_variables(block, variables)
    with torch.no_grad():
        out = _nhwc(block(_nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("hw", [(64, 48), (72, 54)])
def test_resunet_parity(hw):
    """(72, 54) makes both decoder skips one row/column short of the
    upsampled map, so _skip_concat pads them; (64, 48) needs no pad."""
    x = np.random.default_rng(2).random((2,) + hw + (3,)).astype(np.float32)
    variables, ref = _jax_apply(jax_enc.ResUNet(1, [1, 1, 1], num_out_layers=8), x,
                                jit=True)
    enc = pt_enc.ResUNet(1, [1, 1, 1], num_out_layers=8).eval()
    load_jax_variables(enc, variables)
    with torch.no_grad():
        out = enc(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    cfg = pt_default_cfg.clone()
    cfg.ENCODER.TYPE = "ResUNet"
    assert pt_enc.encoder_out_hw(cfg.ENCODER, *hw) == tuple(ref.shape[1:3])
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


AGG_CASES = {
    "fused_3d3d": dict(position_encoder=True, max_score_channel=True),
    "dense_3d3d": dict(position_encoder=True, max_score_channel=True, fused=False),
    "fused_half_channels_im1_upsample": dict(
        position_encoder=True, position_encoder_im1=True, upsample_pos_enc=4,
        max_score_channel=True, cv_half_channels=True),
    "fused_normalise_dot": dict(position_encoder=True, normalise_dot=True),
    "dense_dustbin": dict(position_encoder=True, max_score_channel=True, dustbin=True),
    "dense_cv_outlayers": dict(position_encoder=True, cv_outlayers=4),
}


@pytest.mark.parametrize("name", list(AGG_CASES))
def test_aggregator_parity(name, monkeypatch):
    monkeypatch.setattr(jax_corr, "INTERPRET_FALLBACK", True)
    kw = AGG_CASES[name]
    rng = np.random.default_rng(3)
    B, H, W, C = 2, 6, 5, 8
    vol0, vol1 = (rng.normal(size=(B, H, W, C)).astype(np.float32) for _ in range(2))
    jmod = jax_agg.CorrelationVolumeWarping(**kw)
    variables, ref = _jax_apply(jmod, vol0, vol1)
    agg = pt_agg.CorrelationVolumeWarping(**kw, hw=H * W).eval()
    assert agg._can_fuse() == (kw.get("fused", True) and jmod._can_fuse())
    if variables:
        load_jax_variables(agg, variables)
    with torch.no_grad():
        out = agg(torch.from_numpy(vol0), torch.from_numpy(vol1)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


HEAD_CASES = {
    "deep_avgpool_basis": dict(deep=True, avg_pool=True, add_basis=True),
    "deep_ravel_12pts": dict(deep=True, avg_pool=False, num_pts=12),
    "deep_no_bn": dict(deep=True, avg_pool=True, batch_norm=False, add_basis=True),
    "shallow_3pts_basis": dict(deep=False, num_pts=3, add_basis=True),
}


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_procrustes_head_parity(name):
    kw = HEAD_CASES[name]
    x = np.random.default_rng(4).normal(size=(2, 12, 10, 19)).astype(np.float32)
    variables, (R_ref, t_ref, _) = _jax_apply(jax_heads.ProcrustesHead(**kw), x)
    head = pt_heads.ProcrustesHead(19, (12, 10), **kw).eval()
    load_jax_variables(head, variables)
    with torch.no_grad():
        R, t, _ = head(torch.from_numpy(x))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=ATOL)


def narrow_cfg(default):
    c = default.clone()
    c.MODEL = "Regression"
    c.ENCODER.TYPE = "ResUNet"
    c.ENCODER.BLOCK_TYPE = 1
    c.ENCODER.NUM_BLOCKS = "1-1-1"
    c.ENCODER.NUM_OUT_LAYERS = 8
    c.AGGREGATOR.TYPE = "CorrelationVolumeWarping"
    c.AGGREGATOR.POSITION_ENCODER = True
    c.AGGREGATOR.MAX_SCORE_CHANNEL = True
    c.HEAD.TYPE = "ProcrustesDeepResBlock"
    c.HEAD.ADD_BASIS = True
    c.HEAD.AVG_POOL = True
    c.DATASET.HEIGHT, c.DATASET.WIDTH = 64, 48
    c.TPU.COMPUTE_DTYPE = "float32"
    return c


def _jax_net_variables(net, seed=0):
    img = jnp.zeros((1, 64, 48, 3), jnp.float32)
    return _jax_init(net, img, img, seed=seed, jit=True)


def test_regression_net_parity_yuv_unique_refs(monkeypatch):
    """The whole network on planar YUV420 input with two unique refs
    gathered by ref_idx after the encoder."""
    monkeypatch.setattr(jax_corr, "INTERPRET_FALLBACK", True)
    jnet = jax_build_net(narrow_cfg(jax_default_cfg))
    variables = _jax_net_variables(jnet)
    rng = np.random.default_rng(5)
    refs = yuv420_pack_host(rng.random((2, 64, 48, 3)).astype(np.float32))
    queries = yuv420_pack_host(rng.random((3, 64, 48, 3)).astype(np.float32))
    ref_idx = np.array([0, 1, 1], np.int32)
    apply = jax.jit(lambda v, a, b, r: jnet.apply(v, a, b, train=False, ref_idx=r))
    R_ref, t_ref, _ = apply(variables, jnp.asarray(refs), jnp.asarray(queries),
                            jnp.asarray(ref_idx))

    net = pt_build_net(narrow_cfg(pt_default_cfg)).eval()
    load_jax_variables(net, variables)
    with torch.no_grad():
        R, t, _ = net(torch.from_numpy(refs), torch.from_numpy(queries),
                      ref_idx=torch.from_numpy(ref_idx))
    assert R.shape == (3, 3, 3) and t.shape == (3, 1, 3)
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=ATOL)


def test_load_jax_variables_rejects_missing_extra_and_misshapen_leaves():
    jnet = jax_build_net(narrow_cfg(jax_default_cfg))
    variables = _jax_net_variables(jnet)
    net = pt_build_net(narrow_cfg(pt_default_cfg))
    load_jax_variables(net, variables)  # the complete tree loads

    missing = _randomize(variables, 0)
    del missing["params"]["encoder"]["firstconv"]
    with pytest.raises(KeyError, match="encoder.firstconv.weight"):
        load_jax_variables(net, missing)

    extra = _randomize(variables, 0)
    extra["params"]["head"]["unknown"] = {"kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(KeyError, match="head.unknown.weight"):
        load_jax_variables(net, extra)

    misshapen = _randomize(variables, 0)
    k = misshapen["params"]["encoder"]["outconv"]["conv"]["kernel"]
    misshapen["params"]["encoder"]["outconv"]["conv"]["kernel"] = k[..., :-1]
    with pytest.raises(ValueError, match="encoder.outconv.conv.weight"):
        load_jax_variables(net, misshapen)


def test_unported_variants_raise():
    """Names no module knows raise (every regression model, head and
    aggregator builds: tests/test_torch_variants*.py; the matching track
    with every correspondence source too, SIFT included:
    tests/test_torch_matching*.py, test_torch_sift_matching.py); a matching
    config is no regression net."""
    cfg = narrow_cfg(pt_default_cfg)
    cfg.MODEL, cfg.FEATURE_MATCHING, cfg.POSE_SOLVER = "FeatureMatching", "SIFT_TPU", "PNP"
    cfg.SIFT.NUM_FEATURES, cfg.SIFT.RATIO_THRESHOLD = 64, 0.8
    assert pt_build_model(cfg, device="cpu").model.feature_matching.on_device
    cfg.FEATURE_MATCHING = "NoSuchSource"
    with pytest.raises(NotImplementedError, match="Invalid feature matching"):
        pt_build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Invalid regression model"):
        pt_build_net(cfg)
    cfg.MODEL = "NoSuchModel"
    with pytest.raises(NotImplementedError, match="Invalid model"):
        pt_build_model(cfg, device="cpu")
    for node, key in (("HEAD", "TYPE"), ("AGGREGATOR", "TYPE"), ("ENCODER", "TYPE")):
        cfg = narrow_cfg(pt_default_cfg)
        cfg[node][key] = "NoSuchModule"
        with pytest.raises(NotImplementedError, match="Invalid"):
            pt_build_net(cfg)
