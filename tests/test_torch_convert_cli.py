"""PyTorch port, the weight converter's CLI
(``python -m mapfree_tpu_torch.tools.convert_weights``, its ``main(argv)``)
against the JAX package's ``convert_state_dict`` on the CPU, float32.

A synthetic reference state dict covering every tensor of the 3d3d net (one
block per stage, 8 output channels; tests/test_convert_weights.py's
``synthetic_torch_state``) is saved as a Lightning checkpoint (``model.``
prefix, optimizer state, loop counters). The port's CLI turns it into a
``.pt`` that ``build_model`` loads; the JAX package converts the same
tensors into flax variables. On the same images the two give the same poses
within 1e-4 (the frameworks sum convolutions in other orders). A missing
tensor raises and names it; so does a shape mismatch.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mapfree_tpu.config import cfg as jax_default_cfg
from mapfree_tpu.models import build_regression_net as jax_build_net
from mapfree_tpu.tools.convert_weights import convert_state_dict
from test_convert_weights import synthetic_torch_state

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.tools.convert_weights import main as convert_main

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
H, W = 48, 36
SMALL = {"ENCODER": {"NUM_BLOCKS": "1-1-1", "NUM_OUT_LAYERS": 8},
         "DATASET": {"HEIGHT": H, "WIDTH": W},
         "TPU": {"COMPUTE_DTYPE": "float32", "INFER_BATCH": 3}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config files, the JAX net and its variables, and the synthetic
    reference state dict."""
    root = tmp_path_factory.mktemp("convert")
    model_cfg = yaml.safe_load((REPO / "configs/regression/mapfree/3d3d.yaml").read_text())
    for node, values in SMALL.items():
        model_cfg.setdefault(node, {}).update(values)
    model = root / "model.yaml"
    model.write_text(yaml.safe_dump(model_cfg))
    dataset = REPO / "configs/mapfree.yaml"

    jcfg = jax_default_cfg.clone()
    jcfg.merge_from_file(str(dataset))
    jcfg.merge_from_file(str(model))
    jcfg.TPU.FUSED_CORRELATION = False  # the same function, without Pallas
    jnet = jax_build_net(jcfg)
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = dict(jax.jit(jnet.init, static_argnums=(3,))(
        jax.random.PRNGKey(0), img, img, False))
    state = synthetic_torch_state(variables)
    return root, model, dataset, jnet, variables, state


def write_lightning(path, state):
    """A Lightning-style checkpoint: the model's tensors under ``model.``,
    an optimizer state and the loop counters beside them."""
    keys = sorted(state)
    torch.save({
        "epoch": 3, "global_step": 120, "pytorch-lightning_version": "1.6.0",
        "state_dict": {f"model.{k}": v for k, v in state.items()},
        "optimizer_states": [{
            "state": {i: {"step": torch.tensor(120.0), "exp_avg": torch.zeros_like(state[k]),
                          "exp_avg_sq": torch.zeros_like(state[k])}
                      for i, k in enumerate(keys) if state[k].is_floating_point()},
            "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999), "eps": 1e-6,
                              "params": list(range(len(keys)))}]}],
        "lr_schedulers": [{"step_size": 200000, "gamma": 0.5}],
    }, path)


def _argv(setup, ckpt, out):
    _, model, dataset, *_ = setup
    return [str(ckpt), str(out), "--config", str(model), "--dataset_config", str(dataset),
            "--device", "cpu"]


def test_cli_output_gives_the_jax_conversions_poses(setup, tmp_path):
    root, model, dataset, jnet, variables, state = setup
    ckpt = tmp_path / "ref.ckpt"
    write_lightning(ckpt, state)
    out = convert_main(_argv(setup, ckpt, tmp_path / "converted.pt"))

    saved = torch.load(out, map_location="cpu")
    assert not any(k.startswith("model.") for k in saved)
    assert all(isinstance(v, torch.Tensor) for v in saved.values())
    assert set(saved) >= set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(saved[k].numpy(), v.numpy())

    rng = np.random.default_rng(0)
    image0 = rng.integers(0, 256, (3, H, W, 3)).astype(np.uint8)
    image1 = rng.integers(0, 256, (3, H, W, 3)).astype(np.uint8)
    converted = convert_state_dict({k: v.numpy() for k, v in state.items()}, variables)
    R_want, t_want, _ = jax.jit(jnet.apply, static_argnums=(3,))(
        converted, jnp.asarray(image0, jnp.float32) / 255.0,
        jnp.asarray(image1, jnp.float32) / 255.0, False)

    pcfg = pt_default_cfg.clone()
    pcfg.merge_from_file(str(dataset))
    pcfg.merge_from_file(str(model))
    R, t, _ = build_model(pcfg, str(out), device="cpu").predict_batch(
        {"image0": image0, "image1": image1})
    np.testing.assert_allclose(R, np.asarray(R_want), atol=TOL)
    np.testing.assert_allclose(t.reshape(3, 3), np.asarray(t_want).reshape(3, 3),
                               atol=TOL * max(1.0, np.abs(t_want).max()))


def test_cli_raises_on_a_missing_tensor_and_names_it(setup, tmp_path):
    *_, state = setup
    partial = dict(state)
    partial.pop("encoder.firstconv.weight")
    write_lightning(tmp_path / "partial.ckpt", partial)
    with pytest.raises(KeyError, match="encoder.firstconv.weight"):
        convert_main(_argv(setup, tmp_path / "partial.ckpt", tmp_path / "p.pt"))
    assert not (tmp_path / "p.pt").exists()


def test_cli_raises_on_a_shape_mismatch(setup, tmp_path):
    *_, state = setup
    bad = dict(state)
    bad["head.mlp.0.weight"] = bad["head.mlp.0.weight"][:, :-1]
    write_lightning(tmp_path / "bad.ckpt", bad)
    with pytest.raises(ValueError, match="head.mlp.0.weight"):
        convert_main(_argv(setup, tmp_path / "bad.ckpt", tmp_path / "b.pt"))
