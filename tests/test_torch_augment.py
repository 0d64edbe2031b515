"""PyTorch port: on-device augmentation against the JAX package. The two
frameworks draw different numbers from the same seed, so the port is fed
the factors the JAX package drew; its own draws are checked for range,
per-image variety and repeatability."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapfree_tpu.data import augment as jax_aug
from mapfree_tpu.ops.image import yuv420_pack_host

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.data import augment as pt_aug

from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _jax_factors(key, lead, strengths=(0.4, 0.4, 0.4)):
    """The factors device_color_jitter draws from ``key``."""
    keys = jax.random.split(key, 3)
    return [np.array(jax.random.uniform(
        k, tuple(lead) + (1, 1, 1), minval=max(0.0, 1.0 - s), maxval=1.0 + s))
        for k, s in zip(keys, strengths)]


def _images(kind, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (3, 16, 12, 3), dtype=np.uint8)
    if kind == "uint8_nhwc":
        return rgb
    if kind == "float_nhwc":
        return (rgb / 255.0).astype(np.float32)
    if kind == "multiframe":
        return rng.integers(0, 256, (2, 3, 16, 12, 3), dtype=np.uint8)
    return yuv420_pack_host((rgb / 255.0).astype(np.float32))  # planar [3, 24, 12]


@pytest.mark.parametrize("kind", ["uint8_nhwc", "float_nhwc", "yuv420", "multiframe"])
def test_color_jitter_with_jax_factors_matches_jax(kind):
    """atol 2e-6: the same float32 arithmetic, means summed in another order."""
    img = _images(kind)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax_aug.device_color_jitter(key, jnp.asarray(img)))
    lead = img.shape[:-3] if img.shape[-1] == 3 else img.shape[:-2]
    factors = [torch.from_numpy(f) for f in _jax_factors(key, lead)]
    out = pt_aug.apply_color_jitter(torch.from_numpy(img), factors)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6)
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


@pytest.mark.parametrize("kind", ["uint8_nhwc", "yuv420"])
def test_grayscale_matches_jax(kind):
    img = _images(kind, seed=1)
    ref = np.asarray(jax_aug.device_grayscale(jnp.asarray(img)))
    out = pt_aug.device_grayscale(torch.from_numpy(img))
    assert out.shape == ref.shape and out.shape[-1] == 3
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_drawn_factors_lie_in_range_differ_per_image_and_repeat():
    gen = pt_aug.augment_generator(seed=3, step=5, device="cpu")
    fb, fc, fs = pt_aug.draw_jitter_factors(gen, (64,), "cpu", 0.4, 0.2, 1.5)
    for f, (lo, hi) in zip((fb, fc, fs), ((0.6, 1.4), (0.8, 1.2), (0.0, 2.5))):
        assert f.shape == (64, 1, 1, 1)
        assert lo <= float(f.min()) and float(f.max()) < hi
        assert len(np.unique(f.numpy())) > 60  # one draw per image
    again = pt_aug.draw_jitter_factors(
        pt_aug.augment_generator(seed=3, step=5, device="cpu"), (64,), "cpu", 0.4, 0.2, 1.5)
    assert all(torch.equal(a, b) for a, b in zip((fb, fc, fs), again))
    other_step = pt_aug.draw_jitter_factors(
        pt_aug.augment_generator(seed=3, step=6, device="cpu"), (64,), "cpu", 0.4, 0.2, 1.5)
    other_seed = pt_aug.draw_jitter_factors(
        pt_aug.augment_generator(seed=4, step=5, device="cpu"), (64,), "cpu", 0.4, 0.2, 1.5)
    assert not torch.equal(fb, other_step[0]) and not torch.equal(fb, other_seed[0])


def _aug_cfg(**kw):
    c = pt_default_cfg.clone()
    c.DATASET.AUGMENTATION_TYPE = kw.get("aug")
    c.DATASET.BLACK_WHITE = kw.get("bw", False)
    c.TPU.DEVICE_AUGMENT = kw.get("device", True)
    return c


def test_make_device_augment_follows_the_config():
    assert pt_aug.make_device_augment(_aug_cfg()) is None  # 3d3d: nothing requested
    assert pt_aug.make_device_augment(_aug_cfg(aug="colorjitter", device=False)) is None
    batch = {"image0": torch.from_numpy(_images("uint8_nhwc")),
             "image1": torch.from_numpy(_images("yuv420", seed=2)),
             "T_0to1": torch.eye(4).expand(3, 4, 4)}

    jitter = pt_aug.make_device_augment(_aug_cfg(aug="colorjitter"))
    out = jitter(pt_aug.augment_generator(0, 0, "cpu"), batch)
    assert out["T_0to1"] is batch["T_0to1"] and batch["image0"].dtype == torch.uint8
    for key in ("image0", "image1"):
        assert out[key].shape == (3, 16, 12, 3) and out[key].dtype == torch.float32
    same = jitter(pt_aug.augment_generator(0, 0, "cpu"), batch)
    assert torch.equal(out["image0"], same["image0"])
    # the two views draw their own factors
    both = jitter(pt_aug.augment_generator(0, 0, "cpu"),
                  {"image0": batch["image0"], "image1": batch["image0"]})
    assert not torch.equal(both["image0"], both["image1"])

    gray = pt_aug.make_device_augment(_aug_cfg(bw=True))(None, batch)
    assert torch.equal(gray["image0"][..., 0], gray["image0"][..., 2])
