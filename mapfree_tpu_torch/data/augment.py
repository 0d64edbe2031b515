"""On-device training augmentation over uint8 batches (port of
mapfree_tpu/data/augment.py).

The reference augments on the host inside torchvision transforms (reference
lib/datasets/datamodules.py:33-40: ColorJitter(0.4, 0.4, 0.4) or
Grayscale(num_output_channels=3)). Here the loader always ships uint8 (NHWC,
or planar YUV420) and the jitter runs on the device in the train step, so
augmented training pays the same host-to-device bytes as evaluation.

Drawing the random factors (:func:`draw_jitter_factors`) is apart from
applying them (:func:`apply_color_jitter`), so that two implementations can
be fed the same factors. The factors come from a ``torch.Generator`` on the
batch's device, seeded from (``TPU.SEED``, step): a resumed run repeats them.
"""

from __future__ import annotations

import torch

from mapfree_tpu_torch.ops.image import yuv420_to_rgb

_LUMA = (0.299, 0.587, 0.114)


def _luma(image):
    return image @ torch.tensor(_LUMA, dtype=image.dtype, device=image.device)


def _to_float01(image):
    if image.shape[-1] != 3:
        # packed planar YUV420 uint8 [..., H*3/2, W]: unpack on the device first
        return yuv420_to_rgb(image)
    if image.dtype == torch.uint8:
        return image.float() / 255.0
    return image.float()


def device_grayscale(image):
    """[..., H, W, 3] -> float32 [0, 1] grayscale kept as 3 channels."""
    gray = _luma(_to_float01(image))
    return gray[..., None].expand(*gray.shape, 3).contiguous()


def draw_jitter_factors(generator, lead, device, brightness=0.4, contrast=0.4,
                        saturation=0.4):
    """One (brightness, contrast, saturation) factor triple per image:
    three tensors of shape ``lead + (1, 1, 1)``, each uniform in
    [max(0, 1 - strength), 1 + strength)."""
    shape = tuple(lead) + (1, 1, 1)
    out = []
    for strength in (brightness, contrast, saturation):
        lo, hi = max(0.0, 1.0 - strength), 1.0 + strength
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        out.append(lo + (hi - lo) * u)
    return tuple(out)


def apply_color_jitter(image, factors):
    """Brightness scale, then contrast about the per-image mean, then
    saturation about per-pixel luma, clipped to [0, 1]. ``image`` is
    [..., H, W, 3] uint8 or float01, or planar YUV420 uint8; every leading
    axis is batch."""
    fb, fc, fs = factors
    image = _to_float01(image)
    out = image * fb
    mean = out.mean(dim=(-1, -2, -3), keepdim=True)
    out = (out - mean) * fc + mean
    gray = _luma(out)[..., None]
    out = (out - gray) * fs + gray
    return torch.clamp(out, 0.0, 1.0)


def _lead_shape(image):
    return image.shape[:-3] if image.shape[-1] == 3 else image.shape[:-2]


def device_color_jitter(generator, image, brightness=0.4, contrast=0.4,
                        saturation=0.4, rows=None):
    """Random brightness/contrast/saturation, one factor triple PER IMAGE.
    With ``rows`` = (start, stop, n) ``image`` is rows [start, stop) of a
    batch of n: the factors are drawn for all n and this block's are taken,
    so that a block's augmentation does not depend on how the batch is
    split."""
    lead = _lead_shape(image)
    if rows is not None:
        start, stop, n = rows
        lead = (n,) + tuple(lead[1:])
    factors = draw_jitter_factors(generator, lead, image.device,
                                  brightness, contrast, saturation)
    if rows is not None:
        factors = tuple(f[start:stop] for f in factors)
    return apply_color_jitter(image, factors)


def augment_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step's augmentation: a function of
    (seed, step) only."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (1 << 63))
    return gen


def make_device_augment(cfg):
    """Augment callable ``fn(generator, batch_dict, rows=None) ->
    batch_dict`` for the train step, or None when the config needs no
    on-device augmentation (``TPU.DEVICE_AUGMENT`` off, or no augmentation
    requested). ``rows`` as :func:`device_color_jitter` takes it: the batch
    is one block of a larger one."""
    if not bool(cfg.TPU.DEVICE_AUGMENT):
        return None
    black_white = bool(cfg.DATASET.BLACK_WHITE)
    jitter = cfg.DATASET.AUGMENTATION_TYPE == "colorjitter"
    if not (black_white or jitter):
        return None

    def augment(generator, batch, rows=None):
        batch = dict(batch)
        for key in ("image0", "image1"):
            batch[key] = (device_grayscale(batch[key]) if black_white
                          else device_color_jitter(generator, batch[key], rows=rows))
        return batch

    return augment
