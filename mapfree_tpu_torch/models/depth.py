"""In-graph monocular depth for the matching track (port of
mapfree_tpu/models/depth.py).

``MonoDepthNet``: a ResUNet-style dense predictor on the RPR track's blocks
(stem -> three pre-activation stages to H/16 -> skip-concat decoder back to
full resolution -> 1x1 head), metric depth = MAX_DEPTH * sigmoid(logit),
resized to the input size where the /16 round trip changes it (bilinear with
the JAX package's ``jax.image.resize`` weights, antialiased when shrinking).

``DepthPredictor`` runs it for :class:`~mapfree_tpu_torch.models.matching.
FeatureMatchingModel`: ``point_depths`` gives the depth at the keypoints on
the device, so the solver gets [B, N] depths as from files. Weights come from
``DEPTH_NET.CHECKPOINT``, a ``.pt`` state dict (``tools/convert_weights.py``
writes one from the JAX package's variables); an empty checkpoint raises
unless ``DEPTH_NET.ALLOW_RANDOM`` is set.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch
from torch import nn

from mapfree_tpu_torch.models.blocks import ConvBnElu, PreActBlock, UpConv, init_weights
from mapfree_tpu_torch.models.builder import tf32_off
from mapfree_tpu_torch.models.encoders import _skip_concat, _Stage, parse_num_blocks
from mapfree_tpu_torch.ops.essential import gather_depth
from mapfree_tpu_torch.tools.convert_weights import load_checkpoint


@lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] float32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis: the triangle kernel at half-pixel sample positions,
    widened by in/out when shrinking (antialias), normalised per output."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(f32)


@lru_cache(maxsize=16)
def _resize_tensor(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """:func:`resize_weights` on ``device``, made once per key (a copy from
    pageable memory on every call would make the host wait for the device)."""
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


def resize_bilinear(depth, out_hw):
    """Resize [B, H, W] float32 maps as ``jax.image.resize`` bilinear does."""
    H, W = depth.shape[-2:]
    if (H, W) == tuple(out_hw):
        return depth
    mh = _resize_tensor(H, out_hw[0], depth.device)
    mw = _resize_tensor(W, out_hw[1], depth.device)
    return mh @ depth @ mw.T


class MonoDepthNet(nn.Module):
    """Dense depth [B, H, W] from images [B, H, W, 3] (uint8, or float in [0, 1])."""

    def __init__(self, num_blocks=(2, 2, 2), max_depth: float = 20.0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.max_depth = float(max_depth)
        self.compute_dtype = compute_dtype
        self.stem = ConvBnElu(3, 32, 7, 2)                       # H/2
        self.stage1 = _Stage(PreActBlock, 32, 64, num_blocks[0], 2)    # H/4
        self.stage2 = _Stage(PreActBlock, 64, 128, num_blocks[1], 2)   # H/8
        self.stage3 = _Stage(PreActBlock, 128, 256, num_blocks[2], 2)  # H/16
        self.up3 = UpConv(256, 128, 3, 2)
        self.i3 = ConvBnElu(256, 128, 3, 1)
        self.up2 = UpConv(128, 64, 3, 2)
        self.i2 = ConvBnElu(128, 64, 3, 1)
        self.up1 = UpConv(64, 32, 3, 2)
        self.i1 = ConvBnElu(64, 32, 3, 1)
        self.up0 = UpConv(32, 16, 3, 2)
        self.head = nn.Conv2d(16, 1, 1)

    def forward(self, images):
        B, H, W = images.shape[:3]
        scale = 1.0 / 255.0 if images.dtype == torch.uint8 else 1.0
        x = (images.to(self.compute_dtype) * scale).permute(0, 3, 1, 2)
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=bf16):
            x1 = self.stem(x)
            x2 = self.stage1(x1)
            x3 = self.stage2(x2)
            x4 = self.stage3(x3)
            y = self.i3(_skip_concat(self.up3(x4), x3))
            y = self.i2(_skip_concat(self.up2(y), x2))
            y = self.i1(_skip_concat(self.up1(y), x1))
            y = self.up0(y)
        with torch.autocast(images.device.type, enabled=False):
            logit = self.head(y.float())[:, 0]
            depth = self.max_depth * torch.sigmoid(logit)
            return resize_bilinear(depth, (H, W))


ORBAX_HELP = (
    "DEPTH_NET.CHECKPOINT {path} is a directory (an orbax checkpoint of the JAX "
    "package?): the port reads a .pt state dict. Restore the variables with the "
    "JAX package and write one with mapfree_tpu_torch.tools.convert_weights."
    "save_jax_variables(MonoDepthNet(...), variables, 'depth.pt').")


class DepthPredictor:
    """Batched depth inference on ``device`` for the matching pipeline."""

    def __init__(self, cfg, device):
        dcfg = cfg.DEPTH_NET
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
        self.net = MonoDepthNet(parse_num_blocks(str(dcfg.NUM_BLOCKS)),
                                float(dcfg.MAX_DEPTH), dtype)
        if dcfg.CHECKPOINT:
            if Path(dcfg.CHECKPOINT).is_dir():
                raise ValueError(ORBAX_HELP.format(path=dcfg.CHECKPOINT))
            load_checkpoint(self.net, dcfg.CHECKPOINT)
        elif bool(getattr(dcfg, "ALLOW_RANDOM", False)):
            init_weights(self.net, torch.Generator().manual_seed(int(cfg.TPU.SEED)))
        else:
            # an untrained depth net gives garbage metric scale while the
            # sweep looks healthy: refuse unless the config opts in
            raise ValueError(
                "DEPTH_NET.ENABLED is set but DEPTH_NET.CHECKPOINT is empty: in-graph "
                "depth would run with random weights and corrupt metric scale. Set "
                "DEPTH_NET.CHECKPOINT to a .pt state dict of trained weights, or set "
                "DEPTH_NET.ALLOW_RANDOM: true (tests and smoke runs only).")
        self.net = self.net.to(device).eval()

    def __call__(self, images):
        """images [B, H, W, 3] on the net's device -> depth [B, H, W] float32
        (TF32 off: float32 stays float32, as in the solvers)."""
        with torch.no_grad(), tf32_off():
            return self.net(images)

    def point_depths(self, images, pts):
        """Depth at floor(pts): [B, H, W, 3] x [B, N, 2] -> [B, N]."""
        return gather_depth(self(images), pts)

