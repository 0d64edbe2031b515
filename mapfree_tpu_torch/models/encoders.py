"""Feature encoders ResNet and ResUNet (port of
mapfree_tpu/models/encoders.py).

- ResNet (reference lib/models/regression/encoder/resnet.py:7-37): a 7x7
  stride-2 stem (padding 1), three pre-activation stages, each followed by
  a 2x2 average pool; 256 * expansion channels out.
- ResUNet (reference encoder/resunet.py:41-128), CAPS-style residual U-Net:
  a 7x7 stride-2 stem and 3x3 stride-2 max-pool to H/4, three
  pre-activation stages to H/16, and a decoder with skip-concats back to H/4
  with ``NUM_OUT_LAYERS`` channels.

The public layout is the JAX package's, NHWC in and out; the convolutions
run NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mapfree_tpu_torch.models.blocks import (
    BatchNorm2d,
    ConvBnElu,
    PreActBlock,
    PreActBottleneck,
    PreActBottleneckDepthwise,
    UpConv,
)

BLOCK_TYPES = [PreActBlock, PreActBottleneck, PreActBottleneckDepthwise]


def parse_num_blocks(spec: str) -> list:
    return [int(x) for x in spec.strip().split("-")]


def encoder_out_channels(encoder_cfg) -> int:
    """Number of channels of the encoder output volume."""
    if encoder_cfg.TYPE == "ResNet":
        return 256 * BLOCK_TYPES[encoder_cfg.BLOCK_TYPE].expansion
    if encoder_cfg.TYPE == "ResUNet":
        n = encoder_cfg.NUM_OUT_LAYERS
        return 128 if n is None else n
    raise NotImplementedError(f"Invalid encoder {encoder_cfg.TYPE}")


def _half(n: int) -> int:
    """Output size of a stride-2 conv or pool with 'same'-style padding."""
    return (n + 1) // 2


def encoder_out_hw(encoder_cfg, height: int, width: int) -> tuple:
    """Spatial size of the encoder's output grid for a [height, width] image.
    ResUNet: stem /2, pool /2, two stride-2 stages, then two 2x upsamples
    (the skips are padded or cropped to the upsampled size). ResNet: stem /2
    (padding 1), then three 2x2 average pools with two stride-2 stages
    between them."""
    if encoder_cfg.TYPE not in ("ResNet", "ResUNet"):
        raise NotImplementedError(f"Invalid encoder {encoder_cfg.TYPE}")
    out = []
    for n in (height, width):
        if encoder_cfg.TYPE == "ResNet":
            n = (n + 2 * 1 - 7) // 2 + 1   # 7x7 stride-2 stem, padding 1
            n = _half(n // 2) // 2         # pool, layer2, pool
            n = _half(n) // 2              # layer3, pool
            out.append(n)
            continue
        n = (n + 2 * 3 - 7) // 2 + 1   # 7x7 stride-2 stem, padding 3
        n = (n + 2 - 3) // 2 + 1       # 3x3 stride-2 max-pool, padding 1
        n = _half(_half(n))            # encoder2, encoder3
        out.append(4 * n)              # upconv4, upconv3
    return tuple(out)


class _Stage(nn.Sequential):
    """A stack of residual blocks named 0, 1, ...; the first carries the stride."""

    def __init__(self, block, in_planes: int, planes: int, num_blocks: int, stride: int):
        layers = []
        for i in range(num_blocks):
            layers.append(block(in_planes, planes, stride if i == 0 else 1))
            in_planes = planes * block.expansion
        super().__init__(*layers)


def _skip_concat(y, skip):
    """Pad (or crop, for negative deltas) the SKIP tensor spatially to the
    upsampled tensor's size and concat channels [upsampled, skip], as the
    reference's skipconnect does (resunet.py:91-103; F.pad crops on
    negative pads). NCHW."""
    pads = []
    for axis in (3, 2):  # F.pad lists the last dimension first
        d = y.shape[axis] - skip.shape[axis]
        lo = d // 2
        pads += [lo, d - lo]
    if any(pads):
        skip = F.pad(skip, pads)
    return torch.cat([y, skip], dim=1)


class ResNet(nn.Module):
    """(reference: encoder/resnet.py:7-37) No normalisation after the stem,
    whose padding of 1 crops the borders slightly, as the reference's does."""

    def __init__(self, block_type: int, num_blocks: Sequence[int]):
        super().__init__()
        block = BLOCK_TYPES[block_type]
        e = block.expansion
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 1, bias=False)
        self.layer1 = _Stage(block, 64, 64, num_blocks[0], 1)
        self.layer2 = _Stage(block, 64 * e, 128, num_blocks[1], 2)
        self.layer3 = _Stage(block, 128 * e, 256, num_blocks[2], 2)

    def forward(self, x):
        """x: [N, H, W, 3] -> [N, h, w, 256 * expansion] (NHWC), h and w as
        :func:`encoder_out_hw` gives them."""
        x = self.conv1(x.permute(0, 3, 1, 2))
        for stage in (self.layer1, self.layer2, self.layer3):
            x = F.avg_pool2d(stage(x), 2, 2)
        return x.permute(0, 2, 3, 1)


class ResUNet(nn.Module):
    """(reference: encoder/resunet.py:41-128)"""

    def __init__(self, block_type: int, num_blocks: Sequence[int],
                 num_out_layers: int = 128, not_concat: bool = False):
        super().__init__()
        block = BLOCK_TYPES[block_type]
        e = block.expansion
        self.not_concat = not_concat
        self.firstconv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.firstbn = BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.encoder1 = _Stage(block, 64, 64, num_blocks[0], 1)
        self.encoder2 = _Stage(block, 64 * e, 128, num_blocks[1], 2)
        self.encoder3 = _Stage(block, 128 * e, 256, num_blocks[2], 2)
        self.upconv4 = UpConv(256 * e, 512, 3, 2)
        self.iconv4 = ConvBnElu(512 if not_concat else 512 + 128 * e, 512, 3, 1)
        self.upconv3 = UpConv(512, 256, 3, 2)
        self.iconv3 = ConvBnElu(256 if not_concat else 256 + 64 * e, 256, 3, 1)
        self.outconv = ConvBnElu(256, num_out_layers, 1, 1)

    def forward(self, x):
        """x: [N, H, W, 3] -> [N, H/4, W/4, num_out_layers] (NHWC)."""
        x = x.permute(0, 3, 1, 2)
        x1 = F.relu(self.firstbn(self.firstconv(x)))
        x1 = F.max_pool2d(x1, 3, 2, padding=1)

        x2 = self.encoder1(x1)
        x3 = self.encoder2(x2)
        x4 = self.encoder3(x3)

        y = self.upconv4(x4)
        if not self.not_concat:
            y = _skip_concat(y, x3)
        y = self.iconv4(y)
        y = self.upconv3(y)
        if not self.not_concat:
            y = _skip_concat(y, x2)
        y = self.iconv3(y)
        y = self.outconv(y)
        return y.permute(0, 2, 3, 1)


def build_encoder(encoder_cfg) -> nn.Module:
    if encoder_cfg.TYPE == "ResNet":
        return ResNet(encoder_cfg.BLOCK_TYPE, parse_num_blocks(encoder_cfg.NUM_BLOCKS))
    if encoder_cfg.TYPE == "ResUNet":
        n = encoder_cfg.NUM_OUT_LAYERS
        return ResUNet(
            encoder_cfg.BLOCK_TYPE,
            parse_num_blocks(encoder_cfg.NUM_BLOCKS),
            num_out_layers=128 if n is None else n,
            not_concat=bool(encoder_cfg.NOT_CONCAT),
        )
    raise NotImplementedError(f"Invalid encoder {encoder_cfg.TYPE}")
