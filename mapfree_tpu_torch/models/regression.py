"""Composed relative-pose regression network (port of
mapfree_tpu/models/regression.py::RegressionNet).

Shared-weight two-view encoder -> correlation aggregator -> pose head
(reference lib/models/regression/model.py:14-73). Both views go through the
encoder as one stacked batch. With ``ref_idx``, image0 holds only the
UNIQUE reference frames and each pair's reference features are gathered
after the encoder, so an inference batch that shares 1-2 references across
its pairs encodes U + B images instead of 2B. Multi-frame models come with
a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from mapfree_tpu_torch.models.aggregators import aggregator_out_channels, build_aggregator
from mapfree_tpu_torch.models.encoders import build_encoder, encoder_out_channels, encoder_out_hw
from mapfree_tpu_torch.models.heads import build_head
from mapfree_tpu_torch.ops.image import yuv420_to_rgb


def compute_dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


class RegressionNet(nn.Module):
    """``forward`` returns (R [B, 3, 3], t [B, 1, 3], aux), R and t float32.

    ``compute_dtype`` bfloat16 runs the convolutions under autocast; the
    correlation, the MLP and the Kabsch solve stay float32."""

    def __init__(self, encoder: nn.Module, aggregator: nn.Module, head: nn.Module,
                 compute_dtype: torch.dtype = torch.float32,
                 learnable_loss_weights: bool = False):
        super().__init__()
        self.encoder = encoder
        self.aggregator = aggregator
        self.head = head
        self.compute_dtype = compute_dtype
        if learnable_loss_weights:  # Kendall weights (TRAINING.LAMBDA == 0)
            self.s_r = nn.Parameter(torch.zeros(1))
            self.s_t = nn.Parameter(torch.zeros(1))

    @staticmethod
    def to_float(img):
        """uint8 NHWC (/255) or planar YUV420 uint8 [N, H*3/2, W] (rank 3)
        -> float32 NHWC RGB."""
        if img.dim() == 3:
            return yuv420_to_rgb(img)
        scale = 1.0 / 255.0 if img.dtype == torch.uint8 else 1.0
        return img.float() * scale

    def forward(self, image0, image1, ref_idx=None):
        """image0: [B, H, W, 3] (or [U, ...] unique refs with ``ref_idx`` [B]);
        image1: [B, H, W, 3]; either may be planar YUV420 [N, H*3/2, W]."""
        image0 = self.to_float(image0)
        image1 = self.to_float(image1)
        U = image0.shape[0]
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(image0.device.type, dtype=torch.bfloat16, enabled=bf16):
            vols = self.encoder(torch.cat([image0, image1], dim=0))
            vol0, vol1 = vols[:U], vols[U:]
            if ref_idx is not None:
                vol0 = vol0[ref_idx.long()]
            global_volume = self.aggregator(vol0, vol1)
            R, t, aux = self.head(global_volume)
        if hasattr(self, "s_r"):
            aux = dict(aux, s_r=self.s_r, s_t=self.s_t)
        return R.float(), t.float(), aux


def build_regression_net(cfg) -> RegressionNet:
    if cfg.MODEL != "Regression":
        raise NotImplementedError(
            f"model {cfg.MODEL} is not ported yet (multi-frame models come with a "
            "later slice of the port)")
    dtype = compute_dtype_of(cfg)
    h, w = encoder_out_hw(cfg.ENCODER, cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH)
    channels = encoder_out_channels(cfg.ENCODER)
    encoder = build_encoder(cfg.ENCODER)
    aggregator = build_aggregator(cfg.AGGREGATOR, hw=h * w, dtype=dtype,
                                  fused=bool(cfg.TPU.FUSED_CORRELATION))
    head = build_head(cfg, aggregator_out_channels(cfg.AGGREGATOR, channels), (h, w))
    return RegressionNet(encoder, aggregator, head, compute_dtype=dtype,
                         learnable_loss_weights=cfg.TRAINING.LAMBDA == 0.0)
