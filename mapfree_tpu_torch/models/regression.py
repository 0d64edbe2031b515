"""Composed relative-pose regression networks (port of
mapfree_tpu/models/regression.py).

:class:`RegressionNet`: shared-weight two-view encoder -> correlation
aggregator -> pose head (reference lib/models/regression/model.py:14-73).
Both views go through the encoder as one stacked batch. With ``ref_idx``,
image0 holds only the UNIQUE reference frames and each pair's reference
features are gathered after the encoder, so an inference batch that shares
1-2 references across its pairs encodes U + B images instead of 2B. With
``multi_frame`` (MODEL RegressionMultiFrame) image1 is a window of F frames
of which only the last, the query frame, is encoded (reference
model.py:240-241).

:class:`RegressionMultiFrameFusionNet` (MODEL RegressionMultiFrameFusion)
uses every frame of the window: the encoder runs once over the B * (F + 1)
frames, the aggregator and head once over the B * F (reference, frame)
pairs, and :func:`fuse_frame_poses` chains each frame's pose through the
device-tracking poses into the query frame and fuses them with weights
predicted from each pair's pooled volume.
"""

from __future__ import annotations

import torch
from torch import nn

from mapfree_tpu_torch.geom.quaternion import mat2quat_torch, quat2mat_torch
from mapfree_tpu_torch.models.aggregators import aggregator_out_channels, build_aggregator
from mapfree_tpu_torch.models.encoders import build_encoder, encoder_out_channels, encoder_out_hw
from mapfree_tpu_torch.models.heads import build_head
from mapfree_tpu_torch.ops.image import yuv420_to_rgb
from mapfree_tpu_torch.utils.timing import span

REGRESSION_MODELS = ("Regression", "RegressionMultiFrame", "RegressionMultiFrameFusion")


def compute_dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


class RegressionNet(nn.Module):
    """``forward`` returns (R [B, 3, 3], t [B, 1, 3], aux), R and t float32.

    ``compute_dtype`` bfloat16 runs the convolutions under autocast; the
    correlation, the MLP and the Kabsch solve stay float32."""

    def __init__(self, encoder: nn.Module, aggregator: nn.Module, head: nn.Module,
                 compute_dtype: torch.dtype = torch.float32,
                 learnable_loss_weights: bool = False, multi_frame: bool = False):
        super().__init__()
        self.encoder = encoder
        self.aggregator = aggregator
        self.head = head
        self.compute_dtype = compute_dtype
        self.multi_frame = multi_frame
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
        image1: [B, H, W, 3], or [B, F, H, W, 3] with ``multi_frame``; either
        may be planar YUV420 [N, H*3/2, W]."""
        if self.multi_frame:
            image1 = image1[:, -1]
        with span("to_float"):
            image0 = self.to_float(image0)
            image1 = self.to_float(image1)
        U = image0.shape[0]
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(image0.device.type, dtype=torch.bfloat16, enabled=bf16):
            with span("encoder"):
                vols = self.encoder(torch.cat([image0, image1], dim=0))
            vol0, vol1 = vols[:U], vols[U:]
            with span("aggregator"):
                if ref_idx is not None:
                    vol0 = vol0[ref_idx.long()]
                global_volume = self.aggregator(vol0, vol1)
            with span("head"):
                R, t, aux = self.head(global_volume)
        if hasattr(self, "s_r"):
            aux = dict(aux, s_r=self.s_r, s_t=self.s_t)
        return R.float(), t.float(), aux


def fuse_frame_poses(R_f, t_f, q_device, t_device, weights):
    """Chain per-frame relative-pose estimates through the device tracking
    and fuse them in the LAST frame's coordinates. float32, autocast off.

    Args:
        R_f, t_f: [B, F, 3, 3] / [B, F, 3] predicted T_ref->f (w2c).
        q_device, t_device: [B, F, 4] / [B, F, 3] per-frame device-tracking
            poses, world-to-camera.
        weights: [B, F] convex frame weights.
    Returns:
        (R [B, 3, 3], t [B, 3]) fused T_ref->last, and the per-frame chained
        estimates (R_est [B, F, 3, 3], t_est [B, F, 3]).

    The rotations are fused by the weighted chordal-L2 mean: the top
    eigenvector of the weighted sum of the estimates' quaternion outer
    products (``torch.linalg.eigh``, which waits for the device on CUDA to
    check its result), turned to w >= 0 by the sign of w + 1e-12. If every
    per-frame prediction and the tracking are exact, every chained estimate
    equals T_ref->last and the fusion returns it for any weights.
    """
    with torch.autocast(R_f.device.type, enabled=False):
        R_dev = quat2mat_torch(q_device.float())  # [B, F, 3, 3]
        t_dev = t_device.float()
        # T_f->last = T_last o T_f^-1 (w2c)
        R_rel = R_dev[:, -1:] @ R_dev.transpose(-1, -2)
        t_rel = t_dev[:, -1:] - torch.einsum("bfij,bfj->bfi", R_rel, t_dev)
        R_est = R_rel @ R_f.float()
        t_est = torch.einsum("bfij,bfj->bfi", R_rel, t_f.float()) + t_rel

        q_est = mat2quat_torch(R_est)  # [B, F, 4]
        M = torch.einsum("bf,bfi,bfj->bij", weights, q_est, q_est)
        q_fused = torch.linalg.eigh(M)[1][..., -1]  # eigenvalues ascend
        q_fused = q_fused * torch.sign(q_fused[..., :1] + 1e-12)
        R = quat2mat_torch(q_fused)
        t = torch.einsum("bf,bfi->bi", weights, t_est)
    return R, t, R_est, t_est


class RegressionMultiFrameFusionNet(nn.Module):
    """Multi-frame fusion (mapfree_tpu/models/regression.py:129-199).
    ``forward`` returns (R [B, 3, 3], t [B, 1, 3], aux) float32; aux holds the
    head's entries for the B * F pairs, the per-frame chained estimates
    (``per_frame_R``, ``per_frame_t``), the frame weights and, with learnable
    loss weights, ``s_r`` and ``s_t``. ``frame_weight`` is a float32 dense
    layer on each pair's aggregated volume, averaged over positions in the
    compute dtype."""

    needs_device_poses = True

    def __init__(self, encoder: nn.Module, aggregator: nn.Module, head: nn.Module,
                 aggregated_channels: int, compute_dtype: torch.dtype = torch.float32,
                 learnable_loss_weights: bool = False):
        super().__init__()
        self.encoder = encoder
        self.aggregator = aggregator
        self.head = head
        self.compute_dtype = compute_dtype
        self.frame_weight = nn.Linear(aggregated_channels, 1)
        if learnable_loss_weights:
            self.s_r = nn.Parameter(torch.zeros(1))
            self.s_t = nn.Parameter(torch.zeros(1))

    def forward(self, image0, image1, q_device=None, t_device=None):
        """image0: [B, H, W, 3]; image1: [B, F, H, W, 3], uint8 (/255) or
        float; q_device, t_device: [B, F, 4] / [B, F, 3] per-frame
        device-tracking poses, world-to-camera (the batch keys
        ``abs_q_1_w2c_device`` and ``abs_c_1_c2w_device``)."""
        if q_device is None or t_device is None:
            raise ValueError("the fusion model needs the device-tracking poses")
        B, F = image1.shape[:2]
        with span("to_float"):
            image0 = RegressionNet.to_float(image0)
            image1 = RegressionNet.to_float(image1.reshape((B * F,) + image1.shape[2:]))
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(image0.device.type, dtype=torch.bfloat16, enabled=bf16):
            with span("encoder"):  # one encoder batch for all B * (F + 1) frames
                vols = self.encoder(torch.cat([image0, image1], dim=0))
            with span("aggregator"):  # each reference volume once per frame of its window
                vol0 = vols[:B].repeat_interleave(F, dim=0)
                gv = self.aggregator(vol0, vols[B:])  # [B * F, h, w, C']
            with span("head"):
                R_f, t_f, aux = self.head(gv)
            with span("fuse"):  # the frames' weights and the fused pose
                pooled = gv.to(self.compute_dtype).mean(dim=(1, 2))  # [B * F, C']
                with torch.autocast(image0.device.type, enabled=False):  # weights, fusion: float32
                    logits = self.frame_weight(pooled.float()).reshape(B, F)
                    w = torch.softmax(logits, dim=-1)
                    R, t, R_est, t_est = fuse_frame_poses(
                        R_f.float().reshape(B, F, 3, 3), t_f.float().reshape(B, F, 3),
                        q_device, t_device, w)
        aux = dict(aux, per_frame_R=R_est, per_frame_t=t_est, frame_weights=w)
        if hasattr(self, "s_r"):
            aux.update(s_r=self.s_r, s_t=self.s_t)
        return R, t.reshape(B, 1, 3), aux


def build_regression_net(cfg) -> nn.Module:
    """The network of ``cfg.MODEL`` (one of :data:`REGRESSION_MODELS`)."""
    if cfg.MODEL not in REGRESSION_MODELS:
        raise NotImplementedError(f"Invalid regression model {cfg.MODEL}")
    dtype = compute_dtype_of(cfg)
    h, w = encoder_out_hw(cfg.ENCODER, cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH)
    channels = encoder_out_channels(cfg.ENCODER)
    encoder = build_encoder(cfg.ENCODER)
    aggregator = build_aggregator(cfg.AGGREGATOR, hw=h * w, dtype=dtype,
                                  fused=bool(cfg.TPU.FUSED_CORRELATION), channels=channels)
    aggregated = aggregator_out_channels(cfg.AGGREGATOR, channels)
    head = build_head(cfg, aggregated, (h, w))
    kendall = cfg.TRAINING.LAMBDA == 0.0
    if cfg.MODEL == "RegressionMultiFrameFusion":
        return RegressionMultiFrameFusionNet(encoder, aggregator, head, aggregated,
                                             compute_dtype=dtype,
                                             learnable_loss_weights=kendall)
    return RegressionNet(encoder, aggregator, head, compute_dtype=dtype,
                         learnable_loss_weights=kendall,
                         multi_frame=cfg.MODEL == "RegressionMultiFrame")
