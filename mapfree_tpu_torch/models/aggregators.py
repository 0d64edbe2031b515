"""Feature aggregators (port of mapfree_tpu/models/aggregators.py):
correlation-volume warping, its QKV-projected variant, and concatenation.

For each position i of view 0, a softmax over all positions j of view 1
gives a matching distribution; view-1 features are soft-warped into view 0's
frame and concatenated with the view-0 features plus optional channels:
soft-argmax warp position (2), uniform grid (2), max score (1), compressed
correlation volume, upsampled positional encoding (reference
aggregator.py:42-116).

Public layout as in the JAX package: feature volumes [B, H, W, C] in and
out, flattened position index i = h * W + w. The fused route calls the CUDA
kernel (:func:`mapfree_tpu_torch.ops.correlation.fused_correlation_warp`)
whenever the variant allows it; the dense route keeps the [B, HW, HW]
volume for the dustbin and compressed-volume variants, which need it.
The QKV variant projects both views by 1x1 convolutions first and warps the
projected values (reference aggregator.py:119-191); ``Concat`` is the
ablation without correlation (aggregator.py:194-200).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mapfree_tpu_torch.models.blocks import PreActBlock
from mapfree_tpu_torch.ops.correlation import fused_correlation_warp


def _uv_grid(H: int, W: int, device=None, dtype=torch.float32):
    """[HW, 2] grid of (u, v) coords in [-1, 1]; u indexes H, v indexes W
    (reference aggregator.py:81-84 meshgrid ordering)."""
    u = torch.linspace(-1.0, 1.0, H, dtype=dtype, device=device)
    v = torch.linspace(-1.0, 1.0, W, dtype=dtype, device=device)
    return torch.stack([u.repeat_interleave(W), v.repeat(H)], dim=-1)


def _to_nchw(x, B, H, W):
    return x.reshape(B, H, W, -1).permute(0, 3, 1, 2)


def _to_flat(x):
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


class CorrelationVolumeWarping(nn.Module):
    """Soft cross-view warping via the correlation volume.

    ``hw`` (the number of feature positions) is needed only with
    ``cv_outlayers > 0``, whose block takes the HW correlation rows as
    channels."""

    def __init__(self, position_encoder: bool = False,
                 position_encoder_im1: bool = False,
                 max_score_channel: bool = False, normalise_dot: bool = False,
                 cv_outlayers: int = 0, cv_half_channels: bool = False,
                 upsample_pos_enc: int = 0, dustbin: bool = False,
                 fused: bool = True, hw: int | None = None,
                 dtype=torch.float32):
        super().__init__()
        self.position_encoder = position_encoder
        self.position_encoder_im1 = position_encoder_im1
        self.max_score_channel = max_score_channel
        self.normalise_dot = normalise_dot
        self.cv_outlayers = cv_outlayers
        self.cv_half_channels = cv_half_channels
        self.upsample_pos_enc = upsample_pos_enc
        self.dustbin = dustbin
        self.fused = fused
        self.dtype = dtype
        if dustbin:
            self.bin_score = nn.Parameter(100.0 * torch.ones(1, 1, 1))
        if position_encoder and upsample_pos_enc > 0:
            self.pos_encoder_block = PreActBlock(
                4 if position_encoder_im1 else 2, upsample_pos_enc)
        if cv_outlayers > 0:
            if hw is None:
                raise ValueError("cv_outlayers > 0 needs the feature grid size hw")
            self.CV_block = PreActBlock(hw, cv_outlayers)

    def _can_fuse(self) -> bool:
        """The fused kernel covers every variant except the dustbin softmax
        structure and the compressed-CV channels (which need the full
        correlation volume)."""
        return self.fused and not self.dustbin and self.cv_outlayers == 0

    def _run_block(self, block, x):
        """Run a conv block in the compute dtype (autocast is off around it)."""
        bf16 = self.dtype == torch.bfloat16
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            return block(x.float())

    def _pos_encoding_parts(self, pos_enc, grid, B, H, W):
        parts = [pos_enc]
        HW = H * W
        if self.position_encoder_im1:
            parts.append(grid[None].expand(B, HW, 2))
        if self.upsample_pos_enc > 0:
            feats = (torch.cat([pos_enc, grid[None].expand(B, HW, 2)], dim=-1)
                     if self.position_encoder_im1 else pos_enc)
            feats = self._run_block(self.pos_encoder_block, _to_nchw(feats, B, H, W))
            parts.append(_to_flat(feats).float())
        return parts

    def forward(self, vol0, vol1):
        if vol0.shape != vol1.shape:
            raise ValueError(f"feature volumes must match: {list(vol0.shape)} "
                             f"vs {list(vol1.shape)}")
        B, H, W, C = vol0.shape
        HW = H * W
        f0 = vol0.reshape(B, HW, C)
        f1 = vol1.reshape(B, HW, C)
        grid = _uv_grid(H, W, device=vol0.device)

        with torch.autocast(vol0.device.type, enabled=False):
            if self.normalise_dot:
                f0 = f0 / torch.clamp(torch.linalg.norm(f0, dim=-1, keepdim=True), min=1e-12)
                f1 = f1 / torch.clamp(torch.linalg.norm(f1, dim=-1, keepdim=True), min=1e-12)

            if self._can_fuse():
                q = f0[..., : C // 2] if self.cv_half_channels else f0
                k = f1[..., : C // 2] if self.cv_half_channels else f1
                warped1, pos_enc, max_score = fused_correlation_warp(
                    q.contiguous(), k.contiguous(), f1.contiguous(), grid)
                parts = [f0.float(), warped1]
                if self.position_encoder:
                    parts += self._pos_encoding_parts(pos_enc, grid, B, H, W)
                if self.max_score_channel:
                    parts.append(max_score)
                return torch.cat(parts, dim=-1).reshape(B, H, W, -1).to(self.dtype)

            qc = C // 2 if self.cv_half_channels else C
            corr = torch.bmm(f0[..., :qc].float(), f1[..., :qc].float().transpose(1, 2))
            if self.dustbin:
                # learned bin row/col appended to the correlation volume
                col = self.bin_score.expand(B, HW, 1)
                row = self.bin_score.expand(B, 1, HW + 1)
                corr = torch.cat([torch.cat([corr, col], dim=2), row], dim=1)
                # non-learned dustbin feature (zeros) appended to view-1 features
                f1_ext = torch.cat([f1, f1.new_zeros(B, 1, C)], dim=1)
            else:
                f1_ext = f1
            cvol = torch.softmax(torch.nan_to_num(corr), dim=2)

            warped1 = torch.bmm(cvol, f1_ext.float())
            if self.dustbin:
                warped1 = warped1[:, :HW]  # drop the dustbin row
                cvol_main = cvol[:, :HW, :HW]
            else:
                cvol_main = cvol

            parts = [f0.float(), warped1]
            if self.position_encoder:
                pos_enc = torch.matmul(cvol_main, grid)  # soft-argmax position
                parts += self._pos_encoding_parts(pos_enc, grid, B, H, W)
            if self.max_score_channel:
                parts.append(cvol.amax(dim=2, keepdim=True)[:, :HW])
            if self.cv_outlayers > 0:
                # correlation rows as channels over the view-1 grid
                cv_img = cvol_main.transpose(1, 2).reshape(B, H, W, HW)
                cv_reduced = self._run_block(self.CV_block, _to_nchw(cv_img, B, H, W))
                parts.append(_to_flat(cv_reduced).float())
            return torch.cat(parts, dim=-1).reshape(B, H, W, -1).to(self.dtype)


class CorrelationVolumeWarpingQKV(nn.Module):
    """QKV-projected soft warping (reference aggregator.py:119-191): 1x1
    convolutions without bias give q from view 0, k from view 1 and v from
    both (one shared ``V_mlp``); with ``residual_att`` each adds its input,
    in the compute dtype. View 1's projected values are warped into view 0's
    frame and concatenated after view 0's (as float32), with the optional
    soft-argmax position and max score. The fused route hands the kernel q,
    k and v1 as contiguous [B, HW, C] tensors in the compute dtype."""

    def __init__(self, channels: int, position_encoder: bool = False,
                 max_score_channel: bool = False, normalise_dot: bool = False,
                 residual_att: bool = False, fused: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.position_encoder = position_encoder
        self.max_score_channel = max_score_channel
        self.normalise_dot = normalise_dot
        self.residual_att = residual_att
        self.fused = fused
        self.dtype = dtype
        self.Q_mlp = nn.Conv2d(channels, channels, 1, bias=False)
        self.K_mlp = nn.Conv2d(channels, channels, 1, bias=False)
        self.V_mlp = nn.Conv2d(channels, channels, 1, bias=False)

    def _project(self, conv, x):
        """The 1x1 convolution of NHWC ``x`` [B, H, W, C] as a product over
        channels, in the compute dtype, plus ``x`` with ``residual_att``;
        returns [B, HW, C] contiguous."""
        B, H, W, C = x.shape
        x = x.to(self.dtype).reshape(B, H * W, C)
        bf16 = self.dtype == torch.bfloat16
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            y = F.linear(x, conv.weight[:, :, 0, 0]).to(self.dtype)
        return y + x if self.residual_att else y

    def forward(self, vol0, vol1):
        if vol0.shape != vol1.shape:
            raise ValueError(f"feature volumes must match: {list(vol0.shape)} "
                             f"vs {list(vol1.shape)}")
        B, H, W, _ = vol0.shape
        q = self._project(self.Q_mlp, vol0)
        k = self._project(self.K_mlp, vol1)
        v0 = self._project(self.V_mlp, vol0)
        v1 = self._project(self.V_mlp, vol1)
        grid = _uv_grid(H, W, device=vol0.device)

        with torch.autocast(vol0.device.type, enabled=False):
            if self.normalise_dot:
                q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
                k = k / torch.clamp(torch.linalg.norm(k, dim=-1, keepdim=True), min=1e-12)
            if self.fused:
                warped1, pos_enc, max_score = fused_correlation_warp(
                    q.contiguous(), k.contiguous(), v1, grid)
            else:
                corr = torch.bmm(q.float(), k.float().transpose(1, 2))
                cvol = torch.softmax(torch.nan_to_num(corr), dim=2)
                warped1 = torch.bmm(cvol, v1.float())
                pos_enc = torch.matmul(cvol, grid)
                max_score = cvol.amax(dim=2, keepdim=True)
            parts = [v0.float(), warped1]
            if self.position_encoder:
                parts.append(pos_enc)
            if self.max_score_channel:
                parts.append(max_score)
            return torch.cat(parts, dim=-1).reshape(B, H, W, -1).to(self.dtype)


class Concat(nn.Module):
    """Channel concatenation [vol0 | vol1], the ablation without correlation
    (reference aggregator.py:194-200)."""

    def forward(self, vol0, vol1):
        return torch.cat([vol0, vol1], dim=-1)


def aggregator_out_channels(agg_cfg, volume_channels: int) -> int:
    """Channel count of the aggregated volume (reference aggregator.py:19-34)."""
    if agg_cfg.TYPE == "Concat":
        return 2 * volume_channels
    n = 2 * volume_channels
    if agg_cfg.POSITION_ENCODER:
        n += 2
    if agg_cfg.TYPE == "CorrelationVolumeWarping" and agg_cfg.POSITION_ENCODER_IM1:
        n += 2
    if agg_cfg.MAX_SCORE_CHANNEL:
        n += 1
    if agg_cfg.TYPE == "CorrelationVolumeWarping":
        if agg_cfg.CV_OUTLAYERS > 0:
            n += agg_cfg.CV_OUTLAYERS
        if agg_cfg.UPSAMPLE_POS_ENC > 0:
            n += agg_cfg.UPSAMPLE_POS_ENC
    return n


def build_aggregator(agg_cfg, hw: int | None = None, dtype=torch.float32,
                     fused: bool = True, channels: int | None = None) -> nn.Module:
    """``hw`` (feature positions) sizes the compressed-volume block;
    ``channels`` (the encoder's output channels) sizes the QKV projections."""
    if agg_cfg.TYPE == "CorrelationVolumeWarping":
        return CorrelationVolumeWarping(
            position_encoder=bool(agg_cfg.POSITION_ENCODER),
            position_encoder_im1=bool(agg_cfg.POSITION_ENCODER_IM1),
            max_score_channel=bool(agg_cfg.MAX_SCORE_CHANNEL),
            normalise_dot=bool(agg_cfg.NORMALISE_DOT),
            cv_outlayers=int(agg_cfg.CV_OUTLAYERS or 0),
            cv_half_channels=bool(agg_cfg.CV_HALF_CHANNELS),
            upsample_pos_enc=int(agg_cfg.UPSAMPLE_POS_ENC or 0),
            dustbin=bool(agg_cfg.DUSTBIN),
            fused=fused,
            hw=hw,
            dtype=dtype,
        )
    if agg_cfg.TYPE == "CorrelationVolumeWarpingQKV":
        if channels is None:
            raise ValueError("the QKV aggregator needs the feature channels")
        return CorrelationVolumeWarpingQKV(
            channels,
            position_encoder=bool(agg_cfg.POSITION_ENCODER),
            max_score_channel=bool(agg_cfg.MAX_SCORE_CHANNEL),
            normalise_dot=bool(agg_cfg.NORMALISE_DOT),
            residual_att=bool(agg_cfg.RESIDUAL_ATT),
            fused=fused,
            dtype=dtype,
        )
    if agg_cfg.TYPE == "Concat":
        return Concat()
    raise NotImplementedError(f"Invalid aggregator {agg_cfg.TYPE}")
