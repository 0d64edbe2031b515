"""Pose regression heads (port of mapfree_tpu/models/heads.py).

This slice ports the Procrustes heads (reference lib/models/regression/
head.py:53-163): residual trunk -> MLP -> 3D anchor correspondences ->
differentiable Kabsch. The other head types raise and come with a later
slice. Input is the aggregated volume [B, H, W, C] (NHWC, as in JAX); the
trunk runs NCHW and ravels in NCHW order, so converted dense weights apply
without a row permutation. The MLP and the Kabsch solve run in float32 with
autocast off, as the JAX head casts to float32 before its dense layers.
"""

from __future__ import annotations

import torch
from torch import nn

from mapfree_tpu_torch.geom.procrustes import procrustes
from mapfree_tpu_torch.models.blocks import PreActBlock


def _half(n: int) -> int:
    return (n + 1) // 2


def _procrustes_from_anchors(xyz, num_pts: int, add_basis: bool):
    """Anchors -> correspondences -> differentiable Kabsch
    (reference head.py:64-103)."""
    B = xyz.shape[0]
    basis = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(B, 3, 3)
    if num_pts == 3:
        cor0 = basis
        cor1 = xyz
    else:
        cor0 = xyz[:, : num_pts // 2]
        cor1 = xyz[:, num_pts // 2:]
    if add_basis:
        if num_pts == 6:
            cor0 = cor0 + basis
        if num_pts in (3, 6):
            cor1 = cor1 + basis
    return procrustes(cor0, cor1)


class ProcrustesHead(nn.Module):
    """Regress 3D anchor correspondences, recover the pose by Kabsch.

    ``deep``: 4 stride-2 pre-act blocks (64-128-256-512) and a 3-layer MLP
    (reference DeepResBlock + mlp Sequential, head.py:27-50, 115-122);
    otherwise 2 blocks (256-128) and one dense layer (ResBlockMLP,
    head.py:10-24). ``feature_hw`` sizes the first dense layer when the
    trunk output is ravelled instead of average-pooled."""

    def __init__(self, in_channels: int, feature_hw: tuple, num_pts: int = 6,
                 add_basis: bool = False, deep: bool = True,
                 batch_norm: bool = True, avg_pool: bool = False):
        super().__init__()
        if not (num_pts == 3 or (num_pts % 2 == 0 and num_pts >= 6)):
            raise ValueError("num_pts must be 3, 6 or an even number >= 6")
        self.num_pts = num_pts
        self.add_basis = add_basis
        self.deep = deep
        self.avg_pool = avg_pool and deep
        h, w = feature_hw
        if deep:
            widths = (64, 128, 256, 512)
            bn = batch_norm
        else:
            widths = (256, 128)
            bn = True
        cin = in_channels
        for i, planes in enumerate(widths, start=1):
            setattr(self, f"resblock{i}", PreActBlock(cin, planes, 2, bn=bn))
            cin = planes
            h, w = _half(h), _half(w)
        self.n_blocks = len(widths)
        flat = cin if self.avg_pool else cin * h * w
        if deep:
            self.mlp = nn.Sequential(
                nn.Linear(flat, 256), nn.ReLU(),
                nn.Linear(256, 128), nn.ReLU(),
                nn.Linear(128, 3 * num_pts))
        else:
            self.mlp = nn.Linear(flat, 3 * num_pts)

    def forward(self, feature_volume):
        """feature_volume [B, H, W, C] -> R [B, 3, 3], t [B, 1, 3], aux."""
        B = feature_volume.shape[0]
        x = feature_volume.permute(0, 3, 1, 2)
        for i in range(1, self.n_blocks + 1):
            x = getattr(self, f"resblock{i}")(x)
        if self.avg_pool:
            x = x.mean(dim=(2, 3), keepdim=True)
        x = x.reshape(B, -1)  # NCHW-order ravel (reference head.py:22-24, 44-50)
        with torch.autocast(x.device.type, enabled=False):
            out = self.mlp(x.float())
        xyz = out.reshape(B, -1, 3)
        R, t = _procrustes_from_anchors(xyz, self.num_pts, self.add_basis)
        return R, t, {"anchors": xyz}


def build_head(cfg, in_channels: int, feature_hw: tuple) -> nn.Module:
    """String-dispatch on cfg.HEAD.TYPE, with the reference head names."""
    h = cfg.HEAD
    t = h.TYPE
    if t in ("ProcrustesResBlockMLP", "ProcrustesDeepResBlock"):
        return ProcrustesHead(
            in_channels, feature_hw, num_pts=h.NUM_PTS,
            add_basis=bool(h.ADD_BASIS), deep=t == "ProcrustesDeepResBlock",
            batch_norm=bool(h.BATCH_NORM), avg_pool=bool(h.AVG_POOL))
    if t in ("QuatDeepResBlock", "DirectResBlockMLP", "DirectDeepResBlockMLP",
             "AngularBinsDeepResBlockMLP"):
        raise NotImplementedError(
            f"head {t} is not ported yet: it comes with the slice that ports the "
            "remaining RPR variants")
    raise NotImplementedError(f"Invalid head {t}")

