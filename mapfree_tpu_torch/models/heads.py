"""Pose regression heads (port of mapfree_tpu/models/heads.py; reference
lib/models/regression/head.py:10-323).

Every head maps the aggregated volume [B, H, W, C] (NHWC, as in JAX) to a
relative pose (R [B, 3, 3], t [B, 1, 3]) and an ``aux`` dict of the
intermediate predictions that specific losses read:

- :class:`ProcrustesHead`: 3D anchor correspondences, then a
  differentiable Kabsch solve;
- :class:`QuatHead`: a unit quaternion and a direction with a scale, or a
  translation;
- :class:`DirectHead`: the 6D rotation and a translation;
- :class:`AngularBinsHead`: Euler-angle bins for R, and spherical-angle bins
  with a scale (or a translation) for t, decoded by argmax without a
  gradient.

The trunks run NCHW and ravel in NCHW order, so converted dense weights
apply without a row permutation. The MLPs and what follows them run in
float32 with autocast off, as the JAX heads cast to float32 before their
dense layers.
"""

from __future__ import annotations

import torch
from torch import nn

from mapfree_tpu_torch.geom.procrustes import procrustes
from mapfree_tpu_torch.geom.rotation import euler_xyz_to_matrix, rotation_matrix_from_ortho6d
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


def _deep_mlp(flat: int, out_dims: int) -> nn.Sequential:
    """Dense(256)-ReLU-Dense(128)-ReLU-Dense(out) (reference head.py:115-122)."""
    return nn.Sequential(nn.Linear(flat, 256), nn.ReLU(), nn.Linear(256, 128), nn.ReLU(),
                         nn.Linear(128, out_dims))


def _quat_to_mat(q):
    """Unit quaternion [B, 4] (w, x, y, z) -> R [B, 3, 3], without
    normalising again."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def _unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)


class _TrunkHead(nn.Module):
    """A head's residual trunk, held as attributes ``resblock1``, ... of the
    head itself (reference head.py:10-50). ``deep``: 4 stride-2 pre-act
    blocks (64-128-256-512), optional global average pool (DeepResBlock);
    otherwise 2 blocks (256-128) with BatchNorm (ResBlockMLP). The trunk's
    output is ravelled in NCHW order; ``feature_hw`` sizes it when it is not
    pooled."""

    def _build_trunk(self, in_channels: int, feature_hw: tuple, deep: bool,
                     batch_norm: bool, avg_pool: bool) -> int:
        """Make the trunk's blocks; returns the ravelled width."""
        self.avg_pool = avg_pool and deep
        widths, bn = ((64, 128, 256, 512), batch_norm) if deep else ((256, 128), True)
        h, w = feature_hw
        cin = in_channels
        for i, planes in enumerate(widths, start=1):
            setattr(self, f"resblock{i}", PreActBlock(cin, planes, 2, bn=bn))
            cin = planes
            h, w = _half(h), _half(w)
        self.n_blocks = len(widths)
        return cin if self.avg_pool else cin * h * w

    def _trunk(self, feature_volume):
        """[B, H, W, C] -> the ravelled trunk output [B, flat], float32."""
        B = feature_volume.shape[0]
        x = feature_volume.permute(0, 3, 1, 2)
        for i in range(1, self.n_blocks + 1):
            x = getattr(self, f"resblock{i}")(x)
        if self.avg_pool:
            x = x.mean(dim=(2, 3), keepdim=True)
        return x.reshape(B, -1).float()  # NCHW-order ravel (reference head.py:22-24, 44-50)


class ProcrustesHead(_TrunkHead):
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
        flat = self._build_trunk(in_channels, feature_hw, deep, batch_norm, avg_pool)
        self.mlp = _deep_mlp(flat, 3 * num_pts) if deep else nn.Linear(flat, 3 * num_pts)

    def forward(self, feature_volume):
        """feature_volume [B, H, W, C] -> R [B, 3, 3], t [B, 1, 3], aux."""
        x = self._trunk(feature_volume)
        with torch.autocast(x.device.type, enabled=False):
            xyz = self.mlp(x).reshape(x.shape[0], -1, 3)
            R, t = _procrustes_from_anchors(xyz, self.num_pts, self.add_basis)
        return R, t, {"anchors": xyz}


class QuatHead(_TrunkHead):
    """Unit quaternion, then a unit direction and a scale
    (``separate_scale``) or a translation (reference head.py:166-213,
    QuatDeepResBlock). aux: ``q``, and ``t_direction`` and ``scale``."""

    def __init__(self, in_channels: int, feature_hw: tuple, separate_scale: bool = True,
                 batch_norm: bool = True, avg_pool: bool = False):
        super().__init__()
        self.separate_scale = separate_scale
        flat = self._build_trunk(in_channels, feature_hw, True, batch_norm, avg_pool)
        self.mlp = _deep_mlp(flat, 8 if separate_scale else 7)

    def forward(self, feature_volume):
        x = self._trunk(feature_volume)
        B = x.shape[0]
        with torch.autocast(x.device.type, enabled=False):
            out = self.mlp(x)
            quat = _unit(out[:, :4])
            aux = {"q": quat}
            if self.separate_scale:
                scale = torch.abs(out[:, 4]).reshape(B, 1, 1)
                direction = _unit(out[:, 5:]).reshape(B, 1, 3)
                aux["t_direction"] = direction
                aux["scale"] = scale
                t = scale * direction
            else:
                t = out[:, 4:].reshape(B, 1, 3)
            return _quat_to_mat(quat), t, aux


class DirectHead(_TrunkHead):
    """The 6D rotation and a translation (reference head.py:216-266):
    ``deep`` with the 3-layer MLP, else the shallow trunk and one dense
    layer."""

    def __init__(self, in_channels: int, feature_hw: tuple, deep: bool = True,
                 batch_norm: bool = True, avg_pool: bool = False):
        super().__init__()
        flat = self._build_trunk(in_channels, feature_hw, deep, batch_norm, avg_pool)
        self.mlp = _deep_mlp(flat, 9) if deep else nn.Linear(flat, 9)

    def forward(self, feature_volume):
        x = self._trunk(feature_volume)
        with torch.autocast(x.device.type, enabled=False):
            out = self.mlp(x)
            return rotation_matrix_from_ortho6d(out[:, :6]), out[:, 6:].reshape(-1, 1, 3), {}


class AngularBinsHead(_TrunkHead):
    """R as 360/180/360 bins of extrinsic xyz Euler angles; t either direct
    or, with ``separate_scale``, as 360/180 bins of its spherical angles and
    a scale (reference head.py:269-323). One float32 dense layer of
    900 + 541 (or 900 + 3) outputs. The argmax decode takes no gradient, as
    in the reference's no_grad block. aux: ``R_bins``, and ``t_sph_phi``,
    ``t_sph_theta``, ``scale``."""

    def __init__(self, in_channels: int, feature_hw: tuple, separate_scale: bool = True,
                 batch_norm: bool = True, avg_pool: bool = False):
        super().__init__()
        self.separate_scale = separate_scale
        flat = self._build_trunk(in_channels, feature_hw, True, batch_norm, avg_pool)
        self.mlp = nn.Linear(flat, 360 * 2 + 180 + (360 + 180 + 1 if separate_scale else 3))

    def forward(self, feature_volume):
        x = self._trunk(feature_volume)
        B = x.shape[0]
        with torch.autocast(x.device.type, enabled=False):
            out = self.mlp(x)
            R_bins = out[:, :900]
            aux = {"R_bins": R_bins}
            bins = R_bins.detach()
            angles = torch.stack([torch.argmax(bins[:, :360], dim=1) - 180,
                                  torch.argmax(bins[:, 360:540], dim=1) - 90,
                                  torch.argmax(bins[:, 540:], dim=1) - 180], dim=1)
            R = euler_xyz_to_matrix(angles.float())
            if not self.separate_scale:
                return R, out[:, 900:].reshape(B, 1, 3), aux
            t_sph_phi = out[:, 900:1260]
            t_sph_theta = out[:, 1260:1440]
            scale = torch.abs(out[:, -1:])
            aux["t_sph_phi"] = t_sph_phi
            aux["t_sph_theta"] = t_sph_theta
            aux["scale"] = scale.reshape(B, 1, 1)
            phi = torch.deg2rad(torch.argmax(t_sph_phi.detach(), dim=1).float())
            theta = torch.deg2rad(torch.argmax(t_sph_theta.detach(), dim=1).float())
            t = scale * torch.stack([torch.cos(phi) * torch.sin(theta),
                                     torch.sin(phi) * torch.sin(theta),
                                     torch.cos(theta)], dim=1)
            return R, t.reshape(B, 1, 3), aux


def build_head(cfg, in_channels: int, feature_hw: tuple) -> nn.Module:
    """String-dispatch on cfg.HEAD.TYPE, with the reference head names."""
    h = cfg.HEAD
    t = h.TYPE
    common = dict(batch_norm=bool(h.BATCH_NORM), avg_pool=bool(h.AVG_POOL))
    if t in ("ProcrustesResBlockMLP", "ProcrustesDeepResBlock"):
        return ProcrustesHead(
            in_channels, feature_hw, num_pts=h.NUM_PTS, add_basis=bool(h.ADD_BASIS),
            deep=t == "ProcrustesDeepResBlock", **common)
    if t == "QuatDeepResBlock":
        return QuatHead(in_channels, feature_hw, separate_scale=bool(h.SEPARATE_SCALE),
                        **common)
    if t in ("DirectResBlockMLP", "DirectDeepResBlockMLP"):
        return DirectHead(in_channels, feature_hw, deep=t == "DirectDeepResBlockMLP",
                          **common)
    if t == "AngularBinsDeepResBlockMLP":
        return AngularBinsHead(in_channels, feature_hw,
                               separate_scale=bool(h.SEPARATE_SCALE), **common)
    raise NotImplementedError(f"Invalid head {t}")

