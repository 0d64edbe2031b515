"""Loss registry for relative pose regression (port of mapfree_tpu/losses.py;
reference lib/utils/loss.py:10-240).

Each loss is a function ``loss(preds, batch) -> scalar tensor`` where

- ``preds``: {'R': [B,3,3], 't': [B,1,3], plus head aux entries}
- ``batch``: {'T_0to1': [B,4,4], ...}

registered by the reference's names, so the YAML configs work unchanged.
The heads' aux entries feed the quaternion (``q``), scale and direction
(``scale``, ``t_direction``) and bin losses (``R_bins``, ``t_sph_phi``,
``t_sph_theta``); their ground truth (the quaternion's hemisphere, the
Euler-angle and spherical-angle bin targets) is derived from ``T_0to1`` on
the device, where the reference used host scipy.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from mapfree_tpu_torch.geom.quaternion import mat2quat_torch
from mapfree_tpu_torch.geom.rotation import matrix_to_euler_xyz

LOSSES: Dict[str, Callable] = {}


def register(fn):
    LOSSES[fn.__name__] = fn
    return fn


def get_loss(name: str) -> Callable:
    if name not in LOSSES:
        raise NotImplementedError(f"Invalid loss {name}")
    return LOSSES[name]


def _gt(batch):
    T = batch["T_0to1"]
    return T[:, :3, :3], T[:, :3, 3:].transpose(1, 2)  # [B, 3, 3], [B, 1, 3]


def _trace(m):
    return m.diagonal(dim1=-2, dim2=-1).sum(dim=-1)


# ---------------------------------------------------------------- rotation --

@register
def rot_frobenius_loss(preds, batch):
    """MSE between residual rotation and identity (reference loss.py:79-92)."""
    Rgt, _ = _gt(batch)
    R = preds["R"]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    residual = Rgt.transpose(1, 2) @ R
    return torch.mean((residual - eye) ** 2)


@register
def rot_l1_loss(preds, batch):
    Rgt, _ = _gt(batch)
    R = preds["R"]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    residual = Rgt.transpose(1, 2) @ R
    return torch.mean(torch.abs(residual - eye))


@register
def rot_angle_loss(preds, batch):
    """L1 of residual rotation angle in radians (reference loss.py:111-127)."""
    Rgt, _ = _gt(batch)
    residual = preds["R"].transpose(1, 2) @ Rgt
    cosine = torch.clamp((_trace(residual) - 1) / 2, -0.99999, 0.99999)
    return torch.mean(torch.abs(torch.acos(cosine)))


def _bin_ce(logits, labels):
    """Mean cross-entropy of ``logits`` [B, n] at integer ``labels`` [B]."""
    logp = F.log_softmax(logits, dim=1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


@register
def rot_bin_loss(preds, batch):
    """Cross-entropy over Euler-angle bins (reference loss.py:130-135; the
    targets as loss.py:45-56 derives them): the ground truth's extrinsic xyz
    angles in degrees, offset by (180, 90, 180), rounded half to even and
    clipped to the 360, 180 and 360 bins."""
    Rgt, _ = _gt(batch)
    R_bins = preds["R_bins"]
    angles = matrix_to_euler_xyz(Rgt)
    offset = torch.tensor([180.0, 90.0, 180.0], dtype=angles.dtype, device=angles.device)
    target = torch.round(angles + offset).long()
    tx = torch.clamp(target[:, 0], 0, 359)
    ty = torch.clamp(target[:, 1], 0, 179)
    tz = torch.clamp(target[:, 2], 0, 359)
    return (_bin_ce(R_bins[:, :360], tx) + _bin_ce(R_bins[:, 360:540], ty)
            + _bin_ce(R_bins[:, 540:], tz)) / 3


@register
def quat_l1_loss(preds, batch):
    Rgt, _ = _gt(batch)
    return torch.mean(torch.abs(preds["q"] - mat2quat_torch(Rgt)))  # qgt has w >= 0


@register
def robust_quat_l1_loss(preds, batch):
    """min(||q + qgt||, ||q - qgt||) averaged (reference loss.py:173-191)."""
    Rgt, _ = _gt(batch)
    qgt = mat2quat_torch(Rgt)
    q = preds["q"]
    return torch.mean(torch.minimum(torch.linalg.norm(q + qgt, dim=1),
                                    torch.linalg.norm(q - qgt, dim=1)))


# ------------------------------------------------------------- translation --

@register
def trans_l2_loss(preds, batch):
    _, tgt = _gt(batch)
    return torch.mean((preds["t"] - tgt) ** 2)


@register
def trans_l1_loss(preds, batch):
    _, tgt = _gt(batch)
    return torch.mean(torch.abs(preds["t"] - tgt))


@register
def trans_ang_loss(preds, batch):
    """L1 of translation angular error, symmetric about pi/2
    (reference loss.py:206-222)."""
    _, tgt = _gt(batch)
    t = preds["t"]
    scale_t = torch.linalg.norm(t, dim=-1)
    scale_tgt = torch.linalg.norm(tgt, dim=-1)
    cosine = torch.sum(t * tgt, dim=-1) / (scale_t * scale_tgt + 1e-6)
    cosine = torch.clamp(cosine, -0.99999, 0.99999)
    ang = torch.acos(cosine)
    ang = torch.minimum(ang, math.pi - ang)
    return torch.mean(torch.abs(ang))


@register
def trans_scale_direction_loss(preds, batch):
    """L1 scale + L1 unit direction (reference loss.py:194-203)."""
    _, tgt = _gt(batch)
    norm = torch.linalg.norm(tgt, dim=-1, keepdim=True)  # [B, 1, 1]
    dirgt = tgt / torch.clamp(norm, min=1e-12)
    return (torch.mean(torch.abs(preds["scale"] - norm))
            + torch.mean(torch.abs(preds["t_direction"] - dirgt)))


@register
def trans_scale_l1_loss(preds, batch):
    _, tgt = _gt(batch)
    return torch.mean(torch.abs(preds["scale"] - torch.linalg.norm(tgt, dim=-1, keepdim=True)))


@register
def trans_sphbin_loss(preds, batch):
    """Scale L1 + cross-entropy over spherical-angle bins (reference
    loss.py:226-230; the targets as loss.py:59-71 derives them): theta in
    [0, 179] and phi in [0, 359] degrees, rounded half to even, 360 wrapping
    to 0."""
    _, tgt = _gt(batch)
    scalegt = torch.linalg.norm(tgt, dim=-1, keepdim=True)
    dirgt = (tgt / torch.clamp(scalegt, min=1e-12)).reshape(-1, 3)
    theta_gt = torch.arccos(torch.clamp(dirgt[:, 2], -1.0, 1.0))
    phi_gt = torch.atan2(dirgt[:, 1], dirgt[:, 0] + 1e-5)
    phi_gt = torch.where(phi_gt < 0, phi_gt + 2 * math.pi, phi_gt)
    theta_bin = torch.clamp(torch.round(torch.rad2deg(theta_gt)).long(), 0, 179)
    phi_bin = torch.round(torch.rad2deg(phi_gt)).long()
    phi_bin = torch.where(phi_bin == 360, torch.zeros_like(phi_bin), phi_bin)
    lscale = torch.mean(torch.abs(preds["scale"].reshape(-1) - scalegt.reshape(-1)))
    return lscale + (_bin_ce(preds["t_sph_phi"], phi_bin)
                     + _bin_ce(preds["t_sph_theta"], theta_bin)) / 2


@register
def empty_loss(preds, batch):
    return torch.zeros((), dtype=torch.float32, device=preds["R"].device)


def combined_loss(preds, batch, rot_loss_name, trans_loss_name, lam,
                  s_r=None, s_t=None):
    """Total loss with fixed LAMBDA weighting or Kendall & Cipolla learnable
    weighting when LAMBDA == 0 (reference model.py:75-85)."""
    R_loss = get_loss(rot_loss_name)(preds, batch)
    t_loss = get_loss(trans_loss_name)(preds, batch)
    if lam == 0.0:
        loss = R_loss * torch.exp(-s_r) + t_loss * torch.exp(-s_t) + s_r + s_t
        loss = loss.reshape(())
    else:
        loss = R_loss + lam * t_loss
    return R_loss, t_loss, loss
