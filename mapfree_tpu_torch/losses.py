"""Loss registry for relative pose regression (port of mapfree_tpu/losses.py;
reference lib/utils/loss.py:10-240).

Each loss is a function ``loss(preds, batch) -> scalar tensor`` where

- ``preds``: {'R': [B,3,3], 't': [B,1,3], plus head aux entries}
- ``batch``: {'T_0to1': [B,4,4], ...}

registered by the reference's names, so the YAML configs work unchanged.
This slice ports every loss whose inputs the ported (Procrustes) heads
produce. The quaternion, bin and scale/direction losses need heads and
``geom/rotation.py`` that are not ported; asking for one raises.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

LOSSES: Dict[str, Callable] = {}

# registered in the JAX package, not ported yet: they come with the slice of
# the remaining RPR variants (quaternion, direct and angular-bin heads)
_LATER_SLICE = (
    "rot_bin_loss", "quat_l1_loss", "robust_quat_l1_loss",
    "trans_scale_direction_loss", "trans_scale_l1_loss", "trans_sphbin_loss",
)


def register(fn):
    LOSSES[fn.__name__] = fn
    return fn


def get_loss(name: str) -> Callable:
    if name in _LATER_SLICE:
        raise NotImplementedError(
            f"loss {name} is not ported yet: it comes with the slice that ports the "
            "remaining RPR variants")
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
