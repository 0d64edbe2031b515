"""Differentiable batched Kabsch/Procrustes alignment.

The port of mapfree_tpu/geom/procrustes.py (reference lib/utils/solver.py:4-37),
used by the Procrustes regression heads. It runs in float32 with autocast
off; the caller keeps TF32 off for matmuls (``torch.backends.cuda.matmul.
allow_tf32 = False``, PyTorch's default), since 3x3 rotation algebra under
TF32's 10-bit mantissa loses whole degrees.

Two routes compute the same float32 arithmetic (:func:`procrustes_route`
picks by what the inputs show): the tensor version :func:`procrustes_plain`,
on the CPU and wherever autograd records (a training step, whose backward
goes through it), and on CUDA otherwise the hand-written kernel
``ops/csrc/kabsch.cu`` (its wrapper and launch counter are
``ops/kabsch.py``), one launch in place of the tensor version's ~1,090 tiny
ones. A call routed to the kernel launches it or raises.
"""

from __future__ import annotations

import torch

from mapfree_tpu_torch.geom.smallblas import det3, svd3

ROUTE_KERNEL = "kernel"
ROUTE_TENSOR = "tensor"


def procrustes_route(A, B, weights=None) -> str:
    """``ROUTE_KERNEL`` for CUDA inputs of which autograd records nothing
    (no gradient enabled, or no input that requires one), else
    ``ROUTE_TENSOR``."""
    if A.device.type != "cuda":
        return ROUTE_TENSOR
    inputs = (A, B) if weights is None else (A, B, weights)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return ROUTE_TENSOR
    return ROUTE_KERNEL


def procrustes(A, B, weights=None):
    """Find R, t minimising || (A @ R^T + t) - B || over rigid transforms.

    Args:
        A: [B, N, 3] source points.
        B: [B, N, 3] target points.
        weights: optional [B, N] non-negative weights (e.g. inlier mask).
    Returns:
        R: [B, 3, 3]; t: [B, 1, 3], with B ≈ A @ R^T + t.
    """
    if procrustes_route(A, B, weights) == ROUTE_KERNEL:
        # imported here: the ops package imports this module (pnp, procrustes_ransac)
        from mapfree_tpu_torch.ops.kabsch import procrustes_cuda

        return procrustes_cuda(A.float().contiguous(), B.float().contiguous(),
                               None if weights is None else weights.float().contiguous())
    return procrustes_plain(A, B, weights)


def procrustes_plain(A, B, weights=None):
    """:func:`procrustes` as tensor arithmetic on any device, differentiable:
    the CPU route, the route where autograd records, and the kernel's
    yardstick on the card."""
    with torch.autocast(A.device.type, enabled=False):
        A = A.float()
        B = B.float()
        if weights is None:
            a_mean = A.mean(dim=1, keepdim=True)
            b_mean = B.mean(dim=1, keepdim=True)
            A_c = A - a_mean
        else:
            w = weights.float()[..., None]  # [B, N, 1]
            wsum = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
            a_mean = (A * w).sum(dim=1, keepdim=True) / wsum
            b_mean = (B * w).sum(dim=1, keepdim=True) / wsum
            A_c = (A - a_mean) * w
        B_c = B - b_mean
        H = A_c.transpose(-1, -2) @ B_c

        U, S, Vt = svd3(H)
        V = Vt.transpose(-1, -2)
        det = det3(U @ Vt)
        # fix orientation so det(R) = +1: R = V @ diag(1, 1, sign) @ U^T
        sign = torch.sign(det)[..., None, None]  # [B, 1, 1]
        V_fixed = torch.cat([V[..., :2], V[..., 2:] * sign], dim=-1)
        R = V_fixed @ U.transpose(-1, -2)
        t = b_mean - a_mean @ R.transpose(-1, -2)
    return R, t
