"""Batched exact 2-NN descriptor matching with Lowe's ratio test (port of
mapfree_tpu/ops/matching.py; it replaces the reference's FLANN KD-tree
matcher, lib/models/matching/feature_matching.py:87-102).

For a few thousand descriptors the exact [N0, N1] distance matrix is one
batched matrix product, and ``torch.topk(..., largest=False)`` takes the two
nearest per row. It runs on the tensors' device under
``models/builder.py::tf32_off``: the squared distance ``|a|^2 - 2 a.b +
|b|^2`` cancels, and TF32's ten-bit mantissa in the product would move it by
far more than the ratio test's margins.
"""

from __future__ import annotations

import torch

from mapfree_tpu_torch.geom.smallblas import tf32_off

BIG = 1e12  # the squared distance of a masked descriptor of view 1


def mutual_2nn_ratio_match(desc0, desc1, mask0, mask1, ratio_threshold):
    """Lowe-ratio matching of L2-normalised-ish descriptors.

    Args:
        desc0: [B, N0, D]; desc1: [B, N1, D] float32.
        mask0: [B, N0]; mask1: [B, N1] validity (bool).
        ratio_threshold: Lowe ratio (match if d1 < ratio * d2).
    Returns:
        idx1: [B, N0] int64, the best match in view 1 of each view-0
        descriptor;
        match_mask: [B, N0] True where the ratio test passes and both
        descriptors are valid.
    """
    with torch.no_grad(), tf32_off():
        sq0 = torch.sum(desc0 * desc0, dim=-1)[..., :, None]  # [B, N0, 1]
        sq1 = torch.sum(desc1 * desc1, dim=-1)[..., None, :]  # [B, 1, N1]
        cross = torch.bmm(desc0, desc1.transpose(1, 2))
        d2 = sq0 - 2.0 * cross + sq1  # [B, N0, N1]
        d2 = torch.where(mask1[:, None, :], d2, torch.full_like(d2, BIG))
        # the two smallest distances per row, in ascending order
        top2, idx_top2 = torch.topk(d2, 2, dim=-1, largest=False, sorted=True)
        idx1 = idx_top2[..., 0]
        # Lowe's ratio on distances (not squared): d1 < ratio * d2
        d_first = torch.sqrt(torch.clamp(top2[..., 0], min=0.0))
        d_second = torch.sqrt(torch.clamp(top2[..., 1], min=0.0))
        ok = (d_first < ratio_threshold * d_second) & mask0 & (d_first < 1e5)
    return idx1, ok
