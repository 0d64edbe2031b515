"""On-device image format ops (port of mapfree_tpu/ops/image.py).

:func:`yuv420_to_rgb` unpacks the loader's planar YUV420 batches into [0, 1]
RGB on the device: 4:2:0 chroma halves the host->device bytes of a uint8 RGB
batch. The chroma upsample uses the same half-pixel-centre interpolation
matrices as the JAX package (two small matmuls), and the colour matrix is
libjpeg's JFIF full-range YCbCr->RGB.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _interp_matrix_halfpix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] linear-interpolation matrix with half-pixel-centre sampling
    (cv2.resize INTER_LINEAR convention; for 2x chroma upsampling this is the
    triangle filter libjpeg's fancy h2v2 upsampler applies). Two nonzeros per
    row. Cached per shape; callers must not write to the result."""
    src = (np.arange(out_size, dtype=np.float32) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m


def yuv420_to_rgb(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Planar YUV420 uint8 [..., H*3/2, W] -> RGB [..., H, W, 3] in [0, 1].

    Layout: rows 0..H are the Y plane; the bottom H/2 rows hold the
    quarter-resolution chroma side by side (U in columns 0..W/2, V in the
    rest). The arithmetic runs in float32 with autocast off; the result is
    cast to ``dtype``.
    """
    *lead, H15, W = packed.shape
    H = (H15 * 2) // 3
    dev = packed.device
    with torch.autocast(dev.type, enabled=False):
        flat = packed.reshape(-1, H15, W)
        y = flat[:, :H, :].float()
        uv = flat[:, H:, :].float() - 128.0
        u, v = uv[:, :, : W // 2], uv[:, :, W // 2:]

        mh = torch.from_numpy(_interp_matrix_halfpix(H // 2, H)).to(dev)
        mw = torch.from_numpy(_interp_matrix_halfpix(W // 2, W)).to(dev)

        def up2(c):
            c = torch.matmul(mh, c)                   # [N, H, W/2]
            return torch.matmul(c, mw.transpose(0, 1))  # [N, H, W]

        u, v = up2(u), up2(v)
        r = y + 1.402 * v
        g = y - 0.344136286 * u - 0.714136286 * v
        b = y + 1.772 * u
        rgb = torch.stack([r, g, b], dim=-1) * (1.0 / 255.0)
        rgb = torch.clamp(rgb, 0.0, 1.0).to(dtype)
    return rgb.reshape(tuple(lead) + (H, W, 3))


def yuv420_pack_host(rgb01: np.ndarray) -> np.ndarray:
    """Host packer: RGB float [0,1] [N, H, W, 3] -> planar YUV420 uint8
    [N, H*3/2, W] (JFIF forward matrix + 2x2 box chroma)."""
    x = rgb01.astype(np.float32) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    n, h, w = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 requires even dims, got {h}x{w}")

    def box2(c):
        return c.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))

    out = np.empty((n, h + h // 2, w), np.uint8)
    out[:, :h, :] = np.clip(y + 0.5, 0, 255).astype(np.uint8)
    out[:, h:, : w // 2] = np.clip(box2(cb) + 0.5, 0, 255).astype(np.uint8)
    out[:, h:, w // 2:] = np.clip(box2(cr) + 0.5, 0, 255).astype(np.uint8)
    return out
