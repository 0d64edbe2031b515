"""On-device SIFT: a DoG scale-space detector with oriented 128-D
descriptors (port of mapfree_tpu/ops/sift.py).

A batched, fixed-shape stand-in for OpenCV's SIFT (reference
lib/models/matching/feature_matching.py:58,81-82): the Gaussian and DoG
pyramid as separable convolutions, 3x3x3 extrema by max-pooling, the
contrast and edge tests, a per-octave and a global top-K, quadratic
sub-pixel refinement, one dominant orientation and a 4x4x8 descriptor from
bilinear gathers. Every image yields exactly ``num_features`` keypoints
(ranked by score; surplus slots masked), so the matcher and the solvers see
static shapes. Not keypoint-for-keypoint OpenCV's, but descriptors of the
same family.

Where the JAX function ``vmap``s over images and keypoints, this one carries
explicit leading dimensions: the gathers index a flattened [B, S*H*W] stack
with one [B, K * samples] index tensor.

Choices that differ from a straight transcription, and why:
- The 36-bin orientation histogram and the 128-bin descriptor are not
  scatter-adds (``scatter_add_`` on CUDA sums with atomics, in no fixed
  order, and the histogram's argmax would then flip between runs on near
  ties). Each bin is a masked sum over a fixed axis instead: 36 sums over a
  keypoint's 256 samples for the histogram; for the descriptor, the 16
  samples of each of the 16 spatial cells (a cell is fixed by a sample's
  grid position, not by the data) summed per orientation bin, 8 sums. The
  card then gives the same bits on every run, and memory stays at a few
  [B, K, 256] tensors.
- TF32 is off for the block (``models/builder.py::tf32_off``): cuDNN's
  float32 convolutions default to TF32, and a 1e-3 change in a blurred
  image moves the extrema.
- ``torch.topk`` orders tied scores differently from ``lax.top_k``: masked
  slots (score 0 per octave, -1 globally) hold other points than the JAX
  function's. Only the valid slots carry meaning; the matcher masks the
  rest.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mapfree_tpu_torch.geom.smallblas import tf32_off

_CONTRAST_THR = 0.015
_EDGE_RATIO = 10.0
_NUM_SCALES = 3  # scales searched per octave
_SIGMA0 = 1.6
_BORDER = 8  # pixels of each octave image where no extremum is taken
_R = 8  # half-size of the 16x16 sampling grid, in grid steps


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur(img, sigma: float):
    """Separable Gaussian blur with zero padding, [B, H, W] float32."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = _gaussian_kernel1d(sigma, radius, img.device)
    out = F.conv2d(img[:, None], k.view(1, 1, -1, 1), padding=(radius, 0))
    out = F.conv2d(out, k.view(1, 1, 1, -1), padding=(0, radius))
    return out[:, 0]


def _octave_responses(gray, num_octaves: int):
    """Per-octave stacks: a list of (dogs [B, S+2, H, W], gauss [B, S+3, H,
    W], scale_factor)."""
    k = 2.0 ** (1.0 / _NUM_SCALES)
    out = []
    base = _blur(gray, _SIGMA0)
    scale_factor = 1.0
    for _ in range(num_octaves):
        gs = [base]
        sigma_prev = _SIGMA0
        for s in range(1, _NUM_SCALES + 3):
            sigma_total = _SIGMA0 * (k ** s)
            sigma_inc = math.sqrt(max(sigma_total ** 2 - sigma_prev ** 2, 0.01))
            gs.append(_blur(gs[-1], sigma_inc))
            sigma_prev = sigma_total
        gauss = torch.stack(gs, dim=1)  # [B, S+3, H, W]
        dogs = gauss[:, 1:] - gauss[:, :-1]  # [B, S+2, H, W]
        out.append((dogs, gauss, scale_factor))
        base = gs[_NUM_SCALES][:, ::2, ::2]
        scale_factor *= 2.0
    return out


def _extrema_scores(dogs):
    """Scale-space extremum response per (scale, y, x) of the searchable
    scales: dogs [B, S+2, H, W] -> scores [B, S, H, W] (0 where no extremum
    or rejected by the contrast or edge test).

    The 3x3x3 window pads every axis, the scale axis too (``lax.reduce_window``
    with -inf / +inf padding): ``max_pool3d`` with padding 1, and the minimum
    as the max-pool of the negation. The Hessian's neighbours wrap around
    the image (``jnp.roll``); the border mask removes those positions."""
    H, W = dogs.shape[-2:]
    center = dogs
    mx = F.max_pool3d(dogs[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-dogs[:, None], 3, stride=1, padding=1)[:, 0]
    is_ext = (center >= mx) | (center <= mn)
    is_ext &= torch.abs(center) > _CONTRAST_THR

    # edge rejection: 2x2 spatial Hessian ratio
    def roll(t, dy, dx):
        return torch.roll(t, (dy, dx), dims=(2, 3))

    dxx = roll(center, 0, -1) + roll(center, 0, 1) - 2 * center
    dyy = roll(center, -1, 0) + roll(center, 1, 0) - 2 * center
    dxy = 0.25 * (roll(center, -1, -1) - roll(center, -1, 1)
                  - roll(center, 1, -1) + roll(center, 1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = _EDGE_RATIO
    is_ext &= (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    scores = torch.where(is_ext, torch.abs(center), torch.zeros_like(center))
    scores = scores[:, 1:_NUM_SCALES + 1]  # scales with both neighbours
    mask = torch.zeros((H, W), dtype=scores.dtype, device=scores.device)
    mask[_BORDER:H - _BORDER, _BORDER:W - _BORDER] = 1.0
    return scores * mask


def _bilinear_gather(flat, plane, hw, y, x):
    """Sample image planes at float coordinates, clamped to the border.

    flat: [B, P * H * W] (P planes of H x W per image); plane: [B, K] the
    plane of each keypoint; y, x: [B, K, M] coordinates -> [B, K, M]."""
    H, W = hw
    B = flat.shape[0]
    y = torch.clamp(y, 0.0, H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = y - y0
    fx = x - x0
    base = (plane * (H * W))[..., None] + y0.long() * W + x0.long()

    def at(offset):
        return torch.gather(flat, 1, (base + offset).reshape(B, -1)).reshape(base.shape)

    v00, v01, v10, v11 = at(0), at(1), at(W), at(W + 1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _grid(device):
    """The 16x16 sampling grid's offsets (oy, ox), each [256] in row-major
    order, and their Gaussian weights."""
    offs = torch.arange(-_R, _R, dtype=torch.float32, device=device) + 0.5
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    oy, ox = oy.reshape(-1), ox.reshape(-1)
    w_gauss = torch.exp(-(oy ** 2 + ox ** 2) / (2 * (_R / 2) ** 2))
    return oy, ox, w_gauss


def _gradients(flat, plane, hw, y, x):
    """Central differences of bilinear samples: (gx, gy), each [B, K, M]."""
    gx = (_bilinear_gather(flat, plane, hw, y, x + 1)
          - _bilinear_gather(flat, plane, hw, y, x - 1)) * 0.5
    gy = (_bilinear_gather(flat, plane, hw, y + 1, x)
          - _bilinear_gather(flat, plane, hw, y - 1, x)) * 0.5
    return gx, gy


def _orientation_and_descriptor(gauss_flat, plane, hw, y, x, scale_px):
    """Dominant orientation and 128-D descriptor of every keypoint.

    gauss_flat: [B, P * H * W] the octave's Gaussian stack; plane [B, K] the
    keypoint's scale plane; y, x, scale_px: [B, K] (octave pixels).
    Returns (theta [B, K], desc [B, K, 128])."""
    oy, ox, w_gauss = _grid(y.device)
    step = (scale_px / 2.0)[..., None]  # [B, K, 1]
    y_, x_ = y[..., None], x[..., None]

    # orientation: a 36-bin histogram of gradients over the grid
    gx, gy = _gradients(gauss_flat, plane, hw, y_ + oy * step, x_ + ox * step)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    bins36 = torch.floor((ang + math.pi) / (2 * math.pi) * 36).long() % 36
    weight = mag * w_gauss
    hist = torch.stack([torch.where(bins36 == b, weight, 0.0).sum(-1) for b in range(36)], -1)
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    theta = (torch.argmax(hist, dim=-1).float() + 0.5) / 36.0 * 2 * math.pi - math.pi

    # descriptor: the grid rotated by theta -> 4x4 cells x 8 orientation bins
    cos_t, sin_t = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    ry = oy * step
    rx = ox * step
    gxs, gys = _gradients(gauss_flat, plane, hw, y_ + (sin_t * rx + cos_t * ry),
                          x_ + (cos_t * rx - sin_t * ry))
    mag_d = torch.sqrt(gxs * gxs + gys * gys + 1e-12) * w_gauss
    ang_d = torch.atan2(gys, gxs) - theta[..., None]  # rotation-invariant
    obin = torch.floor((ang_d + 3 * math.pi) / (2 * math.pi) * 8).long() % 8

    # the grid's 16x16 samples by cell: [B, K, cell_y, row, cell_x, col] ->
    # [B, K, 16 cells, 16 samples]; cell (cy, cx) holds rows 4cy..4cy+3 and
    # columns 4cx..4cx+3, which is where (o + R) / (2R / 4) puts them
    B, K = y.shape

    def by_cell(t):
        return t.reshape(B, K, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5).reshape(B, K, 16, 16)

    mag_c, obin_c = by_cell(mag_d), by_cell(obin)
    desc = torch.stack([torch.where(obin_c == o, mag_c, 0.0).sum(-1) for o in range(8)], -1)
    desc = desc.reshape(B, K, 128)  # (cell * 8 + orientation bin)

    # normalise, clip, renormalise (the standard illumination robustness)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    return theta, desc


def _refine(dog_flat, plane, hw, y, x):
    """Quadratic sub-pixel refinement in space on the extremum's DoG plane:
    y, x [B, K] integer positions -> refined (y, x), each offset by at most
    half a pixel."""
    def d(dy, dx):
        return _bilinear_gather(dog_flat, plane, hw, (y + dy)[..., None],
                                (x + dx)[..., None])[..., 0]

    d00 = d(0, 0)
    dxx = d(0, 1) + d(0, -1) - 2 * d00
    dyy = d(1, 0) + d(-1, 0) - 2 * d00
    gx = (d(0, 1) - d(0, -1)) * 0.5
    gy = (d(1, 0) - d(-1, 0)) * 0.5
    big = torch.full_like(dxx, 1e9)
    off_x = torch.clamp(-gx / torch.where(torch.abs(dxx) > 1e-9, dxx, big), -0.5, 0.5)
    off_y = torch.clamp(-gy / torch.where(torch.abs(dyy) > 1e-9, dyy, big), -0.5, 0.5)
    return y + off_y, x + off_x


def sift_detect_describe(gray, num_features: int = 2048, num_octaves: int = 4):
    """Batched SIFT over grayscale images.

    Args:
        gray: [B, H, W] float32 in [0, 1], on any device.
        num_features: fixed keypoint budget per image.
        num_octaves: scale-space octaves.
    Returns a dict of:
        keypoints [B, K, 2] (x, y) in input pixels;
        descriptors [B, K, 128] (L2-normalised, before rootSIFT);
        scores [B, K]; mask [B, K] validity.
    """
    with torch.no_grad(), tf32_off():
        return _sift(gray, num_features, num_octaves)


def _sift(gray, num_features, num_octaves):
    B = gray.shape[0]
    per_oct = num_features // num_octaves + 8
    all_xy, all_scores, all_desc, all_valid = [], [], [], []
    for dogs, gauss, sf in _octave_responses(gray, num_octaves):
        scores = _extrema_scores(dogs)  # [B, S, h, w]
        _, S, h, w = scores.shape
        top_scores, top_idx = torch.topk(scores.reshape(B, -1), per_oct, dim=-1)
        s_idx = top_idx // (h * w)
        yx = top_idx % (h * w)
        y_i = (yx // w).float()
        x_i = (yx % w).float()
        plane = s_idx + 1  # the extremum's centre scale, in dogs and gauss alike

        yr, xr = _refine(dogs.reshape(B, -1), plane, (h, w), y_i, x_i)
        scale_px = _SIGMA0 * torch.pow(2.0, (s_idx.float() + 1.0) / _NUM_SCALES)
        _, desc = _orientation_and_descriptor(gauss.reshape(B, -1), plane, (h, w), yr, xr,
                                              scale_px)
        all_xy.append(torch.stack([xr * sf, yr * sf], dim=-1))  # (x, y) input pixels
        all_scores.append(top_scores)
        all_desc.append(desc)
        all_valid.append(top_scores > 0.0)

    xy = torch.cat(all_xy, dim=1)
    scores = torch.cat(all_scores, dim=1)
    desc = torch.cat(all_desc, dim=1)
    valid = torch.cat(all_valid, dim=1)

    # the global top-K across octaves
    masked_scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    top_scores, sel = torch.topk(masked_scores, num_features, dim=-1)
    xy = torch.gather(xy, 1, sel[..., None].expand(-1, -1, 2))
    desc = torch.gather(desc, 1, sel[..., None].expand(-1, -1, desc.shape[-1]))
    return {
        "keypoints": xy,
        "descriptors": desc,
        "scores": torch.clamp(top_scores, min=0.0),
        "mask": top_scores > 0.0,
    }


def root_sift(desc):
    """Hellinger-kernel normalisation (reference feature_matching.py:67-73)."""
    desc = desc / (torch.sum(desc, dim=-1, keepdim=True) + 1e-7)
    return torch.sqrt(desc)


def rgb_to_gray(images):
    """[B, H, W, 3] uint8 (or float in [0, 1]) RGB -> [B, H, W] float32 gray
    in [0, 1] (the JAX TPUSIFTMatching's weights, 0.299, 0.587, 0.114)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=images.device)
    scale = 1.0 / 255.0 if images.dtype == torch.uint8 else 1.0
    with tf32_off():
        return (images.float() * scale) @ w
