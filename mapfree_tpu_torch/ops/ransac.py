"""Fixed-shape batched RANSAC building blocks (port of mapfree_tpu/ops/ransac.py).

A fixed hypothesis budget evaluated as one batched program per batch of
pairs: sample -> minimal solve -> score every correspondence -> argmin.
Padded correspondences carry a validity mask end to end, so no shape depends
on the data.

Every solver draws its minimal samples through a *sampler*: a callable
``sampler(tag, mask, n_iters, sample_size) -> [B, n_iters, sample_size]``
int64 indices into the N axis of ``mask`` [B, N]. ``tag`` names the draw
(``"essential8"``, ``"essential5"``, ``"homography"``, ``"pnp"``,
``"procrustes"``; the adaptive essential ladder prefixes ``"tier1/"`` and
``"tier2/"``). :class:`GeneratorSampler`, the default, draws with a
``torch.Generator`` on the solve's device; a test hands the solvers the JAX
package's own draws instead, which is what makes a whole solver comparable.
"""

from __future__ import annotations

import torch

CHUNK = 256  # rows of the [rows, N] uniform draw made at once


def masked_sample_indices(generator, mask, n_iters: int, sample_size: int):
    """Draw minimal-set indices restricted to valid correspondences.

    ``mask``: [..., N] bool. Returns [..., n_iters, sample_size] int64. The
    top-k of iid uniform keys over the valid points is a uniformly random
    distinct subset. When fewer than ``sample_size`` points are valid the
    picks that fall on invalid slots are remapped to the first valid index
    (the caller's minimum-count gate rejects such pairs).
    """
    lead = mask.shape[:-1]
    N = mask.shape[-1]

    def draw(rows):
        u = torch.rand(lead + (rows, N), generator=generator, device=mask.device)
        u = torch.where(mask[..., None, :], u, -1.0)
        return torch.topk(u, sample_size, dim=-1).indices

    if n_iters > CHUNK and n_iters % CHUNK == 0:
        # bound the [rows, N] transient: at n_iters = 2,048, N = 2,048 and
        # B = 64 the flat draw would be a 1 GB tensor for 8 B of output a row
        idx = torch.cat([draw(CHUNK) for _ in range(n_iters // CHUNK)], dim=-2)
    else:
        idx = draw(n_iters)
    first_valid = torch.argmax(mask.to(torch.uint8), dim=-1)[..., None, None]
    ok = torch.gather(mask[..., None, :].expand(idx.shape[:-1] + (N,)), -1, idx)
    return torch.where(ok, idx, first_valid)


class GeneratorSampler:
    """The default sampler: every draw from one ``torch.Generator`` on the
    solve's device, seeded by the caller."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, tag, mask, n_iters: int, sample_size: int):
        return masked_sample_indices(self.generator, mask, n_iters, sample_size)


def device_sampler(device, seed: int) -> GeneratorSampler:
    return GeneratorSampler(torch.Generator(device=device).manual_seed(int(seed)))


class PrefixedSampler:
    """Passes draws on to ``sampler`` with ``prefix`` before their tag."""

    def __init__(self, sampler, prefix: str):
        self.sampler = sampler
        self.prefix = prefix

    def __call__(self, tag, mask, n_iters: int, sample_size: int):
        return self.sampler(self.prefix + tag, mask, n_iters, sample_size)


def _per_row(thr_sq):
    """A threshold per row of residuals [..., M]: a tensor gains the M axis,
    a Python number broadcasts as it is."""
    return thr_sq[..., None] if isinstance(thr_sq, torch.Tensor) else thr_sq


def msac_score(residual_sq, mask, thr_sq):
    """Truncated-quadratic (MSAC) score over the last axis, lower is better;
    ``thr_sq`` broadcasts against ``residual_sq.shape[:-1]``. Invalid entries
    contribute the truncation constant."""
    t = _per_row(thr_sq)
    capped = torch.where(mask, torch.clamp(residual_sq, max=t), t)
    return torch.sum(capped, dim=-1)


def magsac_score(residual_sq, mask, thr_sq, n_sigmas: int = 5):
    """Sigma-marginalised robust score (MAGSAC-style), lower is better: the
    truncated quadratic averaged over the scales s_k = 4 thr^2 / 4^k, each
    normalised to [0, 1] per point (the ladder reaches one step above the
    threshold)."""
    total = 0.0
    for k in range(n_sigmas):
        s = 4.0 * thr_sq / (4.0 ** k)
        t = _per_row(s)
        capped = torch.where(mask, torch.clamp(residual_sq, max=t), t)
        total = total + torch.sum(capped, dim=-1) / s
    return total / n_sigmas


def inlier_mask(residual_sq, mask, thr_sq):
    return mask & (residual_sq < _per_row(thr_sq))


def best_hypothesis(scores):
    """argmin over the hypothesis axis (the first of equal scores)."""
    return torch.argmin(scores, dim=-1)


def take_points(x, idx):
    """Rows of ``x`` [B, N, ...] at ``idx`` [B, ...] -> [B, ..., ...]."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    rest = x.shape[2:]
    ind = flat.reshape(flat.shape + (1,) * len(rest)).expand(flat.shape + rest)
    return torch.gather(x, 1, ind).reshape(idx.shape + rest)


def pick(x, idx):
    """``x[..., idx, ...]`` per leading element: x [*L, K, *rest], idx [*L]."""
    d = idx.dim()
    ind = idx.reshape(idx.shape + (1,) * (x.dim() - d)).expand(idx.shape + (1,) + x.shape[d + 1:])
    return torch.gather(x, d, ind).squeeze(d)
