"""Shared pieces of the PyTorch port's RANSAC parity tests: the JAX package's
own minimal samples handed to the port's solvers, and synthetic pairs.

The port's solvers draw their minimal samples through a sampler
(mapfree_tpu_torch/ops/ransac.py). :class:`JaxSampler` answers each draw
with the indices the JAX function draws from its key, reproducing the JAX
package's key splits:
- essential_pose: split(key, B) per pair, then (k_e, k_h) = split(pair key),
  (k8, k5) = split(k_e) (mapfree_tpu/ops/essential.py:745,748,603-604);
  the homography's draw takes k_h (estimate_homography, :533);
- the adaptive ladder: (k1, k2) = split(key); tier 1 solves with k1, tier 2
  with k2 over its gathered sub-batch;
- pnp_pose and procrustes_pose: split(key, B), one draw per pair key
  (ops/pnp.py:341,344; ops/procrustes_ransac.py:140).
threefry cannot be reproduced in torch; nothing else makes a whole solver
comparable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mapfree_tpu.ops.ransac import masked_sample_indices

_draw = jax.jit(jax.vmap(masked_sample_indices, in_axes=(0, 0, None, None)),
                static_argnums=(2, 3))


def pair_keys(key, tag: str, B: int):
    """Per-pair keys of one draw, as the JAX solver derives them."""
    if tag.startswith("tier"):
        k1, k2 = jax.random.split(key)
        key = k1 if tag.startswith("tier1/") else k2
        tag = tag.split("/", 1)[1]
    keys = jax.random.split(key, B)
    if tag in ("essential8", "essential5", "homography"):
        k_e, k_h = jax.vmap(jax.random.split, out_axes=1)(keys)
        if tag == "homography":
            return k_h
        k8, k5 = jax.vmap(jax.random.split, out_axes=1)(k_e)
        return k8 if tag == "essential8" else k5
    if tag in ("pnp", "procrustes"):
        return keys
    raise ValueError(f"unknown draw {tag!r}")


class JaxSampler:
    """The port's sampler interface, answered with the JAX package's draws
    from ``key`` (a jax PRNG key, or the raw uint32[2] the matching model
    uses: [0, step])."""

    def __init__(self, key):
        self.key = jnp.asarray(key, jnp.uint32)
        self.tags = []

    def __call__(self, tag, mask, n_iters, sample_size):
        self.tags.append(tag)
        m = jnp.asarray(mask.cpu().numpy())
        idx = _draw(pair_keys(self.key, tag, m.shape[0]), m, n_iters, sample_size)
        return torch.as_tensor(np.asarray(idx), dtype=torch.long).to(mask.device)


def step_sampler(step):
    """The draws of the JAX matching model's batch ``step`` (its key is the
    raw [0, step], mapfree_tpu/models/matching.py:305-306)."""
    return JaxSampler(np.asarray([0, step], np.uint32))


IMG_H, IMG_W = 120, 160
K = np.array([[120.0, 0, 80], [0, 120.0, 60], [0, 0, 1]], np.float32)


def rotation(gen, max_angle=0.5):
    axis = gen.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = gen.uniform(max_angle / 2, max_angle)
    w, (x, y, z) = np.cos(angle / 2), axis * np.sin(angle / 2)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def project(P):
    uv = P @ K.T
    return uv[:, :2] / uv[:, 2:]


def synth_pairs(B, n_points=96, n_outliers=0, noise=0.0, seed=0, pad=0):
    """B two-view pairs of random 3D scenes: (k0, k1, mask [B, N], R, t, X)
    with N = n_points + pad (padded rows invalid), float32 pixels."""
    gen = np.random.default_rng(seed)
    out = {k: [] for k in ("k0", "k1", "mask", "R", "t", "X")}
    for _ in range(B):
        R = rotation(gen)
        t = gen.normal(size=3)
        t = t / np.linalg.norm(t) * gen.uniform(0.5, 2.0)
        X = np.stack([gen.uniform(-2, 2, n_points), gen.uniform(-1.5, 1.5, n_points),
                      gen.uniform(3, 8, n_points)], axis=-1)
        k0 = project(X) + gen.normal(size=(n_points, 2)) * noise
        k1 = project(X @ R.T + t) + gen.normal(size=(n_points, 2)) * noise
        if n_outliers:
            idx = gen.choice(n_points, n_outliers, replace=False)
            k1[idx] = gen.uniform(0, [IMG_W, IMG_H], size=(n_outliers, 2))
        mask = np.ones(n_points + pad, bool)
        mask[n_points:] = False
        zpad = np.zeros((pad, 2))
        out["k0"].append(np.concatenate([k0, zpad]))
        out["k1"].append(np.concatenate([k1, zpad]))
        out["mask"].append(mask)
        out["R"].append(R)
        out["t"].append(t)
        out["X"].append(X)
    out = {k: np.stack(v) for k, v in out.items()}
    for k in ("k0", "k1", "R", "t", "X"):
        out[k] = out[k].astype(np.float32)
    return out


def depth_maps(pairs):
    """Depth maps [B, H, W] of both views holding each scene point's depth at
    its pixel (zero elsewhere)."""
    B = pairs["X"].shape[0]
    d0 = np.zeros((B, IMG_H, IMG_W), np.float32)
    d1 = np.zeros((B, IMG_H, IMG_W), np.float32)
    for b in range(B):
        X = pairs["X"][b]
        for P, depth in ((X, d0[b]), (X @ pairs["R"][b].T + pairs["t"][b], d1[b])):
            uv = project(P)
            ui = np.clip(uv[:, 0].astype(int), 0, IMG_W - 1)
            vi = np.clip(uv[:, 1].astype(int), 0, IMG_H - 1)
            depth[vi, ui] = P[:, 2]
    return d0, d1


def rot_err_deg(R_est, R_gt):
    c = (np.trace(R_est.T @ R_gt) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def rot_diff_rad(Ra, Rb):
    """Angle [B] between two batches of rotations, in radians."""
    c = (np.einsum("bij,bij->b", Ra.astype(np.float64), Rb.astype(np.float64)) - 1) / 2
    return np.arccos(np.clip(c, -1, 1))
