"""The one traffic generator: a mix's data file (``perfbench/traffic/<mix>.json``)
gives its parameters, the configuration its shapes, ``--seed`` its draw.

The batches follow the layouts of the repository's smoke test
(``chip_smoke.py::synthetic_batches`` and ``window_batches``), frozen here:
planar YUV420 pairs sharing 1 or 2 reference frames (alternating by batch),
and RGB windows of a reference and F query frames with unit-quaternion
device poses. The pixels
are uniform noise drawn on the device in one call and copied to host memory,
the poses are drawn on the host; every seed gives the same shapes. A
window's device poses follow a trajectory (a random walk from a random
start) as a phone's tracking does, where the smoke test draws each frame's
pose independently: with nine unrelated rotations the fusion's chordal mean
is ill-conditioned.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness.weights import SEED_MODULUS


def _unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw],
                    axis=-1)


def _trajectory(rng, B: int, F: int, step_deg: float, step_m: float) -> tuple:
    """Device-tracking poses of B windows of F consecutive frames, as a
    phone's tracking gives them: a random start, then a random walk of
    ``step_deg`` degrees and ``step_m`` metres (standard deviations) a
    frame. Returns w2c quaternions [B, F, 4] and camera centres [B, F, 3]."""
    rotvec = np.cumsum(rng.normal(scale=np.radians(step_deg), size=(B, F, 3)), axis=1)
    angle = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    axis = rotvec / np.maximum(angle, 1e-12)
    dq = np.concatenate([np.cos(angle / 2), axis * np.sin(angle / 2)], axis=-1)
    q = _quat_mul(dq, _unit_quats(rng, (B,))[:, None])
    c = rng.normal(size=(B, 1, 3)) + np.cumsum(rng.normal(scale=step_m, size=(B, F, 3)), axis=1)
    return q, c


def _pixels(n_bytes: int, seed: int, device) -> np.ndarray:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MODULUS)
    return torch.randint(0, 256, (n_bytes,), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()


def batch_shapes(shape: dict, mix: dict, i: int) -> dict:
    """The uint8 pixel arrays of pool batch ``i``: {key: shape}. ``shape``
    holds the configuration's ``H``, ``W``, ``batch`` and ``frames`` (0 for
    the two-view model)."""
    H, W, B, F = shape["H"], shape["W"], shape["batch"], shape["frames"]
    if F:
        return {"image0": (B, H, W, 3), "image1": (B, F, H, W, 3)}
    U = mix["unique_refs_cycle"][i % len(mix["unique_refs_cycle"])]
    return {"image0_unique": (U, H * 3 // 2, W), "image1": (B, H * 3 // 2, W)}


def pool_size(shape: dict, mix: dict) -> int:
    """Batches in the pool: ``pool_batches``, fewer where ``pool_bytes``
    would be passed."""
    per = max(sum(int(np.prod(s)) for s in batch_shapes(shape, mix, i).values())
              for i in range(len(mix.get("unique_refs_cycle", [0]))))
    return max(1, min(int(mix["pool_batches"]), int(mix["pool_bytes"]) // per))


def make_pool(shape: dict, mix: dict, seed: int, device) -> list:
    """The host pool of collated numpy batches that the window cycles
    through, drawn from ``seed``: pixels on ``device`` in one call, poses
    and reference indices on the host."""
    n = pool_size(shape, mix)
    layouts = [batch_shapes(shape, mix, i) for i in range(n)]
    total = sum(int(np.prod(s)) for lay in layouts for s in lay.values())
    pixels = _pixels(total, seed, device)
    rng = np.random.default_rng(int(seed) % SEED_MODULUS)
    B, F = shape["batch"], shape["frames"]
    pool, at = [], 0
    for lay in layouts:
        batch = {}
        for key, s in lay.items():
            size = int(np.prod(s))
            batch[key] = pixels[at:at + size].reshape(s)
            at += size
        if "image0_unique" in batch:
            U = batch["image0_unique"].shape[0]
            ref_idx = np.sort(rng.integers(0, U, B)).astype(np.int32)
            ref_idx[0], ref_idx[-1] = 0, U - 1
            batch["ref_idx"] = ref_idx
        if F:
            q, c = _trajectory(rng, B, F, float(mix["device_step_deg"]), float(mix["device_step_m"]))
            batch["abs_q_1_w2c_device"], batch["abs_c_1_c2w_device"] = q, c
        pool.append(batch)
    return pool


def with_names(batch: dict, seq: int, frames: int) -> dict:
    """A pool batch as the sweep's loader yields it: the same arrays under
    fresh names, scene ``<seq>_<ref>`` (``<seq>`` for a window) and query
    ``<row>``, so that every pose the sweep returns maps back to its batch
    and row."""
    B = batch["image1"].shape[0]
    if frames:
        scenes = [f"{seq}"] * B
        names = [("ref", tuple(f"{f}" for f in range(frames - 1)) + (f"{r}",))
                 for r in range(B)]
    else:
        scenes = [f"{seq}_{r}" for r in batch["ref_idx"]]
        names = [("ref", f"{r}") for r in range(B)]
    return dict(batch, scene_id=scenes, pair_names=names)
