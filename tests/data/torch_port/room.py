"""A textured room at known camera poses, and ScanNet and 7Scenes trees of
it: the scene that the ScanNet fixtures (``scannet_{0..3}.jpg``, written by
``make_fixtures.py scannet``) show, which the port's evaluation tests and
``chip_smoke.py`` phase 14 render again at any size with its depth.

Needs numpy, the standard library (the PNG and PGM files are encoded here
with ``zlib``: the machine with the card has no image library) and the
port's intrinsics rescale and ``mat2quat``. Colour frames come from a
caller's writer (a JPEG needs cv2, or is a copy of a committed fixture).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from mapfree_tpu_torch.geom.projection import correct_intrinsic_scale
from mapfree_tpu_torch.geom.quaternion import mat2quat

# the textured room the ScanNet fixtures show: planes n . X = c in world
# metres (y points down, the cameras look along +z), each with the bounds
# (on the two in-plane axes) it is cut to, or None for a whole plane
ROOM = (
    ((0.0, 0.0, 1.0), 4.0, None),              # back wall
    ((0.0, 1.0, 0.0), 1.3, None),              # floor
    ((0.0, 1.0, 0.0), -1.6, None),             # ceiling
    ((1.0, 0.0, 0.0), -2.2, None),             # left wall
    ((1.0, 0.0, 0.0), 2.4, None),              # right wall
    ((0.0, 0.0, 1.0), 2.5, ((-1.0, 0.2), (-0.6, 0.7))),  # a panel in front
    ((0.6, 0.0, 0.8), 2.9, ((-0.2, 0.9), (-1.0, 0.2))),  # a slanted panel
)
SCANNET_W, SCANNET_H = 1296, 968
SCANNET_K = np.array([[1165.0, 0.0, 647.5], [0.0, 1165.0, 483.5], [0.0, 0.0, 1.0]])
SCANNET_VIEWS = 4


def _plane_axes(n):
    n = np.asarray(n, np.float64) / np.linalg.norm(n)
    a = np.cross(n, [0.0, 1.0, 0.0] if abs(n[1]) < 0.9 else [1.0, 0.0, 0.0])
    a /= np.linalg.norm(a)
    return n, a, np.cross(n, a)


def _value_noise(a, b, table, cell):
    """Bilinear value noise: ``table`` [T, T] of random values at the
    corners of square cells of ``cell`` metres, repeated with period T."""
    T = table.shape[0]
    u, v = a / cell, b / cell
    i, j = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    fu, fv = u - i, v - j
    fu, fv = fu * fu * (3 - 2 * fu), fv * fv * (3 - 2 * fv)  # smoothstep
    t = lambda di, dj: table[(i + di) % T, (j + dj) % T]
    return ((t(0, 0) * (1 - fu) + t(1, 0) * fu) * (1 - fv)
            + (t(0, 1) * (1 - fu) + t(1, 1) * fu) * fv)


def render_view(K, R_c2w, C, width: int, height: int, seed: int = 0):
    """The textured room seen by a pinhole camera (intrinsics K, camera-to-
    world rotation R_c2w, centre C; pixel centres at integer coordinates):
    RGB uint8 [height, width, 3] and the depth along the optical axis in
    metres, float32 [height, width]. Each plane carries value noise at four
    scales (20 cm down to 2.5 cm) per channel, from ``seed``."""
    rng = np.random.default_rng(seed)
    tables = [[[rng.uniform(-1, 1, (128, 128)) for _ in range(4)] for _ in range(3)]
              for _ in ROOM]
    base = [rng.uniform(60, 190, 3) for _ in ROOM]
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    rays = np.stack([u, v, np.ones_like(u)], -1).reshape(-1, 3) @ np.linalg.inv(K).T
    d = rays @ np.asarray(R_c2w, np.float64).T  # world directions, camera z = 1
    C = np.asarray(C, np.float64)
    best = np.full(len(d), np.inf)
    which = np.full(len(d), -1)
    for p, (n, c, bounds) in enumerate(ROOM):
        n, ax, bx = _plane_axes(n)
        c = c / np.linalg.norm(ROOM[p][0])
        denom = d @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (c - C @ n) / denom
        ok = np.isfinite(t) & (t > 0.05)
        if bounds is not None:
            X = C + t[:, None] * d
            (a0, a1), (b0, b1) = bounds
            a, b = X @ ax, X @ bx
            ok &= (a >= a0) & (a <= a1) & (b >= b0) & (b <= b1)
        closer = ok & (t < best)
        best[closer] = t[closer]
        which[closer] = p
    if (which < 0).any():
        raise ValueError("a ray leaves the room")
    X = C + best[:, None] * d
    rgb = np.zeros((len(d), 3))
    for p, (n, _, _) in enumerate(ROOM):
        sel = which == p
        _, ax, bx = _plane_axes(n)
        a, b = X[sel] @ ax, X[sel] @ bx
        for ch in range(3):
            val = base[p][ch] + sum(
                amp * _value_noise(a, b, tables[p][ch][o], cell)
                for o, (amp, cell) in enumerate(((55, 0.2), (40, 0.1), (30, 0.05), (22, 0.025))))
            rgb[sel, ch] = val
    rgb = np.clip(rgb + 0.5, 0, 255).astype(np.uint8).reshape(height, width, 3)
    return rgb, best.reshape(height, width).astype(np.float32)


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def scannet_views(n: int = SCANNET_VIEWS, seed: int = 7) -> list:
    """Camera-to-world poses (R, C) of ``n`` views of the room: centres
    within 25 cm of the origin, rotations of 3-8 degrees."""
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(n):
        R = _rotation(rng.normal(size=3), np.radians(rng.uniform(3, 8)))
        views.append((R, rng.uniform(-0.25, 0.25, 3)))
    return views




# -- encoders -------------------------------------------------------------------

def png_bytes(image: np.ndarray) -> bytes:
    """A PNG of uint8 RGB [H, W, 3] or uint16 gray [H, W] (filter type 0)."""
    if image.dtype == np.uint16 and image.ndim == 2:
        H, W = image.shape
        rows, depth, colour = image.astype(">u2").view(np.uint8).reshape(H, 2 * W), 16, 0
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        H, W = image.shape[:2]
        rows, depth, colour = image.reshape(H, 3 * W), 8, 2
    else:
        raise ValueError(f"png_bytes takes uint8 RGB or uint16 gray, got {image.dtype} "
                         f"{image.shape}")
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def pgm16_bytes(image: np.ndarray) -> bytes:
    """A 16-bit binary PGM (P5, maxval 65535) of uint16 [H, W], laid out as
    cv2.imwrite writes one."""
    H, W = image.shape
    return f"P5\n{W} {H}\n65535\n".encode() + image.astype(">u2").tobytes()


def depth_mm(depth_m: np.ndarray) -> np.ndarray:
    return np.round(np.clip(depth_m, 0, 65.535) * 1000.0).astype(np.uint16)


def _w2c(R_c2w, C):
    """World-to-camera (R, t) of a camera-to-world rotation and centre."""
    R = np.asarray(R_c2w).T
    return R, -R @ np.asarray(C)


# -- trees -------------------------------------------------------------------------

def correspondences(depth0, depth1, K, T, n_points: int) -> np.ndarray:
    """Up to ``n_points`` pixels of view 0 on a grid, moved into view 1 by
    the relative pose T [4, 4] (X1 = R X0 + t) with view 0's depth, where
    they land inside view 1 unoccluded (view 1's depth agrees within 5%):
    [N, 4] rows (x0, y0, x1, y1)."""
    H, W = depth0.shape
    gv, gu = np.mgrid[4:H - 4:max(1, H // 32), 4:W - 4:max(1, W // 32)]
    uv0 = np.stack([gu.reshape(-1), gv.reshape(-1)], -1).astype(np.float64)
    z0 = depth0[uv0[:, 1].astype(int), uv0[:, 0].astype(int)]
    X1 = (np.concatenate([uv0, np.ones((len(uv0), 1))], 1) @ np.linalg.inv(K).T * z0[:, None]) \
        @ T[:3, :3].T + T[:3, 3]
    uv1 = X1 @ np.asarray(K).T
    uv1 = uv1[:, :2] / uv1[:, 2:]
    ok = (X1[:, 2] > 0.1) & (uv1[:, 0] >= 0) & (uv1[:, 0] <= W - 1) & (uv1[:, 1] >= 0) \
        & (uv1[:, 1] <= H - 1)
    seen = np.zeros(len(ok))
    seen[ok] = depth1[np.round(uv1[ok, 1]).astype(int), np.round(uv1[ok, 0]).astype(int)]
    ok &= np.abs(seen - X1[:, 2]) < 0.05 * X1[:, 2]
    sel = np.nonzero(ok)[0][:n_points]
    return np.concatenate([uv0[sel], uv1[sel]], 1)


def nan_padded(rows: list) -> np.ndarray:
    """[Ni, 4] arrays -> the NaN-padded [N, max Ni, 4] float32 table of the
    ``Precomputed`` correspondence source."""
    out = np.full((len(rows), max(len(r) for r in rows), 4), np.nan, np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def write_scannet_room(root, W: int, H: int, frames: list, pairs: list, write_color,
                       scene: str = "scene0000_00", matches_file=None,
                       n_points: int = 512) -> dict:
    """A ScanNet test split (``scans_test/<scene>/sensor_data`` and the index
    ``indices/test/pairs.npz``) of the room. ``frames[k]`` is the view (an
    index into :func:`scannet_views`) of frame k; ``write_color(k, path)``
    writes its colour JPEG. Depth ``.pgm`` maps are rendered at W x H (the
    dataset's resize) with the colour intrinsics scaled to that size, poses
    are camera-to-world, ``_info.txt`` holds the 1296x968 intrinsics.
    ``pairs`` are (k0, k1) frame pairs, in index order. With
    ``matches_file``, the pairs' correspondences from the known geometry
    (:func:`correspondences`) go there as one NaN-padded table, the layout
    of the ScanNet configs' precomputed files. Returns {pair index: the
    true relative pose T_0to1 [4, 4]}."""
    root = Path(root)
    sensor = root / "scans_test" / scene / "sensor_data"
    sensor.mkdir(parents=True)
    K = correct_intrinsic_scale(SCANNET_K, W / SCANNET_W, H / SCANNET_H)
    views = scannet_views(max(frames) + 1)
    maps = {v: depth_mm(render_view(K, *views[v], W, H)[1]) for v in sorted(set(frames))}
    depth = {v: pgm16_bytes(m) for v, m in maps.items()}
    K4 = np.eye(4)
    K4[:3, :3] = SCANNET_K
    flat = " ".join(str(v) for v in K4.reshape(-1))
    (sensor / "_info.txt").write_text(f"m_calibrationColorIntrinsic = {flat}\n"
                                      f"m_calibrationDepthIntrinsic = {flat}\n")
    w2c = []
    for k, v in enumerate(frames):
        write_color(k, sensor / f"frame-{k:06}.color.jpg")
        (sensor / f"frame-{k:06}.depth.pgm").write_bytes(depth[v])
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = views[v]
        np.savetxt(sensor / f"frame-{k:06}.pose.txt", c2w, delimiter=" ")
        w2c.append(np.linalg.inv(c2w))
    index = root / "indices" / "test"
    index.mkdir(parents=True)
    sc = int(scene[5:9]), int(scene[10:12])
    np.savez(index / "pairs.npz", name=np.array([(*sc, a, b) for a, b in pairs]),
             score=np.full(len(pairs), 0.5))
    truth = {i: w2c[b] @ np.linalg.inv(w2c[a]) for i, (a, b) in enumerate(pairs)}
    if matches_file is not None:
        metres = {v: m.astype(np.float64) / 1000.0 for v, m in maps.items()}
        np.savez(matches_file, correspondences=nan_padded([
            correspondences(metres[frames[a]], metres[frames[b]], K, truth[i], n_points)
            for i, (a, b) in enumerate(pairs)]))
    return truth


SEVENSCENES_K = np.array([[525.0, 0.0, 320.0], [0.0, 525.0, 240.0], [0.0, 0.0, 1.0]])


def write_7scenes_room(root, scene: str, W: int, H: int, n_refs: int, n_queries: int,
                       pairs_txt: str, depth_suffix: str, n_points: int = 512) -> dict:
    """A 7Scenes scene of the room: PNG colour frames and 16-bit depth
    (``.depth.<depth_suffix>.png``) rendered at W x H, absolute poses in
    ``dataset_{train,test}.txt`` (reference frames train, queries test), a
    pair file ``pairs_txt`` of every (reference, query) with its relative
    pose and a similarity, and ``correspondences_SIFT_<pairs_txt>.npz``: per
    pair up to ``n_points`` reference pixels on a grid, moved into the query
    by the known geometry (visible and unoccluded there), NaN-padded.
    Returns {(reference, query): the true relative pose T [4, 4]}."""
    sdir = Path(root) / scene
    (sdir / "seq-01").mkdir(parents=True)
    K = correct_intrinsic_scale(SEVENSCENES_K, W / 640, H / 480)
    views = scannet_views(n_refs + n_queries, seed=11)
    names = [f"seq-01/frame-{i:06}" for i in range(n_refs)] + \
            [f"seq-01/frame-{100 + i:06}" for i in range(n_queries)]
    depths, poses = {}, {}
    for name, (R, C) in zip(names, views):
        rgb, d = render_view(K, R, C, W, H)
        depths[name] = depth_mm(d).astype(np.float64) / 1000.0  # what the reader gives
        (sdir / f"{name}.color.png").write_bytes(png_bytes(rgb))
        (sdir / f"{name}.depth.{depth_suffix}.png").write_bytes(png_bytes(depth_mm(d)))
        poses[name] = _w2c(R, C)
    for fname, part in (("dataset_train.txt", names[:n_refs]), ("dataset_test.txt", names[n_refs:])):
        lines = ["header"] * 3 + [
            f"{n}.color.png " + " ".join(f"{v:.9f}" for v in (*views[names.index(n)][1],
                                                               *mat2quat(poses[n][0])))
            for n in part]
        (sdir / fname).write_text("\n".join(lines) + "\n")
    lines, table, truth = [], [], {}
    for qn in names[n_refs:]:
        for i, rn in enumerate(names[:n_refs]):
            (R_r, t_r), (R_q, t_q) = poses[rn], poses[qn]
            T = np.eye(4)
            T[:3, :3] = R_q @ R_r.T
            T[:3, 3] = t_q - T[:3, :3] @ t_r
            truth[(f"{rn}.color.png", f"{qn}.color.png")] = T
            lines.append(f"{rn}.color.png {qn}.color.png {1.0 - 0.1 * i:.4f} "
                         + " ".join(f"{v:.9f}" for v in (*mat2quat(T[:3, :3]), *T[:3, 3])))
            table.append(correspondences(depths[rn], depths[qn], K, T, n_points))
    (sdir / pairs_txt).write_text("\n".join(lines) + "\n")
    np.savez(sdir / f"correspondences_SIFT_{pairs_txt}.npz", correspondences=nan_padded(table))
    return truth
