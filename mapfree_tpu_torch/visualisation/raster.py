"""Z-buffered software renderer for scene visualisation (port of
mapfree_tpu/visualisation/raster.py).

The same visual vocabulary as the JAX package's numpy renderer (solid shaded
camera-frustum meshes, image-textured frustum planes, trajectory cuboids, a
checkerboard ground grid, position markers) with the pixel work on a torch
device. Each triangle's setup (projection, near-plane cull, bounding box,
signed area, headlight Lambert factor) is the numpy code of the JAX package,
run on the host; the z-buffer fill runs on the render device in float64, as
the numpy version does, over the triangles of a draw call in chunks:

1. every pixel centre of every triangle's clipped bounding box is one
   fragment; its barycentric weights, inside test and perspective-correct
   depth are the numpy expressions, operation for operation;
2. per pixel, the least (depth, triangle index) among the chunk's inside
   fragments wins, and it is written where its depth is strictly below the
   running buffer's.

The numpy loop overwrites only where a fragment is strictly nearer than the
buffer, so a pixel ends with the first-drawn triangle among those at its
least depth: the per-chunk lexicographic minimum merged with the same strict
``<`` gives that pixel the same triangle, and the same bytes. The mesh
library below is host numpy, the port's own copy.
"""

from __future__ import annotations

import numpy as np
import torch

from mapfree_tpu_torch.models.builder import resolve_device

# fragments (bounding-box pixels) per chunk of a draw call: the chunk's
# float64 temporaries take about 200 bytes a fragment
FRAGMENT_BUDGET = 1 << 21


# ----------------------------------------------------------------- camera ---


def look_at(eye, center, up=(0.0, -1.0, 0.0)):
    """World->view rotation/translation for an observer at ``eye`` looking at
    ``center`` (OpenCV convention: +z forward, +y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(center, np.float64) - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    upv = -np.asarray(up, np.float64)
    right = np.cross(upv, fwd)
    if np.linalg.norm(right) < 1e-9:  # up parallel to fwd: pick any right
        right = np.cross(np.array([1.0, 0.0, 0.0]), fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows = view axes
    t = -R @ eye
    return R, t


def _linear_axis(src: int, dst: int):
    """cv2 INTER_LINEAR along one axis: each output's two source taps and
    weights (half-pixel centres, the edge taps clamped with weight 0 beyond
    them, no antialias)."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f)
    w = f - i0
    i0 = i0.astype(np.int64)
    w[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    last = i0 >= src - 1
    w[last] = 0.0
    i0[last] = src - 1
    return i0, np.minimum(i0 + 1, src - 1), 1.0 - w, w


def resize_linear(image: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """uint8 [h, w, 3] -> uint8 [height, width, 3]: cv2.resize's INTER_LINEAR
    in float64, rounded half up (cv2 rounds its 11-bit fixed-point weights,
    so the two agree within one level)."""
    h, w = image.shape[:2]
    dev = image.device
    x0, x1, ax, bx = (torch.from_numpy(a).to(dev) for a in _linear_axis(w, width))
    y0, y1, ay, by = (torch.from_numpy(a).to(dev) for a in _linear_axis(h, height))
    src = image.double()
    rows = src[y0] * ay[:, None, None] + src[y1] * by[:, None, None]
    out = rows[:, x0] * ax[None, :, None] + rows[:, x1] * bx[None, :, None]
    return torch.floor(out + 0.5).clamp_(0, 255).to(torch.uint8)


# -------------------------------------------------------------- rasterizer --


class Rasterizer:
    """Perspective rasterizer with z-buffer, flat triangles and textures,
    drawing into tensors on ``device`` (``color`` uint8 [H, W, 3],
    ``depth`` float64 [H, W])."""

    def __init__(self, width=960, height=720, fov_deg=55.0,
                 background=(12, 12, 16), device="cuda"):
        self.device = resolve_device(device)
        self.W, self.H = int(width), int(height)
        f = 0.5 * self.W / np.tan(np.radians(fov_deg) / 2)
        self.K = np.array([[f, 0, self.W / 2], [0, f, self.H / 2], [0, 0, 1.0]])
        self.background = np.asarray(background, np.uint8)
        self.near = 0.05
        self.clear()

    def clear(self):
        n = self.H * self.W
        # one spare row past the image: fragments that do not win are
        # written there, so the writes need no boolean indexing (a sync)
        self._rgb = torch.from_numpy(self.background).to(self.device).repeat(n + 1, 1)
        self._z = torch.full((n + 1,), float("inf"), dtype=torch.float64,
                             device=self.device)

    @property
    def color(self) -> torch.Tensor:
        return self._rgb[:-1].view(self.H, self.W, 3)

    @property
    def depth(self) -> torch.Tensor:
        return self._z[:-1].view(self.H, self.W)

    def set_view(self, eye, center, up=(0.0, -1.0, 0.0)):
        self.Rv, self.tv = look_at(eye, center, up)

    # -- low level ------------------------------------------------------

    def _project(self, pts_world):
        """[N, 3] world -> ([N, 2] pixels, [N] view depth)."""
        pv = pts_world @ self.Rv.T + self.tv
        z = pv[:, 2]
        uvw = pv @ self.K.T
        uv = uvw[:, :2] / np.maximum(z[:, None], 1e-9)
        return uv, z

    def _setup(self, tri, shade):
        """The numpy renderer's per-triangle setup, or None where it draws
        nothing: (x0, y0, x1, y1, [pix, z, area, Lambert factor])."""
        pix, z = self._project(tri)
        if np.any(z <= self.near):  # cheap clip: drop near-plane crossers
            return None
        x0 = max(int(np.floor(pix[:, 0].min())), 0)
        x1 = min(int(np.ceil(pix[:, 0].max())) + 1, self.W)
        y0 = max(int(np.floor(pix[:, 1].min())), 0)
        y1 = min(int(np.ceil(pix[:, 1].max())) + 1, self.H)
        if x0 >= x1 or y0 >= y1:
            return None
        a, b, c = pix
        area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(area) < 1e-9:
            return None
        lam = 1.0
        if shade:
            e0, e1 = tri[1] - tri[0], tri[2] - tri[0]
            n = np.cross(e0, e1)
            n = n / (np.linalg.norm(n) + 1e-12)
            view_dir = self.Rv[2]  # headlight along the view axis
            lam = 0.55 + 0.45 * abs(float(n @ view_dir))
        return x0, y0, x1, y1, [*pix.reshape(-1), *z, area, lam]

    def draw_triangles(self, tris, colors, shade=True, texture=None,
                       uvs=None):
        """Rasterise triangles with the z-buffer, in order.

        Args:
            tris: [N, 3, 3] world-space vertices.
            colors: [N, 3] face colors (ignored where textured).
            shade: headlight Lambert shading on face normals.
            texture: optional [h, w, 3] uint8 image (numpy or a tensor); uvs
                [N, 3, 2] in [0, 1] map triangle corners into it (affine
                approximation, which is exact for the fronto-rendered image
                planes used here).
        """
        tris = np.asarray(tris, np.float64)
        colors = np.asarray(colors)
        textured = texture is not None and uvs is not None
        rows = []  # one row per triangle that draws: see _fill
        for i in range(len(tris)):
            setup = self._setup(tris[i], shade)
            if setup is None:
                continue
            x0, y0, x1, y1, values = setup
            extra = (np.asarray(uvs[i], np.float64).reshape(-1) if textured
                     else np.asarray(colors[i], np.float64))
            rows.append([(x1 - x0) * (y1 - y0), x0, y0, x1 - x0, i, *values, *extra])
        if not rows:
            return
        tex = torch.as_tensor(texture, device=self.device) if textured else None
        start, total = 0, 0
        for k, row in enumerate(rows):
            if total and total + row[0] > FRAGMENT_BUDGET:
                self._fill(np.asarray(rows[start:k], np.float64), total, shade, tex)
                start, total = k, 0
            total += row[0]
        self._fill(np.asarray(rows[start:], np.float64), total, shade, tex)

    def _fill(self, table, n_frags, shade, tex):
        """The z-buffer fill of a chunk of set-up triangles, in draw order.
        ``table`` holds a row per triangle (float64; the integers are exact):
        its bounding box's pixel count, x0, y0 and width, its index in the
        draw call, its three pixel positions, three view depths, signed area
        and Lambert factor, then its six uv coordinates (``tex`` given) or
        its colour; ``n_frags`` is the chunk's bounding-box pixels in all."""
        dev = self.device
        table = torch.from_numpy(table)
        if dev.type == "cuda":  # one copy, no wait for the device
            table = table.pin_memory().to(dev, non_blocking=True)
        ints = table[:, :5].long()
        counts, order = ints[:, 0], ints[:, 4]
        starts = torch.cumsum(counts, 0) - counts
        tri = torch.repeat_interleave(torch.arange(len(table), device=dev), counts,
                                      output_size=n_frags)
        local = torch.arange(n_frags, device=dev) - starts[tri]
        bw = ints[tri, 3]
        px = ints[tri, 1] + local % bw
        py = ints[tri, 2] + local // bw
        xs = px.double() + 0.5
        ys = py.double() + 0.5
        v = table[tri, 5:]
        a0, a1, b0, b1, c0, c1, z0, z1, z2, area, lam = v[:, :11].unbind(1)

        w0 = ((b0 - xs) * (c1 - ys) - (b1 - ys) * (c0 - xs)) / area
        w1 = ((c0 - xs) * (a1 - ys) - (c1 - ys) * (a0 - xs)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        # perspective-correct depth via 1/z interpolation
        invz = w0 / z0 + w1 / z1 + w2 / z2
        zpix = 1.0 / torch.clamp(invz, min=1e-12)

        # per pixel: the least depth among the chunk's inside fragments, and
        # among the fragments at that depth the first-drawn triangle; it
        # wins where it is strictly nearer than the buffer
        n_pix = self.H * self.W
        pid = py * self.W + px
        key = torch.where(inside, zpix, float("inf"))
        zmin = torch.full((n_pix,), float("inf"), dtype=torch.float64, device=dev)
        zmin.scatter_reduce_(0, pid, key, "amin")
        cand = inside & (key == zmin[pid])
        drawn = order[tri]
        late = 1 << 62  # after every triangle
        first = torch.full((n_pix,), late, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, pid, torch.where(cand, drawn, late), "amin")
        win = cand & (drawn == first[pid]) & (key < self._z[pid])

        if tex is not None:
            th, tw = tex.shape[:2]
            uv = v[:, 11:]
            u = w0 * uv[:, 0] + w1 * uv[:, 2] + w2 * uv[:, 4]
            t = w0 * uv[:, 1] + w1 * uv[:, 3] + w2 * uv[:, 5]
            # truncation toward zero, then the clip (clamping first keeps
            # the cast in range for fragments outside the triangle)
            ti = torch.clamp(t * (th - 1), -1, th).long().clamp_(0, th - 1)
            tj = torch.clamp(u * (tw - 1), -1, tw).long().clamp_(0, tw - 1)
            rgb = tex.reshape(-1, 3)[ti * tw + tj].double()
        else:
            rgb = v[:, 11:14]
        if shade:
            rgb = rgb * lam[:, None]

        dest = torch.where(win, pid, n_pix)  # the others go to the spare row
        self._rgb.index_put_((dest,), torch.clamp(rgb, 0, 255).to(torch.uint8))
        self._z.index_put_((dest,), zpix)

    def blend_overlay(self, image, corner="tr", frac=0.28, border=2):
        """Picture-in-picture blend of ``image`` (the reference blends the
        query photo over the render, render_scene.py:172-192), resized as
        cv2's INTER_LINEAR does (:func:`resize_linear`)."""
        h = int(self.H * frac)
        w = int(round(h * image.shape[1] / image.shape[0]))
        small = resize_linear(torch.as_tensor(image, device=self.device), w, h)
        y0 = border
        x0 = self.W - w - border if corner.endswith("r") else border
        self.color[y0:y0 + h, x0:x0 + w] = small
        return self


# ------------------------------------------------------------ mesh library --

_FRUSTUM_FACES = [(0, 1, 2), (0, 2, 3), (0, 3, 4), (0, 4, 1)]


def frustum_corners(R_c2w, c, size=0.25, aspect=0.75):
    """Apex + 4 image-plane corners in world coordinates (apex first).
    Corner order: (-w,-h), (w,-h), (w,h), (-w,h) in camera axes."""
    w = size
    h = size * aspect
    z = size * 1.2
    local = np.array(
        [[0, 0, 0], [-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z]], np.float64)
    return local @ np.asarray(R_c2w, np.float64).T + np.asarray(c, np.float64)


def frustum_mesh(R_c2w, c, color, size=0.25, aspect=0.75):
    """Solid frustum side faces: ([4, 3, 3] tris, [4, 3] colors)."""
    p = frustum_corners(R_c2w, c, size, aspect)
    tris = np.stack([p[list(f)] for f in _FRUSTUM_FACES])
    colors = np.tile(np.asarray(color, np.float64), (len(tris), 1))
    return tris, colors


def frustum_image_plane(R_c2w, c, size=0.25, aspect=0.75):
    """Two triangles spanning the frustum's image plane with uv coords —
    carries the query photo like the reference's get_image_box
    (render_util.py:32-105)."""
    p = frustum_corners(R_c2w, c, size, aspect)
    tris = np.stack([p[[1, 2, 3]], p[[1, 3, 4]]])
    # image v runs top->bottom: camera -h (top of image) -> v=0
    uv = np.array([
        [[0, 0], [1, 0], [1, 1]],
        [[0, 0], [1, 1], [0, 1]],
    ], np.float64)
    return tris, uv


def cuboid_from_line(p0, p1, color, thickness=0.01):
    """Axis-aligned-profile box along a segment (reference
    render_util.py:113-145): ([8, 3, 3] tris, colors)."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    d = p1 - p0
    n = np.linalg.norm(d)
    if n < 1e-9:
        return np.zeros((0, 3, 3)), np.zeros((0, 3))
    d = d / n
    helper = np.array([0.0, 1.0, 0.0]) if abs(d[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(d, helper)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)
    quad = [u * thickness, v * thickness, -u * thickness, -v * thickness]
    tris = []
    for i in range(4):
        a0 = p0 + quad[i]
        a1 = p0 + quad[(i + 1) % 4]
        b0 = p1 + quad[i]
        b1 = p1 + quad[(i + 1) % 4]
        tris.append([a0, a1, b0])
        tris.append([a1, b1, b0])
    tris = np.asarray(tris)
    return tris, np.tile(np.asarray(color, np.float64), (len(tris), 1))


def position_marker(c, color, extent=0.03):
    """Small octahedron marker (reference render_util.py:148-162)."""
    c = np.asarray(c, np.float64)
    e = extent
    vx = np.array([[e, 0, 0], [-e, 0, 0], [0, e, 0], [0, -e, 0],
                   [0, 0, e], [0, 0, -e]]) + c
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    tris = np.stack([vx[list(f)] for f in faces])
    return tris, np.tile(np.asarray(color, np.float64), (len(tris), 1))


def ground_grid(center, span, y, n=12, base=(40, 44, 52), accent=(70, 90, 120)):
    """Checkerboard ground plane (the reference draws a colormapped grid,
    render_util.py:165-227)."""
    xs = np.linspace(center[0] - span, center[0] + span, n + 1)
    zs = np.linspace(center[2] - span, center[2] + span, n + 1)
    tris, cols = [], []
    for i in range(n):
        for j in range(n):
            col = base if (i + j) % 2 == 0 else accent
            a = [xs[i], y, zs[j]]
            b = [xs[i + 1], y, zs[j]]
            c = [xs[i + 1], y, zs[j + 1]]
            d = [xs[i], y, zs[j + 1]]
            tris += [[a, b, c], [a, c, d]]
            cols += [col, col]
    return np.asarray(tris, np.float64), np.asarray(cols, np.float64)


def retro_colormap(frac):
    """Error colormap in the spirit of the reference's get_retro_colors
    (render_scene.py:111-140): cyan-green at 0 -> magenta-red at 1."""
    frac = float(np.clip(frac, 0.0, 1.0))
    lo = np.array([80, 235, 180], np.float64)
    hi = np.array([240, 60, 120], np.float64)
    return lo + (hi - lo) * frac
