"""Write the JPEG fixtures of the PyTorch port's decoder, and what the JAX
package decodes from them.

    python tests/data/torch_port/make_fixtures.py

Writes, beside this script:
- ``frame_{0..3}.jpg``: 540x720 (width x height, the MapFree frame size of
  configs/mapfree.yaml) colour frames at JPEG quality 90 with cv2's default
  4:2:0 chroma, each a seeded smooth image with some texture (stripes,
  discs and a little noise);
- ``jax_decode_270x360.npz``: ``mapfree_tpu.data.io.decode_resize_batch``
  of those files at the 3d3d size (270x360), as ``yuv420`` (planar YUV420
  uint8 [4, 540, 270]) and ``uint8`` (NHWC [4, 360, 270, 3]), from the
  package's cv2 branch (the one that runs where the C++ decoder is not
  built);
- ``depth_{0..3}.png``: one smooth synthetic 16-bit depth map in
  millimetres (540x720, as MapFree's ``*.dpt*.png``, in steps of 1 cm to
  keep the files small) per frame, written by cv2 at compression level 9,
  and ``color_0.png``, frame 0 at 135x180 as an 8-bit RGB PNG written by
  PIL (adaptive filters): the encoders' own filter choices are what the
  port's PNG reader undoes; ``png_decoded.npz``: what they hold (``depth``
  uint16 [4, 720, 540], ``color`` uint8 RGB [180, 135, 3]);
- ``decode_gap.json``, when the C++ decoder ``mapfree_native`` is importable
  (built with ``native/build.py``, or on PYTHONPATH): the largest and mean
  absolute difference between the JAX package's two decode paths on these
  files, the native decoder (raw planes at libjpeg's 4/8 scale for YUV420,
  the 4/8-scale decode for uint8) against the cv2 branch. The card's nvJPEG
  decoder is held to the mean limit of 1.0 level and to that largest
  difference.

``make_fixtures.py scannet`` writes the ScanNet fixtures (cv2, numpy and
the JAX package):
- ``scannet_{0..3}.jpg``: 1296x968 colour frames (ScanNet's colour size) at
  JPEG quality 80, views of the textured room of ``room.py::render_view``
  from the camera poses of ``room.py::scannet_views``, so that a matcher
  finds true correspondences between them and their depth (rendered at any
  size by the same function) agrees with their poses;
- ``jax_decode_scannet_320x240.npz``: the JAX package's cv2-branch decode of
  those files at the ScanNet RPR size (``uint8`` NHWC [4, 240, 320, 3]);
- ``scannet_decode_gap.json``, when ``mapfree_native`` is importable: the
  JAX package's own two decode paths' gap on those files (native against
  cv2), as ``decode_gap.json`` holds it for the MapFree frames.

Needs cv2, numpy and the JAX package; ``make_fixtures.py png`` writes
only the PNG fixtures (cv2 and numpy).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))

WIDTH, HEIGHT = 540, 720       # source frames
OUT_W, OUT_H = 270, 360        # configs/regression/mapfree/3d3d.yaml
N_FRAMES = 4
QUALITY = 90


def frame(seed: int) -> np.ndarray:
    """A smooth colour field (a few low-frequency waves per channel) with
    stripes, discs and mild noise on top: uint8 RGB [HEIGHT, WIDTH, 3]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    img = np.zeros((HEIGHT, WIDTH, 3), np.float32)
    for c in range(3):
        img[..., c] = 128.0
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 3.0, size=2) * 2 * np.pi
            phase = rng.uniform(0, 2 * np.pi)
            img[..., c] += rng.uniform(20, 40) * np.cos(fx * x / WIDTH + fy * y / HEIGHT + phase)
    for _ in range(6):  # stripe patches
        x0, y0 = rng.integers(0, WIDTH - 120), rng.integers(0, HEIGHT - 120)
        w, h = rng.integers(40, 120, size=2)
        period = rng.integers(3, 12)
        stripes = ((np.arange(w) // period) % 2).astype(np.float32)[None, :, None]
        img[y0:y0 + h, x0:x0 + w] += (stripes - 0.5) * rng.uniform(40, 90, size=3)
    for _ in range(8):  # discs
        cx, cy = rng.uniform(0, WIDTH), rng.uniform(0, HEIGHT)
        r = rng.uniform(10, 60)
        mask = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[mask] = rng.uniform(0, 255, size=3)
    img += rng.normal(0, 3.0, size=img.shape)
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def depth_map(seed: int) -> np.ndarray:
    """A smooth depth field of 1.5-8 m (a slanted plane and a few long
    waves), in millimetres rounded to centimetres: uint16 [HEIGHT, WIDTH]."""
    rng = np.random.default_rng(100 + seed)
    y, x = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float64)
    d = 3.0 + rng.uniform(-1, 1) * x / WIDTH + rng.uniform(0.5, 2.0) * y / HEIGHT
    for _ in range(3):
        fx, fy = rng.uniform(0.5, 2.5, size=2) * 2 * np.pi
        d += rng.uniform(0.1, 0.4) * np.sin(fx * x / WIDTH + fy * y / HEIGHT + rng.uniform(0, 6.3))
    return (np.round(np.clip(d * 100.0, 150, 800)) * 10).astype(np.uint16)


def write_scannet_fixtures() -> None:
    import cv2

    import mapfree_tpu.data.io as jax_io
    from room import SCANNET_H, SCANNET_K, SCANNET_W, render_view, scannet_views

    paths = []
    for i, (R, C) in enumerate(scannet_views()):
        rgb, _ = render_view(SCANNET_K, R, C, SCANNET_W, SCANNET_H)
        path = HERE / f"scannet_{i}.jpg"
        cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 80])
        paths.append(str(path))
    native = jax_io._HAS_NATIVE
    jax_io._HAS_NATIVE = False  # the cv2 branch, as where the C++ decoder is not built
    try:
        u8 = jax_io.decode_resize_batch(paths, 320, 240, uint8=True)
    finally:
        jax_io._HAS_NATIVE = native
    np.savez_compressed(HERE / "jax_decode_scannet_320x240.npz", uint8=u8)
    sizes = sum(Path(p).stat().st_size for p in paths)
    print(f"wrote {len(paths)} ScanNet JPEGs ({sizes} bytes in all) and "
          f"jax_decode_scannet_320x240.npz {u8.shape}")
    if not native:
        print("mapfree_native is not importable: scannet_decode_gap.json not written")
        return
    import mapfree_native

    diff = np.abs(mapfree_native.decode_resize_batch(paths, 320, 240, uint8=True).astype(np.int32)
                  - u8.astype(np.int32))
    gap = {"uint8": {"max_abs": int(diff.max()), "mean_abs": float(diff.mean())},
           "what": "native/decoder.cpp against the cv2 branch of mapfree_tpu/data/io.py, on "
                   "scannet_0..3.jpg (1296x968) at 320x240 uint8"}
    (HERE / "scannet_decode_gap.json").write_text(json.dumps(gap, indent=1) + "\n")
    print(f"scannet_decode_gap.json: {gap}")


def write_png_fixtures() -> None:
    import cv2
    from PIL import Image

    depth = np.stack([depth_map(i) for i in range(N_FRAMES)])
    for i in range(N_FRAMES):
        cv2.imwrite(str(HERE / f"depth_{i}.png"), depth[i], [cv2.IMWRITE_PNG_COMPRESSION, 9])
    color = cv2.resize(frame(seed=0), (OUT_W // 2, OUT_H // 2), interpolation=cv2.INTER_AREA)
    Image.fromarray(color).save(HERE / "color_0.png")
    np.savez_compressed(HERE / "png_decoded.npz", depth=depth, color=color)
    sizes = sum((HERE / n).stat().st_size for n in
                [f"depth_{i}.png" for i in range(N_FRAMES)] + ["color_0.png", "png_decoded.npz"])
    print(f"wrote {N_FRAMES} depth PNGs, color_0.png and png_decoded.npz, {sizes} bytes in all")


def main() -> None:
    import cv2

    if sys.argv[1:] == ["png"]:
        write_png_fixtures()
        return
    if sys.argv[1:] == ["scannet"]:
        write_scannet_fixtures()
        return

    import mapfree_tpu.data.io as jax_io

    paths = []
    for i in range(N_FRAMES):
        path = HERE / f"frame_{i}.jpg"
        bgr = cv2.cvtColor(frame(seed=i), cv2.COLOR_RGB2BGR)
        cv2.imwrite(str(path), bgr, [cv2.IMWRITE_JPEG_QUALITY, QUALITY])
        paths.append(str(path))
    sizes = [Path(p).stat().st_size for p in paths]
    print(f"wrote {N_FRAMES} JPEGs, {sum(sizes)} bytes in all")

    native = jax_io._HAS_NATIVE
    jax_io._HAS_NATIVE = False  # the cv2 branch, as where the C++ decoder is not built
    try:
        yuv = jax_io.decode_resize_batch(paths, OUT_W, OUT_H, yuv420=True)
        u8 = jax_io.decode_resize_batch(paths, OUT_W, OUT_H, uint8=True)
    finally:
        jax_io._HAS_NATIVE = native
    np.savez_compressed(HERE / "jax_decode_270x360.npz", yuv420=yuv, uint8=u8)
    write_png_fixtures()
    print(f"jax_decode_270x360.npz: yuv420 {yuv.shape}, uint8 {u8.shape}")

    if not native:
        print("mapfree_native is not importable: decode_gap.json not written")
        return
    import mapfree_native

    gap = {}
    for key, ref, kwargs in (("yuv420", yuv, {"yuv420": True}),
                             ("uint8", u8, {"uint8": True})):
        got = mapfree_native.decode_resize_batch(paths, OUT_W, OUT_H, **kwargs)
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        gap[key] = {"max_abs": int(diff.max()), "mean_abs": float(diff.mean())}
    gap["what"] = ("native/decoder.cpp (raw planes at libjpeg's 4/8 scale for yuv420, the "
                   "4/8-scale decode for uint8) against the cv2 branch of "
                   "mapfree_tpu/data/io.py, on frame_0..3.jpg at 270x360")
    (HERE / "decode_gap.json").write_text(json.dumps(gap, indent=1) + "\n")
    print(f"decode_gap.json: {gap}")


if __name__ == "__main__":
    main()
