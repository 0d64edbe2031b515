"""The port's PNG reader (mapfree_tpu_torch/data/png.py), which needs no
image library: against cv2 and PIL on the committed fixtures, and against
PNGs this file encodes itself with each of the five filter types at odd
widths, for every pixel format it reads. Results are exact. On the CPU the
numpy unfilter runs; the C one is built with nvcc on the card's machine
(chip_smoke.py phase 13 holds it to the fixtures), and a failed build there
raises."""

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_threads import one_torch_thread  # noqa: F401

from mapfree_tpu_torch.data import io as pt_io
from mapfree_tpu_torch.data import png

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_port"


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, ftype) -> bytes:
    """Apply PNG filter ``ftype`` (0-4, or a list per row) to [H, stride] bytes."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        f = ftype[y] if isinstance(ftype, list) else ftype
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def encode(img: np.ndarray, ftype, color: int, depth: int = 8, interlace: int = 0) -> bytes:
    H, W = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    data = img.astype(">u2").view(np.uint8) if depth == 16 else img.astype(np.uint8)
    rows = data.reshape(H, -1)
    bpp = channels * depth // 8
    header = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace)
    body = zlib.compress(_filter_rows(rows, bpp, ftype))
    # split the stream over two IDAT chunks: the reader joins them
    return (png.SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", body[:7])
            + _chunk(b"IDAT", body[7:]) + _chunk(b"IEND", b""))


FORMATS = {  # name: (colour type, channels, bit depth)
    "gray8": (0, 1, 8), "gray_alpha": (4, 2, 8), "rgb": (2, 3, 8), "rgba": (6, 4, 8),
    "gray16": (0, 1, 16)}


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("width", [1, 7, 33])
def test_each_filter_type_round_trips_exactly(fmt, ftype, width):
    color, channels, depth = FORMATS[fmt]
    rng = np.random.default_rng(width * 31 + channels)
    shape = (5, width) if channels == 1 else (5, width, channels)
    img = rng.integers(0, 65536 if depth == 16 else 256, shape).astype(
        np.uint16 if depth == 16 else np.uint8)
    ft = [0, 1, 2, 3, 4] if ftype == "mixed" else ftype
    got = png.decode_png(encode(img, ft, color, depth), native=False)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


def test_fixtures_match_cv2_pil_and_their_stored_arrays():
    stored = np.load(FIXTURES / "png_decoded.npz")
    for i in range(4):
        path = FIXTURES / f"depth_{i}.png"
        got = png.read_png(path, native=False)
        np.testing.assert_array_equal(got, stored["depth"][i])
        np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    path = FIXTURES / "color_0.png"
    got = png.read_png(path, native=False)
    np.testing.assert_array_equal(got, stored["color"])
    np.testing.assert_array_equal(got, cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_io_reads_pngs_as_cv2_does(tmp_path):
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 9000, (11, 13)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    want = cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_UNCHANGED) / 1000.0
    np.testing.assert_array_equal(pt_io.read_depth_image(tmp_path / "d.png"), want.astype(np.float32))
    for channels in (1, 3, 4):
        img = rng.integers(0, 256, (9, 5, channels)).astype(np.uint8)
        path = tmp_path / f"c{channels}.png"
        cv2.imwrite(str(path), img[..., 0] if channels == 1 else img)
        want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(pt_io.imread_rgb(path), want)


@pytest.mark.parametrize("what,data", [
    ("interlaced", lambda: encode(np.zeros((3, 3), np.uint8), 0, 0, interlace=1)),
    ("16-bit RGB", lambda: encode(np.zeros((3, 3, 3), np.uint16), 0, 2, depth=16)),
    ("palette", lambda: encode(np.zeros((3, 3), np.uint8), 0, 3)),
    ("not a PNG", lambda: b"GIF89a" + bytes(20)),
])
def test_unsupported_pngs_raise(what, data):
    with pytest.raises(ValueError):
        png.decode_png(data(), native=False)


def test_unknown_filter_type_raises():
    raw = np.zeros(2 * (1 + 3), np.uint8)
    raw[4] = 7
    with pytest.raises(ValueError, match="filter type 7"):
        png.unfilter_numpy(raw, 2, 3, 1)


def test_a_failed_unfilter_build_raises(monkeypatch):
    """Where the C unfilter is the default (a machine with a CUDA device),
    a build that fails raises: there is no quiet numpy fallback."""
    from mapfree_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(png, "native_default", lambda: True)
    monkeypatch.setattr(png, "_fn", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent-build-dir"))
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        png.read_png(FIXTURES / "depth_0.png")
