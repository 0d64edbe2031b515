"""A PNG reader that needs no image library: the stdlib's ``zlib`` inflates
the IDAT stream, and the rows are unfiltered by a small host C function
(``data/csrc/png_unfilter.cu``, built with nvcc at first use by
``ops/_build.py``) or by its plain numpy version.

It reads non-interlaced 8-bit gray, gray+alpha, RGB and RGBA and 16-bit gray
(MapFree's and 7Scenes' depth maps, 7Scenes' colour frames); any other PNG
raises. The machine with the card has no cv2 and no PIL: there the C
function is used, and a failed build raises (there is no quiet numpy
fallback). Elsewhere (``torch.cuda`` not available) the numpy version runs.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

LIBRARY = "png_unfilter"
SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (bit depth 8); 16-bit only for gray (type 0)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}

_lock = threading.Lock()
_fn = None


def _native():
    """The C unfilter, built and loaded once."""
    global _fn
    with _lock:
        if _fn is None:
            from mapfree_tpu_torch.ops import _build

            fn = _build.load_library(LIBRARY, SOURCE_DIR).png_unfilter
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def native_default() -> bool:
    """Whether :func:`read_png` unfilters in C by default: on a machine with
    a CUDA device (which has nvcc and no cv2 or PIL)."""
    import torch

    return torch.cuda.is_available()


def unfilter_numpy(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the per-row filters of ``raw`` (height rows of a filter byte
    and ``stride`` bytes) -> [height, stride] uint8. The plain version of
    the C function: Sub and Up vectorised, Average and Paeth a Python loop
    over the row (they depend on the byte ``bpp`` before)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            src, up = line.tolist(), prev.tolist()
            cur_l = [0] * stride
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur_l[i] = (src[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def unfilter_native(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """:func:`unfilter_numpy` by the C function (built on first use)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    bad = _native()(raw.ctypes.data, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has unknown filter type {raw[(bad - 1) * (stride + 1)]}")
    return out


def decode_png(data: bytes, native: bool | None = None, what: str = "PNG") -> np.ndarray:
    """Decode PNG bytes: uint8 [H, W] (gray), [H, W, C] (C = 2, 3, 4), or
    uint16 [H, W] (16-bit gray)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{what} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{what} has no IHDR or no IDAT chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    if interlace != 0 or color not in CHANNELS or depth not in (8, 16) or (
            depth == 16 and color != 0):
        raise ValueError(
            f"{what}: unsupported PNG (bit depth {depth}, colour type {color}, interlace "
            f"{interlace}); the reader takes non-interlaced 8-bit gray, gray+alpha, RGB, "
            "RGBA and 16-bit gray")
    channels = CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{what}: image data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    use_native = native_default() if native is None else native
    rows = (unfilter_native if use_native else unfilter_numpy)(raw, height, stride, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    img = rows.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path, native: bool | None = None) -> np.ndarray:
    """Read a PNG file (see :func:`decode_png`); a missing file raises
    ``FileNotFoundError``."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, native=native, what=str(path))
