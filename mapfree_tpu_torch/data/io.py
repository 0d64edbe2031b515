"""Image and depth IO (port of mapfree_tpu/data/io.py), returning NHWC numpy
arrays.

:func:`decode_resize_batch` decodes a batch of JPEGs on the card with nvJPEG
(``data/jpeg.py``) for a CUDA device, and on the host with cv2 or PIL for
``device="cpu"``, as the JAX package's cv2/PIL branch does. cv2 and PIL are
imported only on the host path, at first use; on the card neither is touched.
PNGs (depth maps, 7Scenes colour frames) are read on every host by the
port's own reader, which needs neither (``data/png.py``), and so are 16-bit
binary PGMs (ScanNet's depth maps, :func:`read_pgm16`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mapfree_tpu_torch.data.png import read_png
from mapfree_tpu_torch.models.builder import resolve_device
from mapfree_tpu_torch.ops.image import yuv420_pack_host


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _is_png(path) -> bool:
    return str(path).lower().endswith(".png")


def _is_pgm(path) -> bool:
    return str(path).lower().endswith(".pgm")


def _pnm_header(data: bytes, path) -> tuple:
    """The Netpbm header's four tokens (magic, width, height, maxval) and
    the offset of the raster: tokens split by whitespace, ``#`` comments to
    the end of their line, and one whitespace byte after the last."""
    tokens, i, n = [], 0, len(data)
    while len(tokens) < 4:
        while i < n and (data[i:i + 1].isspace() or data[i:i + 1] == b"#"):
            if data[i:i + 1] == b"#":
                while i < n and data[i:i + 1] not in (b"\n", b"\r"):
                    i += 1
            else:
                i += 1
        start = i
        while i < n and not data[i:i + 1].isspace() and data[i:i + 1] != b"#":
            i += 1
        if start == i:
            raise ValueError(f"{path}: the Netpbm header is cut off")
        tokens.append(data[start:i])
    if i >= n or not data[i:i + 1].isspace():
        raise ValueError(f"{path}: no whitespace between the Netpbm header and the raster")
    return tokens, i + 1


def read_pgm16(path) -> np.ndarray:
    """A 16-bit binary PGM (Netpbm ``P5``, maxval 65535, big-endian samples)
    -> uint16 [H, W], as cv2's IMREAD_UNCHANGED gives it. Any other PNM
    variant (ASCII, 8-bit, PPM, PAM) raises."""
    data = Path(path).read_bytes()
    if data[:2] != b"P5" or not data[2:3].isspace():
        raise ValueError(f"{path}: {data[:2]!r} is not a binary PGM (P5); only "
                         "16-bit binary PGMs are read")
    tokens, offset = _pnm_header(data, path)
    try:
        width, height, maxval = (int(t) for t in tokens[1:])
    except ValueError:
        raise ValueError(f"{path}: the PGM header's sizes are not integers") from None
    if maxval != 65535:
        raise ValueError(f"{path}: PGM maxval {maxval}; only 16-bit PGMs (maxval 65535) "
                         "are read")
    if width <= 0 or height <= 0:
        raise ValueError(f"{path}: PGM of {width}x{height}")
    nbytes = 2 * width * height
    if len(data) - offset < nbytes:
        raise ValueError(f"{path}: the PGM raster holds {len(data) - offset} bytes of "
                         f"{nbytes}")
    raster = np.frombuffer(data, ">u2", width * height, offset)
    return raster.astype(np.uint16).reshape(height, width)


def _no_host_reader(path) -> RuntimeError:
    return RuntimeError(
        f"reading {path} on the host needs cv2 or PIL, and this host has neither: "
        "decode JPEGs on the card with device='cuda' (data/jpeg.py); PNGs need neither")


def decode_resize_batch(paths, width: int, height: int, uint8: bool = False,
                        yuv420: bool = False, device="cuda"):
    """Decode and resize a batch of JPEGs in one call: float32 [0, 1] NHWC by
    default, uint8 NHWC when ``uint8``, or planar YUV420 uint8
    [N, H*3/2, W] when ``yuv420``.

    On a CUDA ``device`` nvJPEG decodes on the card (``data/jpeg.py``); on
    the CPU each image is read with cv2 or PIL (:func:`read_color_image`), as
    the JAX package does where its C++ decoder is not built.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        from mapfree_tpu_torch.data.jpeg import decode_resize_batch as on_the_card

        return on_the_card(paths, width, height, uint8=uint8, yuv420=yuv420,
                           device=device)
    out = np.stack([read_color_image(p, resize=(width, height)) for p in paths])
    if yuv420:
        return yuv420_pack_host(out)
    if uint8:
        out = (out * 255.0 + 0.5).astype(np.uint8)
    return out


def imread_rgb(path) -> np.ndarray:
    """Read an image on the host as RGB uint8 [H, W, 3]: a PNG with the
    port's reader (gray repeated to three channels, alpha dropped, as
    cv2's IMREAD_COLOR gives it), anything else with cv2, else PIL."""
    if _is_png(path):
        img = read_png(path)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: a 16-bit PNG is not a colour image")
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] in (1, 2):
            return np.repeat(img[..., :1], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"could not read image {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    Image = _pil_image()
    if Image is None:
        raise _no_host_reader(path)
    return np.asarray(Image.open(path).convert("RGB"))


def read_color_image(path, resize=None, augment_fn=None) -> np.ndarray:
    """Read on the host, resize to (w, h), normalize to [0, 1] float32 NHWC
    (reference lib/datasets/utils.py:58-74, minus the CHW permute)."""
    image = imread_rgb(path)
    if resize is not None and tuple(resize) != (image.shape[1], image.shape[0]):
        # at the size asked for cv2.resize returns its input unchanged, so
        # only a real resize needs an image library
        cv2 = _cv2()
        if cv2 is not None:
            image = cv2.resize(image, tuple(resize))
        else:
            Image = _pil_image()
            if Image is None:
                raise _no_host_reader(path)
            image = np.asarray(Image.fromarray(image).resize(tuple(resize)))
    image = image.astype(np.float32) / 255.0
    if augment_fn is not None:
        image = augment_fn(image)
    return image  # (h, w, 3)


def read_depth_image(path) -> np.ndarray:
    """Read a 16-bit depth image in millimeters -> float32 meters [H, W]
    (reference lib/datasets/utils.py:77-81): a PNG or a 16-bit PGM
    (ScanNet's) with the port's readers, anything else with cv2, else PIL."""
    if _is_png(path):
        depth = read_png(path)
        if depth.ndim != 2:
            raise ValueError(f"{path}: a depth map is a one-channel PNG, got {depth.shape}")
        return (depth / 1000.0).astype(np.float32)
    if _is_pgm(path):
        return (read_pgm16(path) / 1000.0).astype(np.float32)
    cv2 = _cv2()
    if cv2 is not None:
        depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if depth is None:
            raise FileNotFoundError(f"could not read depth {path}")
    else:
        Image = _pil_image()
        if Image is None:
            raise _no_host_reader(path)
        depth = np.asarray(Image.open(path))
    return (depth / 1000.0).astype(np.float32)


def get_resized_wh(w, h, resize=None):
    """Resize the longer edge to ``resize`` keeping aspect ratio
    (reference lib/datasets/utils.py:20-26)."""
    if resize is not None:
        scale = resize / max(h, w)
        return int(round(w * scale)), int(round(h * scale))
    return w, h


def get_divisible_wh(w, h, df=None):
    """Floor dims to a multiple of ``df`` (reference utils.py:29-34)."""
    if df is not None:
        return int(w // df * df), int(h // df * df)
    return w, h


def pad_bottom_right(inp, pad_size, ret_mask=False):
    """Pad a [H, W] or [C, H, W] array to a square ``pad_size`` canvas with an
    optional validity mask (reference utils.py:37-55)."""
    if not (isinstance(pad_size, int) and pad_size >= max(inp.shape[-2:])):
        raise ValueError(f"{pad_size} < {max(inp.shape[-2:])}")
    mask = None
    if inp.ndim == 2:
        padded = np.zeros((pad_size, pad_size), dtype=inp.dtype)
        padded[: inp.shape[0], : inp.shape[1]] = inp
        if ret_mask:
            mask = np.zeros((pad_size, pad_size), dtype=bool)
            mask[: inp.shape[0], : inp.shape[1]] = True
    elif inp.ndim == 3:
        padded = np.zeros((inp.shape[0], pad_size, pad_size), dtype=inp.dtype)
        padded[:, : inp.shape[1], : inp.shape[2]] = inp
        if ret_mask:
            mask = np.zeros((inp.shape[0], pad_size, pad_size), dtype=bool)
            mask[:, : inp.shape[1], : inp.shape[2]] = True
    else:
        raise NotImplementedError()
    return padded, mask


def grayscale3(image: np.ndarray) -> np.ndarray:
    """Black & white augmentation keeping 3 channels
    (reference datamodules.py:37-38 Grayscale(num_output_channels=3))."""
    gray = image @ np.asarray([0.299, 0.587, 0.114], image.dtype)
    return np.repeat(gray[..., None], 3, axis=-1)


def color_jitter(rng: np.random.Generator, brightness=0.4, contrast=0.4,
                 saturation=0.4, hue=0.0):
    """Returns an augment_fn applying random brightness/contrast/saturation
    (host-side equivalent of torchvision ColorJitter defaults used by the
    reference datamodules.py:36)."""

    def fn(image: np.ndarray) -> np.ndarray:
        out = image
        b = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        out = out * b
        c = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        mean = out.mean()
        out = (out - mean) * c + mean
        s = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        gray = out @ np.asarray([0.299, 0.587, 0.114], out.dtype)
        out = (out - gray[..., None]) * s + gray[..., None]
        return np.clip(out, 0.0, 1.0).astype(np.float32)

    return fn
