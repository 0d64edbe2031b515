"""JPEG decoding on the card: nvJPEG, then a resize and a pack in torch.

The card's counterpart of the host decoder ``native/decoder.cpp``
(``decode_resize_batch``), which the machine with the card cannot build (it
has no libjpeg, cv2 or PIL). For a batch of JPEG files:

1. each file's bytes are read on the host, and nvJPEG reads its size from the
   headers (``nvjpegGetImageInfo``);
2. nvJPEG decodes each frame to interleaved RGB uint8 in device memory
   (``nvjpegDecode`` to ``NVJPEG_OUTPUT_RGBI``), ``DECODE_THREADS`` frames at
   a time on host threads with a decode state of their own (the Huffman
   decode runs on the host), each call waiting for its frame before its
   state takes the next (``jpeg_decode.cu``). The batch's work runs on a
   stream of the calling thread's own (:func:`private_stream`), so that
   wait covers the decode alone, not the caller's work on its streams (a
   forward in flight);
3. frames of one size are resized together to (width, height) with the
   arithmetic of ``native/decoder.cpp:142-215`` (:func:`resize_blend`);
4. the result is emitted as one of the host decoder's three outputs: float32
   [0, 1] NHWC, uint8 NHWC, or planar YUV420 uint8 [N, H*3/2, W] packed with
   ``ops/image.py::yuv420_pack_host``'s arithmetic (:func:`yuv420_pack`);
5. one device-to-host copy gives the numpy array the loader returns.

A file that is missing, unreadable, empty or not a JPEG nvJPEG can decode
(the statuses in :data:`BAD_INPUT`) is zero-filled (Y 0 and chroma 128 for
YUV420) and counted, with a warning, as the host decoder does
(``native/decoder.cpp:505-513``). Any other nvJPEG failure is a fault of the
library or the card, and raises; so does a failure to find, build or load
nvJPEG: nothing falls back to a host decoder.

``nvjpeg.h`` and ``libnvjpeg.so`` must lie beside the CUDA toolkit that
``ops/_build.py`` finds; ``data/csrc/jpeg_decode.cu`` is built against them
at first use and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mapfree_tpu_torch.ops import _build

LIBRARY = "jpeg_decode"
SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
DECODE_THREADS = 4  # host threads decoding at once, each with its own nvJPEG state
INV255 = float(np.float32(1.0) / np.float32(255.0))  # native/decoder.cpp's inv255
# nvJPEG's statuses (nvjpeg.h, nvjpegStatus_t) that say the input is not a
# JPEG it can decode: such a frame is zero-filled and counted. On the card
# (nvJPEG 12.4) a text file reads 3 from the headers, a JPEG cut off inside
# its headers 10 from the headers or the decode, and a scan of garbage 4
BAD_INPUT = {3: "NVJPEG_STATUS_BAD_JPEG", 4: "NVJPEG_STATUS_JPEG_NOT_SUPPORTED",
             10: "NVJPEG_STATUS_INCOMPLETE_BITSTREAM"}
# frames decoded and frames zero-filled since the last reset_stats()
stats = {"images": 0, "failures": 0}


def reset_stats() -> None:
    for key in stats:
        stats[key] = 0


def nvjpeg_files() -> tuple:
    """(``nvjpeg.h``, ``libnvjpeg.so``) beside the CUDA toolkit whose nvcc
    ``ops/_build.py`` finds; raises if either is missing."""
    root = Path(_build.find_nvcc()).resolve().parent.parent
    header = root / "include" / "nvjpeg.h"
    libs = [d / "libnvjpeg.so" for d in (root / "lib64", root / "targets" / "x86_64-linux" / "lib")]
    lib = next((p for p in libs if p.exists()), None)
    if not header.is_file() or lib is None:
        raise RuntimeError(
            f"nvJPEG not found beside the CUDA toolkit at {root} (looked for "
            f"{header} and {' or '.join(str(p) for p in libs)}): the card's JPEG "
            "decoder is built against it")
    return header, lib


def library_spec() -> tuple:
    """``ops/_build.load_library``'s arguments for the decoder's source:
    linked with nvJPEG, which the loader finds through the library's rpath."""
    _, lib = nvjpeg_files()
    libdir = lib.parent
    return (LIBRARY, SOURCE_DIR, ("-L" + str(libdir), "-lnvjpeg",
                                  f"-Xlinker=-rpath={libdir}"))


class _Decoder:
    """One nvJPEG handle for the process, a pool of decode threads and one
    decode state per pool thread (a state serves one thread at a time). All
    of them live as long as the process."""

    def __init__(self):
        lib = _build.load_library(*library_spec())
        vp, pvp, pint = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
            ctypes.POINTER(ctypes.c_int)
        for name, args in (
                ("jd_create", [pvp]), ("jd_state_create", [vp, pvp]),
                ("jd_image_info", [vp, ctypes.c_char_p, ctypes.c_size_t, pint, pint, pint]),
                ("jd_decode_rgbi", [vp, vp, ctypes.c_char_p, ctypes.c_size_t, vp,
                                    ctypes.c_size_t, vp]),
                ("jd_version", [pint, pint, pint])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.jd_library_path.argtypes = []
        lib.jd_library_path.restype = ctypes.c_char_p
        self.lib = lib
        handle = ctypes.c_void_p()
        _check(lib.jd_create(ctypes.byref(handle)), "nvjpegCreateSimple")
        self.handle = handle
        self.library_path = lib.jd_library_path().decode()
        v = [ctypes.c_int() for _ in range(3)]
        _check(lib.jd_version(*[ctypes.byref(x) for x in v]), "nvjpegGetProperty")
        self.version = ".".join(str(x.value) for x in v)
        self._tls = threading.local()
        self.pool = ThreadPoolExecutor(max_workers=DECODE_THREADS,
                                       thread_name_prefix="nvjpeg")

    def _state(self) -> ctypes.c_void_p:
        state = getattr(self._tls, "state", None)
        if state is None:
            state = ctypes.c_void_p()
            _check(self.lib.jd_state_create(self.handle, ctypes.byref(state)),
                   "nvjpegJpegStateCreate")
            self._tls.state = state
        return state

    def read_info(self, path):
        """(bytes, width, height) of a JPEG file, or None if it cannot be
        read, is empty, or its headers are no JPEG nvJPEG can decode."""
        try:
            data = Path(path).read_bytes()
        except OSError:
            return None
        if not data:
            return None
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        status = self.lib.jd_image_info(self.handle, data, len(data), ctypes.byref(w),
                                        ctypes.byref(h), ctypes.byref(c))
        if status in BAD_INPUT or w.value < 2 or h.value < 2:  # the resize needs 2x2
            return None
        _check(status, f"nvjpegGetImageInfo on {path}")
        return data, w.value, h.value

    def decode(self, data: bytes, dst: torch.Tensor, stream: int) -> bool:
        """Decode into ``dst`` (uint8 [h, w, 3], contiguous, on the card):
        False if nvJPEG finds the data no JPEG it can decode."""
        status = self.lib.jd_decode_rgbi(self.handle, self._state(), data, len(data),
                                         dst.data_ptr(), dst.shape[1] * 3, stream)
        if status in BAD_INPUT:
            return False
        _check(status, "nvjpegDecode (1000 + e: the wait for the frame, cudaError_t e)")
        return True


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} failed with nvJPEG status {status}")


_decoder = None
_decoder_lock = threading.Lock()


def decoder() -> _Decoder:
    """The process's decoder, built and loaded at first use."""
    global _decoder
    with _decoder_lock:
        if _decoder is None:
            _decoder = _Decoder()
        return _decoder


_streams = threading.local()


def private_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's own stream on ``device``, made at first use: the
    decode's allocations, nvJPEG's work and the resize run on it."""
    streams = getattr(_streams, "by_device", None)
    if streams is None:
        streams = _streams.by_device = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device=device)
    return streams[device]


def _axis(src: int, dst: int):
    """native/decoder.cpp:158-166 along one axis, in float32: the lower
    source neighbour of each destination pixel (half-pixel centres, clamped
    to [0, src - 2]) and its weights (1 - w, w)."""
    scale = np.float32(src) / np.float32(dst)
    f = (np.arange(dst, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    f = np.maximum(f, np.float32(0.0))
    i0 = np.minimum(f.astype(np.int64), src - 2)
    w = (f - i0.astype(np.float32)).astype(np.float32)
    return i0, (np.float32(1.0) - w).astype(np.float32), w


def resize_blend(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Bilinear resize of uint8 [N, h, w, 3] frames to float32 [N, height,
    width, 3] on the 0..255 scale, before rounding: each needed source row
    is resampled along x in float32 (p0 (1 - wx) + p1 wx), then two such rows
    are blended along y (top (1 - wy) + bottom wy), as
    ``native/decoder.cpp::resize_normalize`` does. Runs on any device."""
    _, h, w, _ = src.shape
    dev = src.device
    x0, iwx, wx = (torch.from_numpy(a).to(dev) for a in _axis(w, width))
    y0, iwy, wy = (torch.from_numpy(a).to(dev) for a in _axis(h, height))
    iwx, wx = iwx[:, None], wx[:, None]

    def along_x(rows):
        return rows.index_select(2, x0) * iwx + rows.index_select(2, x0 + 1) * wx

    top = along_x(src.index_select(1, y0).float())
    bottom = along_x(src.index_select(1, y0 + 1).float())
    return top * iwy[:, None, None] + bottom * wy[:, None, None]


def to_uint8(blend: torch.Tensor) -> torch.Tensor:
    """The host decoder's uint8 rounding: + 0.5, truncated (clamped first,
    which only an upscale's extrapolated edge needs)."""
    return (blend + 0.5).clamp_(0.0, 255.0).to(torch.uint8)


def yuv420_pack(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [N, H, W, 3] -> planar YUV420 uint8 [N, H*3/2, W], with the
    arithmetic of ``ops/image.py::yuv420_pack_host`` on ``rgb / 255``: the
    JFIF forward matrix in float32, the 2x2 box mean of the chroma summed in
    numpy's order, + 0.5 and truncation. Runs on any device."""
    n, H, W, _ = rgb.shape
    if H % 2 or W % 2:
        raise ValueError(f"yuv420 requires even dims, got {H}x{W}")
    # a true division, as numpy's (torch divides by a Python number with a
    # reciprocal multiply on the card)
    x = rgb.float() / torch.full((), 255.0, device=rgb.device) * 255.0
    r, g, b = x.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0

    def box2(c):
        return (((c[:, 0::2, 0::2] + c[:, 0::2, 1::2]) + c[:, 1::2, 0::2])
                + c[:, 1::2, 1::2]) / 4.0

    out = torch.empty((n, H + H // 2, W), dtype=torch.uint8, device=rgb.device)
    out[:, :H] = (y + 0.5).clamp_(0, 255).to(torch.uint8)
    out[:, H:, : W // 2] = (box2(cb) + 0.5).clamp_(0, 255).to(torch.uint8)
    out[:, H:, W // 2:] = (box2(cr) + 0.5).clamp_(0, 255).to(torch.uint8)
    return out


def emit(frames: torch.Tensor, width: int, height: int, uint8: bool = False,
         yuv420: bool = False) -> torch.Tensor:
    """Decoded uint8 RGB frames [N, h, w, 3] of one size -> the requested
    output at (width, height): float32 [0, 1] NHWC (the unrounded blend times
    1/255), uint8 NHWC, or planar YUV420 (from the uint8 frames)."""
    _, h, w, _ = frames.shape
    same = (w, h) == (width, height)  # the host decoder's identity fast path
    if not uint8 and not yuv420:
        return (frames.float() if same else resize_blend(frames, width, height)) * INV255
    u8 = frames if same else to_uint8(resize_blend(frames, width, height))
    return yuv420_pack(u8) if yuv420 else u8


def decode_resize_batch(paths, width: int, height: int, uint8: bool = False,
                        yuv420: bool = False, device="cuda") -> np.ndarray:
    """Decode and resize a batch of JPEG files on the card (``device``, a
    CUDA device). Returns what ``mapfree_tpu/data/io.py::decode_resize_batch``
    returns: float32 [0, 1] [N, height, width, 3], uint8 when ``uint8``, or
    planar YUV420 uint8 [N, height*3/2, width] when ``yuv420``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the nvJPEG decoder runs on a CUDA device, not {device}")
    if yuv420 and (width % 2 or height % 2):
        raise ValueError("yuv420 output requires even width and height")
    dec = decoder()
    paths = [str(p) for p in paths]
    n = len(paths)
    if yuv420:
        shape, dtype = (n, height + height // 2, width), torch.uint8
    else:
        shape, dtype = (n, height, width, 3), (torch.uint8 if uint8 else torch.float32)
    with torch.cuda.device(device), torch.cuda.stream(private_stream(device)):
        stream = torch.cuda.current_stream(device).cuda_stream
        infos = list(dec.pool.map(dec.read_info, paths))
        groups: dict = {}  # (h, w) -> indices of the frames of that size
        for i, info in enumerate(infos):
            if info is not None:
                groups.setdefault((info[2], info[1]), []).append(i)
        frames = {hw: torch.empty((len(idx), hw[0], hw[1], 3), dtype=torch.uint8,
                                  device=device) for hw, idx in groups.items()}
        jobs = [(i, dec.pool.submit(dec.decode, infos[i][0], frames[hw][j], stream))
                for hw, idx in groups.items() for j, i in enumerate(idx)]
        failed = [i for i, info in enumerate(infos) if info is None]
        failed += [i for i, job in jobs if not job.result()]
        out = torch.empty(shape, dtype=dtype, device=device)
        for hw, idx in groups.items():
            emitted = emit(frames[hw], width, height, uint8=uint8, yuv420=yuv420)
            if len(idx) == n:
                out = emitted
            else:
                out.index_copy_(0, torch.tensor(idx, device=device), emitted)
        if failed:
            out[failed] = 0
            if yuv420:  # black is (Y 0, chroma 128)
                out[failed, height:] = 128
        host = out.cpu().numpy()
    stats["images"] += n
    stats["failures"] += len(failed)
    if failed:
        warnings.warn(f"{len(failed)} of {n} images failed to decode (zero-filled)",
                      RuntimeWarning, stacklevel=2)
    return host
