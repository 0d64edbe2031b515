"""PyTorch port, the data layer's decoding (mapfree_tpu_torch/data/io.py and
data/jpeg.py) against the JAX package's mapfree_tpu/data/io.py.

On the CPU the port decodes as the JAX package's cv2 branch does, so every
output is bit-equal. The card's path (nvJPEG, then a resize and a pack in
torch) runs only on a CUDA device; its torch arithmetic is held here on CPU
tensors, and the decode itself against the committed fixtures by the
``cuda`` test of tests/test_torch_cuda_decode.py (and by chip_smoke.py phase
7)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import mapfree_tpu.data.io as jax_io  # noqa: E402

from mapfree_tpu_torch.data import io as pt_io  # noqa: E402
from mapfree_tpu_torch.data import jpeg  # noqa: E402
from mapfree_tpu_torch.ops import _build  # noqa: E402
from mapfree_tpu_torch.ops.image import yuv420_pack_host  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_port"
PATHS = [str(FIXTURES / f"frame_{i}.jpg") for i in range(4)]
# the largest |diff| between the JAX package's two decode paths on the
# fixtures, native/decoder.cpp (built against libjpeg-turbo) against its cv2
# branch, in levels (make_fixtures.py wrote it to decode_gap.json): the
# limit of the card's decode in tests/test_torch_cuda_decode.py
NATIVE_VS_CV2_MAX = {"yuv420": 13, "uint8": 54}


@pytest.fixture
def jax_cv2_branch(monkeypatch):
    """The JAX package's decode where its C++ decoder is not built."""
    monkeypatch.setattr(jax_io, "_HAS_NATIVE", False)


def test_fixtures_are_what_the_jax_package_decodes(jax_cv2_branch):
    """The committed outputs (tests/data/torch_port/make_fixtures.py) are
    what the JAX package computes now from the committed JPEGs."""
    ref = np.load(FIXTURES / "jax_decode_270x360.npz")
    assert sorted(ref.files) == ["uint8", "yuv420"]
    np.testing.assert_array_equal(
        jax_io.decode_resize_batch(PATHS, 270, 360, yuv420=True), ref["yuv420"])
    np.testing.assert_array_equal(
        jax_io.decode_resize_batch(PATHS, 270, 360, uint8=True), ref["uint8"])
    for p in PATHS:
        assert cv2.imread(p).shape == (720, 540, 3)  # MapFree's 540x720 frames
    assert sum(Path(p).stat().st_size for p in PATHS) < 1 << 20
    gap = json.loads((FIXTURES / "decode_gap.json").read_text())
    assert {key: gap[key]["max_abs"] for key in NATIVE_VS_CV2_MAX} == NATIVE_VS_CV2_MAX


@pytest.mark.parametrize("fmt", ["float", "uint8", "yuv420"])
def test_cpu_decode_matches_jax(jax_cv2_branch, fmt):
    kwargs = {"float": {}, "uint8": {"uint8": True}, "yuv420": {"yuv420": True}}[fmt]
    ref = jax_io.decode_resize_batch(PATHS, 270, 360, **kwargs)
    got = pt_io.decode_resize_batch(PATHS, 270, 360, device="cpu", **kwargs)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(pt_io.read_color_image(PATHS[1], (64, 48)),
                                  jax_io.read_color_image(PATHS[1], (64, 48)))


def test_yuv420_pack_on_tensors_is_the_host_packer():
    """The card's YUV420 pack (torch) gives the host packer's bytes."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (3, 36, 22, 3), dtype=np.uint8)
    got = jpeg.yuv420_pack(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, yuv420_pack_host(rgb.astype(np.float32) / 255.0))
    with pytest.raises(ValueError, match="even"):
        jpeg.yuv420_pack(torch.from_numpy(rgb[:, :35]))


def _native_resize(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """native/decoder.cpp::resize_normalize written out per output pixel in
    float32 (the oracle of the vectorised :func:`jpeg.resize_blend`)."""
    h, w, _ = src.shape
    sx, sy = np.float32(w) / np.float32(width), np.float32(h) / np.float32(height)
    out = np.empty((height, width, 3), np.float32)
    for y in range(height):
        fy = max(np.float32((np.float32(y) + np.float32(0.5)) * sy - np.float32(0.5)),
                 np.float32(0))
        y0 = min(int(fy), h - 2)
        wy = np.float32(fy - np.float32(y0))
        for x in range(width):
            fx = max(np.float32((np.float32(x) + np.float32(0.5)) * sx - np.float32(0.5)),
                     np.float32(0))
            x0 = min(int(fx), w - 2)
            wx = np.float32(fx - np.float32(x0))
            rows = src[[y0, y0 + 1]].astype(np.float32)
            along_x = rows[:, x0] * (np.float32(1) - wx) + rows[:, x0 + 1] * wx
            out[y, x] = along_x[0] * (np.float32(1) - wy) + along_x[1] * wy
    return out


@pytest.mark.parametrize("src_hw,dst_wh", [((24, 18), (9, 12)), ((10, 16), (16, 10)),
                                           ((20, 14), (14, 20))])
def test_card_resize_arithmetic(src_hw, dst_wh):
    """The card's resize on CPU tensors: the host decoder's float32 blend,
    its uint8 rounding (within one level of cv2's fixed-point resize on a
    downscale), and its float output (the blend over 255, before rounding)."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 256, (2,) + src_hw + (3,), dtype=np.uint8)
    w, h = dst_wh
    blend = jpeg.resize_blend(torch.from_numpy(src), w, h).numpy()
    oracle = np.stack([_native_resize(s, w, h) for s in src])
    np.testing.assert_allclose(blend, oracle, rtol=0, atol=1e-4)
    u8 = jpeg.emit(torch.from_numpy(src), w, h, uint8=True).numpy()
    np.testing.assert_array_equal(u8, np.clip(oracle + 0.5, 0, 255).astype(np.uint8))
    if w <= src_hw[1] and h <= src_hw[0]:
        ref = np.stack([cv2.resize(s, (w, h)) for s in src])
        assert np.abs(u8.astype(int) - ref).max() <= 1
    floats = jpeg.emit(torch.from_numpy(src), w, h).numpy()
    assert floats.dtype == np.float32
    np.testing.assert_allclose(floats, blend * jpeg.INV255, rtol=1e-6)
    same = jpeg.emit(torch.from_numpy(src), src_hw[1], src_hw[0], uint8=True).numpy()
    np.testing.assert_array_equal(same, src)  # the identity fast path


def test_card_decoder_refuses_the_cpu_and_a_missing_nvjpeg(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.decode_resize_batch(PATHS, 270, 360, device="cpu")
    fake_nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    fake_nvcc.parent.mkdir(parents=True)
    fake_nvcc.write_text("")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake_nvcc))
    with pytest.raises(RuntimeError, match="nvJPEG not found"):
        jpeg.library_spec()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_io.decode_resize_batch(PATHS, 270, 360)  # the card unless asked for the CPU


class _FakeNvjpeg:
    """Stands in for the built decoder library: returns the given statuses."""
    def __init__(self, info_status=0, decode_status=0, size=(8, 6)):
        self.info_status, self.decode_status, self.size = info_status, decode_status, size

    def jd_image_info(self, handle, data, length, w, h, c):
        w._obj.value, h._obj.value, c._obj.value = self.size[0], self.size[1], 3
        return self.info_status

    def jd_state_create(self, handle, state):
        return 0

    def jd_decode_rgbi(self, handle, state, data, length, dst, pitch, stream):
        return self.decode_status


def _fake_decoder(lib):
    import threading

    dec = jpeg._Decoder.__new__(jpeg._Decoder)
    dec.lib, dec.handle, dec._tls = lib, None, threading.local()
    return dec


def test_only_undecodable_input_is_zero_filled(tmp_path):
    """A missing or empty file and nvJPEG's bad-input statuses (BAD_JPEG 3,
    JPEG_NOT_SUPPORTED 4, INCOMPLETE_BITSTREAM 10) mark a frame for
    zero-fill; any other status (an allocator, execution or internal
    failure) raises."""
    frame = tmp_path / "frame.jpg"
    frame.write_bytes(b"\xff\xd8 some bytes")
    empty = tmp_path / "empty.jpg"
    empty.write_bytes(b"")
    dst = torch.empty((6, 8, 3), dtype=torch.uint8)
    assert _fake_decoder(_FakeNvjpeg()).read_info(frame) == (frame.read_bytes(), 8, 6)
    assert _fake_decoder(_FakeNvjpeg()).read_info(tmp_path / "missing.jpg") is None
    assert _fake_decoder(_FakeNvjpeg()).read_info(empty) is None
    assert _fake_decoder(_FakeNvjpeg()).decode(b"x", dst, 0) is True
    assert sorted(jpeg.BAD_INPUT) == [3, 4, 10]
    for status in jpeg.BAD_INPUT:
        assert _fake_decoder(_FakeNvjpeg(info_status=status)).read_info(frame) is None
        assert _fake_decoder(_FakeNvjpeg(decode_status=status)).decode(b"x", dst, 0) is False
    for status in (2, 5, 6, 8):  # INVALID_PARAMETER, ALLOCATOR, EXECUTION, INTERNAL
        with pytest.raises(RuntimeError, match=f"nvJPEG status {status}"):
            _fake_decoder(_FakeNvjpeg(info_status=status)).read_info(frame)
        with pytest.raises(RuntimeError, match=f"nvJPEG status {status}"):
            _fake_decoder(_FakeNvjpeg(decode_status=status)).decode(b"x", dst, 0)


def test_build_digest_follows_link_flags():
    src = jpeg.SOURCE_DIR / f"{jpeg.LIBRARY}.cu"
    assert _build.source_digest(src) != _build.source_digest(src, ("-lnvjpeg",))
    assert _build.source_digest(src, ("-lnvjpeg",)) == _build.source_digest(src, ("-lnvjpeg",))


def test_host_reads_raise_without_cv2_or_pil(monkeypatch, tmp_path):
    """Without cv2 and PIL a JPEG read on the host raises (the card decodes
    JPEGs); PNGs are read by the port's own reader, which needs neither, and
    a missing PNG raises as cv2's read did."""
    import cv2

    depth = (np.arange(35, dtype=np.uint16).reshape(5, 7) * 300)
    color = np.arange(105, dtype=np.uint8).reshape(5, 7, 3)
    cv2.imwrite(str(tmp_path / "frame.depth.png"), depth)
    cv2.imwrite(str(tmp_path / "frame.color.png"), color[..., ::-1])
    monkeypatch.setattr(pt_io, "_cv2", lambda: None)
    monkeypatch.setattr(pt_io, "_pil_image", lambda: None)
    np.testing.assert_array_equal(pt_io.imread_rgb(tmp_path / "frame.color.png"), color)
    np.testing.assert_array_equal(pt_io.read_depth_image(tmp_path / "frame.depth.png"),
                                  (depth / 1000.0).astype(np.float32))
    with pytest.raises(FileNotFoundError):
        pt_io.read_depth_image(tmp_path / "missing.depth.png")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        pt_io.read_color_image(PATHS[0])


def test_host_helpers_match_jax():
    rng = np.random.default_rng(2)
    for args in ((640, 480, 360), (540, 720, None), (97, 131, 64)):
        assert pt_io.get_resized_wh(*args) == jax_io.get_resized_wh(*args)
        assert pt_io.get_divisible_wh(*args) == jax_io.get_divisible_wh(*args)
    for shape in ((5, 7), (3, 6, 4)):
        x = rng.normal(size=shape).astype(np.float32)
        for a, b in zip(pt_io.pad_bottom_right(x, 9, True), jax_io.pad_bottom_right(x, 9, True)):
            np.testing.assert_array_equal(a, b)
    image = rng.random((6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(pt_io.grayscale3(image), jax_io.grayscale3(image))
    np.testing.assert_array_equal(
        pt_io.color_jitter(np.random.default_rng(3))(image),
        jax_io.color_jitter(np.random.default_rng(3))(image))
