"""PyTorch port, the host reads that the machine with the card must make
without cv2 or PIL (mapfree_tpu_torch/data/io.py):

- ScanNet's 16-bit depth ``.pgm`` (Netpbm P5, maxval 65535, big-endian),
  read by the port's own numpy reader on every host: bit-equal to cv2's
  IMREAD_UNCHANGED on a file cv2 wrote, and to the JAX package's
  ``read_depth_image`` in metres; header comments allowed; every other PNM
  variant raises;
- ``read_color_image`` at the size the image already has returns it
  unchanged (cv2.resize does the same), so 7Scenes' 640x480 PNG frames need
  no image library; a real resize without cv2 and PIL raises the module's
  ``_no_host_reader`` error, not an AttributeError."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import mapfree_tpu.data.io as jax_io  # noqa: E402

from mapfree_tpu_torch.data import io as pt_io  # noqa: E402


@pytest.fixture
def no_image_library(monkeypatch):
    monkeypatch.setattr(pt_io, "_cv2", lambda: None)
    monkeypatch.setattr(pt_io, "_pil_image", lambda: None)


def test_pgm_written_by_cv2_reads_bit_equal(tmp_path, no_image_library):
    depth = np.random.default_rng(0).integers(0, 65536, (480, 640)).astype(np.uint16)
    path = tmp_path / "frame-000000.depth.pgm"
    assert cv2.imwrite(str(path), depth)
    assert path.read_bytes().startswith(b"P5\n640 480\n65535\n")
    got = pt_io.read_pgm16(path)
    assert got.dtype == np.uint16 and got.shape == (480, 640)
    np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(got, depth)
    meters = pt_io.read_depth_image(path)
    assert meters.dtype == np.float32
    np.testing.assert_array_equal(meters, jax_io.read_depth_image(str(path)))


def test_pgm_header_comments_and_whitespace(tmp_path):
    raster = (np.arange(12).reshape(3, 4) * 5000).astype(">u2")
    path = tmp_path / "c.pgm"
    path.write_bytes(b"P5 # magic\n# a comment line\n4\t3\r\n# another\n65535\n" + raster.tobytes())
    np.testing.assert_array_equal(pt_io.read_pgm16(path), raster.astype(np.uint16))
    np.testing.assert_array_equal(pt_io.read_pgm16(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("data, match", [
    (b"P2\n2 1\n65535\n1 2\n", "not a binary PGM"),           # ASCII PGM
    (b"P6\n1 1\n65535\n" + b"\0" * 6, "not a binary PGM"),     # 16-bit PPM
    (b"P7\nWIDTH 1\n", "not a binary PGM"),                     # PAM
    (b"P5\n2 1\n255\n\x01\x02", "maxval 255"),                  # 8-bit PGM
    (b"P5\n2 2\n65535\n\x00\x01", "holds 2 bytes of 8"),        # cut off
    (b"P5\n2", "cut off"),
    (b"P5\n2 x\n65535\n\x00\x01", "not integers"),
])
def test_other_pnm_variants_raise(tmp_path, data, match):
    path = tmp_path / "bad.pgm"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        pt_io.read_pgm16(path)


def test_a_frame_at_its_own_size_needs_no_image_library(tmp_path, monkeypatch):
    """A 640x480 PNG read at (640, 480) equals the frame, with cv2 and PIL
    hidden, and equals what cv2.resize gives (its input, unchanged)."""
    frame = np.random.default_rng(1).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    path = tmp_path / "frame-000000.color.png"
    assert cv2.imwrite(str(path), frame[..., ::-1])
    np.testing.assert_array_equal(cv2.resize(frame, (640, 480)), frame)
    with_cv2 = pt_io.read_color_image(path, (640, 480))
    monkeypatch.setattr(pt_io, "_cv2", lambda: None)
    monkeypatch.setattr(pt_io, "_pil_image", lambda: None)
    got = pt_io.read_color_image(path, (640, 480))
    np.testing.assert_array_equal(got, frame.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got, with_cv2)
    np.testing.assert_array_equal(got, jax_io.read_color_image(str(path), (640, 480)))


def test_a_resize_without_an_image_library_raises(tmp_path, no_image_library):
    frame = np.zeros((48, 64, 3), np.uint8)
    path = tmp_path / "small.color.png"
    assert cv2.imwrite(str(path), frame)
    with pytest.raises(RuntimeError, match="needs cv2 or PIL") as err:
        pt_io.read_color_image(path, (32, 24))
    assert str(err.value) == str(pt_io._no_host_reader(path))


def test_scannet_fixtures_are_what_the_jax_package_decodes(monkeypatch):
    """The committed 1296x968 ScanNet frames (make_fixtures.py scannet) and
    the JAX package's cv2-branch decode of them at 320x240, which
    chip_smoke.py holds the card's nvJPEG decode to; the port's host decode
    gives the same bytes."""
    from pathlib import Path

    fixtures = Path(__file__).resolve().parent / "data" / "torch_port"
    paths = [str(fixtures / f"scannet_{i}.jpg") for i in range(4)]
    monkeypatch.setattr(jax_io, "_HAS_NATIVE", False)
    ref = np.load(fixtures / "jax_decode_scannet_320x240.npz")["uint8"]
    np.testing.assert_array_equal(jax_io.decode_resize_batch(paths, 320, 240, uint8=True), ref)
    np.testing.assert_array_equal(
        pt_io.decode_resize_batch(paths, 320, 240, uint8=True, device="cpu"), ref)
    for p in paths:
        assert cv2.imread(p).shape == (968, 1296, 3)
    assert sum(Path(p).stat().st_size for p in paths) < 1 << 20
