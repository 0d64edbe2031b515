"""PyTorch port, the scene renderer (mapfree_tpu_torch/visualisation/) and
``utils/visualisation.py::save_video``, against the JAX package's numpy
renderer (mapfree_tpu/visualisation/) on the CPU.

- the mesh helpers, ``look_at``, ``LazyCamera`` and the colour helpers give
  the JAX package's arrays exactly (they are the port's own copies);
- ``Rasterizer`` frames and depth buffers equal the JAX rasterizer's, bit for
  bit: an occlusion scene, a textured scene, and random triangles with
  repeated (equal-depth) faces, the z-buffer fill running as tensor
  operations in float64 over chunks of triangles;
- ``blend_overlay`` within one level of cv2's INTER_LINEAR resize, which
  works in 11-bit fixed point, and equal elsewhere;
- ``render_scene``'s frames, captured by a stand-in ``cv2.VideoWriter``,
  equal the JAX function's (within one level inside the picture-in-picture
  overlay); with cv2 hidden no MP4 is written and one line says so;
- ``render_estimates.main`` on a tiny tree against the JAX CLI, and
  ``save_video`` with and without cv2.
"""

import argparse
import importlib
import sys
from zipfile import ZipFile

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import mapfree_tpu.visualisation.raster as jax_raster  # noqa: E402
import mapfree_tpu.visualisation.render_estimates as jax_estimates  # noqa: E402
from fixtures import gt_submission_line, make_scene  # noqa: E402
from mapfree_tpu.visualisation.lazy_camera import LazyCamera as JaxLazyCamera  # noqa: E402

import mapfree_tpu_torch.visualisation.raster as pt_raster  # noqa: E402
import mapfree_tpu_torch.visualisation.render_estimates as pt_estimates  # noqa: E402
from mapfree_tpu_torch.utils.visualisation import save_video  # noqa: E402
from mapfree_tpu_torch.visualisation import LazyCamera  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

# the modules (each package's __init__ binds the name to the function)
jax_scene = importlib.import_module("mapfree_tpu.visualisation.render_scene")
pt_scene = importlib.import_module("mapfree_tpu_torch.visualisation.render_scene")


def test_mesh_helpers_match_jax():
    rng = np.random.default_rng(0)
    R = jax_scene.quat2mat(rng.normal(size=4))
    c = rng.normal(size=3)
    for name, args in [
            ("frustum_corners", (R, c, 0.3, 0.7)),
            ("frustum_mesh", (R, c, (10, 20, 30), 0.35)),
            ("frustum_image_plane", (R, c)),
            ("cuboid_from_line", (c, c + rng.normal(size=3), (1, 2, 3), 0.02)),
            ("cuboid_from_line", (c, c + np.array([0.0, 1.0, 0.01]), (1, 2, 3))),
            ("cuboid_from_line", (c, c, (1, 2, 3))),  # degenerate: no triangles
            ("position_marker", (c, (4, 5, 6), 0.05)),
            ("ground_grid", (c, 2.5, 0.4)),
            ("ground_grid", (c, 1.0, -0.1, 5, (1, 1, 1), (2, 2, 2))),
            ("retro_colormap", (0.37,)),
            ("retro_colormap", (1.7,)),
            ("look_at", (c, c + rng.normal(size=3))),
            ("look_at", (np.zeros(3), np.array([0.0, 2.0, 0.0]))),  # up parallel to view
    ]:
        got = getattr(pt_raster, name)(*args)
        want = getattr(jax_raster, name)(*args)
        got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(pt_scene.frustum_points(R, c, 0.2),
                                  jax_scene.frustum_points(R, c, 0.2))
    for args in [(0.0, 0.0), (0.1, 2.0), (1.0, 0.0), (0.0, 90.0)]:
        assert pt_scene.error_color(*args) == jax_scene.error_color(*args)

    ours, theirs = LazyCamera(smoothing=0.7, back_off=1.5), JaxLazyCamera(0.7, 1.5)
    for step in range(4):
        target = rng.normal(size=3)
        view = None if step % 2 else rng.normal(size=3)
        ours.update(target, view)
        theirs.update(target, view)
        np.testing.assert_array_equal(ours.center, theirs.center)
        np.testing.assert_array_equal(ours.position, theirs.position)
        assert ours.elev_azim() == theirs.elev_azim()


def _pair(W=160, H=120, eye=(0.0, 0.0, -3.0)):
    jr, pr = jax_raster.Rasterizer(W, H), pt_raster.Rasterizer(W, H, device="cpu")
    for r in (jr, pr):
        r.set_view(np.array(eye), np.zeros(3))
    return jr, pr


def _same(jr, pr):
    np.testing.assert_array_equal(pr.color.numpy(), jr.color)
    np.testing.assert_array_equal(pr.depth.numpy(), jr.depth)


def test_rasterizer_occlusion_matches_jax():
    jr, pr = _pair()
    far = np.array([[[-1, -1, 2.0], [1, -1, 2.0], [0, 1, 2.0]]])
    near = np.array([[[-1, -1, 0.0], [1, -1, 0.0], [0, 1, 0.0]]])
    for r in (jr, pr):
        r.draw_triangles(far, np.array([[255, 0, 0]]), shade=False)
        r.draw_triangles(near, np.array([[0, 255, 0]]), shade=False)
        r.draw_triangles(far, np.array([[255, 0, 0]]), shade=True)
    _same(jr, pr)
    assert pr.color[60, 80, 1] > 200  # the near (green) triangle wins


def test_rasterizer_texture_matches_jax():
    jr, pr = _pair()
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:4, :4] = (255, 0, 0)
    tex[4:, 4:] = (0, 0, 255)
    tris = np.array([[[-1, -1, 0.0], [1, -1, 0.0], [1, 1, 0.0]],
                     [[-1, -1, 0.0], [1, 1, 0.0], [-1, 1, 0.0]]])
    uv = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float64)
    for r in (jr, pr):
        r.draw_triangles(tris, np.zeros((2, 3)), shade=False, texture=tex, uvs=uv)
        r.draw_triangles(tris * 0.5, np.zeros((2, 3)), shade=True, texture=tex, uvs=uv)
    _same(jr, pr)
    assert pr.color[20, 40, 0] > 200 and pr.color[100, 120, 2] > 200


@pytest.mark.parametrize("budget", [1 << 21, 500])
def test_rasterizer_random_triangles_match_jax(budget, monkeypatch):
    """Random triangles, a block of them drawn twice (ties at equal depth
    keep the first-drawn), the near-plane cull, textures and the grid; a
    small fragment budget splits every draw call into many chunks."""
    monkeypatch.setattr(pt_raster, "FRAGMENT_BUDGET", budget)
    rng = np.random.default_rng(3)
    jr, pr = _pair(eye=(0.3, -0.5, -3.0))
    tris = rng.normal(size=(60, 3, 3)) * 1.3
    tris[10:20] = tris[0:10]
    cols = rng.integers(0, 256, (60, 3))
    tex = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    uv = rng.uniform(0, 1, (60, 3, 2))
    grid, grid_cols = jax_raster.ground_grid(np.zeros(3), 3.0, 1.0)
    for r in (jr, pr):
        r.draw_triangles(tris, cols, shade=True)
        r.draw_triangles(tris[:5] * 0.5, cols[:5], shade=False)
        r.draw_triangles(tris * 0.8, np.zeros((60, 3)), shade=False, texture=tex, uvs=uv)
        r.draw_triangles(grid, grid_cols, shade=False)
    _same(jr, pr)


def test_blend_overlay_within_one_level():
    rng = np.random.default_rng(4)
    for W, H, shape in [(160, 120, (30, 40, 3)), (320, 240, (720, 540, 3)),
                        (96, 72, (5, 7, 3))]:
        jr, pr = _pair(W, H)
        image = rng.integers(0, 256, shape).astype(np.uint8)
        jr.blend_overlay(image)
        pr.blend_overlay(image)
        diff = np.abs(pr.color.numpy().astype(int) - jr.color)
        assert diff.max() <= 1
        h = int(H * 0.28)
        w = int(round(h * shape[1] / shape[0]))
        inside = np.zeros((H, W), bool)
        inside[2:2 + h, W - w - 2:W - 2] = True
        assert not diff[~inside].any()


class Recorder:
    """Stands in for cv2.VideoWriter: keeps every frame written per path."""

    videos = {}

    def __init__(self, path, fourcc, fps, size):
        self.frames = Recorder.videos.setdefault(str(path), [])
        self.size = size

    def write(self, frame):
        assert frame.shape == (self.size[1], self.size[0], 3)
        self.frames.append(frame.copy())

    def release(self):
        pass


@pytest.fixture
def recorder(monkeypatch):
    Recorder.videos = {}
    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    return Recorder.videos


def _scene():
    q = np.array([1.0, 0, 0, 0])
    gt = {i: (q, np.array([0.1 * i, 0.05 * i, 1.0]), None) for i in range(0, 25, 5)}
    est = {0: (q, np.array([0.0, 0.02, 1.0]), 50.0),
           5: (np.array([0.99, 0.1, 0.0, 0.05]), np.array([0.5, 0.3, 1.2]), 10.0),
           15: (q, np.array([1.4, 0.9, 1.1]), 1.0)}  # 10, 20: no estimate
    return gt, est


def _overlay_mask(W, H, image_shape):
    h = int(H * 0.28)
    w = int(round(h * image_shape[1] / image_shape[0]))
    mask = np.zeros((H, W, 1), bool)
    mask[2:2 + h, W - w - 2:W - 2] = True
    return mask


@pytest.mark.parametrize("with_images", [False, True])
def test_render_scene_frames_match_jax(recorder, tmp_path, with_images):
    gt, est = _scene()
    images = None
    if with_images:
        rng = np.random.default_rng(5)
        images = {i: rng.integers(0, 256, (48, 64, 3)).astype(np.uint8) for i in (0, 10, 15)}
    kw = dict(confidence_threshold=5.0, fps=2, size=(240, 180), scene_images=images)
    n_jax = jax_scene.render_scene(gt, est, tmp_path / "jax.mp4", **kw)
    n_pt = pt_scene.render_scene(gt, est, tmp_path / "pt.mp4", device="cpu", **kw)
    assert n_jax == n_pt == 5
    want, got = recorder[str(tmp_path / "jax.mp4")], recorder[str(tmp_path / "pt.mp4")]
    assert len(want) == len(got) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        diff = np.abs(g.astype(int) - w)
        if images is not None and 5 * i in images:
            overlay = _overlay_mask(240, 180, (48, 64))
            assert diff.max() <= 1 and not (diff * ~overlay).any(), i
        else:
            assert not diff.any(), i
    assert any(np.abs(a.astype(int) - b).sum() > 0 for a, b in zip(got, got[1:]))


def test_render_scene_without_cv2_writes_no_mp4_and_says_so(monkeypatch, tmp_path, capsys):
    gt, est = _scene()
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    out = tmp_path / "scene.mp4"
    n = pt_scene.render_scene(gt, est, out, size=(96, 72), device="cpu")
    assert n == 5 and not out.exists()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "cv2" in ln]
    assert len(lines) == 1 and "5 frames" in lines[0] and "no MP4" in lines[0]
    frames = list(pt_scene.render_frames(gt, est, size=(96, 72), device="cpu"))
    titles = [t for _, t in frames]
    assert titles[1] == "frame 5: terr=0.21m rerr=12.9deg" and titles[2] == "frame 10: no estimate"
    assert frames[0][0].dtype == torch.uint8 and frames[0][0].shape == (72, 96, 3)


def _estimates_tree(root):
    gts = {}
    for s in range(2):
        scene = root / "val" / f"s{s:05d}"
        gts[scene.name] = make_scene(scene, n_queries=11, img_hw=(48, 36), seed=s,
                                     max_angle=0.3, t_scale=0.3)
    with ZipFile(root / "submission.zip", "w") as z:
        # scene 1 has no estimates: skipped
        lines = [gt_submission_line(name, q, t + 0.05) for name, (q, t) in
                 gts["s00000"].items() if name.startswith("seq1/") and
                 int(name[-9:-4]) % 5 == 0 and name != "seq1/frame_00005.jpg"]
        z.writestr("pose_s00000.txt", "\n".join(lines))
    return root


def test_render_estimates_main_matches_jax(recorder, tmp_path, capsys):
    root = _estimates_tree(tmp_path)
    argv = [str(root / "submission.zip"), "--dataset_path", str(root), "-o",
            str(tmp_path / "pt"), "--device", "cpu"]
    rendered = pt_estimates.main(argv)
    jax_estimates.main(argparse.Namespace(
        submission_path=root / "submission.zip", dataset_path=root, split="val",
        scenes=None, output=tmp_path / "jax", confidence_threshold=0.0, fps=5,
        no_images=False))
    out = capsys.readouterr().out
    assert "skipping s00001: no estimates in submission" in out
    assert rendered == {"s00000": 3}
    got = recorder[str(tmp_path / "pt" / "s00000.mp4")]
    want = recorder[str(tmp_path / "jax" / "s00000.mp4")]
    assert len(got) == len(want) == 3
    overlay = _overlay_mask(960, 720, (48, 36))
    for g, w in zip(got, want):
        diff = np.abs(g.astype(int) - w)
        assert diff.max() <= 1 and not (diff * ~overlay).any()


class _Loader:
    def __iter__(self):
        rng = np.random.default_rng(6)
        for b in range(2):
            yield {"scene_id": ["sA", "sB"], "pair_names": [("r", f"q{b}a"), ("r", f"q{b}b")],
                   "image0": rng.uniform(0, 1, (2, 24, 32, 3)),
                   "image1": rng.uniform(0, 1, (2, 24, 32, 3))}


def test_save_video_with_and_without_cv2(recorder, monkeypatch, tmp_path, capsys):
    results = {"sA": {"q0a": {"abs_t_err": 0.1, "abs_r_err": 2.0}, "q1a": None}}
    np.save(tmp_path / "results.npy", results, allow_pickle=True)
    assert save_video(tmp_path / "results.npy", _Loader(), tmp_path / "v") == ["sA"]
    frames = recorder[str(tmp_path / "v" / "video_sA.mp4")]
    assert len(frames) == 2 and frames[0].shape == (24, 64, 3)

    monkeypatch.setitem(sys.modules, "cv2", None)
    assert save_video(tmp_path / "results.npy", _Loader(), tmp_path / "w") == ["sA"]
    assert not list((tmp_path / "w").iterdir())
    assert "no video written" in capsys.readouterr().out
