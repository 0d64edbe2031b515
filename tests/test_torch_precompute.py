"""PyTorch port, the correspondence precompute tool (``python -m
mapfree_tpu_torch.tools.precompute_correspondences``, its ``main(argv)``
with ``--device cpu``) against the JAX package's on the same tiny MapFree
tree, on the CPU: OpenCV's SIFT on the host in both, the 2-NN ratio matcher
in each package; the NaN-padded ``correspondences_SIFT.npz`` of each scene
must be equal, and the tool without cv2 raises when its matcher is built."""

import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import mapfree_tpu.tools.precompute_correspondences as jax_tool  # noqa: E402
from torch_batches import room_module  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

import mapfree_tpu_torch.tools.precompute_correspondences as pt_tool  # noqa: E402


def write_mapfree_room(scene_dir, views):
    """A MapFree scene of the room: seq0/frame_00000.jpg the reference,
    seq1 the queries, and the poses file the tool reads the queries from."""
    room = room_module()
    K = room.correct_intrinsic_scale(room.SCANNET_K, 160 / room.SCANNET_W, 120 / room.SCANNET_H)
    names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05d}.jpg" for i in range(len(views) - 1)]
    for name, (R, C) in zip(names, views):
        (scene_dir / name).parent.mkdir(parents=True, exist_ok=True)
        rgb, _ = room.render_view(K, R, C, 160, 120)
        cv2.imwrite(str(scene_dir / name), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    (scene_dir / "poses.txt").write_text(
        "# image qw qx qy qz tx ty tz\n" + "".join(f"{n} 1 0 0 0 0 0 0\n" for n in names))


def test_precompute_tool_writes_the_jax_npz(tmp_path, monkeypatch):
    views = room_module().scannet_views(4)
    for s, order in enumerate(([0, 1, 2, 3], [2, 0, 3])):
        write_mapfree_room(tmp_path / "test" / f"s{s:05d}", [views[i] for i in order])
    monkeypatch.setattr(sys, "argv", ["precompute", "-ds", "Mapfree", "--data_root", str(tmp_path),
                                      "--num_features", "512"])
    jax_tool.main()
    ref = {}
    for scene in sorted((tmp_path / "test").iterdir()):
        ref[scene.name] = np.load(scene / "correspondences_SIFT.npz")["correspondences"]
        (scene / "correspondences_SIFT.npz").unlink()
    pt_tool.main(["-ds", "Mapfree", "--data_root", str(tmp_path), "--num_features", "512",
                  "--device", "cpu"])
    for name, table in ref.items():
        got = np.load(tmp_path / "test" / name / "correspondences_SIFT.npz")["correspondences"]
        assert got.shape == table.shape and got.dtype == table.dtype
        np.testing.assert_array_equal(got, table)
        assert (~np.isnan(table[..., 0])).sum(1).min() >= 20  # real matches in every row


def test_precompute_tool_without_cv2_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no cv2"):
        pt_tool.SIFTMatcherBatched((540, 720), device="cpu")
