"""PyTorch port, the two SIFT sources of the matching model
(mapfree_tpu_torch/models/matching.py: ``SIFT_TPU``, the on-device SIFT,
and ``SIFT``, OpenCV's on the host) through ``FeatureMatchingModel`` against
the JAX package's model on one batch, on the CPU.

The batch: two pairs of the textured room of the ScanNet fixtures
(tests/data/torch_port/make_fixtures.py::render_view) at 160x120 with their
rendered depth, PnP with file depth, the JAX model's own minimal samples
(its key [0, step], tests/torch_solvers.py::step_sampler). Held:
- the correspondences: the port's (for ``SIFT_TPU`` found, padded and
  depth-gathered on the device in ``dispatch_device``) against the JAX
  model's ``get_correspondences`` (padded on the host): equal masks,
  keypoints within 1e-3 px (tests/test_torch_sift.py's per-keypoint
  tolerance); for ``SIFT`` (the same OpenCV detector in both) bit-equal;
- the poses: R within 1e-3 rad, t within 1e-3 of |t|, equal inlier
  counts; and both within 1 degree and 3 cm of the truth;
- ``SIFT`` without cv2 raises when the model is built, naming cv2 and
  ``SIFT_TPU``; neither source stands in for the other."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from torch_batches import room_batch  # noqa: E402
from torch_solvers import rot_diff_rad, step_sampler  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu.models.matching import FeatureMatchingModel as JaxModel  # noqa: E402

from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.models import matching as pt_matching  # noqa: E402
from mapfree_tpu_torch.models.matching import FeatureMatchingModel  # noqa: E402

W, H = 160, 120
PAIRS = [(0, 1), (2, 3)]


def sift_cfg(default, kind):
    c = default.clone()
    c.MODEL, c.FEATURE_MATCHING, c.POSE_SOLVER = "FeatureMatching", kind, "PNP"
    c.SIFT.NUM_FEATURES, c.SIFT.RATIO_THRESHOLD = 256, 0.8
    c.TPU.MAX_CORRESPONDENCES = 256
    c.TPU.RANSAC_ITERATIONS = 256
    c.PNP.REPROJECTION_INLIER_THRESHOLD = 3.0
    return c


@pytest.fixture(scope="module")
def batch():
    return room_batch(W, H, PAIRS)


@pytest.mark.parametrize("kind", ["SIFT_TPU", "SIFT"])
def test_sift_sources_through_the_model_match_jax(batch, kind):
    model = FeatureMatchingModel(sift_cfg(pt_default_cfg, kind), "cpu",
                                 sampler_for_step=step_sampler)
    ref_model = JaxModel(sift_cfg(jax_default_cfg, kind))
    assert isinstance(model.feature_matching, {"SIFT_TPU": pt_matching.TPUSIFTMatching,
                                               "SIFT": pt_matching.SIFTMatching}[kind])

    # the correspondences the solve receives
    seen = {}
    solve = model._solve

    def spy(d, sampler, times):
        seen.update({k: d[k].numpy() for k in ("pts0", "pts1", "mask", "d0")})
        return solve(d, sampler, times)

    model._solve = spy
    R, t, inliers = model(batch)
    pts0, pts1, mask = ref_model.feature_matching.get_correspondences(batch)
    np.testing.assert_array_equal(seen["mask"], mask)
    assert mask.sum(1).min() >= 30
    if kind == "SIFT":
        np.testing.assert_array_equal(seen["pts0"], pts0)
        np.testing.assert_array_equal(seen["pts1"], pts1)
    else:
        np.testing.assert_allclose(seen["pts0"], pts0, rtol=0, atol=1e-3)
        np.testing.assert_allclose(seen["pts1"], pts1, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(seen["d0"],
                                  JaxModel._gather_depth_host(batch["depth0"], seen["pts0"]))

    R_ref, t_ref, inliers_ref = ref_model(batch)
    np.testing.assert_array_equal(inliers, inliers_ref)
    assert rot_diff_rad(R, R_ref).max() < 1e-3
    t, t_ref = t.reshape(-1, 3), t_ref.reshape(-1, 3)
    assert (np.linalg.norm(t - t_ref, axis=-1) <= 1e-3 * np.linalg.norm(t_ref, axis=-1)).all()
    T = batch["T_0to1"]
    assert np.degrees(rot_diff_rad(R, T[:, :3, :3])).max() < 1.0
    assert np.linalg.norm(t - T[:, :3, 3], axis=-1).max() < 0.03


def test_sift_without_cv2_raises_naming_sift_tpu(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="no cv2: use FEATURE_MATCHING SIFT_TPU"):
        FeatureMatchingModel(sift_cfg(pt_default_cfg, "SIFT"), "cpu")
    # the on-device source needs no cv2 and is what SIFT_TPU builds
    model = FeatureMatchingModel(sift_cfg(pt_default_cfg, "SIFT_TPU"), "cpu")
    assert type(model.feature_matching) is pt_matching.TPUSIFTMatching
    assert model.feature_matching.on_device
    assert not pt_matching.SIFTMatching.on_device


def test_sift_tpu_ships_images_and_depth_maps_not_correspondences(batch):
    """The on-device source's batch crosses to the device as images and
    whole depth maps (its keypoints are found there); the host sources
    ship correspondences and depth gathered at them."""
    from mapfree_tpu_torch.utils.timing import NULL_TIMES

    model = FeatureMatchingModel(sift_cfg(pt_default_cfg, "SIFT_TPU"), "cpu")
    model.solver = "EssentialMatrixMetric"
    named, B = model._named_arrays(batch, NULL_TIMES)
    assert B == len(PAIRS)
    assert [n for n, _ in named] == ["K0", "K1", "depth0", "depth1", "image0", "image1"]
    host = FeatureMatchingModel(sift_cfg(pt_default_cfg, "SIFT"), "cpu")
    host.solver = "EssentialMatrixMetric"
    named, _ = host._named_arrays(batch, NULL_TIMES)
    assert [n for n, _ in named] == ["pts0", "pts1", "K0", "K1", "d0", "d1", "mask"]
    assert torch.is_tensor(model.feature_matching.correspond(
        torch.from_numpy(batch["image0"]), torch.from_numpy(batch["image1"]))[0])
