"""The port's matching track with the essential-matrix metric solver (the
adaptive ladder on, as configured by default) against the JAX package's
``predict`` over a tiny consistent scene, the port handed the JAX model's
samples of each batch step: R within 1e-3 rad, t within 1e-3 of |t|, equal
inlier counts (tests/test_torch_matching.py has the other solvers, the CLI
and the predictor's rules)."""

import numpy as np
import pytest

pytest.importorskip("cv2")

from torch_batches import matching_case  # noqa: E402
from torch_solvers import rot_diff_rad  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402

from test_torch_matching import assert_same_predictions, jax_predictions, port_predictions  # noqa: E402

from mapfree_tpu.config import cfg as jax_default_cfg  # noqa: E402
from mapfree_tpu_torch.config import cfg as pt_default_cfg  # noqa: E402
from mapfree_tpu_torch.geom.quaternion import quat2mat  # noqa: E402


def test_predict_essential_metric_matches_jax(tmp_path):
    pcfg, poses = matching_case(tmp_path, "EssentialMatrixMetric", pt_default_cfg)
    jcfg, _ = matching_case(tmp_path / "jax", "EssentialMatrixMetric", jax_default_cfg)
    jcfg.DATASET.DATA_ROOT = pcfg.DATASET.DATA_ROOT
    jcfg.MATCHES_FILE_PATH = pcfg.MATCHES_FILE_PATH
    assert pcfg.TPU.ADAPTIVE_RANSAC and jcfg.TPU.ADAPTIVE_RANSAC
    got, want = port_predictions(pcfg, 2), jax_predictions(jcfg, 2)
    assert_same_predictions(got, want)
    for (scene, frame), (R, t, _) in got.items():
        q, t_gt = poses[frame]
        assert np.degrees(rot_diff_rad(R[None], quat2mat(q)[None])[0]) < 1.5
        assert np.linalg.norm(t - t_gt) < 0.08
