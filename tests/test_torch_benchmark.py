"""PyTorch port, the evaluation layer's host numpy
(mapfree_tpu_torch/benchmark/: the MapFree scorer, its metrics and pose-file
IO, and the 7Scenes localisation toolkit localize.py) against the JAX
package's copies on the same inputs, on the CPU.

- The scorer (``run`` and the CLI's ``main``) on a MapFree tree with a
  submission zip (noisy estimates, frames missing, a malformed line, a
  scene outside the split): the same JSON, exactly;
- pose-file IO, the quaternion angle error and VCRE: equal values;
- localize.py's primitives (vector and quaternion errors, the geometric
  median, the chordal mean, triangulation, essential matrices) on seeded
  inputs: equal to 1e-12 (the same float64 numpy on both sides);
- both pipelines, without RANSAC and with it (``np.random`` seeded alike
  before each: the local optimisation shuffles), over scenes of
  tests/test_localize.py's kind (``synth_scene``): the same printed report,
  returned numbers and saved results.
"""

import io
import json
import types
import zipfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("cv2")

import mapfree_tpu.benchmark.localize as jax_loc  # noqa: E402
import mapfree_tpu.benchmark.mapfree as jax_scorer  # noqa: E402
import mapfree_tpu.benchmark.metrics as jax_metrics  # noqa: E402
import mapfree_tpu.benchmark.utils as jax_butils  # noqa: E402
from fixtures import make_scene  # noqa: E402

import mapfree_tpu_torch.benchmark.localize as pt_loc  # noqa: E402
import mapfree_tpu_torch.benchmark.mapfree as pt_scorer  # noqa: E402
import mapfree_tpu_torch.benchmark.metrics as pt_metrics  # noqa: E402
import mapfree_tpu_torch.benchmark.utils as pt_butils  # noqa: E402
from mapfree_tpu_torch.geom.quaternion import mat2quat, quat2mat  # noqa: E402


def write_submission(root: Path, poses: dict, seed: int) -> Path:
    """pose_<scene>.txt lines of noisy w2c estimates for most evaluated
    frames, one malformed line and a scene outside the split."""
    rng = np.random.default_rng(seed)
    path = root / "submission.zip"
    with zipfile.ZipFile(path, "w") as z:
        for scene, frames in poses.items():
            lines = []
            for i, (name, (q, t)) in enumerate(sorted(frames.items())):
                if name.startswith("seq0") or i % 7 == 3:
                    continue  # the reference frame, and some failures
                q = q + rng.normal(0, 0.02, 4)
                q /= np.linalg.norm(q)
                t = t + rng.normal(0, 0.15, 3)
                conf = rng.uniform(10, 500)
                lines.append(f"{name} " + " ".join(f"{v:.6f}" for v in (*q, *t)) + f" {conf:.3f}")
            lines.insert(2, "seq1/frame_00001.jpg 1 0 0")  # malformed: skipped
            z.writestr(f"pose_{scene}.txt", "\n".join(lines))
        z.writestr("pose_s99999.txt", "seq1/frame_00000.jpg 1 0 0 0 0 0 0 1\n")
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mapfree")
    poses = {f"s{i:05d}": make_scene(root / "val" / f"s{i:05d}", n_queries=40, img_hw=(8, 6),
                                     seed=i, max_angle=0.4)
             for i in range(3)}
    del poses["s00002"]  # a scene the submission leaves out: all its frames fail
    return root, write_submission(root, poses, seed=5)


def test_scorer_gives_the_jax_json(tree, capsys):
    root, zip_path = tree
    ref = jax_scorer.run(zip_path, root / "val")
    got = pt_scorer.run(zip_path, root / "val")
    assert got is not None and ref is not None
    assert json.dumps(got, indent=2) == json.dumps(ref, indent=2)
    assert 0 < got["Estimates for % of frames"] < 1
    out = pt_scorer.main([str(zip_path), "--split", "val", "--dataset_path", str(root)])
    printed = capsys.readouterr().out
    jax_scorer.main(types.SimpleNamespace(submission_path=zip_path, dataset_path=root,
                                          split="val"))
    assert printed == capsys.readouterr().out
    assert json.loads(printed) == json.loads(json.dumps(ref)) and out == got


def test_scorer_on_the_ground_truth_scores_zero_error(tree, tmp_path):
    """A zip of the ground-truth poses themselves: zero errors, precision 1."""
    root, _ = tree
    zip_path = tmp_path / "gt.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        for scene in sorted(p.name for p in (root / "val").iterdir()):
            lines = [ln + " 1.0" for ln in (root / "val" / scene / "poses.txt").read_text().splitlines()
                     if ln.startswith("seq1/")]
            z.writestr(f"pose_{scene}.txt", "\n".join(lines))
    got = pt_scorer.run(zip_path, root / "val")
    assert json.dumps(got) == json.dumps(jax_scorer.run(zip_path, root / "val"))
    assert got["Average Median Translation Error"] < 1e-6
    assert got["Average Median Rotation Error"] < 1e-3
    assert got["Average Median Reprojection Error"] < 1e-3
    assert got["Precision @ VCRE < 90px"] == 1.0 and got["Estimates for % of frames"] == 1.0


def test_pose_io_and_metrics_equal_jax(tree):
    root, zip_path = tree
    scene = root / "val" / "s00000"
    with open(scene / "poses.txt") as f:
        ref = jax_butils.load_poses(f)
    with open(scene / "poses.txt") as f:
        got = pt_butils.load_poses(f)
    assert list(got) == list(ref)
    for k in ref:
        for a, b in zip(got[k][:2], ref[k][:2]):
            np.testing.assert_array_equal(a, b)
    K_ref, K_got = jax_butils.load_K(scene / "intrinsics.txt"), pt_butils.load_K(scene / "intrinsics.txt")
    assert K_got[1:] == K_ref[1:] and all(np.array_equal(K_got[0][k], K_ref[0][k]) for k in K_ref[0])
    rng = np.random.default_rng(3)
    for _ in range(20):
        q0, q1 = rng.normal(size=4), rng.normal(size=4)
        t0, t1 = rng.normal(size=3), rng.normal(size=3)
        for variant in ("sin", "cos"):
            assert (pt_butils.quat_angle_error(q0, q1, variant)
                    == jax_butils.quat_angle_error(q0, q1, variant)).all()
        args = dict(q_gt=q0 / np.linalg.norm(q0), t_gt=t0, q_est=q1 / np.linalg.norm(q1),
                    t_est=t1, confidence=1.0, K=K_ref[0][0], W=K_ref[1], H=K_ref[2])
        got_m = pt_metrics.compute_frame_metrics(pt_metrics.Inputs(**args))
        ref_m = jax_metrics.compute_frame_metrics(jax_metrics.Inputs(**args))
        assert got_m == ref_m
    conf, tp = rng.uniform(size=30).round(1), rng.uniform(size=30) < 0.6
    for a, b in zip(pt_butils.precision_recall(conf, tp, 4), jax_butils.precision_recall(conf, tp, 4)):
        np.testing.assert_array_equal(a, b)


def test_localize_primitives_equal_jax():
    rng = np.random.default_rng(7)
    v0, v1 = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    q0, q1 = rng.normal(size=4), rng.normal(size=4)
    pts = rng.normal(size=(9, 3))
    pts[0] += 20.0  # an outlier for the median
    Rs = np.stack([quat2mat(q / np.linalg.norm(q)) for q in rng.normal(size=(6, 4))])
    R, t = quat2mat(q0 / np.linalg.norm(q0)), rng.normal(size=3)
    P0 = pt_loc.compose_projection_matrix(np.eye(3), np.zeros(3))
    P1 = pt_loc.compose_projection_matrix(R, t)
    X = rng.normal(size=3) + [0, 0, 5]
    x0, x1 = X / X[2], (R @ X + t) / (R @ X + t)[2]
    cases = [
        ("cal_vec_angle_error", (v0, v1)),
        ("cal_quat_angle_error", (q0, q1)),
        ("geometric_median", (pts,)),
        ("chordal_l2_mean_rotation", (Rs,)),
        ("essential_matrix_from_pose", (R, t)),
        ("decompose_essential_matrix", (pt_loc.essential_matrix_from_pose(R, t),)),
        ("triangulate_two_views", (x0[:2], P0, x1[:2], P1)),
        ("hat", (t,)),
    ]
    for name, args in cases:
        got, ref = getattr(pt_loc, name)(*args), getattr(jax_loc, name)(*args)
        got, ref = (got, ref) if isinstance(ref, tuple) else ((got,), (ref,))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-12, err_msg=name)


def _results(loc, n_scenes=2, n_queries=5, n_refs=6, noise=(0.002, 0.01), outliers=2, seed=0):
    """tests/test_localize.py::synth_scene's scenes in ``loc``'s classes:
    queries with n_refs reference pairs, the first ``outliers`` corrupted,
    and one query with none."""
    rng = np.random.default_rng(seed)

    def quat(scale=1.0):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(0.1, 0.8) * scale
        return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])

    results = {}
    for s in range(n_scenes):
        pair_data = {}
        for qi in range(n_queries):
            test_abs = loc.AbsPose(quat(), rng.normal(size=3))
            name = f"seq-01/frame-{qi:06d}.color.png"
            pairs = []
            for i in range(n_refs):
                train = loc.AbsPose(quat(), rng.normal(size=3) * 2)
                R_rel = test_abs.r @ train.r.T
                t_rel = test_abs.t - R_rel @ train.t
                lbl = loc.RelaPose(mat2quat(R_rel), t_rel)
                if i < outliers:
                    pred = loc.RelaPose(quat(), rng.normal(size=3) * 2)
                else:
                    q = mat2quat(R_rel) + rng.normal(size=4) * noise[0]
                    pred = loc.RelaPose(q / np.linalg.norm(q), t_rel + rng.normal(size=3) * noise[1])
                pair = loc.RelaPosePair(name, train, lbl, pred, sim=1.0 - 0.1 * i)
                pair.inliers = float(rng.integers(20, 200))
                pairs.append(pair)
            pair_data[name] = {"test_abs_pose": test_abs, "test_pairs": pairs}
        pair_data["seq-01/frame-000099.color.png"] = {
            "test_abs_pose": loc.AbsPose(quat(), rng.normal(size=3)), "test_pairs": []}
        results[f"scene{s}"] = {"pair_data": pair_data, "no_pt_pairs": [("a", "b")]}
    return results


def _run(loc, fn, tmp_path, **kwargs):
    out = io.StringIO()
    np.random.seed(11)
    with redirect_stdout(out):
        value = fn(_results(loc), save_res_path=tmp_path / "results.npy", **kwargs)
    saved = np.load(tmp_path / "results.npy", allow_pickle=True).item()
    return value, out.getvalue(), saved


@pytest.mark.parametrize("pipeline", ["without_ransac", "with_ransac"])
def test_localize_pipelines_equal_jax(pipeline, tmp_path):
    err_thres = ((0.1, 5), (0.25, 5), (0.5, 10), (1, 20))
    kwargs = ({"err_thres": err_thres} if pipeline == "without_ransac" else
              {"log": None, "ransac_thres": [15, 30], "ransac_iter": 10, "ransac_miu": 1.414,
               "pair_type": "relapose", "err_thres": err_thres})
    name = f"eval_pipeline_{pipeline}"
    (tmp_path / "pt").mkdir()
    (tmp_path / "jax").mkdir()
    got, got_out, got_saved = _run(pt_loc, getattr(pt_loc, name), tmp_path / "pt", **kwargs)
    ref, ref_out, ref_saved = _run(jax_loc, getattr(jax_loc, name), tmp_path / "jax", **kwargs)
    strip = lambda s: "\n".join(ln for ln in s.splitlines() if "testing time" not in ln)
    assert strip(got_out) == strip(ref_out) and "Pass" in got_out
    np.testing.assert_array_equal(np.asarray(got[0], float), np.asarray(ref[0], float))
    np.testing.assert_array_equal(np.asarray(got[1], float), np.asarray(ref[1], float))
    assert list(got_saved) == list(ref_saved)
    for scene in ref_saved:
        for query, r in ref_saved[scene].items():
            g = got_saved[scene][query]
            if r is None:
                assert g is None
                continue
            assert sorted(g) == sorted(r)
            np.testing.assert_array_equal(g["abs_pose_pred"].q, r["abs_pose_pred"].q)
            np.testing.assert_array_equal(g["abs_pose_pred"].t, r["abs_pose_pred"].t)
            for key in ("abs_t_err", "abs_r_err", "inliers"):
                assert g[key] == r[key]
    # the per-scene pose files and, with matplotlib, the PR plots
    pt_loc.save_results_visualisation(tmp_path / "pt" / "results.npy")
    jax_loc.save_results_visualisation(tmp_path / "jax" / "results.npy")
    for f in sorted((tmp_path / "jax").glob("pose_*.txt")):
        assert (tmp_path / "pt" / f.name).read_text() == f.read_text()


def test_pr_plots_without_matplotlib_write_none_and_say_so(tmp_path, monkeypatch, capsys):
    import sys

    (tmp_path / "results.npy").parent.mkdir(exist_ok=True)
    _run(pt_loc, pt_loc.eval_pipeline_without_ransac, tmp_path, err_thres=((0.1, 5), (0.25, 5)))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pt_loc.generate_precision_recall_plots(tmp_path / "results.npy", (0.25, 5))
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [f"matplotlib is not installed: no precision-recall plots written "
                   f"(the numbers are in {tmp_path / 'results.npy'})"]
    assert not list(tmp_path.glob("*.jpg"))
    monkeypatch.undo()  # matplotlib back as it was (its submodules stay loaded)
    pt_loc.generate_precision_recall_plots(tmp_path / "results.npy", (0.25, 5))
    assert sorted(p.name for p in tmp_path.glob("*.jpg")) == ["pr_all.jpg", "pr_scene0.jpg",
                                                              "pr_scene1.jpg"]
