"""The port's PnP and 3D-3D solvers (mapfree_tpu_torch/ops/{pnp,procrustes_ransac}.py)
against the JAX package's, float32, on the same seeded inputs: the pieces
at 1e-4 of the largest entry (DLT, the cubic root, Lambda-Twist P3P,
reprojection residuals, the Gauss-Newton refinement, the dense cloud), and
``pnp_pose`` and ``procrustes_pose`` with ICP, whole, on injected samples
(the JAX function's own draws, tests/torch_solvers.py): R within 1e-3 rad,
t within 1e-3 of |t|, equal inlier counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_solvers import JaxSampler, K, depth_maps, rot_diff_rad, synth_pairs
from torch_threads import one_torch_thread  # noqa: F401

from mapfree_tpu.ops import pnp as jp
from mapfree_tpu.ops import procrustes_ransac as jr
from mapfree_tpu_torch.ops import pnp as pp
from mapfree_tpu_torch.ops import procrustes_ransac as pr

TOL = 1e-4


def T(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


@pytest.fixture(scope="module")
def pairs():
    p = synth_pairs(3, n_points=100, n_outliers=20, noise=0.3, seed=31, pad=6)
    Ks = np.tile(K, (3, 1, 1))
    d0, d1 = depth_maps(p)
    return {**p, "Ks": Ks, "d0": d0, "d1": d1}


def _camera_points(seed, n, planar=False):
    gen = np.random.default_rng(seed)
    Z = np.stack([gen.uniform(-1, 1, n), gen.uniform(-1, 1, n), gen.uniform(2, 6, n)], -1)
    if planar:
        Z[:, 2] = 4.0 + 0.3 * Z[:, 0]
    return Z


def test_p3p_dlt_and_cubic_match_jax():
    gen = np.random.default_rng(1)
    Xs, xs = [], []
    for i in range(24):
        Z = _camera_points(i, 6)
        Xs.append(Z + gen.normal(0, 0.5, 3))
        xs.append(Z[:, :2] / Z[:, 2:])
    X, x = np.stack(Xs).astype(np.float32), np.stack(xs).astype(np.float32)
    # Lambda-Twist in float64: in float32 its depth system is flat near the
    # danger cylinder and both packages' candidates move by up to 1e-2 for a
    # change of summation order (the JAX package's own test allows a tail)
    X64, x64 = X.astype(np.float64), x.astype(np.float64)
    with jax.enable_x64(True):
        Rj, tj, okj = map(np.asarray, jax.jit(jax.vmap(jp._p3p_poses))(
            jnp.asarray(X64[:, :3]), jnp.asarray(x64[:, :3])))
    Rp, tp, okp = (a.numpy() for a in pp._p3p_poses(T(X64[:, :3]), T(x64[:, :3])))
    np.testing.assert_array_equal(okp, okj)
    assert okj.sum() >= 24
    assert _rel(Rp[okj], Rj[okj]) < TOL and _rel(tp[okj], tj[okj]) < TOL
    # the unnormalised DLT's 12x12 normal matrix is ill-conditioned in
    # float32 too (rotations of both packages move by ~1e-2): float64
    w = np.ones((24, 6))
    with jax.enable_x64(True):
        Rj, tj = map(np.asarray, jax.jit(jax.vmap(jp._dlt_pose))(*map(jnp.asarray, (X64, x64, w))))
    Rp, tp = (a.numpy() for a in pp._dlt_pose(T(X64), T(x64), T(w)))
    assert _rel(Rp[:, 0], Rj[:, 0]) < TOL and _rel(tp[:, 0], tj[:, 0]) < TOL
    c = gen.normal(size=(50, 4)).astype(np.float32)
    want = np.asarray(jax.vmap(jp._one_real_cubic_root)(jnp.asarray(c)))
    np.testing.assert_allclose(pp._one_real_cubic_root(T(c)).numpy(), want, rtol=TOL, atol=TOL)


def test_residuals_and_gauss_newton_match_jax(pairs):
    X = np.stack([_camera_points(i, 80) for i in range(3)]).astype(np.float32)
    R = pairs["R"]
    t = pairs["t"]
    Xc = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    x = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    x += np.random.default_rng(2).normal(0, 1e-3, x.shape).astype(np.float32)
    want = np.asarray(jax.vmap(jp._reproj_residual_sq)(*map(jnp.asarray, (R, t, X, x))))
    assert _rel(pp._reproj_residual_sq(T(R), T(t), T(X), T(x)).numpy(), want) < TOL
    R0 = (R + np.random.default_rng(3).normal(0, 1e-2, R.shape)).astype(np.float32)
    w = np.ones(x.shape[:2], np.float32)
    Rj, tj = map(np.asarray, jax.vmap(jp._gauss_newton)(*map(jnp.asarray, (R0, t, X, x, w))))
    Rp, tp = (a.numpy() for a in pp._gauss_newton(T(R0), T(t), T(X), T(x), T(w)))
    assert _rel(Rp, Rj) < TOL and _rel(tp, tj) < TOL


def test_pnp_pose_matches_jax(pairs):
    key = jax.random.PRNGKey(11)
    args = (pairs["k0"], pairs["k1"], pairs["mask"], pairs["d0"], pairs["Ks"], pairs["Ks"])
    want = {k: np.asarray(v) for k, v in jp.pnp_pose(key, *map(jnp.asarray, args), 3.0, n_iters=64).items()}
    sampler = JaxSampler(key)
    got = {k: v.numpy() for k, v in pp.pnp_pose(*map(T, args), 3.0, sampler, n_iters=64).items()}
    assert sampler.tags == ["pnp"]
    assert want["valid"].all() and got["valid"].all()
    assert rot_diff_rad(got["R"], want["R"]).max() < 1e-3
    assert (np.linalg.norm(got["t"] - want["t"], axis=-1) / np.linalg.norm(want["t"], axis=-1)).max() < 1e-3
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    assert np.degrees(rot_diff_rad(got["R"], pairs["R"])).max() < 1.0


def test_procrustes_pose_with_icp_matches_jax(pairs):
    key = jax.random.PRNGKey(12)
    clouds = [jr.dense_cloud_from_depth(pairs[k][i], K, 256, seed=i + j)
              for i in range(3) for j, k in enumerate(("d0", "d1"))]
    icp = {"icp_cloud0": np.stack([c for c, _ in clouds[0::2]]),
           "icp_mask0": np.stack([m for _, m in clouds[0::2]]),
           "icp_cloud1": np.stack([c for c, _ in clouds[1::2]]),
           "icp_mask1": np.stack([m for _, m in clouds[1::2]])}
    for i in range(3):  # the port's copy of the host helper: the same clouds
        c, m = pr.dense_cloud_from_depth(pairs["d0"][i], K, 256, seed=i)
        np.testing.assert_array_equal(c, icp["icp_cloud0"][i])
        np.testing.assert_array_equal(m, icp["icp_mask0"][i])
    args = (pairs["k0"], pairs["k1"], pairs["mask"], pairs["d0"], pairs["d1"], pairs["Ks"], pairs["Ks"])
    want = jr.procrustes_pose(key, *map(jnp.asarray, args), 0.05, n_iters=64, refine=True,
                              **{k: jnp.asarray(v) for k, v in icp.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    sampler = JaxSampler(key)
    got = pr.procrustes_pose(*map(T, args), 0.05, sampler, n_iters=64, refine=True,
                             **{k: T(v) for k, v in icp.items()})
    got = {k: v.numpy() for k, v in got.items()}
    assert sampler.tags == ["procrustes"]
    assert rot_diff_rad(got["R"], want["R"]).max() < 1e-3
    assert (np.linalg.norm(got["t"] - want["t"], axis=-1) / np.linalg.norm(want["t"], axis=-1)).max() < 1e-3
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    np.testing.assert_array_equal(got["valid"], want["valid"])


def test_refine_needs_the_dense_clouds(pairs):
    args = (pairs["k0"], pairs["k1"], pairs["mask"], pairs["d0"], pairs["d1"], pairs["Ks"], pairs["Ks"])
    with pytest.raises(ValueError, match="dense clouds"):
        pr.procrustes_pose(*map(T, args), 0.05, JaxSampler(jax.random.PRNGKey(0)),
                           n_iters=16, refine=True)
