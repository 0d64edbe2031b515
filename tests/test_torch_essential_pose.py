"""The port's whole essential-matrix solver (mapfree_tpu_torch/ops/essential.py)
against the JAX package's on injected samples: ``essential_pose_metric``
(8- and 5-point RANSAC, local optimisation, planar rescue, metric scale
from depth) on well-conditioned synthetic pairs (outliers, no pixel noise):
R within 1e-3 rad, metric t within 1e-3 of |t|, equal inlier counts. The
port is handed the minimal samples the JAX function draws from its key
(tests/torch_solvers.py::JaxSampler). With pixel noise the two drift apart
by up to 2e-2 rad (tools/torch_matching_drift.py): the Gauss-Newton
polishes' normal equations are singular along t's scale (damping 1e-8), so
float32 round-off steers them (ROADMAP.md section 3). And the adaptive
ladder's host logic, whole: the same tier results give the same
escalations, the same power-of-two sub-batch and the same merged result in
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_solvers import JaxSampler, K, depth_maps, rot_diff_rad, synth_pairs
from torch_threads import one_torch_thread  # noqa: F401

import mapfree_tpu.ops.essential as je
import mapfree_tpu_torch.ops.essential as pe

N_ITERS = 64


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def solved():
    p = synth_pairs(4, n_points=100, n_outliers=20, noise=0.0, seed=21, pad=12)
    d0, d1 = depth_maps(p)
    Ks = np.tile(K, (4, 1, 1))
    pd0 = np.asarray(je.gather_depth(jnp.asarray(d0), jnp.floor(jnp.asarray(p["k0"]))))
    pd1 = np.asarray(je.gather_depth(jnp.asarray(d1), jnp.floor(jnp.asarray(p["k1"]))))
    key = jax.random.PRNGKey(3)
    args = (p["k0"], p["k1"], p["mask"], Ks, Ks)
    want = je.essential_pose_metric(key, *map(jnp.asarray, args), 2.0, jnp.asarray(pd0),
                                    jnp.asarray(pd1), 0.1, n_iters=N_ITERS)
    want = {k: np.asarray(v) for k, v in want.items()}
    sampler = JaxSampler(key)
    got = pe.essential_pose_metric(*map(T, args), 2.0, T(pd0), T(pd1), 0.1, sampler,
                                   n_iters=N_ITERS)
    got = {k: v.numpy() for k, v in got.items()}
    return p, want, got, sampler


def test_essential_pose_metric_matches_jax(solved):
    p, want, got, sampler = solved
    assert sampler.tags == ["essential8", "essential5", "homography"]
    assert np.all(np.isfinite(got["R"])) and want["valid"].all()
    assert rot_diff_rad(got["R"], want["R"]).max() < 1e-3
    scale = np.linalg.norm(want["t"], axis=-1)
    assert (np.linalg.norm(got["t"] - want["t"], axis=-1) / scale).max() < 1e-3
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    np.testing.assert_array_equal(got["inlier_mask"], want["inlier_mask"])
    np.testing.assert_array_equal(got["adapt"], want["adapt"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["packed"], want["packed"], rtol=1e-3, atol=1e-3)
    # and the truth: metric translation and rotation
    assert np.degrees(rot_diff_rad(got["R"], p["R"])).max() < 0.5
    assert np.abs(got["t"] - p["t"]).max() < 0.05


def _stub_results(B, tier, n_inl, xp):
    """Tier results a stub solver returns for a (sub-)batch whose pairs are
    numbered by ``ids``: R, t and counts that say which tier and pair."""
    def make(ids):
        ids = np.asarray(ids)
        R = np.tile(np.eye(3, dtype=np.float32), (len(ids), 1, 1)) * (1 + tier)
        t = np.stack([ids, np.full(len(ids), tier), ids * 0.5], -1).astype(np.float32)
        inl = n_inl[ids].astype(np.int32)
        adapt = np.stack([inl, np.full(len(ids), 100), np.ones(len(ids))], -1).astype(np.int32)
        n = (inl + tier).astype(np.int32)
        packed = np.concatenate([R.reshape(-1, 9), t, n[:, None], adapt], 1).astype(np.float32)
        out = {"R": R, "t": t, "inliers": n, "inlier_mask": np.zeros((len(ids), 8), bool),
               "valid": np.ones(len(ids), bool), "adapt": adapt, "packed": packed}
        return {k: xp(v) for k, v in out.items()}
    return make


def test_adaptive_ladder_decides_gathers_and_merges_as_jax(monkeypatch):
    """Stub solvers in both packages return the same tier-1 and tier-2
    results (keyed by pair, through kpts0[:, 0, 0] = pair number): the
    escalation decision, the padded power-of-two gather and the merge by
    epipolar-inlier count must give the same result."""
    B = 6
    tier1 = np.array([90, 20, 95, 10, 15, 85])   # epipolar inliers of 100
    tier2 = np.array([0, 30, 0, 5, 60, 0])        # pairs 1 and 4 improve, 3 does not
    calls = {"jax": [], "torch": []}

    def jax_stub(key, kpts0, *args, n5=None, **kw):
        ids = np.asarray(kpts0)[:, 0, 0].astype(int)
        calls["jax"].append((n5, ids.tolist()))
        return _stub_results(len(ids), 0 if n5 == N_ITERS // 2 else 1,
                             tier1 if n5 == N_ITERS // 2 else tier2, jnp.asarray)(ids)

    def torch_stub(kpts0, *args, n5=None, **kw):
        ids = kpts0[:, 0, 0].numpy().astype(int)
        calls["torch"].append((n5, ids.tolist()))
        return _stub_results(len(ids), 0 if n5 == N_ITERS // 2 else 1,
                             tier1 if n5 == N_ITERS // 2 else tier2, torch.as_tensor)(ids)

    monkeypatch.setattr(je, "essential_pose_metric", jax_stub)
    monkeypatch.setattr(pe, "essential_pose_metric", torch_stub)
    k0 = np.zeros((B, 8, 2), np.float32)
    k0[:, 0, 0] = np.arange(B)
    mask = np.ones((B, 8), bool)
    Ks = np.tile(K, (B, 1, 1))
    depths = np.ones((B, 8), np.float32)
    want = je.essential_pose_adaptive(
        jax.random.PRNGKey(0), jnp.asarray(k0), jnp.asarray(k0), jnp.asarray(mask),
        jnp.asarray(Ks), jnp.asarray(Ks), 2.0, n_iters=N_ITERS,
        point_depths=(jnp.asarray(depths), jnp.asarray(depths), 0.1, "ransac"))
    got = pe.essential_pose_adaptive(
        T(k0), T(k0), T(mask), T(Ks), T(Ks), 2.0, JaxSampler(jax.random.PRNGKey(0)),
        n_iters=N_ITERS, point_depths=(T(depths), T(depths), 0.1, "ransac"))
    # tier 1 on all six; tier 2 on the pairs of low inlier ratio (1, 3 and 4;
    # pair 0 does not escalate), padded with pair 0 to a power of two
    assert calls["torch"] == calls["jax"]
    assert calls["jax"] == [(N_ITERS // 2, list(range(B))), (2 * N_ITERS, [1, 3, 4, 0])]
    assert got["escalated"] == 3
    np.testing.assert_array_equal(got["_host_packed"], np.asarray(want["_host_packed"]))
    # pairs 1 and 4 took tier 2's result, pair 3 kept tier 1's
    np.testing.assert_array_equal(got["_host_packed"][:, 10], [0, 1, 0, 0, 1, 0])
