"""The port's essential-matrix pieces (mapfree_tpu_torch/ops/essential.py)
against the JAX package's (mapfree_tpu/ops/essential.py), each on the same
seeded numpy inputs, at 1e-4 of the largest entry: normalisation, the
8-point solve, Sampson residuals (one and many hypotheses), MAGSAC scoring,
the E decomposition and cheirality, the Gauss-Newton polish from a
hypothesis near the truth, the homography DLT, its Faugeras decomposition
and RANSAC (on injected samples), the depth gather and both metric-scale
variants. The Nister 5-point solver is compared in float64: in float32 its
root finding is ill-conditioned enough that both packages' candidates stray
from each other (and from float64) by up to 1e-1 on random minimal samples
while satisfying the constraints equally well; in float64 the two compute
the same function to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_solvers import K, depth_maps, synth_pairs
from torch_threads import one_torch_thread  # noqa: F401

from mapfree_tpu.ops import essential as je
from mapfree_tpu_torch.ops import essential as pe

TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def T(a):
    return torch.as_tensor(np.array(a))


def _pairs(noise, n_outliers):
    p = synth_pairs(3, n_points=120, n_outliers=n_outliers, noise=noise, seed=11, pad=8)
    Ks = np.tile(K, (3, 1, 1))
    x0 = np.asarray(je.normalize_keypoints(jnp.asarray(p["k0"]), jnp.asarray(Ks)))
    x1 = np.asarray(je.normalize_keypoints(jnp.asarray(p["k1"]), jnp.asarray(Ks)))
    return {**p, "Ks": Ks, "x0": x0, "x1": x1, "thr": np.full(3, 2.0 / 120.0, np.float32)}


@pytest.fixture(scope="module")
def pairs():
    """Pairs with outliers and 0.3 px noise."""
    return _pairs(0.3, 20)


@pytest.fixture(scope="module")
def clean():
    """The same scenes without noise or outliers: the weighted least-squares
    refits and the Gauss-Newton polish are well-conditioned there (with
    noise their float32 results move by 1e-4 to 1e-3 for a change of the
    summation order in either package)."""
    return _pairs(0.0, 0)


def _true_E(p):
    def skew(t):
        return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = np.stack([skew(t / np.linalg.norm(t)) @ R for R, t in zip(p["R"], p["t"])])
    return E.astype(np.float32)


def _inlier_weights(pairs, cauchy=False):
    """The true inliers (Sampson residual under the true E below the
    threshold), as 0/1 or as the solver's Cauchy weights: the weighted
    least-squares problems the local optimisation poses once it has found
    the basin (with the outliers at full weight the bottom eigenvalues are
    not separated and 6 inverse-iteration steps stop short)."""
    res = np.asarray(jax.vmap(je.sampson_sq)(*map(jnp.asarray, (_true_E(pairs), pairs["x0"], pairs["x1"]))))
    thr_sq = pairs["thr"][:, None] ** 2
    inl = pairs["mask"] & (res < thr_sq)
    if cauchy:
        return (inl / (1.0 + res / thr_sq)).astype(np.float32)
    return inl.astype(np.float32)


def test_normalize_and_eight_point(pairs, clean):
    got = pe.normalize_keypoints(T(pairs["k0"]), T(pairs["Ks"])).numpy()
    assert _rel(got, pairs["x0"]) < TOL
    pairs = clean
    w = _inlier_weights(pairs)
    want = np.asarray(jax.vmap(je._eight_point)(*map(jnp.asarray, (pairs["x0"], pairs["x1"], w))))
    got = pe._eight_point(T(pairs["x0"]), T(pairs["x1"]), T(w)).numpy()
    s = np.sign(np.sum(want * got, axis=(1, 2)))[:, None, None]  # E up to sign
    assert _rel(got * s, want) < TOL


def test_sampson_scores_and_cheirality(pairs):
    E = _true_E(pairs) + np.random.default_rng(1).normal(0, 1e-2, (3, 3, 3)).astype(np.float32)
    Es = E[:, None] + np.random.default_rng(2).normal(0, 1e-2, (3, 5, 3, 3)).astype(np.float32)
    x0, x1, m = pairs["x0"], pairs["x1"], pairs["mask"]
    want = np.asarray(jax.vmap(je.sampson_sq)(*map(jnp.asarray, (E, x0, x1))))
    assert _rel(pe.sampson_sq(T(E), T(x0), T(x1)).numpy(), want) < TOL
    want_many = np.asarray(jax.vmap(je.sampson_sq_many)(*map(jnp.asarray, (Es, x0, x1))))
    got_many = pe.sampson_sq_many(T(Es), T(x0), T(x1)).numpy()
    assert _rel(got_many, want_many) < TOL
    thr_sq = pairs["thr"] ** 2
    ok = np.ones((3, 5), bool)
    ok[:, 3] = False
    want_s = np.asarray(jax.vmap(je.score_hypotheses, in_axes=(0, 0, 0, 0, 0, 0))(
        *map(jnp.asarray, (Es, ok, x0, x1, m, thr_sq))))
    got_s = pe.score_hypotheses(T(Es), T(ok), T(x0), T(x1), T(m), T(thr_sq), chunk=2).numpy()
    np.testing.assert_array_equal(np.isinf(got_s), np.isinf(want_s))
    assert _rel(got_s[ok], want_s[ok]) < TOL
    R1j, R2j, tj = map(np.asarray, jax.vmap(je.decompose_E)(jnp.asarray(E)))
    R1p, R2p, tp = (a.numpy() for a in pe.decompose_E(T(E)))
    assert max(_rel(R1p, R1j), _rel(R2p, R2j), _rel(tp, tj)) < TOL
    want_c = jax.vmap(je.cheirality_pose)(*map(jnp.asarray, (E, x0, x1, m)))
    got_c = pe.cheirality_pose(T(E), T(x0), T(x1), T(m))
    assert _rel(got_c[0].numpy(), np.asarray(want_c[0])) < TOL
    assert _rel(got_c[1].numpy(), np.asarray(want_c[1])) < TOL
    np.testing.assert_array_equal(got_c[2].numpy(), np.asarray(want_c[2]))
    np.testing.assert_array_equal(got_c[3].numpy(), np.asarray(want_c[3]))


def test_gauss_newton_polish_from_near_the_truth(clean):
    """From a hypothesis near the truth the polish is well-conditioned (far
    from it, its normal equations are singular along t's scale with a 1e-8
    damping, and round-off steers both packages apart: ROADMAP.md
    section 3)."""
    pairs = clean
    E0 = _true_E(pairs) + np.random.default_rng(3).normal(0, 2e-3, (3, 3, 3)).astype(np.float32)
    w = _inlier_weights(pairs, cauchy=True)
    want = np.asarray(jax.vmap(je.refine_essential_gn)(*map(jnp.asarray, (E0, pairs["x0"], pairs["x1"], w))))
    got = pe.refine_essential_gn(T(E0), T(pairs["x0"]), T(pairs["x1"]), T(w)).numpy()
    s = np.sign(np.sum(want * got, axis=(1, 2)))[:, None, None]
    assert _rel(got * s, want) < TOL


def test_five_point_candidates_match_jax_in_float64(pairs):
    """Per minimal sample: the same valid roots and the same E's (up to
    sign) at 1e-4. A few random samples are near-degenerate: there even the
    JAX function's vmapped and one-sample float64 evaluations differ (by
    0.16 on one of 32 in tools/torch_matching_drift.py), and a grid point
    within round-off of a root can bracket it in one package only. So at
    least 28 of the 32 samples must agree."""
    x0 = pairs["x0"][0].astype(np.float64)
    x1 = pairs["x1"][0].astype(np.float64)
    idx = np.random.default_rng(4).choice(120, (32, 5))
    with jax.enable_x64(True):
        Ej, vj = jax.jit(jax.vmap(je._five_point_candidates))(
            jnp.asarray(x0[idx]), jnp.asarray(x1[idx]))
        Ej, vj = np.asarray(Ej), np.asarray(vj)
    assert Ej.dtype == np.float64 and vj.sum() > 32
    Ep, vp = pe._five_point_candidates(torch.from_numpy(x0[idx]), torch.from_numpy(x1[idx]))
    Ep, vp = Ep.numpy(), vp.numpy()
    diff = np.minimum(np.abs(Ep - Ej), np.abs(Ep + Ej)).max(axis=(-2, -1))  # E up to sign
    agree = (vp == vj).all(axis=1) & (diff.max(axis=1) < TOL)
    assert agree.sum() >= 28, agree


def test_homography_pieces_and_ransac(pairs):
    rng = np.random.default_rng(5)
    H = (np.eye(3) + rng.normal(0, 0.05, (3, 3, 3))).astype(np.float32)
    x0 = pairs["x0"]
    y = np.einsum("bij,bnj->bni", H, np.concatenate([x0, np.ones_like(x0[..., :1])], -1))
    x1 = (y[..., :2] / y[..., 2:]).astype(np.float32)
    x1[:, :30] += rng.normal(0, 0.05, (3, 30, 2)).astype(np.float32)  # outliers
    m = pairs["mask"]
    w = m.astype(np.float32)
    want = np.asarray(jax.vmap(je._homography_4pt)(*map(jnp.asarray, (x0, x1, w))))
    got = pe._homography_4pt(T(x0), T(x1), T(w)).numpy()
    s = np.sign(np.sum(want * got, axis=(1, 2)))[:, None, None]
    assert _rel(got * s, want) < TOL
    Rj, tj = map(np.asarray, jax.vmap(je.homography_pose_candidates)(jnp.asarray(H)))
    Rp, tp = (a.numpy() for a in pe.homography_pose_candidates(T(H)))
    assert max(_rel(Rp, Rj), _rel(tp, tj)) < TOL
    key = jax.random.PRNGKey(6)
    thr = pairs["thr"]
    keys = jax.random.split(key, 3)
    Hj, inlj, nj = jax.vmap(lambda k, a, b, mm, t: je.estimate_homography(k, a, b, mm, t, n_iters=64))(
        keys, *map(jnp.asarray, (x0, x1, m, thr)))
    from mapfree_tpu.ops.ransac import masked_sample_indices
    idx = np.asarray(jax.vmap(lambda k, mm: masked_sample_indices(k, mm, 64, 4))(keys, jnp.asarray(m)))
    Hp, inlp, np_ = pe.estimate_homography(T(idx), T(x0), T(x1), T(m), T(thr))
    s = np.sign(np.sum(np.asarray(Hj) * Hp.numpy(), axis=(1, 2)))[:, None, None]
    assert _rel(Hp.numpy() * s, np.asarray(Hj)) < TOL
    np.testing.assert_array_equal(inlp.numpy(), np.asarray(inlj))
    Rj, tj, cj = jax.vmap(je.homography_cheirality_pose)(*map(jnp.asarray, (H, x0, x1, m)))
    Rp, tp, cp = pe.homography_cheirality_pose(T(H), T(x0), T(x1), T(m))
    assert max(_rel(Rp.numpy(), np.asarray(Rj)), _rel(tp.numpy(), np.asarray(tj))) < TOL
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))


@pytest.mark.parametrize("variant", ["ransac", "mean"])
def test_gather_depth_and_metric_scale(pairs, variant):
    d0, d1 = depth_maps(pairs)
    k0, k1 = pairs["k0"], pairs["k1"]
    t_unit = (pairs["t"] / np.linalg.norm(pairs["t"], axis=-1, keepdims=True)).astype(np.float32)
    inl = pairs["mask"].copy()
    want_g = np.asarray(je.gather_depth(jnp.asarray(d0), jnp.floor(jnp.asarray(k0))))
    np.testing.assert_array_equal(pe.gather_depth(T(d0), torch.floor(T(k0))).numpy(), want_g)
    args = (pairs["R"], t_unit, k0, k1, inl, d0, d1, pairs["Ks"], pairs["Ks"])
    want = je.metric_scale_from_depth(*map(jnp.asarray, args), 0.1, variant=variant)
    got = pe.metric_scale_from_depth(*map(T, args), 0.1, variant=variant)
    assert _rel(got[0].numpy(), np.asarray(want[0])) < TOL
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the truth: metric t up to the solver's sign
    err = np.minimum(np.abs(got[0].numpy() - pairs["t"]), np.abs(got[0].numpy() + pairs["t"]))
    assert err.max() < 0.15


def test_pack_outputs(pairs):
    rng = np.random.default_rng(7)
    R, t = rng.normal(size=(3, 3, 3)).astype(np.float32), rng.normal(size=(3, 3)).astype(np.float32)
    n, adapt = np.array([3, 4, 5]), rng.integers(0, 50, (3, 3)).astype(np.int32)
    want = np.asarray(je._pack_outputs(*map(jnp.asarray, (R, t, n, adapt))))
    np.testing.assert_array_equal(pe._pack_outputs(*map(T, (R, t, n, adapt))).numpy(), want)
