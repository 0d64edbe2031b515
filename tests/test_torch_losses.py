"""PyTorch port: the loss registry and the pose-error metrics against the
JAX package, values and gradients, on the same numpy inputs; and the
gradient through the Kabsch solve (3x3 Jacobi SVD) that the losses reach."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapfree_tpu import losses as jax_losses
from mapfree_tpu import metrics as jax_metrics
from mapfree_tpu.geom import quat2mat
from mapfree_tpu.geom.procrustes import procrustes as jax_procrustes

from mapfree_tpu_torch import losses as pt_losses
from mapfree_tpu_torch import metrics as pt_metrics
from mapfree_tpu_torch.geom.procrustes import procrustes as pt_procrustes

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PORTED = ["rot_frobenius_loss", "rot_l1_loss", "rot_angle_loss", "trans_l2_loss",
          "trans_l1_loss", "trans_ang_loss", "empty_loss"]
# the losses of the quaternion, 6D and angular-bin heads, which read the heads'
# aux entries (tests/test_torch_heads_losses.py holds them against the JAX
# package)
LATER = ["rot_bin_loss", "quat_l1_loss", "robust_quat_l1_loss",
         "trans_scale_direction_loss", "trans_scale_l1_loss", "trans_sphbin_loss"]


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return quat2mat(q).astype(np.float32)


def _case(B=12, seed=0):
    """Predictions a little off the ground truth, so that no clip is active
    and every loss has a gradient."""
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = _rotations(rng, B)
    T[:, :3, 3] = rng.normal(size=(B, 3))
    R = T[:, :3, :3] @ _rotations(rng, B) + rng.normal(size=(B, 3, 3)).astype(np.float32) * 0.05
    t = (T[:, :3, 3] + rng.normal(size=(B, 3)) * 0.3).astype(np.float32)[:, None, :]
    return R.astype(np.float32), t, T


def test_registry_holds_the_ported_losses():
    assert sorted(pt_losses.LOSSES) == sorted(PORTED + LATER) == sorted(jax_losses.LOSSES)


@pytest.mark.parametrize("name", PORTED)
def test_loss_matches_jax_in_value_and_gradient(name):
    """rtol 1e-5 on the value, 1e-4 of the largest entry on the gradients
    (acos near the clip amplifies float32 round-off)."""
    R, t, T = _case()

    def jloss(R, t):
        return jax_losses.get_loss(name)({"R": R, "t": t}, {"T_0to1": jnp.asarray(T)})

    ref, (gR, gt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(R), jnp.asarray(t))
    Rt = torch.from_numpy(R).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    out = pt_losses.get_loss(name)({"R": Rt, "t": tt}, {"T_0to1": torch.from_numpy(T)})
    assert out.shape == () and out.dtype == torch.float32
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5, atol=1e-7)
    if name == "empty_loss":
        assert not out.requires_grad
        return
    out.backward()
    for g, r in ((Rt.grad, gR), (tt.grad, gt)):
        r = np.asarray(r)
        got = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(got, r, atol=1e-4 * max(np.abs(r).max(), 1e-3))


@pytest.mark.parametrize("name", LATER)
def test_unported_loss_raises_naming_its_slice(name):
    """The heads' losses are registered under the JAX package's names and
    ``get_loss`` returns them (none is left to raise)."""
    fn = pt_losses.get_loss(name)
    assert fn is pt_losses.LOSSES[name] and fn.__name__ == jax_losses.get_loss(name).__name__


def test_unknown_loss_raises():
    with pytest.raises(NotImplementedError, match="Invalid loss"):
        pt_losses.get_loss("no_such_loss")


@pytest.mark.parametrize("lam", [1.0, 0.3, 0.0])
def test_combined_loss_matches_jax(lam):
    """Fixed LAMBDA, and the Kendall form (LAMBDA == 0) with its gradient to
    the learnable weights."""
    R, t, T = _case(seed=1)
    s_r, s_t = np.array([0.3], np.float32), np.array([-0.2], np.float32)

    def jloss(s_r, s_t):
        return jax_losses.combined_loss(
            {"R": jnp.asarray(R), "t": jnp.asarray(t)}, {"T_0to1": jnp.asarray(T)},
            "rot_angle_loss", "trans_l1_loss", lam, s_r=s_r, s_t=s_t)[2]

    ref = jax_losses.combined_loss(
        {"R": jnp.asarray(R), "t": jnp.asarray(t)}, {"T_0to1": jnp.asarray(T)},
        "rot_angle_loss", "trans_l1_loss", lam, s_r=jnp.asarray(s_r), s_t=jnp.asarray(s_t))
    sr = torch.from_numpy(s_r).requires_grad_(True)
    st = torch.from_numpy(s_t).requires_grad_(True)
    out = pt_losses.combined_loss(
        {"R": torch.from_numpy(R), "t": torch.from_numpy(t)},
        {"T_0to1": torch.from_numpy(T)}, "rot_angle_loss", "trans_l1_loss", lam,
        s_r=sr, s_t=st)
    for o, r in zip(out, ref):
        assert o.shape == ()
        np.testing.assert_allclose(float(o.detach()), float(r), rtol=1e-5)
    if lam == 0.0:
        out[2].backward()
        g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(s_r), jnp.asarray(s_t))
        np.testing.assert_allclose(sr.grad.numpy(), np.asarray(g[0]), rtol=1e-5)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(g[1]), rtol=1e-5)


def test_pose_error_matches_jax():
    R, t, T = _case(seed=2)
    ref = jax_metrics.pose_error(jnp.asarray(R), jnp.asarray(t), jnp.asarray(T))
    out = pt_metrics.pose_error(torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(T))
    assert set(out) == set(ref)
    for key, r in ref.items():
        assert out[key].shape == tuple(r.shape) == (12, 1)
        # degrees: acos amplifies float32 round-off near 0 and 180
        np.testing.assert_allclose(out[key].numpy(), np.asarray(r), rtol=1e-4, atol=1e-3)


def test_host_metrics_match_jax_package():
    rng = np.random.default_rng(3)
    errs = np.abs(rng.normal(size=200)) * 10
    errs[5] = np.nan
    for thr in ((5, 10, 20), (0.1, 0.5, 1.0)):
        assert pt_metrics.error_auc(errs, thr) == jax_metrics.error_auc(errs, thr)
    sym = 1.0 + np.abs(rng.normal(size=100))
    assert pt_metrics.A_metrics(sym) == jax_metrics.A_metrics(sym)
    agg = {"R_err": errs[:100], "t_err_euc": sym}
    assert pt_metrics.precision(agg, 5.0, 1.5) == jax_metrics.precision(agg, 5.0, 1.5)
    for a, b in zip(pt_metrics.ecdf(sym), jax_metrics.ecdf(sym)):
        np.testing.assert_array_equal(a, b)


def test_metrics_accumulator_takes_tensors_and_arrays(capsys):
    acc = pt_metrics.MetricsAccumulator()
    acc.accumulate({"R_err": torch.tensor([[1.0], [2.0]]), "t_err_ang": np.array([3.0, 4.0]),
                    "t_err_euc": np.array([0.05, 0.7])})
    acc.accumulate({"R_err": np.array([[30.0]]), "t_err_ang": torch.tensor([1.0]),
                    "t_err_euc": torch.tensor([2.0])})
    agg = acc.aggregate()
    np.testing.assert_array_equal(agg["R_err"], [1.0, 2.0, 30.0])
    pt_metrics.print_auc_table(agg)
    ours = capsys.readouterr().out
    jax_metrics.print_auc_table(agg)
    assert ours == capsys.readouterr().out and "Pose error AUC" in ours


def _procrustes_grads(A, B, W1, W2):
    tA = torch.from_numpy(A).requires_grad_(True)
    tB = torch.from_numpy(B).requires_grad_(True)
    R, t = pt_procrustes(tA, tB)
    ((R * torch.from_numpy(W1)).sum() + (t * torch.from_numpy(W2)).sum()).backward()
    return tA.grad.numpy(), tB.grad.numpy()


def test_procrustes_gradient_matches_jax():
    """The straight-line Jacobi SVD under autograd against jax.grad of the
    same code: 1e-4 of the largest gradient entry."""
    rng = np.random.default_rng(4)
    A, B = (rng.normal(size=(16, 6, 3)).astype(np.float32) for _ in range(2))
    W1 = rng.normal(size=(16, 3, 3)).astype(np.float32)
    W2 = rng.normal(size=(16, 1, 3)).astype(np.float32)

    def jloss(A, B):
        R, t = jax_procrustes(A, B)
        return jnp.sum(R * W1) + jnp.sum(t * W2)

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(B))
    for g, r in zip(_procrustes_grads(A, B, W1, W2), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max())


def test_procrustes_gradient_is_finite_on_degenerate_input():
    """Already-diagonal (off-diagonals exactly zero, so every Jacobi rotation
    takes its identity branch with a huge zeta), rank-deficient and all-zero
    correspondences: the values are the reference's, and no NaN comes out of
    the branches not taken."""
    eye2 = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    A = np.stack([eye2 * np.array([1.0, 2.0, 3.0], np.float32),   # H = diag(2, 8, 18)
                  eye2,                                            # H = 2 I
                  np.outer(np.arange(6.0), [1.0, 2.0, 3.0]).astype(np.float32),  # rank 1
                  np.ones((6, 3), np.float32)])                    # rank 0
    B = A.copy()
    B[2] = np.outer(np.arange(6.0), [1.0, 0.0, 0.0])
    W1 = np.ones((4, 3, 3), np.float32)
    W2 = np.ones((4, 1, 3), np.float32)
    gA, gB = _procrustes_grads(A, B, W1, W2)
    assert np.all(np.isfinite(gA)) and np.all(np.isfinite(gB))
    R, t = pt_procrustes(torch.from_numpy(A), torch.from_numpy(B))
    Rj, tj = jax_procrustes(jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-5)
