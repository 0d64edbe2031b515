"""PyTorch port: the rotation representations (``geom/rotation.py``) and the
torch quaternion functions (``geom/quaternion.py``) against the JAX
package's on the same numpy inputs, values and gradients, at float32.

Edge cases: the zero rotation vector and small angles (Rodrigues), the
gimbal lock at +-90 degrees of pitch (``matrix_to_euler_xyz``: az = 0), a
quaternion with w < 0, each of the four Shepperd pivots, and pivots that tie
exactly (the first wins in both frameworks) or nearly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapfree_tpu.geom import quaternion as jax_quat
from mapfree_tpu.geom import rotation as jax_rot

from mapfree_tpu_torch.geom import quaternion as pt_quat
from mapfree_tpu_torch.geom import rotation as pt_rot

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _rotations(rng, n):
    return np.asarray(jax_quat.quat2mat(_unit_quats(rng, n)), np.float32)


def _axis_angle_rotation(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    th = np.deg2rad(deg)
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _inputs(name, rng):
    if name == "rotation_matrix_from_ortho6d":
        return rng.normal(size=(16, 6)).astype(np.float32)
    if name == "rodrigues":
        r = rng.normal(size=(16, 3)).astype(np.float32)
        r[0] = 0.0                       # the identity
        r[1] = [1e-7, -2e-7, 0.0]        # below the small-angle guard's reach
        return r
    if name == "inv_rodrigues":
        R = _rotations(rng, 16)
        R[0] = np.eye(3)                                  # theta = 0
        R[1] = _axis_angle_rotation([1, 2, 3], 1e-3)      # a small angle
        return R
    if name == "euler_xyz_to_matrix":
        return rng.uniform(-180, 180, size=(16, 3)).astype(np.float32)
    if name == "matrix_to_euler_xyz":
        R = _rotations(rng, 16)
        # gimbal lock: pitch of exactly +90 and -90 degrees
        R[0] = np.asarray(jax_rot.euler_xyz_to_matrix(jnp.array([30.0, 90.0, 20.0])))
        R[1] = np.asarray(jax_rot.euler_xyz_to_matrix(jnp.array([-40.0, -90.0, 10.0])))
        return R
    if name == "quat2mat":
        q = _unit_quats(rng, 16)
        q[0] = [-0.5, 0.5, -0.5, 0.5]    # w < 0: the same rotation as -q
        q[1] *= 3.0                      # not normalised
        return q
    raise KeyError(name)


CASES = {
    "rotation_matrix_from_ortho6d": (jax_rot.rotation_matrix_from_ortho6d,
                                     pt_rot.rotation_matrix_from_ortho6d),
    "rodrigues": (jax_rot.rodrigues, pt_rot.rodrigues),
    "inv_rodrigues": (jax_rot.inv_rodrigues, pt_rot.inv_rodrigues),
    "euler_xyz_to_matrix": (jax_rot.euler_xyz_to_matrix, pt_rot.euler_xyz_to_matrix),
    "matrix_to_euler_xyz": (jax_rot.matrix_to_euler_xyz, pt_rot.matrix_to_euler_xyz),
    "quat2mat": (jax_quat.quat2mat, pt_quat.quat2mat_torch),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_in_value_and_gradient(name):
    """Values within 1e-5 (degrees for the Euler angles: 1e-3), the gradient
    of a random linear function of the output within 1e-4 of its largest
    entry where the JAX gradient is finite. The gimbal-lock rows of
    ``matrix_to_euler_xyz`` take no gradient comparison: both frameworks
    differentiate arcsin at 1."""
    jfn, pfn = CASES[name]
    rng = np.random.default_rng(len(name))
    x = _inputs(name, rng)
    ref = np.asarray(jfn(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pfn(xt)
    atol = 1e-3 if name == "matrix_to_euler_xyz" else ATOL
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=atol)

    w = rng.normal(size=ref.shape).astype(np.float32)
    rows = slice(2, None) if name == "matrix_to_euler_xyz" else slice(None)
    w[:2] = 0.0 if name == "matrix_to_euler_xyz" else w[:2]
    g_ref = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x)))
    (out * torch.from_numpy(w)).sum().backward()
    g, g_ref = xt.grad.numpy()[rows], g_ref[rows]
    # at the zero rotation JAX's gradient is NaN (the norm's at 0 in
    # rodrigues, arccos' at 1 in inv_rodrigues); torch takes 0 for the norm's
    # gradient at 0, so the port's is finite there. Compared where JAX's is
    finite = np.isfinite(g_ref)
    assert np.isfinite(g[finite]).all()
    np.testing.assert_allclose(g[finite], g_ref[finite], rtol=0,
                               atol=1e-4 * max(np.abs(g_ref[finite]).max(), 1.0))


def test_gimbal_lock_puts_the_in_plane_angle_into_ax():
    """At pitch +-90 degrees only ax - az (or ax + az) is defined: both
    frameworks return az = 0 and the matrix back."""
    angles = np.array([[30.0, 90.0, 20.0], [-40.0, -90.0, 10.0]], np.float32)
    R = pt_rot.euler_xyz_to_matrix(torch.from_numpy(angles))
    back = pt_rot.matrix_to_euler_xyz(R)
    np.testing.assert_array_equal(back[:, 2].numpy(), [0.0, 0.0])
    np.testing.assert_allclose(np.abs(back[:, 1].numpy()), [90.0, 90.0], atol=1e-2)
    np.testing.assert_allclose(pt_rot.euler_xyz_to_matrix(back).numpy(), R.numpy(), atol=1e-3)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jax_rot.matrix_to_euler_xyz(jnp.asarray(R.numpy()))),
                               atol=1e-3)


def _pivot_cases():
    rng = np.random.default_rng(7)
    out = {
        # qw2 = 1 + trace is the largest pivot
        "pivot_w": _axis_angle_rotation([1, 2, 3], 30),
        # 180 degrees about x, y, z: the pivot is that axis (qw2 = 0)
        "pivot_x": _axis_angle_rotation([1, 0.1, 0.2], 175),
        "pivot_y": _axis_angle_rotation([0.1, 1, 0.2], 175),
        "pivot_z": _axis_angle_rotation([0.1, 0.2, 1], 175),
        # 180 degrees about (1, 1, 0) / sqrt 2: qx2 = qy2 = 2, an exact tie
        "tie_x_y": np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float32),
        # 180 degrees about (0, 1, 1) / sqrt 2: qy2 = qz2, an exact tie
        "tie_y_z": np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32),
        # 120 degrees about (1, 1, 1): all four pivots equal 1, ties everywhere
        "tie_all": np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32),
        # qw2 and qx2 within 1e-6 of each other
        "near_tie_w_x": _axis_angle_rotation([1, 0, 0], 90.0001),
        "random": _rotations(rng, 1)[0],
    }
    return out


@pytest.mark.parametrize("name", list(_pivot_cases()))
def test_mat2quat_matches_jax_on_each_pivot(name):
    """The same pivot, hence the same quaternion, with w >= 0, within 1e-6;
    the gradient of a random linear function within 1e-4 of its largest
    entry, except at exact ties, where the two frameworks' argmax choose the
    same candidate but the float32 pivots may not tie after rounding."""
    R = _pivot_cases()[name][None]
    ref = np.asarray(jax_quat.mat2quat(jnp.asarray(R)))
    Rt = torch.from_numpy(R).requires_grad_(True)
    q = pt_quat.mat2quat_torch(Rt)
    np.testing.assert_allclose(q.detach().numpy(), ref, rtol=0, atol=1e-6)
    assert q[0, 0] >= 0.0
    np.testing.assert_allclose(float(q.detach().norm()), 1.0, atol=1e-6)
    # the numpy branch the port keeps for pose extraction agrees too
    np.testing.assert_allclose(pt_quat.mat2quat(R.astype(np.float64)), ref, atol=1e-6)

    w = np.random.default_rng(1).normal(size=(1, 4)).astype(np.float32)
    g_ref = np.asarray(jax.grad(lambda a: jnp.sum(jax_quat.mat2quat(a) * w))(jnp.asarray(R)))
    (q * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(Rt.grad.numpy(), g_ref, rtol=0,
                               atol=1e-4 * max(np.abs(g_ref).max(), 1.0))


def test_mat2quat_and_quat2mat_round_trip_with_w_below_zero():
    """q and -q are one rotation: quat2mat of either, then mat2quat, gives
    the one with w >= 0."""
    q = _unit_quats(np.random.default_rng(3), 32)
    q[:, 0] = -np.abs(q[:, 0])
    R = pt_quat.quat2mat_torch(torch.from_numpy(q))
    np.testing.assert_allclose(R.numpy(), pt_quat.quat2mat_torch(torch.from_numpy(-q)).numpy(),
                               atol=1e-6)
    back = pt_quat.mat2quat_torch(R).numpy()
    np.testing.assert_allclose(back, -q, atol=1e-5)
