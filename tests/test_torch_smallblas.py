"""The port's batched small-matrix algebra (mapfree_tpu_torch/geom/smallblas.py)
against the JAX package's (mapfree_tpu/geom/smallblas.py), float32, on the
same seeded numpy inputs: 1e-5 of the largest entry. The inverse-iteration
eigenvectors are compared on spectra with a gap (the regime the RANSAC
solvers use them in: a tiny nullspace under the data spread), and up to sign
where the sign is free."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from mapfree_tpu.geom import smallblas as jsb
from mapfree_tpu_torch.geom import smallblas as psb

RTOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _gapped_psd(n, k, batch, seed):
    """[batch, n, n] PSD matrices with k small eigenvalues, each a factor
    of 100 under the next, under a gap to the rest: inverse iteration then
    converges within its 6 steps, and float32 rounding of M moves the
    eigenvectors far less than the tolerance (with eigenvalues near float32
    round-off of M, both packages' vectors stray from float64's by 1e-4)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        small = rng.uniform(1.0, 2.0, k) * 1e-3 * 1e2 ** np.arange(k)
        ev = np.concatenate([small, rng.uniform(1.0, 5.0, n - k)])
        out.append((Q * ev) @ Q.T)
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def jitted():
    return {
        "eigvecs": jax.jit(jsb.smallest_eigvecs, static_argnums=(1,)),
        "eigvec": jax.jit(jsb.smallest_eigvec),
        "det": jax.jit(jsb.det_small),
        "qr_solve": jax.jit(jsb.qr_solve),
        "null": jax.jit(jsb.nullspace_qr),
        "mgs": jax.jit(jsb._mgs),
    }


@pytest.mark.parametrize("n,k", [(9, 1), (9, 2), (12, 2)])
def test_smallest_eigvecs_match_jax(jitted, n, k):
    M = _gapped_psd(n, k, 6, seed=n + k)
    want = np.asarray(jitted["eigvecs"](jnp.asarray(M), k))
    got = psb.smallest_eigvecs(torch.from_numpy(M), k).numpy()
    assert got.shape == (6, n, k)
    assert _rel(got, want) < RTOL


def test_smallest_eigvec_matches_jax_on_rank_deficient_input(jitted):
    # an exact nullspace (the minimal-sample case): the Tikhonov shift keeps
    # the Cholesky factor finite
    rng = np.random.default_rng(3)
    A = rng.standard_normal((5, 8, 9)).astype(np.float32)
    M = np.einsum("bki,bkj->bij", A, A).astype(np.float32)
    want = np.asarray(jitted["eigvec"](jnp.asarray(M)))
    got = psb.smallest_eigvec(torch.from_numpy(M)).numpy()
    assert _rel(got, want) < RTOL
    # it is the nullspace
    assert np.abs(np.einsum("bki,bi->bk", A, got)).max() < 1e-4


@pytest.mark.parametrize("n", [3, 6, 10])
def test_det_small_matches_jax(jitted, n):
    A = np.random.default_rng(n).standard_normal((7, n, n)).astype(np.float32)
    want = np.asarray(jitted["det"](jnp.asarray(A)))
    got = psb.det_small(torch.from_numpy(A)).numpy()
    assert _rel(got, want) < RTOL
    np.testing.assert_allclose(got, np.linalg.det(A.astype(np.float64)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m", [(3, 1), (6, 1), (10, 10)])
def test_qr_solve_matches_jax(jitted, n, m):
    rng = np.random.default_rng(10 * n + m)
    A = (rng.standard_normal((5, n, n)) + 3 * np.eye(n)).astype(np.float32)
    B = rng.standard_normal((5, n, m)).astype(np.float32)
    want = np.asarray(jitted["qr_solve"](jnp.asarray(A), jnp.asarray(B)))
    got = psb.qr_solve(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert _rel(got, want) < RTOL
    np.testing.assert_allclose(A @ got, B, atol=1e-4)


@pytest.mark.parametrize("m,n", [(5, 9), (8, 9), (2, 4)])
def test_nullspace_qr_matches_jax(jitted, m, n):
    A = np.random.default_rng(m * n).standard_normal((6, m, n)).astype(np.float32)
    want = np.asarray(jitted["null"](jnp.asarray(A)))
    got = psb.nullspace_qr(torch.from_numpy(A)).numpy()
    assert got.shape == (6, n, n - m)
    assert _rel(got, want) < RTOL
    assert np.abs(A @ got).max() < 1e-5


def test_mgs_and_cholesky_solve(jitted):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((4, 9, 3)).astype(np.float32)
    assert _rel(psb._mgs(torch.from_numpy(X)).numpy(), np.asarray(jitted["mgs"](jnp.asarray(X)))) < RTOL
    M = _gapped_psd(7, 0, 3, seed=5) + np.eye(7, dtype=np.float32)
    L = psb._cholesky(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(M.astype(np.float64)), atol=1e-5)
    Y = psb._cho_solve(torch.from_numpy(L), torch.from_numpy(X[:3, :7])).numpy()
    np.testing.assert_allclose(M @ Y, X[:3, :7], atol=1e-4)


def test_smallblas_products_ignore_tf32_flags():
    """The products are broadcast-multiply-sums: the same bits whatever
    torch's TF32 flags say (on the CPU the flags change nothing either way;
    the card's check is chip_smoke.py phase 13)."""
    M = torch.from_numpy(_gapped_psd(9, 1, 3, seed=6))
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        a = psb.smallest_eigvecs(M, 1)
        torch.backends.cuda.matmul.allow_tf32 = False
        b = psb.smallest_eigvecs(M, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(a, b)
