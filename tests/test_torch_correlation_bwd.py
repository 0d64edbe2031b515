"""PyTorch port: the correlation warp's gradient (the autograd Function over
K1, K2, K3) against the JAX package's ``custom_vjp``.

The JAX side runs its Pallas kernels under the interpreter, as
tests/test_correlation.py does. The port's CPU route is the written-out plain
backward (:func:`fused_correlation_warp_bwd_plain`) behind the same Function
that launches the CUDA kernels on the card; the kernels themselves are held
against it there (``cuda`` marker; skipped without a card).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapfree_tpu.models.aggregators import _uv_grid as jax_uv_grid
from mapfree_tpu.ops.correlation import fused_correlation_warp as jax_fcw

from mapfree_tpu_torch.ops import correlation as pt_corr


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none (decided at run
    time, never at import, so every test process collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(B, H, W, C, seed, cv=None):
    rng = np.random.default_rng(seed)
    HW = H * W
    q, k = (rng.normal(size=(B, HW, C)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, HW, cv or C)).astype(np.float32)
    # fixed random weights on the three outputs: every cotangent is nonzero
    w = [rng.normal(size=(B, HW, n)).astype(np.float32) for n in (cv or C, 2, 1)]
    return q, k, v, np.array(jax_uv_grid(H, W, jnp.float32)), w


def _torch_grads(fn, q, k, v, grid, w, dtype=torch.float32, device="cpu"):
    q, k, v = (torch.from_numpy(a).to(device, dtype).requires_grad_(True) for a in (q, k, v))
    g = torch.from_numpy(grid).to(device).requires_grad_(True)
    out = fn(q, k, v, g)
    loss = sum((o * torch.from_numpy(ww).to(device)).sum() for o, ww in zip(out, w))
    loss.backward()
    return [t.grad for t in (q, k, v)], g.grad


# (name, B, H, W, C): the gradient cases of tests/test_correlation.py (HW=48
# and the mid-window HW=576) and a ragged HW=130
GRAD_CASES = [
    ("hw48_c16", 2, 6, 8, 16),
    ("hw130_c32", 2, 10, 13, 32),
    ("hw576_b1_c8", 1, 24, 24, 8),
]


@pytest.mark.parametrize("name,B,H,W,C", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_function_gradients_match_jax_custom_vjp(name, B, H, W, C):
    """atol 1e-3, the bound of tests/test_correlation.py for the interpreted
    kernels against autodiff; against torch autograd of the plain forward
    (no ties in random data, so it computes the same function) 2e-5 relative
    to the largest gradient: float32 sums in another order."""
    q, k, v, grid, w = _inputs(B, H, W, C, seed=len(name))

    def jloss(q, k, v):
        out = jax_fcw(q, k, v, jnp.asarray(grid), interpret=True)
        return sum(jnp.sum(o * ww) for o, ww in zip(out, w))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    grads, grid_grad = _torch_grads(pt_corr.fused_correlation_warp, q, k, v, grid, w)
    assert grid_grad is None  # the grid is a constant: no gradient reaches it
    for g, r in zip(grads, ref):
        assert g.dtype == torch.float32 and g.shape == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3)

    auto, _ = _torch_grads(pt_corr.fused_correlation_warp_plain, q, k, v, grid, w)
    for g, a in zip(grads, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(),
                                   atol=2e-5 * max(1.0, float(a.abs().max())))


def test_function_gradients_half_channel_queries():
    """Cq != Cv (the aggregator's cv_half_channels), against the JAX vjp."""
    q, k, v, grid, w = _inputs(2, 6, 8, 8, seed=3, cv=16)

    def jloss(q, k, v):
        out = jax_fcw(q, k, v, jnp.asarray(grid), interpret=True)
        return sum(jnp.sum(o * ww) for o, ww in zip(out, w))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    grads, _ = _torch_grads(pt_corr.fused_correlation_warp, q, k, v, grid, w)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3)


def test_function_gradients_bf16_inputs():
    """bf16 q, k, v: gradients come back in bf16, computed in float32 from
    the bf16-rounded inputs; against the JAX vjp on the same bf16 inputs at
    0.05 (its forward bound for bf16), relative to the largest gradient."""
    q, k, v, grid, w = _inputs(2, 6, 8, 16, seed=4)

    def jloss(q, k, v):
        out = jax_fcw(q, k, v, jnp.asarray(grid), interpret=True)
        return sum(jnp.sum(o * ww) for o, ww in zip(out, w))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    grads, _ = _torch_grads(pt_corr.fused_correlation_warp, q, k, v, grid, w,
                            dtype=torch.bfloat16)
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(g.float().numpy(), r, atol=0.05 * np.abs(r).max())


def test_tie_routes_the_max_score_cotangent_to_the_first_index():
    """Two identical keys tie for the row maximum. jnp.argmax and the TPU
    kernel give the whole max-score cotangent to the first; torch.amax's
    autograd would split it evenly."""
    rng = np.random.default_rng(5)
    B, HW, C = 1, 6, 4
    q = rng.normal(size=(B, HW, C)).astype(np.float32)
    k = rng.normal(size=(B, HW, C)).astype(np.float32) * 0.1
    k[0, 2] = k[0, 4] = 3.0 * q[0, 0] / np.linalg.norm(q[0, 0])  # row 0: keys 2, 4 tie
    v = rng.normal(size=(B, HW, C)).astype(np.float32)
    grid = rng.normal(size=(HW, 2)).astype(np.float32)
    dout = np.zeros((B, HW, C + 3), np.float32)
    dout[0, 0, -1] = 1.0  # only row 0's max score has a cotangent
    args = [torch.from_numpy(a) for a in (q, k, v, grid)]
    s = args[0] @ args[1].transpose(1, 2)
    assert s[0, 0, 2] == s[0, 0, 4] == s[0, 0].max()

    dq, dk, dv, amax = pt_corr.fused_correlation_warp_bwd_plain(*args, torch.from_numpy(dout))
    assert int(amax[0, 0]) == 2
    # dS_0j = P_0j ([j == 2] - P_02): key 2 is pushed up, its twin 4 down
    p = torch.softmax(s, dim=-1)[0, 0]
    expect_dk = (p * ((torch.arange(HW) == 2).float() - p[2]))[:, None] * args[0][0, 0]
    np.testing.assert_allclose(dk[0].numpy(), expect_dk.numpy(), atol=1e-6)
    assert float(dk[0, 2] @ args[0][0, 0]) > 0 > float(dk[0, 4] @ args[0][0, 0])
    assert float(dv.abs().max()) == 0.0  # no cotangent on warped or pos

    def jloss(q, k, v):
        return jnp.sum(jax_fcw(q, k, v, jnp.asarray(grid), interpret=True)[2][0, 0])

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, r in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)

    # and through the Function itself
    qt, kt, vt = (a.clone().requires_grad_(True) for a in args[:3])
    pt_corr.fused_correlation_warp(qt, kt, vt, args[3])[2][0, 0].sum().backward()
    np.testing.assert_allclose(kt.grad.numpy(), dk.numpy(), atol=1e-7)


def test_backward_takes_strided_and_missing_cotangents():
    """Only ``pos`` is used downstream: autograd hands the Function a
    cotangent that is zero elsewhere; a transposed-view cotangent is made
    contiguous. The CPU route counts no launch."""
    q, k, v, grid, w = _inputs(1, 4, 5, 8, seed=6)
    before = dict(pt_corr.launches)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    _, pos, _ = pt_corr.fused_correlation_warp(qt, kt, vt, torch.from_numpy(grid))
    wt = torch.from_numpy(np.ascontiguousarray(w[1].transpose(0, 2, 1))).transpose(1, 2)
    assert not wt.is_contiguous()
    (pos * wt).sum().backward()
    dout = torch.zeros(1, 20, 11)
    dout[..., 8:10] = wt
    dq, dk, dv, _ = pt_corr.fused_correlation_warp_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, grid)), dout)
    for g, r in zip((qt.grad, kt.grad, vt.grad), (dq, dk, dv)):
        assert torch.equal(g, r)
    assert pt_corr.launches == before


def test_row_and_column_plain_versions_are_the_parts_of_the_whole():
    q, k, v, grid, _ = _inputs(2, 5, 7, 8, seed=7)
    args = [torch.from_numpy(a) for a in (q, k, v, grid)]
    dout = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 35, 11)).astype(np.float32))
    dq, dk, dv, amax = pt_corr.fused_correlation_warp_bwd_plain(*args, dout)
    dq2, amax2 = pt_corr.correlation_bwd_rows_plain(*args, dout)
    dk2, dv2 = pt_corr.correlation_bwd_cols_plain(*args, dout)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(amax, amax2)


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain(cuda_device):
    """K2 and K3 on the card against the plain backward, through the
    Function, by the design that serves the inputs. The FMA design (float32):
    1e-4 of each gradient's largest magnitude (same inputs, f32 sums in
    another order, exp2 of log2e-scaled scores). The tensor-core design
    (bf16) takes the card check's two tolerances: the relative L2
    ``MMA_VS_MATCHED_L2_TOL`` against the plain backward with the same bf16
    roundings and ``MMA_VS_EXACT_TOL`` of the largest magnitude against the
    exact one, each widened by the Function's rounding of its gradients to
    bf16 (2^-8 of an entry)."""
    for cq, td in ((32, torch.float32), (16, torch.float32), (32, torch.bfloat16),
                   (16, torch.bfloat16)):
        q, k, v, grid, w = _inputs(2, 10, 13, 32, seed=9)
        q, k = q[..., :cq], k[..., :cq]
        before = dict(pt_corr.launches)
        grads, _ = _torch_grads(pt_corr.fused_correlation_warp,
                                np.ascontiguousarray(q), np.ascontiguousarray(k), v, grid,
                                w, dtype=td, device=cuda_device)
        torch.cuda.synchronize()
        for name in pt_corr.launches:
            assert pt_corr.launches[name] == before[name] + 1
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device, td)
                for a in (q, k, v)]
        dout = torch.cat([torch.from_numpy(x) for x in w], dim=-1).to(cuda_device)
        grid_t = torch.from_numpy(grid).to(cuda_device)
        ref = pt_corr.fused_correlation_warp_bwd_plain(*args, grid_t, dout)[:3]
        if td == torch.float32:
            assert pt_corr.backward_design(td, cq, 32) == pt_corr.DESIGN_FMA
            for g, r in zip(grads, ref):
                torch.testing.assert_close(
                    g, r, atol=1e-4 * max(1.0, float(r.abs().max())), rtol=0)
            continue
        assert pt_corr.backward_design(td, cq, 32) == pt_corr.DESIGN_MMA
        matched = pt_corr.fused_correlation_warp_bwd_plain(
            *args, grid_t, dout, bf16_roundings=True)[:3]
        for g, r, m in zip(grads, ref, matched):
            tol = (pt_corr.MMA_VS_EXACT_TOL + 2 ** -8) * max(1.0, float(r.abs().max()))
            torch.testing.assert_close(g.float(), r, atol=tol, rtol=0)
            rel_l2 = float((g.float() - m).norm() / m.norm())
            assert rel_l2 <= pt_corr.MMA_VS_MATCHED_L2_TOL + 2 ** -8, rel_l2
