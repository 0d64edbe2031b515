"""PyTorch port: the correlation warp at the channel widths the ResNet
encoder and a 128-channel ResUNet give (``ops/correlation.py``), on CPU
tensors, against the JAX package's ``fused_correlation_warp`` with its
Pallas kernels interpreted, as tests/test_correlation.py runs them.

On the CPU the port computes its plain versions (the forward and the
written-out backward behind the same autograd Function that launches K1-K3
on the card); the card holds the kernels to those at every width
(chip_smoke.py phase 3). Cq = Cv in {128, 256} and Cq != Cv (256 / 96), at
HW = 20 (the ResNet bottleneck's 5 x 4 grid at 360x270) and 70, float32:

- warped, pos and the max score within 1e-5 of the JAX forward;
- dq, dk and dv of a loss with fixed random weights on the three outputs
  within 1e-4 of each gradient's largest entry, against the JAX vjp.

In bf16 the card runs K1's tensor-core design at these widths, which rounds
P to bf16; its plain version (``bf16_roundings=True``) is held against the
JAX forward on the same bf16 inputs (the Pallas kernel keeps P in float32)
at (128, 128) and (256, 96), HW 20 and 70: warped and pos within
``MMA_FWD_VS_EXACT_TOL`` of their largest entry (or of 1), the tolerance
``tests/test_torch_correlation_fwd_mma.py`` derives for what that rounding
costs and shows to cover these widths; the max score, which the design sums
from the float32 P, within the card's float32 tolerance 5e-5. The bf16 backward the card runs at
136, 256, 1,024 and 256 / 96 channels (the tensor-core K2 and K3) is held
the same way in its plain version (``bf16_roundings=True``: K2's one sweep
over ``BWD_KEY_TILE`` keys) against the JAX package's _fcw_bwd.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapfree_tpu.models.aggregators import _uv_grid as jax_uv_grid
from mapfree_tpu.ops.correlation import fused_correlation_warp as jax_fcw

from mapfree_tpu_torch.ops import correlation as pt_corr

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (Cq, Cv, H, W)
CASES = [(128, 128, 4, 5), (128, 128, 7, 10), (256, 256, 4, 5), (256, 256, 7, 10),
         (256, 96, 4, 5), (256, 96, 7, 10)]


def _inputs(cq, cv, H, W, seed):
    rng = np.random.default_rng(seed)
    HW = H * W
    q, k = (rng.normal(size=(2, HW, cq)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(2, HW, cv)).astype(np.float32)
    w = [rng.normal(size=(2, HW, n)).astype(np.float32) for n in (cv, 2, 1)]
    return q, k, v, np.array(jax_uv_grid(H, W, jnp.float32)), w


@pytest.mark.parametrize("cq,cv,H,W", CASES, ids=[f"q{c[0]}_v{c[1]}_hw{c[2] * c[3]}"
                                                   for c in CASES])
def test_wide_warp_and_gradients_match_jax(cq, cv, H, W):
    q, k, v, grid, w = _inputs(cq, cv, H, W, seed=cq + cv + H * W)
    jq, jk, jv, jgrid = (jnp.asarray(a) for a in (q, k, v, grid))
    ref = jax_fcw(jq, jk, jv, jgrid, interpret=True)

    def jloss(q, k, v):
        out = jax_fcw(q, k, v, jgrid, interpret=True)
        return sum(jnp.sum(o * ww) for o, ww in zip(out, w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = pt_corr.fused_correlation_warp(tq, tk, tv, torch.from_numpy(grid))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=0, atol=1e-5)
    sum((o * torch.from_numpy(ww)).sum() for o, ww in zip(out, w)).backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad), jgrads):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())


BF16_CASES = [(cq, cv, H, W) for cq, cv in ((128, 128), (256, 96)) for H, W in ((4, 5), (7, 10))]


@pytest.mark.parametrize("cq,cv,H,W", BF16_CASES, ids=[f"q{c[0]}_v{c[1]}_hw{c[2] * c[3]}"
                                                       for c in BF16_CASES])
def test_wide_bf16_rounded_forward_matches_jax(cq, cv, H, W):
    assert pt_corr.forward_design(torch.bfloat16, cq, cv) == pt_corr.DESIGN_MMA
    q, k, v, grid, _ = _inputs(cq, cv, H, W, seed=cq + cv + H * W + 1)
    scale = (32.0 / cq) ** 0.25  # the scores spread as at 32 channels
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (scale * q, scale * k, v))
    ref = jax_fcw(jq, jk, jv, jnp.asarray(grid), interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
                  for a in (jq, jk, jv))
    out = pt_corr.fused_correlation_warp_plain(tq, tk, tv, torch.from_numpy(grid),
                                               bf16_roundings=True)
    for o, r in zip(out[:2], ref[:2]):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape
        tol = pt_corr.MMA_FWD_VS_EXACT_TOL * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=tol)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=0, atol=5e-5)


BF16_BWD_CASES = [(cq, cv, H, W) for cq, cv in ((136, 136), (256, 256), (1024, 1024), (256, 96))
                  for H, W in ((4, 5), (7, 10))]


@pytest.mark.parametrize("cq,cv,H,W", BF16_BWD_CASES, ids=[f"q{c[0]}_v{c[1]}_hw{c[2] * c[3]}"
                                                           for c in BF16_BWD_CASES])
def test_wide_bf16_rounded_backward_matches_jax(cq, cv, H, W):
    """The backward the card runs at these widths in bf16 (the tensor-core
    K2 and K3: dmain, P and dS rounded to bf16, dq in one sweep over
    BWD_KEY_TILE keys) in its plain version, against the JAX package's
    _fcw_bwd on the same bf16 inputs (interpreted Pallas kernels, float32
    inside, the gradients cast to bf16): each gradient within
    mma_backward_exact_tol(Cq, Cv) of its largest entry (what the roundings
    cost, derived in tests/test_torch_correlation_mma.py) plus 2^-8 of it
    (JAX's cast of its gradients to bf16)."""
    assert pt_corr.backward_design(torch.bfloat16, cq, cv) == pt_corr.DESIGN_MMA
    q, k, v, grid, w = _inputs(cq, cv, H, W, seed=cq + cv + H * W + 2)
    scale = (32.0 / cq) ** 0.25  # the scores spread as at 32 channels
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (scale * q, scale * k, v))
    jgrid = jnp.asarray(grid)
    _, vjp = jax.vjp(lambda a, b, c: jax_fcw(a, b, c, jgrid, interpret=True), jq, jk, jv)
    jgrads = vjp(tuple(jnp.asarray(ww) for ww in w))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
                  for a in (jq, jk, jv))
    dout = torch.from_numpy(np.concatenate(w, axis=-1))
    got = pt_corr.fused_correlation_warp_bwd_plain(
        tq, tk, tv, torch.from_numpy(grid), dout, bf16_roundings=True)[:3]
    for g, r in zip(got, jgrads):
        r = np.asarray(r.astype(jnp.float32))
        assert tuple(g.shape) == r.shape
        tol = (pt_corr.mma_backward_exact_tol(cq, cv) + 2.0 ** -8) * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol)
