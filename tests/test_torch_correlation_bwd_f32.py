"""PyTorch port: the exact plain backward of the correlation warp (the CPU
route of the autograd Function, and the yardstick the FMA design of K2 and K3
is held to on the card) against the JAX package's ``custom_vjp`` with its
Pallas kernels interpreted, as tests/test_correlation.py runs them.

The shapes are the edges of the FMA design's two kernel pairs
(``ops/csrc/correlation_bwd.cu::dispatch_rows`` and ``dispatch_cols``), each
the CPU twin of a case of ``tests/test_torch_cuda_kernels.py::
test_k23_cuda_fma_edges_match_plain``: the 3d3d grid (HW = 6,256, ragged row
and key tiles), HW 20 and the few-rows pair's largest HW (64) with one below
and one above it, HW below one long-rows tile of 128 rows, Cq != Cv on each
pair, the ResNet bottleneck's 1,024 channels on its 5x4 grid with q and k
scaled by (32 / C)^(1/4) and unscaled (scores up to some 150), scores near
3,300 (q = k = 1 + |N(0, 1)|: each row's own key wins by hundreds), an exact
tie for a row's maximum on each pair (the max-score cotangent goes to the
first index on both sides), and a bf16 width that is not a multiple of 8 on
each pair.

Tolerances: dq, dk, dv within 1e-3 of the JAX gradients (the bound of
tests/test_torch_correlation_bwd.py for the interpreted kernels: both sides
sum in float32, in other orders); for bf16 inputs, whose gradients both
sides return in bf16, one bf16 step (2^-8 of the entry) on top. Against
torch autograd of the plain forward (the same function where no row ties)
within 2e-5 of the largest gradient: float32 sums in another order.
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

WIDE = (32 / 1024) ** 0.25
# (name, B, H, W, Cq, Cv, dtype, inputs): inputs "normal" (q, k scaled by the
# factor given), "large" (q = k = 1 + |N(0, 1)|) or "tie" (row 0's maximum
# taken by two equal keys)
CASES = [
    ("3d3d_hw6256", 1, 92, 68, 32, 32, "float32", ("normal", 1.0)),
    ("hw20", 2, 4, 5, 32, 32, "float32", ("normal", 1.0)),
    ("hw63", 2, 7, 9, 32, 32, "float32", ("normal", 1.0)),
    ("hw64", 2, 8, 8, 32, 32, "float32", ("normal", 1.0)),
    ("hw65", 2, 5, 13, 32, 32, "float32", ("normal", 1.0)),
    ("hw100_below_row_tile", 2, 10, 10, 32, 32, "float32", ("normal", 1.0)),
    ("hw130_q16_v32", 2, 10, 13, 16, 32, "float32", ("normal", 1.0)),
    ("hw20_q24_v40", 2, 4, 5, 24, 40, "float32", ("normal", 1.0)),
    ("hw20_c1024_scaled", 2, 4, 5, 1024, 1024, "float32", ("normal", WIDE)),
    ("hw20_c1024_unscaled", 2, 4, 5, 1024, 1024, "float32", ("normal", 1.0)),
    ("hw20_c1024_large_scores", 2, 4, 5, 1024, 32, "float32", ("large", 1.0)),
    ("hw70_c1024_large_scores", 2, 7, 10, 1024, 32, "float32", ("large", 1.0)),
    ("hw20_tie", 1, 4, 5, 32, 32, "float32", ("tie", 1.0)),
    ("hw100_tie", 1, 10, 10, 32, 32, "float32", ("tie", 1.0)),
    ("hw20_c12_bf16", 2, 4, 5, 12, 12, "bfloat16", ("normal", 1.0)),
    ("hw130_c12_bf16", 2, 10, 13, 12, 12, "bfloat16", ("normal", 1.0)),
]
JAX_ATOL = 1e-3
AUTOGRAD_TOL = 2e-5
BF16_STEP = 2.0 ** -8


def case_inputs(B, HW, cq, cv, kind, scale, seed):
    """q, k, v and random weights on the three outputs (every cotangent
    nonzero), float32 numpy."""
    rng = np.random.default_rng(seed)
    if kind == "large":
        q = 1.0 + np.abs(rng.standard_normal((B, HW, cq))).astype(np.float32)
        k = q.copy()
    else:
        q, k = (scale * rng.standard_normal((B, HW, cq)).astype(np.float32) for _ in range(2))
    if kind == "tie":  # keys 3 and 5 equal, both row 0's maximum by a wide margin
        k[:, 5] = k[:, 3]
        q[:, 0] = 3.0 * k[:, 3]
    v = rng.standard_normal((B, HW, cv)).astype(np.float32)
    w = [rng.standard_normal((B, HW, n)).astype(np.float32) for n in (cv, 2, 1)]
    return q, k, v, w


@pytest.mark.parametrize("name,B,H,W,cq,cv,dtype,inputs", CASES, ids=[c[0] for c in CASES])
def test_exact_backward_matches_jax(name, B, H, W, cq, cv, dtype, inputs):
    HW = H * W
    q, k, v, w = case_inputs(B, HW, cq, cv, *inputs, seed=len(name) + HW + cq)
    grid = np.array(jax_uv_grid(H, W, jnp.float32))
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))

    def jloss(q, k, v):
        out = jax_fcw(q, k, v, jnp.asarray(grid), interpret=True)
        return sum(jnp.sum(o.astype(jnp.float32) * ww) for o, ww in zip(out, w))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    # the same values on both sides: bf16 inputs rounded once, by JAX
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (jq, jk, jv))
    assert pt_corr.backward_design(tdt, cq, cv) == pt_corr.DESIGN_FMA

    def port_grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        out = fn(*leaves, torch.from_numpy(grid))
        sum((o * torch.from_numpy(ww)).sum() for o, ww in zip(out, w)).backward()
        return [t.grad for t in leaves]

    grads = port_grads(pt_corr.fused_correlation_warp)
    if inputs[0] == "tie":
        s = tq[0, 0] @ tk[0].T
        assert s[3] == s[5] == s.max()
    for g, r in zip(grads, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert g.dtype == tdt and tuple(g.shape) == r.shape and np.isfinite(r).all()
        rtol = BF16_STEP if dtype == "bfloat16" else 0.0
        np.testing.assert_allclose(g.float().numpy(), r, rtol=rtol, atol=JAX_ATOL)
    if inputs[0] == "tie":
        return  # autograd of the plain forward splits a tie's max-score cotangent evenly
    auto = port_grads(pt_corr.fused_correlation_warp_plain)
    for g, a in zip(grads, auto):
        a = a.float()
        tol = AUTOGRAD_TOL * max(1.0, float(a.abs().max()))
        if dtype == "bfloat16":
            np.testing.assert_allclose(g.float().numpy(), a.numpy(), rtol=BF16_STEP, atol=tol)
        else:
            np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0, atol=tol)
