"""PyTorch port: the exact plain forward of the correlation warp
(``ops/correlation.py``, the CPU route and the yardstick K1's FMA design is
held to on the card) against the JAX package's ``fused_correlation_warp``
with its Pallas kernel interpreted, as tests/test_correlation.py runs it.

The shapes are the edges of the FMA design's two kernels
(``ops/csrc/correlation_fwd.cu::dispatch_fma``), each the CPU twin of a case
of ``tests/test_torch_cuda_kernels.py::test_k1_cuda_fma_edges_match_plain``:
the 3d3d grid (HW = 6,256, whose last row and key tiles are ragged), HW below
the long-rows kernel's row tile of 128, the few-rows kernel's largest HW (64)
with one below and one above it, Cq != Cv on each kernel, the ResNet
bottleneck's 1,024 channels on its 5x4 grid with q and k scaled by
(32 / C)^(1/4) and unscaled (scores up to some 150), and a bf16 width that is
not a multiple of 8.

Tolerances: float32 within 5e-5 of the JAX forward (chip_smoke.py's
ATOL["float32"]: both sum each score over the channels in float32, in other
orders, which at 1,024 unscaled channels moves a score by up to some 1e-4 of
its size and a peaked row's output with it); bf16 inputs (both sides take
the same bf16 values and compute in float32) within 1e-3, the card's bf16
tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapfree_tpu.models.aggregators import _uv_grid as jax_uv_grid
from mapfree_tpu.ops.correlation import fused_correlation_warp as jax_fcw

from mapfree_tpu_torch.ops import correlation as pt_corr

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (name, B, H, W, Cq, Cv, dtype, scale): scale multiplies q and k
CASES = [
    ("3d3d_hw6256", 1, 92, 68, 32, 32, "float32", 1.0),
    ("hw100_below_row_tile", 2, 10, 10, 32, 32, "float32", 1.0),
    ("hw63", 2, 7, 9, 32, 32, "float32", 1.0),
    ("hw64", 2, 8, 8, 32, 32, "float32", 1.0),
    ("hw65", 2, 5, 13, 32, 32, "float32", 1.0),
    ("hw130_q16_v32", 2, 10, 13, 16, 32, "float32", 1.0),
    ("hw20_q24_v40", 2, 4, 5, 24, 40, "float32", 1.0),
    ("hw20_c1024_scaled", 2, 4, 5, 1024, 1024, "float32", (32 / 1024) ** 0.25),
    ("hw20_c1024_unscaled", 2, 4, 5, 1024, 1024, "float32", 1.0),
    ("hw20_c12_bf16", 2, 4, 5, 12, 12, "bfloat16", 1.0),
    ("hw130_c12_bf16", 2, 10, 13, 12, 12, "bfloat16", 1.0),
]
ATOL = {"float32": 5e-5, "bfloat16": 1e-3}


@pytest.mark.parametrize("name,B,H,W,cq,cv,dtype,scale", CASES, ids=[c[0] for c in CASES])
def test_exact_forward_matches_jax(name, B, H, W, cq, cv, dtype, scale):
    rng = np.random.default_rng(len(name) + H * W + cq)
    HW = H * W
    q, k = (scale * rng.standard_normal((B, HW, cq), np.float32) for _ in range(2))
    v = rng.standard_normal((B, HW, cv), np.float32)
    grid = np.array(jax_uv_grid(H, W, jnp.float32))
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    ref = jax_fcw(jq, jk, jv, jnp.asarray(grid), interpret=True)
    # the same values on both sides: bf16 inputs rounded once, by JAX
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    assert pt_corr.forward_design(tq.dtype, cq, cv) == pt_corr.DESIGN_FMA
    out = pt_corr.fused_correlation_warp(tq, tk, tv, torch.from_numpy(grid))
    for o, r in zip(out, ref):
        r = np.asarray(r, np.float32)
        assert tuple(o.shape) == r.shape
        assert np.isfinite(r).all()
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("H,W", [(4, 5), (7, 10)], ids=["hw20", "hw70"])
def test_exact_forward_matches_jax_at_large_scores(H, W):
    """The twin of tests/test_torch_cuda_kernels.py::
    test_k1_cuda_fma_max_score_at_large_scores: scores near 3,300 (1,024
    channels, q = k = 1 + |N(0, 1)|), each row's own key winning by
    hundreds, so that both sides give a one-hot P and a max score of 1
    whatever order they sum in."""
    rng = np.random.default_rng(H * W)
    q = 1.0 + np.abs(rng.standard_normal((2, H * W, 1024))).astype(np.float32)
    v = rng.standard_normal((2, H * W, 32)).astype(np.float32)
    grid = np.array(jax_uv_grid(H, W, jnp.float32))
    ref = jax_fcw(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v), jnp.asarray(grid),
                  interpret=True)
    out = pt_corr.fused_correlation_warp(torch.from_numpy(q), torch.from_numpy(q),
                                         torch.from_numpy(v), torch.from_numpy(grid))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=ATOL["float32"])
    np.testing.assert_allclose(out[2].numpy(), 1.0, rtol=0, atol=ATOL["float32"])
