#!/usr/bin/env python3
"""How far the PyTorch port's matching solvers and the JAX package's drift
apart on the same minimal samples, on the CPU (the numbers behind
ROADMAP.md section 3's "Float32 round-off steers the matching solvers").

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tools/torch_matching_drift.py

1. ``essential_pose`` (64 hypotheses) on 3 seeds x 3 synthetic pairs at
   pixel noise 0, 0.2 and 0.5 px, 20 outliers of 96 points: the largest
   rotation difference (rad) and t difference per noise level;
2. the 5-point solver in float64 on 32 random minimal samples: how many
   samples the port and the JAX function agree on at 1e-4, and how far the
   JAX function's own vmapped and one-sample evaluations differ.

Needs JAX and the JAX package (it compiles ``essential_pose`` once, about a
minute).
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from mapfree_tpu.ops import essential as je
from mapfree_tpu_torch.ops import essential as pe
from torch_solvers import JaxSampler, K, rot_diff_rad, synth_pairs


def drift():
    Ks = np.tile(K, (3, 1, 1))
    for noise in (0.0, 0.2, 0.5):
        dR, dt = 0.0, 0.0
        for seed in range(3):
            p = synth_pairs(3, n_points=96, n_outliers=20, noise=noise, seed=seed, pad=8)
            key = jax.random.PRNGKey(seed)
            want = je.essential_pose(key, *map(jnp.asarray, (p["k0"], p["k1"], p["mask"], Ks, Ks)),
                                     2.0, n_iters=64)
            got = pe.essential_pose(*map(torch.as_tensor, (p["k0"], p["k1"], p["mask"], Ks, Ks)),
                                    2.0, JaxSampler(key), n_iters=64)
            dR = max(dR, float(rot_diff_rad(got["R"].numpy(), np.asarray(want["R"])).max()))
            dt = max(dt, float(np.abs(got["t"].numpy() - np.asarray(want["t"])).max()))
        print(f"essential_pose, noise {noise} px: R differs by up to {dR:.3g} rad, "
              f"unit t by up to {dt:.3g}")


def five_point():
    p = synth_pairs(1, n_points=120, n_outliers=20, noise=0.3, seed=11)
    x0 = ((p["k0"][0] - K[:2, 2]) / K[0, 0]).astype(np.float64)
    x1 = ((p["k1"][0] - K[:2, 2]) / K[0, 0]).astype(np.float64)
    idx = np.random.default_rng(4).choice(120, (32, 5))
    with jax.enable_x64(True):
        Ej, vj = map(np.asarray, jax.jit(jax.vmap(je._five_point_candidates))(
            jnp.asarray(x0[idx]), jnp.asarray(x1[idx])))
        one = jax.jit(je._five_point_candidates)
        single = np.stack([np.asarray(one(jnp.asarray(x0[i]), jnp.asarray(x1[i]))[0]) for i in idx])
    Ep, vp = (a.numpy() for a in pe._five_point_candidates(torch.from_numpy(x0[idx]),
                                                           torch.from_numpy(x1[idx])))
    diff = np.minimum(np.abs(Ep - Ej), np.abs(Ep + Ej)).max(axis=(-2, -1))
    agree = (vp == vj).all(axis=1) & (diff.max(axis=1) < 1e-4)
    self_gap = np.abs(single - Ej).max(axis=(1, 2, 3))
    print(f"5-point, float64, 32 samples: the port agrees with JAX at 1e-4 on {agree.sum()}; "
          f"the JAX function's vmapped and one-sample evaluations differ by more than 1e-8 on "
          f"{(self_gap > 1e-8).sum()} (at most {self_gap.max():.3g})")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    drift()
    five_point()
