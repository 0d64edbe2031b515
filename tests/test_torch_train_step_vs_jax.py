"""PyTorch port, training: one float32 train step against the JAX package's
``make_train_step`` on the same weights and batch (loss, clipped gradients,
BatchNorm running statistics).

The configuration is tests/test_torch_train.py's tiny one. The JAX
aggregator runs its Pallas kernels (forward and the two backward passes)
under the interpreter; the port runs the plain versions through its autograd
Function, as it does for any CPU tensor. The test has a file of its own: it
is the slowest of the training tests (compiling the JAX step), and test
workers schedule whole files.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mapfree_tpu.ops.correlation as jax_corr
from mapfree_tpu.config import cfg as jax_default_cfg
from mapfree_tpu.models import build_regression_net as jax_build_net
from mapfree_tpu.train import init_state as jax_init_state
from mapfree_tpu.train import make_train_step as jax_make_train_step

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables, to_jax_variables
from mapfree_tpu_torch.train import init_state, make_train_step

from test_torch_train import flat, make_batch, numpy_tree, tiny_cfg, to_torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_train_step_matches_jax(monkeypatch):
    """Loss within 1e-4 relative; every gradient within 1e-3 of its tensor's
    largest magnitude (the frameworks sum convolutions, the softmax and the
    Jacobi sweeps in other orders); running statistics equal to the new
    batch_stats at 1e-5, which needs the biased-variance update."""
    monkeypatch.setattr(jax_corr, "INTERPRET_FALLBACK", True)
    batch = make_batch()
    jcfg = tiny_cfg(jax_default_cfg)
    jnet = jax_build_net(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jax_init_state(jnet, jcfg, jax.random.PRNGKey(0), jbatch)
    jnew, jlogs = jax_make_train_step(jnet, jcfg, donate=False)(jstate, jbatch)
    # the step's (clipped) gradients, read back from Adam's first moment:
    # after one step mu = (1 - 0.9) * g
    adam = [s for s in jax.tree.leaves(jnew.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
    jgrads = jax.tree.map(lambda m: m / (1.0 - 0.9), adam.mu)

    pcfg = tiny_cfg(pt_default_cfg)
    net = pt_build_net(pcfg)
    load_jax_variables(net, {"params": numpy_tree(jstate.params),
                             "batch_stats": numpy_tree(jstate.batch_stats)})
    state = init_state(net, pcfg, device="cpu")
    state, logs = make_train_step(net, pcfg)(state, to_torch(batch))
    assert state.step == 1

    for key in ("train/loss", "train/R_loss", "train/t_loss"):
        assert float(logs[key]) == pytest.approx(float(jlogs[key]), rel=1e-4)
    jg = flat(numpy_tree(jgrads))
    pg = flat(to_jax_variables(net, grads=True)["params"])  # clipped, as the JAX ones
    assert set(pg) == set(jg)
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in pg.values()))
    assert gnorm == pytest.approx(1.0, rel=1e-4)  # the clip was active on both sides
    for name, g in jg.items():
        # a conv bias before a BatchNorm has a zero gradient: both sides hold
        # float32 round-off there (~1e-7), hence the absolute floor
        tol = max(1e-3 * np.abs(g).max(), 2e-6)
        np.testing.assert_allclose(pg[name], g, atol=tol, err_msg=name)

    new_stats = flat(numpy_tree(jnew.batch_stats))
    old_stats = flat(numpy_tree(jstate.batch_stats))
    port_stats = flat(to_jax_variables(net)["batch_stats"])
    assert set(port_stats) == set(new_stats)
    moved = 0
    for name, ref in new_stats.items():
        np.testing.assert_allclose(port_stats[name], ref, atol=1e-5, err_msg=name)
        moved += int(np.abs(ref - old_stats[name]).max() > 1e-4)
    assert moved > len(new_stats) // 2  # the step did update the statistics
