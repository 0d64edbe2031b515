"""PyTorch port, the validation step: its outputs on carried-over weights
against the JAX package's ``make_val_step`` and both packages'
``aggregate_validation`` on the same outputs. The test has a file of its own:
compiling the JAX step makes it one of the slowest training tests, and test
workers schedule whole files."""

import numpy as np

import jax
import jax.numpy as jnp

import mapfree_tpu.ops.correlation as jax_corr
from mapfree_tpu.config import cfg as jax_default_cfg
from mapfree_tpu.models import build_regression_net as jax_build_net
from mapfree_tpu.train import aggregate_validation as jax_aggregate_validation
from mapfree_tpu.train import init_state as jax_init_state
from mapfree_tpu.train import make_val_step as jax_make_val_step

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables
from mapfree_tpu_torch.train import (
    aggregate_validation,
    init_state,
    make_predict_step,
    make_val_step,
    run_validation,
)

from test_torch_train import make_batch, numpy_tree, tiny_cfg, to_torch
from test_torch_train_loop import CHANNELS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_val_step_and_aggregation_match_jax(monkeypatch):
    """The port's validation outputs on carried-over weights against
    ``make_val_step`` (1e-3: degrees through acos and the Kabsch solve), and
    both packages' ``aggregate_validation`` on the same outputs: equal."""
    monkeypatch.setattr(jax_corr, "INTERPRET_FALLBACK", True)
    jcfg = tiny_cfg(jax_default_cfg)
    jnet = jax_build_net(jcfg)
    batches = [make_batch(B=4, seed=s) for s in range(3)]
    jstate = jax_init_state(jnet, jcfg, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batches[0].items()})
    jval = jax_make_val_step(jnet, jcfg)
    ref = [jax.device_get(jval(jstate, {k: jnp.asarray(v) for k, v in b.items()}))
           for b in batches]

    cfg = tiny_cfg(pt_default_cfg)
    net = pt_build_net(cfg)
    load_jax_variables(net, {"params": numpy_tree(jstate.params),
                             "batch_stats": numpy_tree(jstate.batch_stats)})
    state = init_state(net, cfg, device="cpu")
    val_step = make_val_step(net, cfg)
    outputs = [val_step(state, to_torch(b)) for b in batches]
    assert not net.training
    for out, r in zip(outputs, ref):
        assert set(out) == set(r)
        for key in r:
            assert tuple(out[key].shape) == np.shape(r[key])
            np.testing.assert_allclose(out[key].numpy(), np.asarray(r[key]),
                                       rtol=1e-3, atol=1e-3, err_msg=key)

    logs = aggregate_validation(outputs)
    assert CHANNELS.issubset(logs.keys()) and len(logs) == 22
    assert all(np.isfinite(v) for v in logs.values())
    assert aggregate_validation(ref) == jax_aggregate_validation(ref)
    assert run_validation(val_step, state, [to_torch(b) for b in batches]) == logs
    assert run_validation(val_step, state, []) == {}

    R, t = make_predict_step(net, cfg)(state, to_torch(batches[0]))
    assert R.shape == (4, 3, 3) and t.shape == (4, 1, 3)
