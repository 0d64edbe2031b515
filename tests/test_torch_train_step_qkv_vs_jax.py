"""PyTorch port, training: one float32 train step of the QKV model
(``configs/regression/mapfree/rotbin_transdirectionbin_scale_qkv.yaml``: the
QKV aggregator with the angular-bin head, trained by ``rot_bin_loss`` and
``trans_sphbin_loss``) against the JAX package's ``make_train_step`` on the
CPU, from the JAX package's initial weights and on the same numpy batch
(``torch_configs.check_train_step``: loss 1e-4 relative, each gradient 1e-3
of its tensor's largest entry, BatchNorm statistics 1e-5).

The config is cut as tests/test_torch_train.py cuts 3d3d.yaml: one block
per stage of the basic pre-activation block (``BLOCK_TYPE`` 0), 8 encoder
channels, 32 x 32 frames; batch 8. With the config's bottleneck encoder, a
change of 1e-7 in the input images moves some gradients of its early stages
by 1e-2 to 3e-2 (ReLU and max-pool inputs within round-off of their
switch), and a float32 step strays from a float64 evaluation of the same
step by up to 2.6e-2 in either package, which no comparison at 1e-3
survives. The cut keeps the aggregator, the head and the losses at their
config's settings. The JAX aggregator takes its dense route on the CPU, the
port its plain versions.

A file of its own: compiling the JAX step is the slow part, and test
workers schedule whole files.
"""

import numpy as np

from mapfree_tpu_torch.config import cfg as pt_default_cfg

from torch_configs import check_train_step, small_cfg, train_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL_YAML = "configs/regression/mapfree/rotbin_transdirectionbin_scale_qkv.yaml"
CUT = {"H": 32, "W": 32, "ENCODER.BLOCK_TYPE": 0, "ENCODER.NUM_OUT_LAYERS": 8}


def test_train_step_matches_jax():
    batch = train_batch(small_cfg(pt_default_cfg, MODEL_YAML, **CUT), B=8, seed=11)
    loss = check_train_step(MODEL_YAML, batch, **CUT)
    assert np.isfinite(loss)
