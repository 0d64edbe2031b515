"""PyTorch port, training: one float32 train step of the multi-frame fusion
model (``configs/regression/mapfree/multiframe/3d3d_multi_fusion.yaml`` over
``configs/mapfree_multi.yaml``, F = 9; trained through ``fuse_frame_poses``
and its ``eigh`` by ``rot_angle_loss`` and ``trans_l1_loss``) against the
JAX package's ``make_train_step`` on the CPU, from the JAX package's initial
weights and on the same numpy batch (``torch_configs.check_train_step``:
loss 1e-4 relative, each gradient 1e-3 of its tensor's largest entry,
BatchNorm statistics 1e-5).

The config is cut as tests/test_torch_train.py cuts 3d3d.yaml: one block
per stage of the basic pre-activation block (``BLOCK_TYPE`` 0), 8 encoder
channels; 48 x 48 frames, batch 2 (20 frames, 18 pairs through the head).
At this batch the port's float32 gradients agree with a float64 evaluation
of the same step to 6e-5 of each tensor's largest entry, and move by no more
when the input windows move by 1e-7; at most other small batches either
package strays from float64 by 1e-3 to 1e-1 (ReLU, max-pool and BatchNorm
inputs within round-off of where their gradient changes).

flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2
(``use_fast_variance``, its default). At this batch that one-pass formula
puts the JAX step's float32 gradients 2.5e-2 from the float64 step while the
port (torch's two-pass variance) stays within 6e-5; with the two-pass
variance the JAX step agrees with float64 to 3e-5. So the JAX reference here
runs flax's two-pass variance (``two_pass_variance``): the same function in
float32 arithmetic that resolves it. The JAX package itself is not changed.
The cut keeps the aggregator, the head, the fusion and the losses at
their config's settings. The JAX aggregator takes its dense route on the
CPU, the port its plain versions.

A file of its own: compiling the JAX step is the slow part, and test
workers schedule whole files.
"""

import numpy as np
import pytest
from flax.linen import normalization as flax_normalization

from mapfree_tpu_torch.config import cfg as pt_default_cfg

from torch_configs import check_train_step, small_cfg, train_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL_YAML = "configs/regression/mapfree/multiframe/3d3d_multi_fusion.yaml"
CUT = {"H": 48, "W": 48, "ENCODER.BLOCK_TYPE": 0, "ENCODER.NUM_OUT_LAYERS": 8}


@pytest.fixture
def two_pass_variance(monkeypatch):
    """flax's BatchNorm statistics with ``use_fast_variance=False``."""
    compute_stats = flax_normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    monkeypatch.setattr(flax_normalization, "_compute_stats", two_pass)


def test_train_step_matches_jax(two_pass_variance):
    batch = train_batch(small_cfg(pt_default_cfg, MODEL_YAML, **CUT), B=2, seed=11)
    loss = check_train_step(MODEL_YAML, batch, **CUT)
    assert np.isfinite(loss)
