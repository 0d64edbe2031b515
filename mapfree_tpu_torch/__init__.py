"""mapfree_tpu_torch — the PyTorch / CUDA port of mapfree_tpu for NVIDIA Hopper.

The package mirrors mapfree_tpu's layout module for module (config/, data/,
ops/, geom/, models/, train/, utils/, tools/) and keeps its public layouts (NHWC uint8 or
planar YUV420 images, [B, HW, C] correlation features, R [B, 3, 3] and
t [B, 1, 3] poses) so every module can be held against its JAX counterpart.
It imports nothing of JAX or of mapfree_tpu. Entry points take an explicit
``device`` argument that defaults to ``"cuda"``.

The hand-written kernels, the fused correlation softmax-warp forward and its
backward, are CUDA C++ for sm_90a (``ops/csrc/correlation_fwd.cu``,
``ops/csrc/correlation_bwd.cu``, ``ops/csrc/correlation_bwd_mma.cu``), built
with nvcc at first use; so is the
data layer's JPEG decoder over nvJPEG (``data/csrc/jpeg_decode.cu``) and
the PNG reader's row unfilter (``data/csrc/png_unfilter.cu``, host code).
The feature-matching track (``models/matching.py``: the essential-matrix,
PnP and Procrustes RANSAC solvers of ``ops/``, the in-graph depth net of
``models/depth.py``) is plain PyTorch: the JAX package has no kernel there.
The user's entry points are ``python -m mapfree_tpu_torch.train`` and
``python -m mapfree_tpu_torch.submission``.
"""

__version__ = "0.1.0"
