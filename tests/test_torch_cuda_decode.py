"""PyTorch port: the card's JPEG decode (``mapfree_tpu_torch/data/jpeg.py``,
nvJPEG in ``data/csrc/jpeg_decode.cu``) against the committed fixtures
(``tests/data/torch_port/``): the JAX package's decode of the four 540x720
JPEGs at 270x360, written by ``make_fixtures.py`` and held to what the JAX
package computes now by ``tests/test_torch_data_io.py``.

The case needs a card (``cuda`` marker) and skips without one; the file
imports no JAX and nothing of the JAX package, so that it runs on a machine
with a card and PyTorch alone:

    python -m pytest -m cuda tests/test_torch_cuda_decode.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mapfree_tpu_torch.data import jpeg

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_port"
PATHS = [str(FIXTURES / f"frame_{i}.jpg") for i in range(4)]
# the largest |diff| between the JAX package's two decode paths on the
# fixtures, in levels (decode_gap.json; tests/test_torch_data_io.py pins the
# values): the limit of the card's decode
NATIVE_VS_CV2_MAX = {key: gap["max_abs"] for key, gap in
                     json.loads((FIXTURES / "decode_gap.json").read_text()).items()
                     if key in ("yuv420", "uint8")}


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none (decided at run
    time, never at import, so every test process collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: nvJPEG decodes on the card only")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_nvjpeg_decode_matches_jax_fixtures(cuda_device):
    """On the card: nvJPEG against the JAX package's decode of the fixtures,
    mean |diff| at most 1 level, the largest no larger than the gap between
    the JAX package's own two decode paths (decode_gap.json)."""
    ref = np.load(FIXTURES / "jax_decode_270x360.npz")
    assert sorted(NATIVE_VS_CV2_MAX) == ["uint8", "yuv420"]
    for key, limit in NATIVE_VS_CV2_MAX.items():
        got = jpeg.decode_resize_batch(PATHS, 270, 360, device=cuda_device, **{key: True})
        diff = np.abs(got.astype(np.int32) - ref[key].astype(np.int32))
        assert diff.mean() <= 1.0 and diff.max() <= limit, key
