"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the repository's root. Tests marked ``cuda`` need the card and skip
without it; on the card they run in one call of the same command."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes for the CPU: one block a stage, 96x72 images, batches of 4
SMALL = {"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96, "DATASET.WIDTH": 72,
         "TPU.INFER_BATCH": 4}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

