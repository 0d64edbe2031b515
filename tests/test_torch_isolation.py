"""The PyTorch port stands alone: neither mapfree_tpu_torch nor chip_smoke.py
imports JAX, flax, orbax or anything of the JAX package (the machine with
the card has none of them), and chip_smoke.py refuses to run without a CUDA
device or outside a checkout."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "mapfree_tpu")


def _port_sources():
    return sorted((REPO / "mapfree_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_jax_package():
    sources = _port_sources()
    assert len(sources) > 25
    bad = [(str(p.relative_to(REPO)), root) for p in sources
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_entry_points_load_no_jax_modules():
    code = (
        "import sys\n"
        "import mapfree_tpu_torch.models.builder, mapfree_tpu_torch.utils.submission\n"
        "import mapfree_tpu_torch.tools.convert_weights, mapfree_tpu_torch.config\n"
        "import mapfree_tpu_torch.train.fit, mapfree_tpu_torch.utils.data\n"
        "import mapfree_tpu_torch.ops.sift, mapfree_tpu_torch.ops.matching\n"
        "import mapfree_tpu_torch.models.matching, mapfree_tpu_torch.utils.logger\n"
        "import mapfree_tpu_torch.benchmark.mapfree, mapfree_tpu_torch.benchmark.scannet\n"
        "import mapfree_tpu_torch.benchmark.sevenscenes, mapfree_tpu_torch.benchmark.localize\n"
        "import mapfree_tpu_torch.tools.precompute_correspondences\n"
        "import mapfree_tpu_torch.parallel.mesh, mapfree_tpu_torch.train.__main__\n"
        "import mapfree_tpu_torch.geom, mapfree_tpu_torch.ops, mapfree_tpu_torch.models\n"
        "import mapfree_tpu_torch.utils, mapfree_tpu_torch.parallel\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_data_layer_and_clis_load_without_jax_cv2_or_pil(tmp_path):
    """The machine with the card has no JAX, cv2 or PIL: with each of them
    unimportable, the data layer, the train and submission CLIs, the
    evaluation CLIs and the precompute tool import, and a DataModule
    builds its datasets and loaders over a MapFree tree (no image is read:
    cv2 and PIL are imported only where the host decodes)."""
    from fixtures import make_scene

    for split in ("train", "val", "test"):
        make_scene(tmp_path / split / "s00000", n_queries=5, img_hw=(16, 12),
                   train=split == "train")
    code = (
        "import sys\n"
        "for name in ('jax', 'cv2', 'PIL'):\n"
        "    sys.modules[name] = None  # import raises ImportError\n"
        "import mapfree_tpu_torch.data, mapfree_tpu_torch.submission\n"
        "import mapfree_tpu_torch.train.__main__\n"
        "import mapfree_tpu_torch.benchmark.mapfree, mapfree_tpu_torch.benchmark.scannet\n"
        "import mapfree_tpu_torch.benchmark.sevenscenes\n"
        "import mapfree_tpu_torch.tools.precompute_correspondences\n"
        "from mapfree_tpu_torch.config import cfg\n"
        "from mapfree_tpu_torch.data import DataModule\n"
        "c = cfg.clone()\n"
        "c.merge_from_file('configs/mapfree.yaml')\n"
        "c.merge_from_file('configs/regression/mapfree/3d3d.yaml')\n"
        f"c.DATASET.DATA_ROOT = {str(tmp_path)!r}\n"
        "dm = DataModule(c, device='cpu')\n"
        "sizes = [len(dm.train_dataloader()), len(dm.val_dataloader().dataset),\n"
        "         len(dm.test_dataloader(batch_size=2, unique_refs=True).dataset)]\n"
        "print(sizes)\n"
        f"bad = sorted(m for m, mod in sys.modules.items()\n"
        f"             if mod is not None and m.split('.')[0] in {FORBIDDEN + ('cv2', 'PIL')!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad or sizes[1:] != [1, 1] else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_cuda_or_checkout(where, tmp_path):
    """Here there is no card: the script must exit nonzero and print no
    result line, in the checkout and alone in an empty directory."""
    import torch

    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: in the checkout the smoke would run")
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd, env = tmp_path, {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    else:
        cwd, env = REPO, _env()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
