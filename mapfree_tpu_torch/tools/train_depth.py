"""GT-depth-supervised training for the in-graph MonoDepthNet (port of
mapfree_tpu/tools/train_depth.py).

The matching track's ``*_ingraph.yaml`` configs run ``MonoDepthNet``
(``models/depth.py``) and need trained weights in ``DEPTH_NET.CHECKPOINT``.
This tool supervises the net on scenes that carry GT depth PNGs
(``*.<suffix>.png``, 16-bit millimetres, the MapFree/ScanNet format) and
writes the ``.pt`` state dict that ``DepthPredictor`` reads.

Loss: masked L1 on log-depth (scale-aware; valid where GT > 0), both pair
views folded into one conv batch per step; Adam at ``--lr``, as optax's
``adam`` (betas 0.9, 0.999, eps 1e-8). Initial weights come from
``init_weights`` with a generator seeded from ``TPU.SEED``.

Usage::

    python -m mapfree_tpu_torch.tools.train_depth configs/mapfree.yaml \\
        --data_root data/mapfree --depth_suffix gt \\
        --steps 2000 --batch 8 --out weights/depth.pt

Then point any ``*_ingraph.yaml`` run at it::

    python -m mapfree_tpu_torch.submission configs/matching/mapfree/sift_emat_ingraph.yaml \\
        --dataset_config configs/mapfree.yaml   # with DEPTH_NET.CHECKPOINT weights/depth.pt

``--device`` (default ``cuda``) is where the net trains and the loader
decodes (nvJPEG on the card); pass ``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import shutil
from pathlib import Path

import numpy as np
import torch

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.data import DataLoader, MapFreeDataset
from mapfree_tpu_torch.models.blocks import init_weights
from mapfree_tpu_torch.models.builder import resolve_device, tf32_off
from mapfree_tpu_torch.models.depth import MonoDepthNet
from mapfree_tpu_torch.models.encoders import parse_num_blocks


def depth_loss(pred, gt):
    """Masked L1 on log-depth: scale-aware, ignores invalid (<=0) GT."""
    valid = gt > 1e-3
    err = torch.abs(torch.log(torch.clamp(pred, min=1e-3))
                    - torch.log(torch.clamp(gt, min=1e-3)))
    n = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, err, 0.0).sum() / n


def make_step(net, optimizer):
    """``step(images, gt) -> loss``: one optimizer step of ``net`` in train
    mode (BatchNorm on the batch's statistics, its running statistics
    updated) on tensors on the net's device. The loss is a 0-d tensor on the
    device; each parameter's ``.grad`` keeps the step's gradient. A float32
    net on the card runs with TF32 off, so float32 stays float32."""
    device = next(net.parameters()).device
    exact = device.type == "cuda" and net.compute_dtype == torch.float32

    def step(images, gt):
        net.train()
        with tf32_off() if exact else contextlib.nullcontext():
            optimizer.zero_grad(set_to_none=True)
            loss = depth_loss(net(images), gt)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def fold_batch(batch):
    """Fold both pair views into one [2B, H, W, 3] image / [2B, H, W] depth
    conv batch (each view is an independent supervision sample). Images keep
    the loader's dtype: uint8 (the card's decode) or float32 in [0, 1]."""
    images = np.concatenate(
        [np.asarray(batch["image0"]), np.asarray(batch["image1"])])
    depths = np.concatenate(
        [np.asarray(batch["depth0"]), np.asarray(batch["depth1"])])
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    return images, depths.astype(np.float32)


def build_net(cfg) -> MonoDepthNet:
    """The config's ``MonoDepthNet`` with weights from ``TPU.SEED``."""
    dcfg = cfg.DEPTH_NET
    dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
    net = MonoDepthNet(parse_num_blocks(str(dcfg.NUM_BLOCKS)),
                       float(dcfg.MAX_DEPTH), dtype)
    init_weights(net, torch.Generator().manual_seed(int(cfg.TPU.SEED)))
    return net


def train(cfg, data_root: str, depth_suffix: str, out: str,
          steps: int = 1000, batch: int = 8, lr: float = 1e-4,
          mode: str = "train", log_every: int = 50, device="cuda"):
    """Train the config's net (:func:`build_net`) for ``steps`` steps on
    ``device`` and write its state dict to ``out`` (a ``.pt`` file, replaced
    if it exists). Returns (the path, the last logged loss)."""
    device = resolve_device(device)
    cfg = cfg.clone()
    cfg.DATASET.DATA_ROOT = data_root
    cfg.DATASET.ESTIMATED_DEPTH = depth_suffix
    if cfg.DATASET.MIN_OVERLAP_SCORE is None:
        cfg.DATASET.MIN_OVERLAP_SCORE = 0.0
        cfg.DATASET.MAX_OVERLAP_SCORE = 1.0

    dataset = MapFreeDataset(cfg, mode, device=device)
    loader = DataLoader(dataset, batch_size=batch, shuffle=True,
                        num_workers=int(cfg.TRAINING.NUM_WORKERS or 2))
    # the JAX tool draws one batch (one permutation of the loader's
    # generator) for its init shapes before the epochs; the same draw keeps
    # the batches in its order
    loader._indices()

    net = build_net(cfg).to(device)
    step_fn = make_step(net, torch.optim.Adam(net.parameters(), lr=lr))

    n = 0
    last_loss = float("nan")
    while n < steps:
        for b in loader:
            if n >= steps:
                break
            images, gt = fold_batch(b)
            loss = step_fn(torch.from_numpy(images).to(device),
                           torch.from_numpy(gt).to(device))
            n += 1
            if n % log_every == 0 or n == steps:
                last_loss = float(loss)
                print(f"[train_depth s{n}] log-L1={last_loss:.4f}")

    out_path = Path(out).absolute()
    if out_path.is_dir():  # an orbax directory of the JAX tool
        shutil.rmtree(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, out_path)
    print(f"[train_depth] checkpoint written to {out_path} "
          f"(final log-L1 {last_loss:.4f})")
    return out_path, last_loss


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m mapfree_tpu_torch.tools.train_depth",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset_config", help="dataset yaml (e.g. configs/mapfree.yaml)")
    p.add_argument("--data_root", required=True)
    p.add_argument("--depth_suffix", default="gt",
                   help="depth png suffix to supervise on (gt = sensor depth)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--mode", default="train", choices=["train", "val"])
    p.add_argument("--out", default="weights/depth.pt")
    p.add_argument("--log_every", type=int, default=50,
                   help="print the loss every this many steps (and at the last)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    args = p.parse_args(argv)

    cfg = default_cfg.clone()
    cfg.merge_from_file(args.dataset_config)
    return train(cfg, args.data_root, args.depth_suffix, args.out,
                 steps=args.steps, batch=args.batch, lr=args.lr, mode=args.mode,
                 log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
