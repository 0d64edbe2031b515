"""Training CLI of the port (the counterpart of the repository's train.py).

Single-frame:  python -m mapfree_tpu_torch.train \\
                   configs/regression/mapfree/3d3d.yaml configs/mapfree.yaml

Merge order is deterministic and printed at startup: dataset configs first
(in the order given), then the model config(s); later files override
earlier, so the model config wins (train.py's semantics). ``--device``
(default ``cuda``) is where the model trains and the loaders decode; pass
``--device cpu`` to run on the CPU. Checkpoints and scalars go to
``weights/<experiment>/`` under the working directory.

Several cards: with ``--device cuda`` (the default) the run is data-parallel
over every visible card, as train.py is over every JAX device: with more
than one card this process starts one rank per card itself (a NCCL group
over ``tcp://localhost``) and returns when they are done. Under
``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) each process is one rank of
torchrun's group instead, on the card ``LOCAL_RANK``. On one card it is a
single process with no process group.
"""

import argparse
import os
import socket
from pathlib import Path

import torch

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.config import config_merge_from_file
from mapfree_tpu_torch.parallel.mesh import GROUP_TIMEOUT
from mapfree_tpu_torch.train.fit import fit


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m mapfree_tpu_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "config", help="model config yaml (merged last: overrides dataset configs)")
    parser.add_argument(
        "dataset_config", nargs="+",
        help="dataset config yaml(s), merged first in the order given")
    parser.add_argument(
        "--config", dest="extra_config", action="append", default=[],
        metavar="YAML", help="additional model config, merged after the "
        "positional one (repeatable; later overrides earlier)")
    parser.add_argument(
        "--dataset-config", "--dataset_config", dest="extra_dataset_config",
        action="append", default=[], metavar="YAML",
        help="additional dataset config, merged after the positional ones")
    parser.add_argument("--experiment", help="experiment name", default="default")
    parser.add_argument("--resume", help="resume from checkpoint tag", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    args.merge_order = (
        list(args.dataset_config) + list(args.extra_dataset_config)
        + [args.config] + list(args.extra_config)
    )
    missing = [p for p in args.merge_order if not Path(p).is_file()]
    if missing:
        parser.error("config file(s) not found: " + ", ".join(missing))
    return args


def _train(args, device):
    cfg = default_cfg.clone()
    for path in args.merge_order:
        config_merge_from_file(cfg, path)
    return fit(cfg, experiment=args.experiment, resume=args.resume, device=device)


def _rank(local_rank, args, world, init_method):
    """One rank of the run this process started: its card, its NCCL group."""
    import torch.distributed as dist

    torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl", init_method=init_method, world_size=world,
                            rank=local_rank, timeout=GROUP_TIMEOUT)
    try:
        _train(args, torch.device("cuda", local_rank))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    """Parse ``argv`` (default: the command line), merge the configs into a
    copy of the default config and train; returns the final train state
    (rank 0's under torchrun; None where this process started the ranks)."""
    args = parse_args(argv)
    print("config merge order (later overrides earlier): "
          + " -> ".join(args.merge_order))
    device = torch.device(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # a rank of torchrun's group
        import torch.distributed as dist

        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        if device.type == "cuda":
            torch.cuda.set_device(local_rank)
            device = torch.device("cuda", local_rank)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=GROUP_TIMEOUT)
        try:
            return _train(args, device)
        finally:
            dist.destroy_process_group()
    n_cards = torch.cuda.device_count() if device.type == "cuda" and device.index is None else 1
    if n_cards > 1:
        import torch.multiprocessing as mp

        print(f"[train] one rank per card: {n_cards} ranks over NCCL")
        mp.spawn(_rank, args=(args, n_cards, f"tcp://localhost:{_free_port()}"),
                 nprocs=n_cards, join=True)
        return None
    return _train(args, device)


if __name__ == "__main__":
    main()
