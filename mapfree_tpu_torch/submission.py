"""Submission CLI of the port (the counterpart of the repository's
submission.py): runs the model over the val or test split in batches of
``TPU.INFER_BATCH`` and writes ``submission.zip``.

    python -m mapfree_tpu_torch.submission configs/regression/mapfree/3d3d.yaml \\
        --dataset_config configs/mapfree.yaml --checkpoint weights/default/last.pt

``--device`` (default ``cuda``) is where the model runs and the loader
decodes; pass ``--device cpu`` to run on the CPU.

With ``--num_hosts`` (or in a torch.distributed process group of more than
one process) the sweep is sharded over hosts by scene
(``parallel/multihost.py``): each host writes
``submission.part<host_id>.zip`` and host 0, after a barrier where the
group has one, merges them into ``submission.zip``. ``--host_id`` defaults
to the process group's rank, else 0; ``--checkpoint`` reaches every host.
"""

import argparse
from pathlib import Path

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.data import DataLoader, DataModule
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.parallel import default_barrier, host_topology, run_sharded_sweep
from mapfree_tpu_torch.utils.submission import predict, save_submission
from mapfree_tpu_torch.utils.timing import NULL_TIMES, stage


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m mapfree_tpu_torch.submission")
    parser.add_argument("config", help="path to model config file")
    parser.add_argument("--dataset_config", default="configs/mapfree.yaml",
                        help="path to the dataset config (merged first)")
    parser.add_argument("--checkpoint", default="",
                        help="path to model checkpoint (learned models)")
    parser.add_argument("--output_root", "-o", type=Path, default=Path("results/"))
    parser.add_argument("--split", choices=("val", "test"), default="test")
    parser.add_argument("--num_hosts", type=int, default=None,
                        help="override host count for a sharded sweep "
                             "(default: torch.distributed's world size, else 1)")
    parser.add_argument("--host_id", type=int, default=None,
                        help="override this host's shard id")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None, times=None) -> Path:
    """Parse ``argv`` (default: the command line), run the sweep and write
    ``<output_root>/submission.zip``; returns its path (a host other than 0
    of a sharded sweep: its partial zip's). ``times`` (a
    ``utils.timing.StageTimes``) receives the model's build time, the
    loader's and the sweep's stage times, and the whole sweep's (single
    host)."""
    args = parse_args(argv)
    cfg = default_cfg.clone()
    cfg.merge_from_file(args.dataset_config)
    cfg.merge_from_file(args.config)

    if args.num_hosts or host_topology()[0] > 1:
        out = run_sharded_sweep(
            cfg, args.split, args.output_root, n_hosts=args.num_hosts,
            host_id=args.host_id, barrier=default_barrier(), device=args.device,
            checkpoint=args.checkpoint)
        print(f"wrote {out}")
        return out

    batch = int(cfg.TPU.INFER_BATCH)
    unique_refs = cfg.MODEL == "Regression" and int(cfg.TPU.UNIQUE_REFS) > 0
    dm = DataModule(cfg, device=args.device)
    if args.split == "test":
        dataloader = dm.test_dataloader(batch_size=batch, unique_refs=unique_refs)
    else:
        # the whole val split, no drop_last: every frame must receive an
        # estimate or count as a failure
        dataset = dm.dataset_type(cfg, "val", device=args.device)
        dataloader = DataLoader(dataset, batch_size=batch,
                                num_workers=cfg.TRAINING.NUM_WORKERS or 2,
                                unique_refs=unique_refs)
    times = times or NULL_TIMES
    dataloader.times = times

    with stage(times, "build_model"):
        model = build_model(cfg, args.checkpoint, device=args.device)
    with stage(times, "sweep"):  # spans the loader's and predict's stages
        results_dict = predict(dataloader, model, times)

    args.output_root.mkdir(parents=True, exist_ok=True)
    path = args.output_root / "submission.zip"
    save_submission(results_dict, path)
    return path


if __name__ == "__main__":
    main()
