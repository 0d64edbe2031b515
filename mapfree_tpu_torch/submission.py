"""Submission CLI of the port (the counterpart of the repository's
submission.py, its single-host branch): runs the model over the val or test
split in batches of ``TPU.INFER_BATCH`` and writes ``submission.zip``.

    python -m mapfree_tpu_torch.submission configs/regression/mapfree/3d3d.yaml \\
        --dataset_config configs/mapfree.yaml --checkpoint weights/default/last.pt

``--device`` (default ``cuda``) is where the model runs and the loader
decodes; pass ``--device cpu`` to run on the CPU.
"""

import argparse
from pathlib import Path

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.data import DataLoader, DataModule
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.utils.submission import predict, save_submission
from mapfree_tpu_torch.utils.timing import NULL_TIMES


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m mapfree_tpu_torch.submission")
    parser.add_argument("config", help="path to model config file")
    parser.add_argument("--dataset_config", default="configs/mapfree.yaml",
                        help="path to the dataset config (merged first)")
    parser.add_argument("--checkpoint", default="",
                        help="path to model checkpoint (learned models)")
    parser.add_argument("--output_root", "-o", type=Path, default=Path("results/"))
    parser.add_argument("--split", choices=("val", "test"), default="test")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None, times=None) -> Path:
    """Parse ``argv`` (default: the command line), run the sweep and write
    ``<output_root>/submission.zip``; returns its path. ``times`` (a
    ``utils.timing.StageTimes``) receives the model's build time, the
    loader's and the sweep's stage times, and the whole sweep's."""
    args = parse_args(argv)
    cfg = default_cfg.clone()
    cfg.merge_from_file(args.dataset_config)
    cfg.merge_from_file(args.config)

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

    with times.stage("build_model"):
        model = build_model(cfg, args.checkpoint, device=args.device)
    with times.stage("sweep"):  # spans the loader's and predict's stages
        results_dict = predict(dataloader, model, times)

    args.output_root.mkdir(parents=True, exist_ok=True)
    path = args.output_root / "submission.zip"
    save_submission(results_dict, path)
    return path


if __name__ == "__main__":
    main()
