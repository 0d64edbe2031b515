"""Training CLI of the port (the counterpart of the repository's train.py).

Single-frame:  python -m mapfree_tpu_torch.train \\
                   configs/regression/mapfree/3d3d.yaml configs/mapfree.yaml

Merge order is deterministic and printed at startup: dataset configs first
(in the order given), then the model config(s); later files override
earlier, so the model config wins (train.py's semantics). ``--device``
(default ``cuda``) is where the model trains and the loaders decode; pass
``--device cpu`` to run on the CPU. Checkpoints and scalars go to
``weights/<experiment>/`` under the working directory.
"""

import argparse
from pathlib import Path

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.config import config_merge_from_file
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


def main(argv=None):
    """Parse ``argv`` (default: the command line), merge the configs into a
    copy of the default config and train; returns the final train state."""
    args = parse_args(argv)
    print("config merge order (later overrides earlier): "
          + " -> ".join(args.merge_order))
    cfg = default_cfg.clone()
    for path in args.merge_order:
        config_merge_from_file(cfg, path)
    return fit(cfg, experiment=args.experiment, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
