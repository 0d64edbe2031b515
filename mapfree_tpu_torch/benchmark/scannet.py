"""ScanNet relative-pose evaluation CLI (port of
mapfree_tpu/benchmark/scannet.py; reference benchmark/scannet.py:15-57):
sweeps the test loader in batches of ``TPU.INFER_BATCH``, accumulates pose
errors, prints medians, AUC tables, recall at thresholds, A-metrics and the
failure ratio, and saves an npz of the raw metrics.

    python -m mapfree_tpu_torch.benchmark.scannet <model_config.yaml>

``--device`` (default ``cuda``) is where the model runs and the loader
decodes; pass ``--device cpu`` to run on the CPU. The report goes to standard
output and to ``results/scannet/<config>.txt``, the metrics to
``results/scannet/<config>.npz``, under the working directory.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from mapfree_tpu_torch import metrics as M
from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.data import DataModule
from mapfree_tpu_torch.metrics import A_metrics, MetricsAccumulator, precision, print_auc_table
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.utils.logger import tee_stdout
from mapfree_tpu_torch.utils.submission import iter_predictions
from mapfree_tpu_torch.utils.timing import NULL_TIMES, stage


def pose_error_numpy(R, t, Tgt):
    """Pose errors of possibly-NaN solver outputs on the host (NaN
    propagates, like the reference's torch version on failed estimates):
    :func:`mapfree_tpu_torch.metrics.pose_error` on CPU float32 tensors."""
    out = M.pose_error(torch.as_tensor(np.asarray(R, np.float32)),
                       torch.as_tensor(np.asarray(t, np.float32)),
                       torch.as_tensor(np.asarray(Tgt, np.float32)))
    return {k: v.numpy() for k, v in out.items()}


def evaluate(loader, model, times=None) -> dict:
    """Pipelined sweep (utils/submission.py::iter_predictions): batch i+1's
    transfer and forward overlap batch i's metric accumulation on the host."""
    macc = MetricsAccumulator()
    for Tgt, fetch in iter_predictions(loader, model, lambda b: np.asarray(b["T_0to1"]),
                                       times):
        R, t, _ = fetch()
        macc.accumulate(pose_error_numpy(R, t, Tgt))
    return macc.aggregate()


def report(agg_metrics: dict):
    print(f"Median Rotation error [deg]: {np.nanmedian(agg_metrics['R_err']):.2f}")
    print("Median Translation angular error [deg]: "
          f"{np.nanmedian(agg_metrics['t_err_ang']):.2f}")
    print("Median Translation Euclidean error [m]: "
          f"{np.nanmedian(agg_metrics['t_err_euc']):.2f}")
    print_auc_table(agg_metrics)

    thresholds = ((0.1, 5), (0.25, 5), (0.5, 10), (1, 20))
    print("Recall @ "
          + "/".join(f"({t[0]:.1f}m,{t[1]:.0f}deg)" for t in thresholds)
          + ": "
          + "/".join("{:.2f}".format(precision(agg_metrics, t[1], t[0])) for t in thresholds))

    a1, a2, a3 = A_metrics(agg_metrics["t_err_scale_sym"])
    print(f"t_scale_error A1/A2/A3 [%]: {a1*100:.1f}/{a2*100:.1f}/{a3*100:.1f}")

    ratio_failures = np.isnan(agg_metrics["R_err"]).mean()
    print(f"failures (not enough corr.) [%]: {ratio_failures*100:.1f}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m mapfree_tpu_torch.benchmark.scannet")
    parser.add_argument("config", help="path to config file")
    parser.add_argument("--dataset_config", default="configs/scannet.yaml")
    parser.add_argument("--checkpoint", help="path to checkpoint", default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None, times=None) -> dict:
    """Parse ``argv`` (default: the command line), sweep the test split and
    report; returns the aggregated metrics. ``times`` (a
    ``utils.timing.StageTimes``) receives the loader's and the sweep's stage
    times and the whole sweep's."""
    args = parse_args(argv)
    cfg = default_cfg.clone()
    cfg.merge_from_file(args.dataset_config)
    cfg.merge_from_file(args.config)

    times = times or NULL_TIMES
    loader = DataModule(cfg, device=args.device).test_dataloader(
        batch_size=int(cfg.TPU.INFER_BATCH))
    loader.times = times
    model = build_model(cfg, args.checkpoint, device=args.device)

    config_name = Path(args.config).stem
    out_dir = Path("results/scannet")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tee_stdout(out_dir / f"{config_name}.txt"):
        with stage(times, "sweep"):
            agg_metrics = evaluate(loader, model, times)
        report(agg_metrics)
    np.savez(out_dir / config_name, **agg_metrics)
    return agg_metrics


if __name__ == "__main__":
    main()
