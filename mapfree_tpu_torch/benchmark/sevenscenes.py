"""7Scenes visual-localisation evaluation CLI (port of
mapfree_tpu/benchmark/sevenscenes.py; reference benchmark/sevenscenes.py:17-145):
the absolute pose of each query from its 1..k reference images, by the
geometric median of the positions and the chordal-L2 mean of the rotations,
or by triangulation and pose-graph RANSAC (``--triang``); DSAC pass rates,
AP, per-scene result files and precision-recall plots.

    python -m mapfree_tpu_torch.benchmark.sevenscenes <config> <dataset_config> [--triang]

``--device`` (default ``cuda``) is where the model runs and the loader
decodes; pass ``--device cpu`` to run on the CPU. The plots need matplotlib:
where it does not import, they are left out with one line saying so
(benchmark/localize.py::generate_precision_recall_plots).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from mapfree_tpu_torch.benchmark.localize import (
    AbsPose,
    RelaPose,
    RelaPosePair,
    eval_pipeline_with_ransac,
    eval_pipeline_without_ransac,
    generate_precision_recall_plots,
    save_results_visualisation,
)
from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.data import DataModule
from mapfree_tpu_torch.geom.quaternion import mat2quat
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.utils.logger import tee_stdout
from mapfree_tpu_torch.utils.submission import iter_predictions
from mapfree_tpu_torch.utils.timing import NULL_TIMES, stage

_META_KEYS = ("pair_names", "scene_id", "abs_q_0", "abs_c_0", "abs_q_1", "abs_c_1",
              "T_0to1", "sim")


def predict(loader, model, times=None):
    """Per-(reference, query) RelaPosePair results (reference
    benchmark/sevenscenes.py:17-66), batched and pipelined: batch i+1's
    transfer and solve overlap batch i's pose-pair assembly on the host
    (utils/submission.py::iter_predictions)."""
    results_dict = {}
    for batch, fetch in iter_predictions(loader, model,
                                         lambda b: {k: b[k] for k in _META_KEYS}, times):
        R, t, inliers = fetch()
        for i in range(R.shape[0]):
            train, test = batch["pair_names"][i]
            scene = batch["scene_id"][i]
            scene_res = results_dict.setdefault(scene, {"pair_data": {}, "no_pt_pairs": []})
            pdata = scene_res["pair_data"].setdefault(test, {"test_pairs": []})

            train_abs_pose = AbsPose(np.asarray(batch["abs_q_0"][i], np.float64),
                                     np.asarray(batch["abs_c_0"][i], np.float64))
            pdata["test_abs_pose"] = AbsPose(np.asarray(batch["abs_q_1"][i], np.float64),
                                             np.asarray(batch["abs_c_1"][i], np.float64))

            T = np.asarray(batch["T_0to1"][i], np.float64)
            rela_pose_lbl = RelaPose(mat2quat(T[:3, :3]), T[:3, 3])

            Ri = np.asarray(R[i], np.float64)
            ti = np.asarray(t[i], np.float64).reshape(-1)
            if np.isnan(Ri).any() or np.isnan(ti).any() or np.isinf(ti).any():
                scene_res["no_pt_pairs"].append(batch["pair_names"][i])
            else:
                rela_pose_pred = RelaPose(mat2quat(Ri), ti)
                sim = float(np.asarray(batch["sim"][i]))
                test_pair = RelaPosePair(test, train_abs_pose, rela_pose_lbl, rela_pose_pred,
                                         sim)
                test_pair.inliers = float(np.asarray(inliers[i]))
                pdata["test_pairs"].append(test_pair)
    return results_dict


def eval(args, times=None):
    """Sweep, localise and report into ``args.output_root``; returns the
    path of ``results.npy``."""
    cfg = default_cfg.clone()
    cfg.merge_from_file(args.dataset_config)
    cfg.merge_from_file(args.config)
    if args.test_pair_txt:
        cfg.DATASET.PAIRS_TXT.TEST = args.test_pair_txt
    if args.one_nn:
        cfg.DATASET.PAIRS_TXT.ONE_NN = True

    times = times or NULL_TIMES
    args.output_root.mkdir(parents=True, exist_ok=True)
    with tee_stdout(args.output_root / "test_results.txt"):
        dataloader = DataModule(cfg, device=args.device).test_dataloader(
            batch_size=int(cfg.TPU.INFER_BATCH))
        dataloader.times = times
        model = build_model(cfg, args.checkpoint, device=args.device)

        with stage(times, "sweep"):
            results_dict = predict(dataloader, model, times)
        np.save(args.output_root / "rawpred.npy", results_dict)

        err_thres = ((0.1, 5), (0.25, 5), (0.5, 10), (1, 20))
        save_res_path = args.output_root / "results.npy"
        if args.triang:
            eval_pipeline_with_ransac(
                results_dict, None, ransac_thres=args.triang_ransac_thres,
                ransac_iter=10, ransac_miu=1.414, pair_type="relapose",
                err_thres=err_thres, save_res_path=save_res_path)
        else:
            eval_pipeline_without_ransac(results_dict, err_thres=err_thres,
                                         save_res_path=save_res_path)

        save_results_visualisation(save_res_path)
        generate_precision_recall_plots(save_res_path, err_thres[1])
    return save_res_path


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m mapfree_tpu_torch.benchmark.sevenscenes")
    parser.add_argument("config", help="path to config file")
    parser.add_argument("dataset_config", help="path to dataset config file")
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--test_pair_txt", "-pair", type=str, default=None)
    parser.add_argument("--output_root", "-odir", type=str, default="results/")
    parser.add_argument("--one_nn", action="store_true",
                        help="keep only the highest-similarity reference per query")
    parser.add_argument("--triang", action="store_true",
                        help="triangulation + RANSAC absolute pose")
    parser.add_argument("--triang_ransac_thres", "-rthres", type=int, nargs="+",
                        default=[15])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    args.output_root = Path(args.output_root)
    if args.one_nn and args.triang:
        parser.error("triangulation needs more than one nearest neighbour")
    return args


def main(argv=None, times=None) -> Path:
    """Parse ``argv`` (default: the command line) and run :func:`eval`."""
    return eval(parse_args(argv), times)


if __name__ == "__main__":
    main()
