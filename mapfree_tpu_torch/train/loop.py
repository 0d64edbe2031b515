"""Validation aggregation, checkpointing and logging (port of
mapfree_tpu/train/loop.py).

- ``aggregate_validation``: the 24 scalar channels logged per val epoch
  (reference lib/models/regression/model.py:114-178);
- ``CheckpointManager``: top-k-by-val-loss + 'last' checkpoints as
  ``torch.save`` files of net, optimizer, scheduler and step
  (reference train.py:37-50);
- ``ScalarLogger``, ``check_finite_or_die`` (replacing the heads' in-graph
  sys.exit guards, reference head.py:90-102), ``run_validation``.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from mapfree_tpu_torch.metrics import A_metrics, error_auc


def _flat(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value).reshape(-1)


def aggregate_validation(step_outputs: list) -> dict:
    """Aggregate per-batch val outputs into the reference's 24 channels."""
    agg = {
        key: np.concatenate([_flat(o[key]) for o in step_outputs])
        for key in step_outputs[0].keys()
    }

    logs = {}
    logs["val_loss/R_loss"] = float(agg["R_loss"].mean())
    logs["val_loss/t_loss"] = float(agg["t_loss"].mean())
    logs["val_loss/loss"] = float(agg["loss"].mean())
    logs["val_metrics/t_ang_err"] = float(np.median(agg["t_err_ang"]))
    logs["val_metrics/t_scale_err"] = float(np.median(agg["t_err_scale"]))
    logs["val_metrics/t_euclidean_err"] = float(np.median(agg["t_err_euc"]))
    logs["val_metrics/R_err"] = float(np.median(agg["R_err"]))

    a1, a2, a3 = A_metrics(agg["t_err_scale_sym"])
    logs["val_t_scale/a1"] = float(a1)
    logs["val_t_scale/a2"] = float(a2)
    logs["val_t_scale/a3"] = float(a3)

    auc = error_auc(agg["t_err_euc"], [0.1, 0.5, 1.0])
    logs["val_auc/euc_10"], logs["val_auc/euc_50"], logs["val_auc/euc_100"] = (
        auc["auc@0.1"], auc["auc@0.5"], auc["auc@1.0"])

    pose_err = np.maximum(agg["t_err_ang"], agg["R_err"])
    auc = error_auc(pose_err, [5, 10, 20])
    logs["val_auc/pose_5"], logs["val_auc/pose_10"], logs["val_auc/pose_20"] = (
        auc["auc@5"], auc["auc@10"], auc["auc@20"])

    auc = error_auc(agg["R_err"], [5, 10, 20])
    logs["val_auc/rot_5"], logs["val_auc/rot_10"], logs["val_auc/rot_20"] = (
        auc["auc@5"], auc["auc@10"], auc["auc@20"])

    auc = error_auc(agg["t_err_ang"], [5, 10, 20])
    logs["val_auc/tang_5"], logs["val_auc/tang_10"], logs["val_auc/tang_20"] = (
        auc["auc@5"], auc["auc@10"], auc["auc@20"])

    return logs


class CheckpointManager:
    """Keep the top-k checkpoints by val loss, plus 'last' at every save.

    A checkpoint is one ``torch.save`` file ``<tag>.pt`` of the train
    state's ``state_dict()``; its ``state_dict`` entry is the net's, so
    ``tools/convert_weights.py::load_checkpoint`` reads it for inference.
    The top-k ranking is persisted to ``topk.json`` beside the checkpoints
    and reloaded on construction, so a resumed run keeps evicting against
    the val losses seen before the restart."""

    def __init__(self, directory, top_k: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self._best: list = []  # (val_loss, step)
        topk = self.directory / "topk.json"
        if topk.exists():
            # keep only entries whose checkpoint still exists on disk
            self._best = [
                (float(v), int(s))
                for v, s in json.loads(topk.read_text())
                if self.path(f"step_{int(s)}").exists()
            ]
            self._best.sort()

    def path(self, tag) -> Path:
        return self.directory / f"{tag}.pt"

    def _write(self, tag, ckpt: dict) -> None:
        tmp = self.path(tag).with_suffix(".tmp")
        torch.save(ckpt, tmp)
        os.replace(tmp, self.path(tag))

    def _write_topk(self):
        (self.directory / "topk.json").write_text(
            json.dumps([[v, s] for v, s in self._best]))

    def save(self, state, step: int, val_loss: float | None = None):
        ckpt = state.state_dict()
        self._write("last", ckpt)  # 'last' checkpoint: always refreshed
        if val_loss is not None and math.isfinite(val_loss):
            self._best.append((val_loss, step))
            self._best.sort()
            self._write(f"step_{step}", ckpt)
            while len(self._best) > self.top_k:  # evict beyond top-k
                _, evict_step = self._best.pop()
                self.path(f"step_{evict_step}").unlink(missing_ok=True)
            self._write_topk()

    def restore(self, state, tag="last"):
        """Load checkpoint ``tag`` into ``state`` (net, optimizer, scheduler,
        step) and return it."""
        ckpt = torch.load(self.path(tag), map_location=state.device)
        state.load_state_dict(ckpt)
        return state

    def best_tag(self):
        if not self._best:
            return "last"
        return f"step_{self._best[0][1]}"


class ScalarLogger:
    """JSONL scalar logger (TensorBoard-format channel names)."""

    def __init__(self, directory, experiment="default"):
        self.path = Path(directory) / experiment
        self.path.mkdir(parents=True, exist_ok=True)
        self.file = (self.path / "scalars.jsonl").open("a")

    def log(self, step: int, scalars: dict):
        rec = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        self.file.write(json.dumps(rec) + "\n")
        self.file.flush()


def check_finite_or_die(loss_value: float, step: int):
    """Host-side NaN guard, replacing the reference heads' sys.exit
    (reference head.py:90-102): kill a diverged run loudly."""
    if not math.isfinite(loss_value):
        raise FloatingPointError(
            f"Non-finite training loss {loss_value} at step {step}; aborting "
            "(reference behaviour: hard exit on NaN anchors/poses)."
        )


def run_validation(val_step, state, val_batches) -> dict:
    """Run ``val_step`` over the batches; the outputs stay on the device
    until every batch is dispatched, then come to the host once."""
    outputs = [val_step(state, batch) for batch in val_batches]
    if not outputs:
        return {}
    return aggregate_validation(outputs)
