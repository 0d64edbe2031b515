"""Submission writer: batched inference sweep -> leaderboard zip.

The port's copy of mapfree_tpu/utils/submission.py (itself the equivalent of
reference submission.py:18-65): per-scene ``pose_{scene}.txt`` lines
``imgpath qw qx qy qz tx ty tz confidence``, NaN/Inf frames skipped (counted
as failures by the evaluator). Quaternions come from the port's own float64
:func:`mapfree_tpu_torch.geom.quaternion.mat2quat`.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from zipfile import ZipFile

import numpy as np

from mapfree_tpu_torch.geom.quaternion import mat2quat
from mapfree_tpu_torch.utils.timing import NULL_TIMES, in_batch, set_batch, stage


@dataclass
class Pose:
    image_name: str
    q: np.ndarray
    t: np.ndarray
    inliers: float

    def __str__(self) -> str:
        formatter = {"float": lambda v: f"{v:.6f}"}
        max_line_width = 1000
        q_str = np.array2string(self.q, formatter=formatter,
                                max_line_width=max_line_width)[1:-1]
        t_str = np.array2string(self.t, formatter=formatter,
                                max_line_width=max_line_width)[1:-1]
        return f"{self.image_name} {q_str} {t_str} {self.inliers}"


TRANSFER_WORKERS = 4  # threads packing and shipping batches to the device
MAX_TRANSFERS = TRANSFER_WORKERS + 1  # batches submitted to them at once
DEPTH = 4  # dispatched batches whose result fetch is deferred


def iter_predictions(loader, model, meta_fn, times=None):
    """Pipelined sweep: yields ``(meta_fn(batch), fetch)`` in loader order,
    where ``fetch() -> (R, t, inliers)`` blocks on that batch's result.

    The sweep is a three-stage pipeline over the model's
    ``transfer_batch``/``dispatch_device`` split: worker threads pack and
    ship batches to the device, the calling thread issues the forwards in
    order, and up to ``DEPTH`` batches in flight defer their result fetch.

    Batches are numbered in loader order from 0, and each thread's spans
    (``utils/timing.py``) carry the number of the batch it works on: a
    worker's while it transfers one, the calling thread's while it loads,
    waits for and dispatches one, and, from each yield until the consumer
    asks for the next, that of the batch yielded.
    """
    from concurrent.futures import ThreadPoolExecutor

    times = times or NULL_TIMES
    pending = []
    inflight = []
    it = iter(loader)
    exhausted = False
    taken = 0  # batches taken from the loader
    outer = set_batch(None)
    try:
        with ThreadPoolExecutor(max_workers=TRANSFER_WORKERS) as ex:
            while not exhausted or inflight or pending:
                while not exhausted and len(inflight) < MAX_TRANSFERS:
                    set_batch(taken)
                    with stage(times, "load_wait"):
                        batch = next(it, None)
                    if batch is None:
                        exhausted = True
                        break
                    meta = meta_fn(batch)
                    inflight.append((taken, meta, ex.submit(
                        in_batch, taken, model.transfer_batch, batch, times)))
                    taken += 1
                if inflight:
                    seq, meta, fut = inflight.pop(0)
                    set_batch(seq)
                    with stage(times, "transfer_wait"):
                        transferred = fut.result()
                    pending.append((seq, meta, model.dispatch_device(transferred, times)))
                    while len(pending) > DEPTH:
                        yield _handed_over(pending.pop(0))
                elif pending:
                    yield _handed_over(pending.pop(0))
    finally:
        set_batch(outer)


def _handed_over(entry):
    """``(meta, fetch)`` of a pending ``(seq, meta, fetch)``, with the
    calling thread's batch id set to ``seq`` for the consumer's spans."""
    seq, meta, fetch = entry
    set_batch(seq)
    return meta, fetch


def predict(loader, model, times=None):
    """Run the model over a loader; returns dict scene -> [Pose]."""
    times = times or NULL_TIMES
    results_dict = defaultdict(list)

    def meta_fn(batch):
        return (batch["scene_id"], batch["pair_names"])

    for (scene_ids, pair_names), fetch in iter_predictions(
            loader, model, meta_fn, times):
        R, t, inliers = fetch()
        with stage(times, "pose_extract"):
            for i in range(R.shape[0]):
                Ri = np.asarray(R[i], np.float64)
                ti = np.asarray(t[i], np.float64).reshape(-1)
                if np.isnan(Ri).any() or np.isnan(ti).any() or np.isinf(ti).any():
                    continue  # no estimate for this frame -> failure downstream
                query_img = pair_names[i][1]
                if isinstance(query_img, (tuple, list)):
                    query_img = query_img[-1]  # multi-frame: the query frame
                results_dict[scene_ids[i]].append(
                    Pose(
                        image_name=query_img,
                        q=mat2quat(Ri).reshape(-1),
                        t=ti.reshape(-1),
                        inliers=float(np.asarray(inliers[i])),
                    )
                )
    return results_dict


def save_submission(results_dict: dict, output_path: Path):
    with ZipFile(output_path, "w") as z:
        for scene, poses in results_dict.items():
            poses_str = "\n".join(str(p) for p in poses)
            z.writestr(f"pose_{scene}.txt", poses_str.encode("utf-8"))
