"""Per-pair results video: side-by-side reference/query images with pose-error
overlay (port of mapfree_tpu/utils/visualisation.py; reference
lib/utils/visualisation.py:8-80, which uses vidgear/ffmpeg; here
cv2.VideoWriter). Without cv2 no video is written and one line says so; the
frames are counted all the same."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_video(results_path, dataloader, output_root, fps: int = 4):
    """Render a video per scene from saved localisation results.

    Args:
        results_path: npy of {scene: {query_im: res dict}} written by the
            7Scenes eval pipelines.
        dataloader: loader over the same test pairs (provides images).
        output_root: directory for ``video_{scene}.mp4``.
    Returns the sorted scenes that have frames.
    """
    from mapfree_tpu_torch.data.io import _cv2

    cv2 = _cv2()
    results = np.load(results_path, allow_pickle=True).item()
    output_root = Path(output_root)
    output_root.mkdir(parents=True, exist_ok=True)

    writers = {}
    frames = {}
    for batch in dataloader:
        B = len(batch["scene_id"])
        for i in range(B):
            scene = batch["scene_id"][i]
            if scene not in results:
                continue
            frames[scene] = frames.get(scene, 0) + 1
            if cv2 is None:
                continue
            query_im = batch["pair_names"][i][1]
            res = results[scene].get(query_im)

            img0 = (np.asarray(batch["image0"][i]) * 255).astype(np.uint8)
            img1 = (np.asarray(batch["image1"][i]) * 255).astype(np.uint8)
            frame = np.concatenate([img0, img1], axis=1)
            frame = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)

            if res is None:
                text = "FAILURE (no estimate)"
                color = (0, 0, 255)
            else:
                text = f"t_err {res['abs_t_err']:.2f}m r_err {res['abs_r_err']:.1f}deg"
                ok = res["abs_t_err"] < 0.25 and res["abs_r_err"] < 5
                color = (0, 200, 0) if ok else (0, 0, 255)
            cv2.putText(frame, text, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        color, 1, cv2.LINE_AA)

            if scene not in writers:
                h, w = frame.shape[:2]
                writers[scene] = cv2.VideoWriter(
                    str(output_root / f"video_{scene}.mp4"),
                    cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h),
                )
            writers[scene].write(frame)

    for w in writers.values():
        w.release()
    if cv2 is None:
        print(f"save_video: cv2 is not installed: {sum(frames.values())} frames of "
              f"{len(frames)} scenes, no video written to {output_root}")
    return sorted(frames)
