"""Render per-scene MP4s of submission estimates vs ground truth (port of
mapfree_tpu/visualisation/render_estimates.py; reference
visualisation/render_estimates.py:15-72).

Run: ``python -m mapfree_tpu_torch.visualisation.render_estimates submission.zip
--split val --dataset_path data/mapfree -o renders/``

``--device`` (default ``cuda``) is where the frames are rendered and the
query photos decoded (nvJPEG, at each file's own size); with ``--device
cpu`` the photos are read on the host (``data/io.py::imread_rgb``). Without
cv2 the frames are rendered but no MP4 is written (``render_scene``).
"""

from __future__ import annotations

import argparse
from io import TextIOWrapper
from pathlib import Path
from zipfile import ZipFile

from mapfree_tpu_torch.benchmark.utils import load_poses, subsample_poses
from mapfree_tpu_torch.models.builder import resolve_device
from mapfree_tpu_torch.visualisation.render_scene import render_scene


def read_photos(paths, device) -> list:
    """RGB uint8 [H, W, 3] numpy arrays of JPEG files at their own sizes:
    decoded on the card with nvJPEG for a CUDA ``device`` (one batch per
    size), read on the host otherwise."""
    device = resolve_device(device)
    if device.type != "cuda":
        from mapfree_tpu_torch.data.io import imread_rgb

        return [imread_rgb(p) for p in paths]
    from mapfree_tpu_torch.data.jpeg import decode_resize_batch, decoder

    sizes: dict = {}  # (w, h) -> indices of the files of that size
    for i, p in enumerate(paths):
        info = decoder().read_info(p)
        if info is None:
            raise ValueError(f"{p} is no JPEG that nvJPEG can decode")
        sizes.setdefault((info[1], info[2]), []).append(i)
    out = [None] * len(paths)
    for (w, h), idx in sizes.items():
        batch = decode_resize_batch([paths[i] for i in idx], w, h, uint8=True,
                                    device=device)
        for j, i in enumerate(idx):
            out[i] = batch[j]
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m mapfree_tpu_torch.visualisation.render_estimates")
    parser.add_argument("submission_path", type=Path)
    parser.add_argument("--dataset_path", type=Path, default=Path("data/mapfree"))
    parser.add_argument("--split", choices=("val", "test"), default="val")
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--output", "-o", type=Path, default=Path("renders"))
    parser.add_argument("--confidence_threshold", type=float, default=0.0)
    parser.add_argument("--fps", type=int, default=5)
    parser.add_argument("--no_images", action="store_true",
                        help="skip loading query photos (no textured planes "
                             "or picture-in-picture)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Render every scene of the split that the submission has estimates
    for; returns {scene: frames rendered}."""
    args = parse_args(argv)
    dataset_path = args.dataset_path / args.split
    scenes = sorted(f.name for f in dataset_path.iterdir() if f.is_dir())
    if args.scenes:
        scenes = [s for s in scenes if s in args.scenes]

    args.output.mkdir(parents=True, exist_ok=True)
    rendered = {}
    with ZipFile(args.submission_path, "r") as submission_zip:
        for scene in scenes:
            with (dataset_path / scene / "poses.txt").open("r", encoding="utf-8") as f:
                gt_poses = subsample_poses(load_poses(f, load_confidence=False), 5)
            try:
                with submission_zip.open(f"pose_{scene}.txt") as est_file:
                    est_poses = load_poses(TextIOWrapper(est_file, encoding="utf-8"),
                                           load_confidence=True)
            except KeyError:
                print(f"skipping {scene}: no estimates in submission")
                continue

            scene_images = None
            if not args.no_images:
                paths = {frame_num: dataset_path / scene / "seq1" / f"frame_{frame_num:05d}.jpg"
                         for frame_num in gt_poses}
                paths = {k: p for k, p in paths.items() if p.exists()}
                scene_images = dict(zip(paths, read_photos(list(paths.values()), args.device)))

            out = args.output / f"{scene}.mp4"
            n = render_scene(gt_poses, est_poses, out,
                             confidence_threshold=args.confidence_threshold,
                             fps=args.fps, scene_images=scene_images,
                             device=args.device)
            rendered[scene] = n
            print(f"rendered {scene}: {n} frames -> {out}")
    return rendered


if __name__ == "__main__":
    main()
