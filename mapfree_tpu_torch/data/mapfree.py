"""MapFree dataset: scene parsing, pair generation, sample loading (port of
mapfree_tpu/data/mapfree.py).

Behavioural equivalent of reference lib/datasets/mapfree.py:16-420: samples
are NHWC numpy dicts with the same key contract ({image0, image1, depth0,
depth1, T_0to1, abs_q/c_*, K_color0/1, scene_id, pair_id, pair_names, sim}),
collated into fixed-shape batches by :mod:`mapfree_tpu_torch.data.loader`.

A dataset's ``device`` says where its batch paths (``getitems``,
``getbatch``) decode: on a CUDA device nvJPEG decodes each batch on the card
(``data/jpeg.py``); on the CPU cv2 or PIL decode it on the host. The
per-sample ``__getitem__`` reads on the host, as the JAX package does.

Pair semantics preserved exactly:
- train scenes: pairs from overlaps.npz filtered to (MIN, MAX) overlap
  (reference mapfree.py:85-147);
- val/test scenes: (seq0/frame_00000, every 5th query frame)
  (reference mapfree.py:148-164);
- multi-frame: windows of QUERY_FRAME_COUNT consecutive valid frames ending at
  the query frame, with device-tracking poses from poses_device.txt
  (reference mapfree.py:91-143, 165-202, 273-365).
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from mapfree_tpu_torch.data.io import read_color_image, read_depth_image
from mapfree_tpu_torch.geom.projection import correct_intrinsic_scale
from mapfree_tpu_torch.geom.quaternion import (
    qinverse,
    quat2mat,
    relative_pose_wxyz,
    rotate_vector,
)
from mapfree_tpu_torch.models.builder import resolve_device

_FRAME_NUM_RE = re.compile(r"_(\d+)\..*$")


def _as_float01(image: np.ndarray) -> np.ndarray:
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image


def read_intrinsics(scene_root: Path, resize=None) -> dict:
    Ks = {}
    with (scene_root / "intrinsics.txt").open("r") as f:
        for line in f.readlines():
            if "#" in line:
                continue
            parts = line.strip().split(" ")
            img_name = parts[0]
            fx, fy, cx, cy, W, H = map(float, parts[1:])
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
            if resize is not None:
                K = correct_intrinsic_scale(K, resize[0] / W, resize[1] / H).astype(
                    np.float32
                )
            Ks[img_name] = K
    return Ks


def read_poses(scene_root: Path, filename: str = "poses.txt") -> dict:
    """img_path -> (q, t) world-to-camera: X_c = R(q) X_w + t."""
    poses = {}
    with (scene_root / filename).open("r") as f:
        for line in f.readlines():
            if "#" in line:
                continue
            parts = line.strip().split(" ")
            qt = np.array(list(map(float, parts[1:])))
            poses[parts[0]] = (qt[:4], qt[4:])
    return poses


def _train_pairs(scene_root: Path, overlap_limits, sample_offset: int):
    f = np.load(scene_root / "overlaps.npz", allow_pickle=True)
    idxs, overlaps = f["idxs"], f["overlaps"]

    if sample_offset > 0:
        # all frame ids that appear in any pair, per sequence (pre-filter!)
        valid_frame_ids = {
            seq: sorted(
                set(idxs[idxs[:, 0] == seq, 1]) | set(idxs[idxs[:, 2] == seq, 3])
            )
            for seq in (0, 1)
        }
        frame_rank = {
            seq: {fid: i for i, fid in enumerate(valid_frame_ids[seq])}
            for seq in (0, 1)
        }

    if overlap_limits is not None:
        lo, hi = overlap_limits
        mask = np.logical_and(lo < overlaps, overlaps < hi)
        idxs = idxs[mask]

    if sample_offset == 0:
        return [tuple(row) for row in idxs]

    # multi-frame: a window of `sample_offset` consecutive valid frames ending
    # at imgB, provided the window exists and the map frame does not fall
    # inside it (reference mapfree.py:117-141)
    out = []
    for seqA, imgA, seqB, imgB in idxs:
        ranks = frame_rank[seqB]
        fids = valid_frame_ids[seqB]
        r = ranks[imgB]
        start = r - sample_offset + 1
        if start < 0:
            continue
        if not (seqA != seqB or imgA < fids[start] or imgB < imgA):
            continue
        window = tuple(fids[start + i] for i in range(sample_offset))
        out.append((seqA, imgA, seqB, window))
    return out


def _eval_pairs(poses: dict, sample_factor: int, sample_offset: int):
    frames = sorted(
        int(_FRAME_NUM_RE.search(fn).group(1))
        for fn in poses.keys()
        if "seq0" not in fn
    )
    rows = [(0, 0, 1, f) for f in frames]
    if sample_offset == 0:
        return rows[0::sample_factor]
    # multi-frame: every sample_factor-th row starting at sample_offset, with
    # the window being the preceding rows (reference mapfree.py:165-202)
    out = []
    for i in range(sample_offset, len(rows), sample_factor):
        window = tuple(rows[j][3] for j in range(i - sample_offset + 1, i + 1))
        out.append((0, 0, 1, window))
    return out


class MapFreeScene:
    """One scene: a reference seq0 frame + query seq1 frames (or train pairs)."""

    multi_frame = False

    def __init__(self, scene_root, resize, sample_factor=1, overlap_limits=None,
                 transforms=None, estimated_depth=None, sample_offset: int = 0):
        self.scene_root = Path(scene_root)
        self.resize = resize
        self.sample_factor = sample_factor
        self.sample_offset = sample_offset
        self.transforms = transforms
        self.estimated_depth = estimated_depth

        self.poses = read_poses(self.scene_root)
        self.K = read_intrinsics(self.scene_root, resize)
        if (self.scene_root / "overlaps.npz").exists():
            self.pairs = _train_pairs(self.scene_root, overlap_limits, sample_offset)
        else:
            self.pairs = _eval_pairs(self.poses, sample_factor, sample_offset)

    def __len__(self):
        return len(self.pairs)

    def get_pair_path(self, pair):
        seqA, imgA, seqB, imgB = pair
        return (f"seq{seqA}/frame_{imgA:05}.jpg", f"seq{seqB}/frame_{imgB:05}.jpg")

    def _read_depth(self, im_path):
        dpath = str(self.scene_root / im_path).replace(
            ".jpg", f".{self.estimated_depth}.png"
        )
        return read_depth_image(dpath)

    def _relative_pose(self, im1_path, im2_path):
        q1, t1 = self.poses[im1_path]
        q2, t2 = self.poses[im2_path]
        c1 = rotate_vector(-t1, qinverse(q1))  # camera centers, world coords
        c2 = rotate_vector(-t2, qinverse(q2))
        q12, t12 = relative_pose_wxyz(q1, t1, q2, t2)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = quat2mat(q12)
        T[:3, -1] = t12
        return T, (q1, c1), (q2, c2)

    def image_paths(self, index):
        """Absolute color-image paths a sample needs, in getitem order —
        the batch-decode contract used by ConcatDataset.getitems."""
        im1_path, im2_path = self.get_pair_path(self.pairs[index])
        return [str(self.scene_root / im1_path), str(self.scene_root / im2_path)]

    def __getitem__(self, index):
        images = [
            read_color_image(p, self.resize) for p in self.image_paths(index)
        ]
        return self.getitem_decoded(index, images)

    def getitem_decoded(self, index, images):
        """Assemble a sample from already-decoded HWC images (uint8 or
        float32 [0,1], one per image_paths entry): lets the loader decode
        whole batches in one call (nvJPEG on the card) instead of per image.
        uint8 images pass through untouched (models normalise on the
        device; 4x cheaper host->device transfer)."""
        im1_path, im2_path = self.get_pair_path(self.pairs[index])

        image1, image2 = images
        if self.transforms is not None:
            image1 = self.transforms(_as_float01(image1))
            image2 = self.transforms(_as_float01(image2))
        if self.estimated_depth is not None:
            depth1 = self._read_depth(im1_path)
            depth2 = self._read_depth(im2_path)
        else:
            depth1 = depth2 = np.zeros((0,), np.float32)

        T, (q1, c1), (q2, c2) = self._relative_pose(im1_path, im2_path)

        return {
            "image0": image1,  # (h, w, 3)
            "depth0": depth1,  # (h, w)
            "image1": image2,
            "depth1": depth2,
            "T_0to1": T,  # (4, 4) relative pose
            "abs_q_0": q1,
            "abs_c_0": c1,
            "abs_q_1": q2,
            "abs_c_1": c2,
            "K_color0": self.K[im1_path].copy(),
            "K_color1": self.K[im2_path].copy(),
            "dataset_name": "Mapfree",
            "scene_id": self.scene_root.stem,
            "scene_root": str(self.scene_root),
            "pair_id": index * self.sample_factor,
            "pair_names": (im1_path, im2_path),
            "sim": 0.0,  # 7Scenes eval compatibility
        }


class MapFreeSceneMultiFrame(MapFreeScene):
    """Query is a window of frames; device-tracking poses are attached
    (reference mapfree.py:273-365)."""

    multi_frame = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.poses_device = read_poses(self.scene_root, "poses_device.txt")

    def get_pair_path(self, pair):
        seqA, imgA, seqB, imgB = pair
        return (
            f"seq{seqA}/frame_{imgA:05}.jpg",
            tuple(f"seq{seqB}/frame_{b:05}.jpg" for b in imgB),
        )

    def image_paths(self, index):
        im1_path, im2_paths = self.get_pair_path(self.pairs[index])
        return [str(self.scene_root / im1_path)] + [
            str(self.scene_root / p) for p in im2_paths
        ]

    def getitem_decoded(self, index, images):
        im1_path, im2_paths = self.get_pair_path(self.pairs[index])

        image1, *window = images
        if self.transforms is not None:
            image1 = self.transforms(_as_float01(image1))
            window = [self.transforms(_as_float01(im)) for im in window]
        image2 = np.stack(window)
        if self.estimated_depth is not None:
            depth1 = self._read_depth(im1_path)
            depth2 = np.stack([self._read_depth(p) for p in im2_paths])
        else:
            depth1 = depth2 = np.zeros((0,), np.float32)

        # the LAST window frame is the query frame
        T, (q1, c1), (q2, c2) = self._relative_pose(im1_path, im2_paths[-1])

        data = {
            "image0": image1,            # (h, w, 3)
            "depth0": depth1,
            "image1": image2,            # (F, h, w, 3)
            "depth1": depth2,
            "T_0to1": T,
            "abs_q_0": q1,
            "abs_c_0": c1,
            "abs_q_1": q2,
            "abs_c_1": c2,
            "K_color0": self.K[im1_path].copy(),
            "K_color1": self.K[im2_paths[-1]].copy(),
            "dataset_name": "Mapfree",
            "scene_id": self.scene_root.stem,
            "scene_root": str(self.scene_root),
            "pair_id": index * self.sample_factor,
            "pair_names": (im1_path, im2_paths),
            "sim": 0.0,
        }

        if self.poses_device is not None:
            qd, td = zip(*(self.poses_device[p] for p in im2_paths))
            data["abs_q_1_w2c_device"] = np.stack(qd)
            data["abs_q_1_c2w_device"] = np.stack([qinverse(q) for q in qd])
            data["abs_c_1_c2w_device"] = np.stack(td)
            q_c2w = [qinverse(q) for q in qd]
            t_c2w = [rotate_vector(-t, q) for q, t in zip(q_c2w, td)]
            data["abs_q_1_c2w_multi"] = np.stack(q_c2w)
            data["abs_c_1_c2w_multi"] = np.stack(t_c2w)
        return data


def _collated_metadata(resolved):
    """Collated metadata (every field but the images) for a batch of
    single-frame samples, assembled with ONE batched quaternion pipeline.

    Field-for-field identical to ``collate([getitem_decoded(...)])`` minus
    image0/image1 (the quaternion ops in geom/quaternion.py are shape-
    polymorphic, so the batched math is the same arithmetic): one numpy
    pipeline per batch instead of one per sample."""
    names = [ds.get_pair_path(ds.pairs[i]) for ds, i in resolved]
    B = len(resolved)
    q1 = np.stack([ds.poses[n[0]][0] for (ds, _), n in zip(resolved, names)])
    t1 = np.stack([ds.poses[n[0]][1] for (ds, _), n in zip(resolved, names)])
    q2 = np.stack([ds.poses[n[1]][0] for (ds, _), n in zip(resolved, names)])
    t2 = np.stack([ds.poses[n[1]][1] for (ds, _), n in zip(resolved, names)])
    q12, t12 = relative_pose_wxyz(q1, t1, q2, t2)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = quat2mat(q12)
    T[:, :3, 3] = t12
    c1 = rotate_vector(-t1, qinverse(q1))
    c2 = rotate_vector(-t2, qinverse(q2))
    empty = [np.zeros((0,), np.float32)] * B  # depth stays uncollated (loader)
    return {
        "depth0": empty,
        "depth1": empty,
        "T_0to1": T,
        "abs_q_0": q1,
        "abs_c_0": c1,
        "abs_q_1": q2,
        "abs_c_1": c2,
        "K_color0": np.stack(
            [ds.K[n[0]] for (ds, _), n in zip(resolved, names)]),
        "K_color1": np.stack(
            [ds.K[n[1]] for (ds, _), n in zip(resolved, names)]),
        "dataset_name": ["Mapfree"] * B,
        "scene_id": [ds.scene_root.stem for ds, _ in resolved],
        "scene_root": [str(ds.scene_root) for ds, _ in resolved],
        "pair_id": np.asarray([i * ds.sample_factor for ds, i in resolved]),
        "pair_names": names,
        "sim": np.zeros(B),
    }


class ConcatDataset:
    """Minimal concat-of-datasets with cumulative index mapping. ``device``
    is where the batch paths decode (see the module's docstring)."""

    def __init__(self, datasets, device="cuda"):
        self.device = resolve_device(device)
        self.datasets = list(datasets)
        sizes = [len(d) for d in self.datasets]
        self.cumulative_sizes = np.cumsum(sizes).tolist()
        self._decode_cache: dict = {}  # path -> decoded image (FIFO, max 16)
        # getbatch ships planar YUV420 uint8 (half the H2D bytes) when set
        # by the owning dataset (cfg.TPU.YUV420_TRANSFER) and dims are even
        self.yuv420_transfer = False
        # getitems may ALSO emit YUV420 samples — only for consumers whose
        # device program unpacks them (the train step with DEVICE_AUGMENT;
        # DataModule.train_dataloader sets this). Host consumers (SIFT,
        # visualisation) need RGB, so this is opt-in per loader, not global.
        self.yuv420_getitems = False

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def _resolve(self, idx):
        d = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        lo = 0 if d == 0 else self.cumulative_sizes[d - 1]
        return self.datasets[d], idx - lo

    def __getitem__(self, idx):
        ds, local = self._resolve(idx)
        return ds[local]

    def getitems(self, indices):
        """Batch fetch: decode every color image the batch needs in ONE
        call on the dataset's device, then assemble samples. Takes the
        per-item __getitem__ when a sub-dataset does not speak the
        batch-decode protocol, resize dims differ or a file is no JPEG."""
        resolved = [self._resolve(i) for i in indices]
        sizes = {
            getattr(ds, "resize", None)
            for ds, _ in resolved
            if hasattr(ds, "image_paths")
        }
        if (
            any(not hasattr(ds, "image_paths") for ds, _ in resolved)
            or len(sizes) != 1
            or next(iter(sizes)) is None
        ):
            return [ds[i] for ds, i in resolved]

        from mapfree_tpu_torch.data.io import decode_resize_batch

        path_lists = [ds.image_paths(i) for ds, i in resolved]
        # the batch decoders are JPEG-only (7Scenes ships PNGs)
        if not all(
            p.lower().endswith((".jpg", ".jpeg"))
            for pl in path_lists for p in pl
        ):
            return [ds[i] for ds, i in resolved]
        w, h = next(iter(sizes))
        uint8 = all(ds.transforms is None for ds, _ in resolved)
        # planar YUV420 halves the train loader's H2D bytes; restricted to
        # single-frame samples (the multi-frame fusion net normalises RGB)
        # and opt-in via yuv420_getitems (host consumers need RGB). Cache
        # keys carry the format so mixed calls can't serve the wrong layout.
        yuv = (self.yuv420_getitems and uint8 and w % 2 == 0 and h % 2 == 0
               and all(len(pl) == 2 for pl in path_lists))
        ckey = (lambda p: ("yuv", p)) if yuv else (lambda p: p)

        # decode each unique path once: in the eval sweep every sample of a
        # scene shares the same reference frame, so dedup + a small
        # cross-batch cache nearly halves decode work. Cache hits are
        # SNAPSHOTTED at scan time (``cached``): the cache is shared across
        # loader worker threads and evicted below, so re-reading it after
        # this loop can KeyError (deterministically so when one batch holds
        # >16 distinct repeated paths — the eviction outran the reads).
        unique, by_path, cached = [], {}, {}
        for pl in path_lists:
            for p in pl:
                if p in by_path or p in cached:
                    continue
                hit = self._decode_cache.get(ckey(p))
                if hit is not None:
                    cached[p] = hit
                else:
                    by_path[p] = len(unique)
                    unique.append(p)
        decoded = (
            decode_resize_batch(unique, w, h, uint8=uint8, yuv420=yuv,
                                device=self.device)
            if unique else None
        )

        def lookup(p):
            if p in by_path:
                return decoded[by_path[p]]
            return cached[p]

        # cache paths that repeat within this batch (the hot ref frames)
        counts = {}
        for pl in path_lists:
            for p in pl:
                counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            if c > 1:
                self._decode_cache[ckey(p)] = lookup(p)
        while len(self._decode_cache) > 16:
            self._decode_cache.pop(next(iter(self._decode_cache)))

        return [
            ds.getitem_decoded(i, [lookup(p) for p in pl])
            for (ds, i), pl in zip(resolved, path_lists)
        ]

    def getbatch(self, indices):
        """Batch fetch with reference-frame dedup kept through collation.

        Returns a collated batch whose image fields are
        ``image0_unique [U, H, W, 3]`` + ``ref_idx [B]`` (each pair's row in
        the unique array) + ``image1 [B, H, W, 3]``, or None when the fast
        path does not apply (multi-frame windows, PNGs, transforms, repeated
        queries). Two wins over getitems+collate: the query stack is a
        zero-copy view of the decoder's output (no re-stacking of the
        batch), and only the UNIQUE reference frames are shipped to and
        encoded on the device (an eval batch shares 1-2 refs across its
        pairs; reference submission.py:33-58 re-encodes the ref for every
        pair).
        """
        resolved = [self._resolve(i) for i in indices]
        sizes = {
            getattr(ds, "resize", None)
            for ds, _ in resolved
            if hasattr(ds, "image_paths")
        }
        if (
            any(not hasattr(ds, "image_paths") for ds, _ in resolved)
            or len(sizes) != 1
            or next(iter(sizes)) is None
            or any(ds.transforms is not None for ds, _ in resolved)
        ):
            return None
        path_lists = [ds.image_paths(i) for ds, i in resolved]
        if not all(len(pl) == 2 for pl in path_lists):  # single-frame only
            return None
        if not all(
            p.lower().endswith((".jpg", ".jpeg"))
            for pl in path_lists for p in pl
        ):
            return None
        queries = [pl[1] for pl in path_lists]
        refs = [pl[0] for pl in path_lists]
        if len(set(queries)) != len(queries):
            return None

        from mapfree_tpu_torch.data.io import decode_resize_batch

        w, h = next(iter(sizes))
        # planar YUV420 halves the H2D bytes; cache keys carry the format so
        # a getitems (RGB) call on the same instance can't mix layouts
        yuv = self.yuv420_transfer and w % 2 == 0 and h % 2 == 0
        ckey = (lambda p: ("yuv", p)) if yuv else (lambda p: p)

        ref_rows, ref_of = [], {}
        for p in refs:
            if p not in ref_of:
                ref_of[p] = len(ref_rows)
                ref_rows.append(p)
        # snapshot cache hits NOW: the cache is shared across loader worker
        # threads and evicted below, so a later read could miss
        new_refs, cached = [], {}
        for p in ref_rows:
            hit = self._decode_cache.get(ckey(p))
            if hit is None:
                new_refs.append(p)
            else:
                cached[p] = hit
        # decode order [queries..., new refs...]: image1 is a zero-copy view
        decoded = decode_resize_batch(
            queries + new_refs, w, h, uint8=True, yuv420=yuv, device=self.device)
        B = len(queries)
        image1 = decoded[:B]

        new_pos = {p: B + j for j, p in enumerate(new_refs)}
        ref_arrays = [
            decoded[new_pos[p]] if p in new_pos else cached[p]
            for p in ref_rows
        ]
        image0_unique = np.stack(ref_arrays)
        for p in ref_rows:  # refs repeat across batches of the same scene
            self._decode_cache[ckey(p)] = ref_arrays[ref_of[p]]
        while len(self._decode_cache) > 16:
            self._decode_cache.pop(next(iter(self._decode_cache)))

        if all(ds.estimated_depth is None for ds, _ in resolved):
            batch = _collated_metadata(resolved)
        else:  # depth reads are per-file: keep the per-sample path
            from mapfree_tpu_torch.data.loader import collate

            samples = []
            for j, ((ds, i), pl) in enumerate(zip(resolved, path_lists)):
                s = ds.getitem_decoded(
                    i, [ref_arrays[ref_of[pl[0]]], decoded[j]])
                s.pop("image0")
                s.pop("image1")
                samples.append(s)
            batch = collate(samples)
        batch["image0_unique"] = image0_unique
        batch["ref_idx"] = np.asarray([ref_of[p] for p in refs], np.int32)
        # the ref identities, as the JAX package's loader gives them (its
        # predictor keeps a ref cache across batches; the port's predictor
        # ships the unique refs with every batch and does not read them)
        batch["ref_names"] = [(ckey(p) if yuv else p) for p in ref_rows]
        batch["image1"] = image1
        return batch


class MapFreeDataset(ConcatDataset):
    def __init__(self, cfg, mode, transforms=None, device="cuda"):
        assert mode in ("train", "val", "test"), "Invalid dataset mode"

        scenes = cfg.DATASET.SCENES
        data_root = Path(cfg.DATASET.DATA_ROOT) / mode
        resize = (cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT)
        estimated_depth = cfg.DATASET.ESTIMATED_DEPTH
        overlap_limits = (cfg.DATASET.MIN_OVERLAP_SCORE, cfg.DATASET.MAX_OVERLAP_SCORE)
        assert isinstance(cfg.DATASET.QUERY_FRAME_COUNT, int)

        if cfg.DATASET.QUERY_FRAME_COUNT == 1:
            sample_factor = {"train": 1, "val": 5, "test": 5}[mode]
            sample_offset = 0
            scene_cls = MapFreeScene
        else:
            sample_factor = cfg.DATASET.QUERY_FRAME_COUNT + 1
            sample_offset = cfg.DATASET.QUERY_FRAME_COUNT
            scene_cls = MapFreeSceneMultiFrame

        if scenes is None:
            scenes = sorted(s.name for s in data_root.iterdir() if s.is_dir())
        else:
            scenes = [s for s in scenes if (data_root / s).exists()]

        workers = max(1, int(cfg.TRAINING.NUM_WORKERS or 1))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            data_srcs = list(
                ex.map(
                    lambda scene: scene_cls(
                        scene_root=data_root / scene,
                        resize=resize,
                        sample_factor=sample_factor,
                        overlap_limits=overlap_limits,
                        transforms=transforms,
                        estimated_depth=estimated_depth,
                        sample_offset=sample_offset,
                    ),
                    scenes,
                )
            )
        super().__init__(data_srcs, device=device)
        self.yuv420_transfer = bool(getattr(cfg.TPU, "YUV420_TRANSFER", False))
