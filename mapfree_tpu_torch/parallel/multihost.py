"""Multi-host scene-sharded evaluation (port of
mapfree_tpu/parallel/multihost.py).

Data parallelism over scenes across hosts: each host runs the normal batched
sweep over its shard of the scene list on its own card, writes a per-host
partial submission, and host 0 merges. No collectives are needed: scenes are
embarrassingly parallel and only the merge touches the shared filesystem
(after one barrier).

Everything is injectable (n_hosts / host_id default to torch.distributed's
world size and rank where a process group is initialized, else 1 and 0), so
a single process can dry-run an N-host sweep and byte-compare the merged
result against a single-host run.
"""

from __future__ import annotations

from pathlib import Path
from zipfile import ZipFile

from mapfree_tpu_torch.parallel.mesh import world_and_rank as _world


def shard_scenes(scenes, n_hosts: int, host_id: int) -> list:
    """Deterministic balanced split of the sorted scene list.

    Every host computes the same global assignment (sorted scenes,
    round-robin) so no coordination is required.
    """
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} is not in [0, {n_hosts})")
    ordered = sorted(scenes)
    return ordered[host_id::n_hosts]


def partial_submission_path(out_root: Path, host_id: int) -> Path:
    return Path(out_root) / f"submission.part{host_id:03d}.zip"


def merge_submissions(part_paths, out_path: Path) -> None:
    """Merge per-host partial submission zips into one leaderboard zip.

    Scene files are written in sorted order so the merged zip holds the same
    bytes whatever the host count. Duplicate scene files across parts are an
    error: the sharding is disjoint by construction.
    """
    entries = {}
    for part in part_paths:
        with ZipFile(part, "r") as z:
            for name in z.namelist():
                if name in entries:
                    raise ValueError(f"scene {name} in multiple shards")
                entries[name] = z.read(name)
    with ZipFile(out_path, "w") as z:
        for name in sorted(entries):
            z.writestr(name, entries[name])


def host_topology(n_hosts=None, host_id=None):
    """Resolve (n_hosts, host_id) from torch.distributed's process group
    unless explicitly injected (tests / dryruns)."""
    world, rank = _world()
    n_hosts = world if n_hosts is None else n_hosts
    host_id = rank if host_id is None else host_id
    return int(n_hosts), int(host_id)


def default_barrier():
    """``barrier(tag)`` over torch.distributed's process group where its
    world is larger than 1, else None."""
    if _world()[0] <= 1:
        return None
    import torch.distributed as dist

    return lambda tag: dist.barrier()


def list_split_scenes(cfg, split: str) -> list:
    """Scene names of a dataset split (the sweep's unit of sharding)."""
    root = Path(cfg.DATASET.DATA_ROOT) / split
    scenes = cfg.DATASET.SCENES
    if scenes:
        return [s for s in scenes if (root / s).exists()]
    return sorted(p.name for p in root.iterdir() if p.is_dir())


def run_sharded_sweep(cfg, split: str, out_root, model=None,
                      n_hosts=None, host_id=None, barrier=None,
                      device="cuda", checkpoint: str = ""):
    """One host's share of the eval sweep -> partial zip; host 0 merges.

    Args:
        cfg: merged config (DATASET.SCENES is overridden per shard).
        split: 'val' | 'test'.
        out_root: output directory (shared filesystem across hosts).
        model: optional prebuilt model (else ``build_model(cfg, checkpoint,
            device=device)``).
        n_hosts, host_id: topology injection for dryruns.
        barrier: optional callable invoked after the partial write and before
            the merge (:func:`default_barrier` on a real multi-host run).
        device: where the loader decodes and the model runs.
        checkpoint: weights of the model built here.
    Returns the merged submission path on host 0, else the partial path.
    """
    from mapfree_tpu_torch.data import DataLoader
    from mapfree_tpu_torch.data.datamodule import DataModule
    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.utils.submission import predict, save_submission

    n_hosts, host_id = host_topology(n_hosts, host_id)
    out_root = Path(out_root)
    out_root.mkdir(parents=True, exist_ok=True)

    shard_cfg = cfg.clone()
    shard = shard_scenes(list_split_scenes(cfg, split), n_hosts, host_id)
    shard_cfg.DATASET.SCENES = shard

    part = partial_submission_path(out_root, host_id)
    if shard:
        dm = DataModule(shard_cfg, device=device)
        dataset = dm.dataset_type(shard_cfg, split, device=device)
        loader = DataLoader(
            dataset,
            batch_size=int(shard_cfg.TPU.INFER_BATCH),
            num_workers=shard_cfg.TRAINING.NUM_WORKERS or 2,
            unique_refs=(shard_cfg.MODEL == "Regression"
                         and int(shard_cfg.TPU.UNIQUE_REFS) > 0),
        )
        if model is None:
            model = build_model(shard_cfg, checkpoint, device=device)
        results = predict(loader, model)
    else:  # more hosts than scenes: an empty but valid partial
        results = {}
    save_submission(results, part)

    if barrier is not None:
        barrier("mapfree_sharded_sweep")
    if host_id != 0:
        return part

    parts = [partial_submission_path(out_root, h) for h in range(n_hosts)]
    merged = out_root / "submission.zip"
    merge_submissions(parts, merged)
    return merged
