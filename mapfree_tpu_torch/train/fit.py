"""End-to-end training loop (port of mapfree_tpu/train/fit.py; reference
train.py:20-64).

Epoch structure, val interval, checkpointing and logging mirror the
reference's Lightning setup:
- val every TRAINING.VAL_INTERVAL fraction of an epoch, limited to
  TRAINING.VAL_BATCHES batches,
- top-5-by-val-loss + 'last' checkpoints,
- scalar channels identical to the reference's TensorBoard names.

:func:`fit_loaders` is the loop itself and takes its loaders as arguments:
any re-iterable (with ``len``) of collated numpy batches holding ``image0``,
``image1`` and ``T_0to1`` (and, for the fusion net, ``abs_q_1_w2c_device``
and ``abs_c_1_c2w_device``). :func:`fit` keeps the JAX package's signature,
plus the device: it builds the ``DataModule`` from the config, whose loaders
decode on that device, and hands its loaders to :func:`fit_loaders`.

Inside a ``torch.distributed`` process group of more than one rank (the
train CLI starts one rank per card, or joins ``torchrun``'s) the run is
data-parallel over the ranks' mesh (``parallel/mesh.py``), as the JAX fit
is over its device mesh: the batch size is rounded up to a multiple of the
rank count, every rank draws the same sampler order and decodes only its
own block of each batch, the steps reduce over the group
(``train/state.py``), and rank 0 alone prints, logs and writes checkpoints;
a resume loads on every rank.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from mapfree_tpu_torch.data import DataModule
from mapfree_tpu_torch.models.builder import resolve_device
from mapfree_tpu_torch.models.regression import build_regression_net
from mapfree_tpu_torch.parallel.mesh import (make_mesh, pad_to_multiple, rank_devices,
                                             world_and_rank)
from mapfree_tpu_torch.train.loop import (
    CheckpointManager,
    ScalarLogger,
    check_finite_or_die,
    run_validation,
)
from mapfree_tpu_torch.train.state import init_state, make_train_step, make_val_step
from mapfree_tpu_torch.utils.data import (
    data_to_device,
    prefetch_to_device,
    record_on_current_stream,
)

_TRAIN_KEYS = ("image0", "image1", "T_0to1")
_DEVICE_POSE_KEYS = ("abs_q_1_w2c_device", "abs_c_1_c2w_device")
PROFILE_STEPS = 20


def _train_keys(net) -> tuple:
    """Batch keys the training step takes: the fusion net needs the
    device-tracking poses as well."""
    if getattr(net, "needs_device_poses", False):
        return _TRAIN_KEYS + _DEVICE_POSE_KEYS
    return _TRAIN_KEYS


def _device_batch(batch, device, pad_to: int, keys=_TRAIN_KEYS, stream=None):
    """Keep the numeric training keys, pad the leading axis to the fixed
    batch size (with unit quaternions for the device poses), and move them
    to the device."""
    out = {}
    for k in keys:
        x = np.asarray(batch[k])
        if x.dtype == np.float64:  # pose metadata loads f64; train in f32
            x = x.astype(np.float32)
        if x.shape[0] < pad_to:
            filler = np.zeros((pad_to - x.shape[0],) + x.shape[1:], x.dtype)
            if k == "abs_q_1_w2c_device":  # quaternions stay unit-norm
                filler[..., 0] = 1.0
            x = np.concatenate([x, filler])
        out[k] = x
    return data_to_device(out, device, stream=stream)


class _NullLogger:
    def log(self, step, scalars):
        pass


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def fit_loaders(cfg, train_loader, val_loader, experiment: str = "default",
                resume: str | None = None, weights_dir: str = "weights",
                max_steps: int | None = None, device="cuda", mesh=None):
    """Train ``cfg``'s model on ``train_loader``, validating on
    ``val_loader``; returns the final train state. With a ``mesh`` of
    several ranks both loaders have ``rows`` set and yield this rank's block
    of each global batch."""
    device = resolve_device(device)
    batch_size = int(cfg.TRAINING.BATCH_SIZE)
    ranks = mesh is not None and mesh.size > 1
    main = not ranks or mesh.rank == 0
    say = print if main else (lambda *a, **k: None)
    if ranks and any(getattr(loader, "rows", None) is None
                     for loader in (train_loader, val_loader)):
        raise ValueError("over several ranks each loader yields its rank's rows: set loader.rows")
    pad_to = batch_size // mesh.size if ranks else batch_size

    net = build_regression_net(cfg)
    generator = torch.Generator().manual_seed(int(cfg.TPU.SEED))
    state = init_state(net, cfg, generator, device=device)

    ckpts = CheckpointManager(Path(weights_dir) / experiment, top_k=5)
    logger = ScalarLogger(weights_dir, experiment) if main else _NullLogger()
    if resume:
        state = ckpts.restore(state, tag=resume)
        say(f"[fit] resumed from {resume} at step {int(state.step)}")

    train_step = make_train_step(net, cfg, mesh=mesh)
    val_step = make_val_step(net, cfg, mesh=mesh)
    train_keys = _train_keys(net)

    steps_per_epoch = len(train_loader)
    val_every = max(1, int(steps_per_epoch * float(cfg.TRAINING.VAL_INTERVAL or 1.0)))
    val_batches = int(cfg.TRAINING.VAL_BATCHES or 0) or None
    log_every = int(cfg.TRAINING.LOG_INTERVAL or 50)

    def validate():
        def batches():
            for i, vb in enumerate(val_loader):
                if val_batches is not None and i >= val_batches:
                    break
                yield _device_batch(vb, device, pad_to, train_keys)
        return run_validation(val_step, state, batches())

    # optional torch.profiler trace of the first few steps
    profile_dir = cfg.TPU.PROFILE_DIR
    profiler, profile_until = None, None
    if profile_dir and main:
        profiler = _start_profiler()
        profile_until = int(state.step) + PROFILE_STEPS

    def stop_profiler():
        nonlocal profiler
        if profiler is not None:
            profiler.stop()
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
            profiler = None
            say(f"[fit] profiler trace written to {profile_dir}")

    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def _transfer(batch):
        return _device_batch(batch, device, pad_to, train_keys, stream=copy_stream)

    step = int(state.step)
    first_step = step
    t_start = time.time()
    try:
        for epoch in range(int(cfg.TRAINING.EPOCHS)):
            # batch k+1's host-to-device copy overlaps batch k's step
            for dbatch in prefetch_to_device(train_loader, _transfer):
                state, logs = train_step(state, record_on_current_stream(dbatch))
                step += 1

                if profile_until is not None and step >= profile_until:
                    stop_profiler()
                    profile_until = None

                if step % log_every == 0:
                    host_logs = {k: float(v) for k, v in logs.items()}
                    check_finite_or_die(host_logs["train/loss"], step)
                    rate = (step - first_step) * batch_size / (time.time() - t_start)
                    host_logs["train/samples_per_sec"] = rate
                    logger.log(step, host_logs)
                    say(f"[e{epoch} s{step}] loss={host_logs['train/loss']:.4f} "
                        f"({rate:.1f} samples/s)")

                if step % val_every == 0:
                    vlogs = validate()
                    if vlogs:
                        logger.log(step, vlogs)
                        if main:
                            ckpts.save(state, step, val_loss=vlogs["val_loss/loss"])
                        say(f"[e{epoch} s{step}] val_loss={vlogs['val_loss/loss']:.4f}")

                if max_steps is not None and step >= max_steps:
                    if main:
                        ckpts.save(state, step)
                    return state

            if main:
                ckpts.save(state, step)  # epoch-end 'last'
    finally:
        stop_profiler()
    return state


def fit(cfg, experiment: str = "default", resume: str | None = None,
        weights_dir: str = "weights", max_steps: int | None = None, device="cuda"):
    """Train ``cfg``'s model on its dataset (mapfree_tpu/train/fit.py:66-80):
    the ``DataModule``'s train and validation loaders, decoding on
    ``device``, feed :func:`fit_loaders`. Returns the final train state.

    The JAX fit draws one batch from the train loader to give its model
    shapes, and its loader's ``len`` draws a whole epoch from the
    scene-balance sampler, so its first epoch trains on the sampler's third
    draw. A torch module needs no shapes and the port's loader counts
    without drawing, so here the first epoch trains on the sampler's first
    draw: the batch the JAX fit initialises from.

    Inside a process group of more than one rank ``device`` is this rank's
    (a bare "cuda" is the current CUDA device) and the run is data-parallel
    over the ranks (see the module's docstring)."""
    world, rank = world_and_rank()
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(cfg, devices=rank_devices(device) if world > 1 else [device])
    n_dev = mesh.size
    batch_size = int(cfg.TRAINING.BATCH_SIZE)
    if batch_size % n_dev != 0:
        batch_size = pad_to_multiple(batch_size, n_dev)
        if rank == 0:
            print(f"[fit] rounding batch size up to {batch_size} for {n_dev} devices")
        cfg.TRAINING.BATCH_SIZE = batch_size

    datamodule = DataModule(cfg, device=device)
    train_loader, val_loader = datamodule.train_dataloader(), datamodule.val_dataloader()
    if n_dev > 1:  # every rank draws the sampler's order, decodes its own rows
        per = batch_size // n_dev
        for loader in (train_loader, val_loader):
            loader.rows = (mesh.rank * per, (mesh.rank + 1) * per)
    return fit_loaders(cfg, train_loader, val_loader,
                       experiment=experiment, resume=resume, weights_dir=weights_dir,
                       max_steps=max_steps, device=device, mesh=mesh if n_dev > 1 else None)
