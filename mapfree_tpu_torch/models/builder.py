"""Model builder: batched inference over collated loader batches (port of
mapfree_tpu/models/builder.py::RegressionPredictor, build_model).

``predict_batch(batch) -> (R [B,3,3], t [B,1,3], inliers [B])`` numpy, and
the split the pipelined sweep drives (utils/submission.py::iter_predictions).
It serves every regression model: ``Regression``, and the multi-frame
``RegressionMultiFrame`` and ``RegressionMultiFrameFusion``, whose image1 is
an RGB uint8 window [B, F, H, W, 3] and whose fusion takes the batch's
device-tracking poses as well.

- :meth:`RegressionPredictor.transfer_batch` runs on worker threads. It pads
  the final partial batch, buckets the unique-ref rows, packs every array
  into ONE pinned uint8 buffer and copies it to the device on a side stream
  of its own thread, recording an event there. Pinning is what makes the
  copy asynchronous (``non_blocking`` from pageable memory is synchronous).
- :meth:`RegressionPredictor.dispatch_device` runs on the calling thread. Its
  compute stream (the thread's current stream) waits on that event before
  the forward, so the forward never reads a half-copied buffer, and the
  buffer is recorded on the compute stream so the allocator does not reuse
  it early. The result is copied to pinned host memory behind the forward;
  ``finalize()`` waits for that one device-to-host copy.

On the CPU (``device="cpu"``, as the tests run) the same code runs without
streams or pinning.

Several cards (port of the JAX predictor's sharded forward): with the bare
``device="cuda"`` on a machine with more than one card, or with
``devices=[...]``, the predictor holds one replica of the net per device of
the mesh (``parallel/mesh.py``), rounds ``INFER_BATCH`` up to a multiple of
the device count, ships each device the contiguous block of rows the data
axis gives it (the unique reference frames to every device) in a packed
buffer of its own, runs the replicas one after another from the calling
thread (each on its device's stream, so they overlap on the cards) and
gathers the poses in order. With one device the mesh is dropped: one
replica, one block of the whole batch, the single-device path above.
"""

from __future__ import annotations

import contextlib
import copy
import threading

import numpy as np
import torch

from mapfree_tpu_torch.geom.smallblas import tf32_off
from mapfree_tpu_torch.models.blocks import init_weights
from mapfree_tpu_torch.models.regression import REGRESSION_MODELS, build_regression_net
from mapfree_tpu_torch.parallel.mesh import (batch_sharding, local_mesh, make_mesh,
                                             pad_to_multiple, world_and_rank)
from mapfree_tpu_torch.tools.convert_weights import load_checkpoint
from mapfree_tpu_torch.utils.data import fetch_later
from mapfree_tpu_torch.utils.packing import pack_arrays, spec_of, unpack
from mapfree_tpu_torch.utils.timing import NULL_TIMES, active, stage


def resolve_device(device) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU; a CUDA
    request without a CUDA device raises instead of carrying on elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)")
    return device


def ship_packed(arrays, device, tls):
    """Pack ``arrays`` into one uint8 buffer and start its copy to
    ``device``: on the card from pinned memory on a side stream of the
    calling thread (kept in ``tls``, a ``threading.local``), with an event
    recorded there. Returns (device buffer, event or None, host buffer: it
    must outlive the asynchronous copy)."""
    if device.type != "cuda":
        return torch.from_numpy(pack_arrays(arrays)), None, None
    total = sum(int(a.nbytes) for a in arrays)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    pack_arrays(arrays, out=host.numpy())
    streams = getattr(tls, "streams", None)
    if streams is None:
        streams = tls.streams = {}
    stream = streams.get(device)
    if stream is None:
        stream = streams[device] = torch.cuda.Stream(device=device)
    with torch.cuda.stream(stream):
        dev = host.to(device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    return dev, ready, host


def receive_packed(dev, ready, spec):
    """The compute side of :func:`ship_packed`: the current stream waits for
    the copy and keeps the buffer alive until its work is done; returns the
    unpacked fields."""
    if ready is not None:
        compute = torch.cuda.current_stream(dev.device)
        compute.wait_event(ready)
        dev.record_stream(compute)
    return unpack(dev, spec)


def _predictor_mesh(cfg, device, devices):
    """The mesh the predictor splits a batch over, or None for one device:
    ``devices`` if given, else every visible card for the bare "cuda" (not
    inside a process group of several ranks, whose processes each drive
    their own card)."""
    if devices is None:
        device = torch.device(device)
        if (device.type != "cuda" or device.index is not None or world_and_rank()[0] > 1
                or not torch.cuda.is_available() or torch.cuda.device_count() < 2):
            return None
        mesh = make_mesh(cfg)
    else:
        mesh = local_mesh(cfg, [resolve_device(d) for d in devices])
    return mesh if mesh.size > 1 else None  # a 1-device mesh shards nothing


class RegressionPredictor:
    """Batched inference with one fixed batch size; smaller (final) batches
    are padded up to it. Over a mesh of several devices, one replica each
    (see the module's docstring)."""

    def __init__(self, cfg, checkpoint: str = "", device="cuda", devices=None):
        self.mesh = _predictor_mesh(cfg, device, devices)
        if self.mesh is None:
            self.device = resolve_device(devices[0] if devices else device)
        else:
            self.device = self.mesh.devices.flat[0]
        self.cfg = cfg
        net = build_regression_net(cfg)
        init_weights(net, torch.Generator().manual_seed(int(cfg.TPU.SEED)))
        if checkpoint:
            load_checkpoint(net, checkpoint)
        self.net = net.to(self.device).eval()
        # one replica per device; one device is a mesh of one
        self.devices = [self.device] if self.mesh is None else list(self.mesh.devices.flat)
        self.replicas = [self.net] + [copy.deepcopy(self.net).to(d) for d in self.devices[1:]]
        # float32 mode runs its forward with TF32 off, so float32 stays
        # float32. bfloat16 mode needs no setting: its convolutions run in
        # bf16 under autocast, and its float32 MLP and 3x3 Kabsch matmuls
        # keep PyTorch's default of matmul TF32 off.
        self._tf32_off = (self.device.type == "cuda"
                          and cfg.TPU.COMPUTE_DTYPE == "float32")
        self.batch_size = int(cfg.TPU.INFER_BATCH)
        if self.mesh is None:
            self.blocks = [(0, self.batch_size)]
        else:
            self.batch_size = pad_to_multiple(self.batch_size, self.mesh.size)
            self.blocks = batch_sharding(self.mesh).blocks(self.batch_size)
        self.needs_device_poses = getattr(net, "needs_device_poses", False)
        # deduped-reference path: encode U unique refs + B queries (the
        # two-view model only)
        self.u_max = (min(self.batch_size, int(cfg.TPU.UNIQUE_REFS))
                      if cfg.MODEL == "Regression" else 0)
        self._tls = threading.local()

    def _named_arrays(self, batch):
        """[(name, array)] in packing order, padded to the batch size, and
        the batch's real pair count."""
        if "image0_unique" in batch:
            u = np.asarray(batch["image0_unique"])
            ridx = np.asarray(batch["ref_idx"], np.int32)
            if self.u_max and u.shape[0] <= self.u_max:
                image1 = np.asarray(batch["image1"])
                B = image1.shape[0]
                if B < self.batch_size:
                    pad = self.batch_size - B
                    image1 = np.concatenate(
                        [image1, np.zeros((pad,) + image1.shape[1:], image1.dtype)])
                    ridx = np.concatenate([ridx, np.zeros(pad, np.int32)])
                # ref rows bucketed to the next power of two (1, 2, 4, ...):
                # a typical batch has ONE unique ref
                bucket = min(1 << max(0, (u.shape[0] - 1).bit_length()), self.u_max)
                if u.shape[0] < bucket:
                    u = np.concatenate(
                        [u, np.zeros((bucket - u.shape[0],) + u.shape[1:], u.dtype)])
                # ref_idx first: the int32 field sits at byte offset 0
                return [("ref_idx", ridx), ("image0u", u), ("image1", image1)], B
            # too many unique refs: materialise the per-pair ref stack
            batch = dict(batch)
            batch["image0"] = u[ridx]
        image0 = np.asarray(batch["image0"])
        image1 = np.asarray(batch["image1"])
        if image0.dtype != np.uint8:  # uint8 ships as-is (4x fewer bytes)
            image0 = image0.astype(np.float32, copy=False)
            image1 = image1.astype(np.float32, copy=False)
        named = [("image0", image0), ("image1", image1)]
        if self.needs_device_poses:  # float32 fields first: their offsets stay aligned
            named = [("q_device", np.asarray(batch["abs_q_1_w2c_device"], np.float32)),
                     ("t_device", np.asarray(batch["abs_c_1_c2w_device"], np.float32))] + named
        B = image0.shape[0]
        if B < self.batch_size:
            pad = self.batch_size - B
            for i, (name, a) in enumerate(named):
                filler = np.zeros((pad,) + a.shape[1:], a.dtype)
                if name == "q_device":
                    # unit quaternions: a zero one divides by zero in quat2mat
                    # and puts NaN into the fusion's eigh
                    filler[..., 0] = 1.0
                named[i] = (name, np.concatenate([a, filler]))
        return named, B

    def transfer_batch(self, batch, times=None):
        """Host -> device stage (safe on a worker thread): each device's
        contiguous block of the padded batch (the unique reference frames
        whole), packed and shipped to it. Returns what
        :meth:`dispatch_device` consumes."""
        times = times or NULL_TIMES
        named, B = self._named_arrays(batch)
        shipped = []
        with stage(times, "h2d"):
            for dev, (start, stop) in zip(self.devices, self.blocks):
                part = [(name, a if name == "image0u" else a[start:stop]) for name, a in named]
                shipped.append((*ship_packed([a for _, a in part], dev, self._tls),
                                spec_of(part)))
        return shipped, B

    def _forward(self, net, parts):
        """The packed [bs, 4, 3] (R | t) of one replica's forward."""
        with torch.inference_mode(), \
                (tf32_off() if self._tf32_off else contextlib.nullcontext()):
            if "ref_idx" in parts:
                R, t, _ = net(parts["image0u"], parts["image1"], ref_idx=parts["ref_idx"])
            elif "q_device" in parts:
                R, t, _ = net(parts["image0"], parts["image1"],
                              q_device=parts["q_device"], t_device=parts["t_device"])
            else:
                R, t, _ = net(parts["image0"], parts["image1"])
            return torch.cat([R, t.reshape(-1, 1, 3)], dim=1)

    def dispatch_device(self, transferred, times=None):
        """Compute stage: each replica's forward on its device-resident
        block, launched on its device in turn; returns finalize() -> (R, t,
        inliers) numpy, the poses gathered in block order."""
        times = times or NULL_TIMES
        shipped, B = transferred
        fetched = []
        with stage(times, "dispatch"):
            for net, dev, (buf, ready, _host, spec) in zip(self.replicas, self.devices, shipped):
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    parts = receive_packed(buf, ready, spec)
                    with active(times):  # the network's spans are stages of ``times``
                        fetched.append(fetch_later(self._forward(net, parts)))

        def finalize():
            with stage(times, "d2h_wait"):
                for _, done in fetched:
                    if done is not None:
                        done.synchronize()
                host = np.concatenate([h.numpy() for h, _ in fetched])[:B]
            return host[:, :3], host[:, 3:].reshape(B, 1, 3), np.zeros((B,), np.float32)

        return finalize

    def predict_batch(self, batch):
        return self.dispatch_device(self.transfer_batch(batch))()


class MatchingPredictor:
    """The feature-matching track behind the same transfer/dispatch split as
    :class:`RegressionPredictor`, so the sweep overlaps the correspondence
    fetch and copy of batch i+1 with the solve of batch i
    (models/matching.py). ``sampler_for_step`` is
    :class:`~mapfree_tpu_torch.models.matching.FeatureMatchingModel`'s."""

    def __init__(self, cfg, device="cuda", sampler_for_step=None):
        from mapfree_tpu_torch.models.matching import FeatureMatchingModel

        self.device = resolve_device(device)
        self.model = FeatureMatchingModel(cfg, self.device, sampler_for_step)

    def transfer_batch(self, batch, times=None):
        return self.model.transfer_batch(batch, times)

    def dispatch_device(self, transferred, times=None):
        return self.model.dispatch_device(transferred, times)

    def predict_batch(self, batch):
        return self.model(batch)


def build_model(cfg, checkpoint: str = "", device="cuda", devices=None):
    """The predictor of ``cfg``'s model on ``device``; a regression model
    over ``devices`` (or every card for the bare "cuda") when there are
    several (:class:`RegressionPredictor`)."""
    if cfg.MODEL in REGRESSION_MODELS:
        return RegressionPredictor(cfg, checkpoint, device=device, devices=devices)
    if cfg.MODEL == "FeatureMatching":
        return MatchingPredictor(cfg, device=device)
    raise NotImplementedError(f"Invalid model {cfg.MODEL}")
