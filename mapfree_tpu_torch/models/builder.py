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
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from mapfree_tpu_torch.models.blocks import init_weights
from mapfree_tpu_torch.models.regression import REGRESSION_MODELS, build_regression_net
from mapfree_tpu_torch.tools.convert_weights import load_checkpoint
from mapfree_tpu_torch.utils.packing import pack_arrays, spec_of, unpack
from mapfree_tpu_torch.utils.timing import NULL_TIMES


def resolve_device(device) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU; a CUDA
    request without a CUDA device raises instead of carrying on elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)")
    return device


@contextlib.contextmanager
def tf32_off():
    """TF32 off for float32 matmuls and cuDNN convolutions (cuDNN defaults to
    on) inside the block; the process's settings are restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class RegressionPredictor:
    """Batched inference with one fixed batch size; smaller (final) batches
    are padded up to it."""

    def __init__(self, cfg, checkpoint: str = "", device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        net = build_regression_net(cfg)
        init_weights(net, torch.Generator().manual_seed(int(cfg.TPU.SEED)))
        if checkpoint:
            load_checkpoint(net, checkpoint)
        self.net = net.to(self.device).eval()
        # float32 mode runs its forward with TF32 off, so float32 stays
        # float32. bfloat16 mode needs no setting: its convolutions run in
        # bf16 under autocast, and its float32 MLP and 3x3 Kabsch matmuls
        # keep PyTorch's default of matmul TF32 off.
        self._tf32_off = (self.device.type == "cuda"
                          and cfg.TPU.COMPUTE_DTYPE == "float32")
        self.batch_size = int(cfg.TPU.INFER_BATCH)
        self.needs_device_poses = getattr(net, "needs_device_poses", False)
        # deduped-reference path: encode U unique refs + B queries (the
        # two-view model only)
        self.u_max = (min(self.batch_size, int(cfg.TPU.UNIQUE_REFS))
                      if cfg.MODEL == "Regression" else 0)
        self._tls = threading.local()

    def _copy_stream(self):
        stream = getattr(self._tls, "stream", None)
        if stream is None:
            stream = self._tls.stream = torch.cuda.Stream(device=self.device)
        return stream

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
        """Host -> device stage (safe on a worker thread). Returns what
        :meth:`dispatch_device` consumes."""
        times = times or NULL_TIMES
        named, B = self._named_arrays(batch)
        spec = spec_of(named)
        arrays = [a for _, a in named]
        with times.stage("h2d"):
            if self.device.type != "cuda":
                return torch.from_numpy(pack_arrays(arrays)), None, None, B, spec
            total = sum(int(a.nbytes) for a in arrays)
            host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            pack_arrays(arrays, out=host.numpy())
            stream = self._copy_stream()
            with torch.cuda.stream(stream):
                dev = host.to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
        # ``host`` rides along so the pinned source outlives the async copy
        return dev, ready, host, B, spec

    def dispatch_device(self, transferred, times=None):
        """Compute stage: the forward on the device-resident buffer; returns
        finalize() -> (R, t, inliers) numpy."""
        times = times or NULL_TIMES
        dev, ready, _host, B, spec = transferred
        with times.stage("dispatch"):
            cuda = self.device.type == "cuda"
            if cuda:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ready)
                dev.record_stream(compute)
            parts = unpack(dev, spec)
            with torch.inference_mode(), \
                    (tf32_off() if self._tf32_off else contextlib.nullcontext()):
                if "ref_idx" in parts:
                    R, t, _ = self.net(parts["image0u"], parts["image1"],
                                       ref_idx=parts["ref_idx"])
                elif "q_device" in parts:
                    R, t, _ = self.net(parts["image0"], parts["image1"],
                                       q_device=parts["q_device"],
                                       t_device=parts["t_device"])
                else:
                    R, t, _ = self.net(parts["image0"], parts["image1"])
                out = torch.cat([R, t.reshape(-1, 1, 3)], dim=1)  # [bs, 4, 3]
                if cuda:
                    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    host_out.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(compute)
                else:
                    host_out, done = out, None

        def finalize():
            with times.stage("d2h_wait"):
                if done is not None:
                    done.synchronize()
                host = host_out.numpy()[:B]
            return host[:, :3], host[:, 3:].reshape(B, 1, 3), np.zeros((B,), np.float32)

        return finalize

    def predict_batch(self, batch):
        return self.dispatch_device(self.transfer_batch(batch))()


def build_model(cfg, checkpoint: str = "", device="cuda"):
    if cfg.MODEL in REGRESSION_MODELS:
        return RegressionPredictor(cfg, checkpoint, device=device)
    if cfg.MODEL == "FeatureMatching":
        raise NotImplementedError(
            f"model {cfg.MODEL} is not ported yet (a later slice of the port)")
    raise NotImplementedError(f"Invalid model {cfg.MODEL}")
