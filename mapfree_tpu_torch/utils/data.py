"""Host batch -> device helpers (port of mapfree_tpu/utils/data.py; API
parity with reference lib/utils/data.py:4-17)."""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_NUMERIC = (np.ndarray, np.generic, int, float)


def prefetch_to_device(batches, transfer, lookahead: int = 2, pool_workers: int = 2):
    """Overlap host->device transfer of upcoming batches with the consumer's
    current step.

    ``transfer(batch)`` runs on a worker thread and must FENCE its device
    tensors before returning (:func:`data_to_device` on a side stream does),
    so that the consumer never reads a half-copied buffer. Up to
    ``lookahead`` + 1 transfers are in flight on ``pool_workers`` threads.
    Yields transferred batches in order.
    """
    q: deque = deque()
    it = iter(batches)
    exhausted = False
    with ThreadPoolExecutor(max_workers=pool_workers) as ex:
        while q or not exhausted:
            while not exhausted and len(q) <= lookahead:
                b = next(it, None)
                if b is None:
                    exhausted = True
                else:
                    q.append(ex.submit(transfer, b))
            if q:
                yield q.popleft().result()


def data_to_device(batch: dict, device="cuda", stream=None, mesh=None):
    """Move numeric batch entries to ``device``; metadata (strings, lists of
    names) stays on the host.

    On a CUDA device numpy arrays go through pinned memory (which is what
    makes the copy asynchronous). With a ``stream`` the copies are made on
    it and waited for before returning, so the caller may be a worker thread
    and the consumer another stream; the consumer should then call
    ``record_stream`` on what it uses (:func:`record_on_current_stream`).

    With a ``mesh`` (``parallel/mesh.py``) the numeric entries are sharded
    over its data axis instead: the result is a list with one dict per
    device this process drives, each holding that device's block of rows
    on it (``device`` is not read).
    """
    if mesh is not None:
        from mapfree_tpu_torch.parallel.mesh import batch_sharding

        sharding = batch_sharding(mesh)
        numeric = [k for k, v in batch.items() if isinstance(v, (torch.Tensor,) + _NUMERIC)]
        n = len(batch[numeric[0]]) if numeric else 0
        return [data_to_device({k: (v[start:stop] if k in numeric else v)
                                for k, v in batch.items()}, dev, stream=stream)
                for dev, start, stop in sharding.local_blocks(n)]
    device = torch.device(device)
    cuda = device.type == "cuda"

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device, non_blocking=True)
        t = torch.as_tensor(np.asarray(v))
        if cuda:
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def move_all():
        return {k: move(v) if isinstance(v, (torch.Tensor,) + _NUMERIC) else v
                for k, v in batch.items()}

    if not cuda or stream is None:
        return move_all()
    with torch.cuda.stream(stream):
        out = move_all()
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def record_on_current_stream(batch: dict) -> dict:
    """Tell the allocator that the current stream uses tensors that were
    allocated on a side stream, so their memory is not handed out again
    before this stream is done with them."""
    for v in batch.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(torch.cuda.current_stream(v.device))
    return batch


def fetch_later(t):
    """Start copying ``t`` to pinned host memory behind the current
    stream's work: (host tensor, event to wait on, or None on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done
