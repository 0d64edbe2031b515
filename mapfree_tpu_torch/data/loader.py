"""Batched data loading with prefetch (port of mapfree_tpu/data/loader.py).

The replacement for torch's DataLoader (reference
lib/datasets/datamodules.py:35-70): a thread pool loads samples, a collator
stacks them into fixed-shape NHWC numpy batches, and a small prefetch queue
overlaps loading with device compute. Numeric fields are stacked;
string/metadata fields are collected into lists (same contract the reference
gets from torch's default collate). The batches are numpy arrays on the host
whatever decoded them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_NUMERIC_KEYS = {
    "image0", "image1", "T_0to1",
    "abs_q_0", "abs_c_0", "abs_q_1", "abs_c_1",
    "K_color0", "K_color1", "sim", "pair_id",
    "abs_q_1_w2c_device", "abs_q_1_c2w_device", "abs_c_1_c2w_device",
    "abs_q_1_c2w_multi", "abs_c_1_c2w_multi",
    # depth0/depth1 deliberately NOT here, as in the JAX package: the
    # matching track only samples depth AT correspondences, so its consumers
    # take the uncollated per-sample list instead of a stack of whole maps
}


def collate(samples: list) -> dict:
    """Stack numeric fields to [B, ...] arrays; gather metadata into lists."""
    batch = {}
    for key in samples[0].keys():
        vals = [s[key] for s in samples]
        if key in _NUMERIC_KEYS:
            batch[key] = np.stack([np.asarray(v) for v in vals])
        else:
            batch[key] = list(vals)
    return batch


class DataLoader:
    """Iterates fixed-size batches over a dataset given an index sampler."""

    def __init__(self, dataset, batch_size: int, sampler=None, shuffle: bool = False,
                 num_workers: int = 1, drop_last: bool = False, prefetch: int = 2,
                 seed: int = 0, times=None, unique_refs: bool = False, rows=None):
        from mapfree_tpu_torch.utils.timing import NULL_TIMES

        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        self.times = times or NULL_TIMES
        # emit image0_unique/ref_idx batches (dataset.getbatch) for consumers
        # that gather the deduped reference frames on-device
        self.unique_refs = unique_refs
        # (start, stop): decode only these rows of each batch, as one rank of
        # a data-parallel run does (the sampler's order is every rank's); a
        # batch with none of them yields its metadata and numeric entries of
        # zero rows, which the consumer pads
        self.rows = rows

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = self._rng.permutation(idx)
        return idx.tolist()

    def __len__(self):
        # the sampler's own length: the JAX loader draws a whole epoch from
        # the sampler to count it, which advances the sampler's generator
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = self._indices()
        batches = [
            indices[i: i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        # batch-level JPEG decode on the card when the dataset speaks the
        # protocol and decodes on a CUDA device (the JAX package's loader
        # takes it when its C++ decoder is built); else the per-item thread
        # pool, as the JAX package takes it where that decoder is not built
        device = getattr(self.dataset, "device", None)
        on_the_card = device is not None and device.type == "cuda"
        getitems = getattr(self.dataset, "getitems", None)
        use_batch_io = on_the_card and getitems is not None
        getbatch = getattr(self.dataset, "getbatch", None)
        use_getbatch = self.unique_refs and on_the_card and getbatch is not None

        from mapfree_tpu_torch.utils.timing import stage

        times = self.times

        def produce():
            try:
                fill()
            except BaseException as exc:  # noqa: BLE001  (raised by the consumer)
                q.put(exc)
                return
            q.put(sentinel)

        def fill():
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                for b in batches:
                    none_here = False
                    if self.rows is not None:
                        mine = b[self.rows[0]:self.rows[1]]
                        none_here = not mine
                        b = mine or b[:1]  # one row for the entries' shapes
                    item = None
                    if use_getbatch:
                        with stage(times, "decode"):
                            item = getbatch(b)
                    if item is None:
                        with stage(times, "decode"):
                            if use_batch_io:
                                samples = getitems(b)
                            else:
                                samples = list(
                                    ex.map(self.dataset.__getitem__, b))
                        with stage(times, "collate"):
                            item = collate(samples)
                    if none_here:
                        item = {k: v[:0] for k, v in item.items()}
                    with stage(times, "queue_put"):  # backpressure wait
                        q.put(item)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                # a load that raised on the producer thread (a decoder that
                # does not build, a file that cannot be read) raises here
                raise item
            yield item
