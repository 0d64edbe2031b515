"""Scene-balanced random sampler (port of mapfree_tpu/data/sampler.py, with
the same numpy draws: the same seed gives the same indices).

Capability equivalent of reference lib/datasets/sampler.py:6-86
(RandomConcatSampler): every epoch draws the same number of samples from each
sub-dataset of a concat dataset, so large scenes cannot dominate a training
epoch. Semantics preserved:

- per-scene quota ``n_samples_per_subset``, drawn with or without
  replacement (short scenes are topped up with replacement draws);
- a private generator seeded independently of the global seed (seed 66,
  reference sampler.py:29);
- ``reset_on_iter`` re-seeds every epoch so validation visits identical
  samples across epochs (reference sampler.py:50-51);
- optional whole-epoch ``repeat`` with independent shuffles.

Uses numpy's Generator rather than torch's, so the index stream is the JAX
package's, not the reference's. Not distribution-aware.
"""

from __future__ import annotations

import numpy as np


class RandomConcatSampler:
    def __init__(self, data_source, n_samples_per_subset: int,
                 subset_replacement: bool = True, shuffle: bool = True,
                 repeat: int = 1, seed: int = 66, reset_on_iter: bool = False):
        assert repeat >= 1
        self.data_source = data_source
        self.n_samples_per_subset = n_samples_per_subset
        self.subset_replacement = subset_replacement
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed
        self.reset_on_iter = reset_on_iter
        self.generator = np.random.default_rng(seed)

    @property
    def _subset_ranges(self):
        """[lo, hi) global-index range of each sub-dataset."""
        hi = list(self.data_source.cumulative_sizes)
        lo = [0] + hi[:-1]
        return list(zip(lo, hi))

    def __len__(self):
        return len(self._subset_ranges) * self.n_samples_per_subset * self.repeat

    def _draw_subset(self, rng, lo: int, hi: int) -> np.ndarray:
        """One scene's quota of global indices."""
        quota = self.n_samples_per_subset
        if self.subset_replacement:
            return rng.integers(lo, hi, size=quota)
        size = hi - lo
        draw = lo + rng.permutation(size)[:quota]
        if size < quota:  # short scene: top up with replacement
            draw = np.concatenate(
                [draw, rng.integers(lo, hi, size=quota - size)]
            )
        return draw

    def __iter__(self):
        if self.reset_on_iter:
            self.generator = np.random.default_rng(self.seed)
        rng = self.generator

        epoch = np.concatenate(
            [self._draw_subset(rng, lo, hi) for lo, hi in self._subset_ranges]
        )
        if self.shuffle:
            rng.shuffle(epoch)

        rounds = [epoch]
        for _ in range(self.repeat - 1):
            again = epoch.copy()
            if self.shuffle:
                rng.shuffle(again)
            rounds.append(again)
        out = np.concatenate(rounds)
        assert out.shape[0] == len(self)
        return iter(out.tolist())
