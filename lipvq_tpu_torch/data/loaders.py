"""Host-side batch loading (copy of ``DataLoader`` and ``CyclingIterator``
from ``lipvq_tpu/data/loaders.py``).

A numpy sampler + collate over any indexable dataset of nested sample dicts;
the train loop cycles it indefinitely the way ``run_epoch`` does on
StopIteration (reference train_utils.py:1286-1293). The algo moves each
batch to its device.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.utils.tensor_utils import stack_collate


class DataLoader:
    """Shuffling mini-batch iterator over a dataset.

    ``sampler`` (an iterable of indices) overrides the shuffle order."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, sampler=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sampler = sampler
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self.sampler is not None:
            order = np.fromiter(iter(self.sampler), dtype=np.int64)
        elif self.shuffle:
            order = self._rng.permutation(len(self.dataset))
        else:
            order = np.arange(len(self.dataset))
        n = len(order)
        for i in range(0, n - (self.batch_size - 1 if self.drop_last else 0),
                       self.batch_size):
            idx = order[i : i + self.batch_size]
            if len(idx) == 0:
                break
            yield stack_collate([self.dataset[int(j)] for j in idx])


class CyclingIterator:
    """Infinite iterator that restarts the loader on exhaustion
    (reference run_epoch's StopIteration handling)."""

    def __init__(self, loader):
        self.loader = loader
        self._it = iter(loader)

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)

    def __iter__(self):
        return self
