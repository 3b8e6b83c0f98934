"""Host-side batch loading (counterpart of ``lipvq_tpu/data/loaders.py``).

A numpy sampler + collate over any indexable dataset of nested sample dicts;
the train loop cycles it indefinitely the way ``run_epoch`` does on
StopIteration (reference train_utils.py:1286-1293). The algo moves each
batch to its device.

- ``DataLoader``: in-process, one batch at a time
- ``PrefetchLoader``: a thread assembles the next batches while the caller
  trains (``train.num_data_workers = 1``)
- ``MultiprocessLoader``: worker processes assemble batches from index
  batches and return them in completion order (``num_data_workers > 1``,
  the image protocol's 5). Workers read numpy only and never touch the
  card; the export reader keeps no file open between reads.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict

import numpy as np
import torch

from lipvq_tpu_torch.utils.tensor_utils import stack_collate

PREFETCH = 2  # batches assembled ahead (per worker process)


class _Batches:
    """The index batches of one epoch per iteration: a seeded permutation (or
    the sampler's order) cut into ``batch_size`` rows."""

    def __init__(self, n, batch_size, shuffle, seed, drop_last, sampler):
        self.n, self.batch_size, self.shuffle = n, batch_size, shuffle
        self.drop_last, self.sampler = drop_last, sampler
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else self.n
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self.sampler is not None:
            order = np.fromiter(iter(self.sampler), dtype=np.int64)
        elif self.shuffle:
            order = self._rng.permutation(self.n)
        else:
            order = np.arange(self.n)
        for b in range(len(self)):
            yield order[b * self.batch_size:(b + 1) * self.batch_size]


class DataLoader:
    """Shuffling mini-batch iterator over a dataset.

    ``sampler`` (an iterable of indices) overrides the shuffle order."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, sampler=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self._batches = _Batches(len(dataset), self.batch_size, shuffle, seed,
                                 drop_last, sampler)

    def __len__(self):
        return len(self._batches)

    def __iter__(self):
        for idx in self._batches:
            yield stack_collate([self.dataset[int(j)] for j in idx])


class PrefetchLoader:
    """Assemble up to ``PREFETCH`` batches of ``loader`` ahead in a thread
    (``__getitem__`` and collate overlap the caller's step where they leave
    the interpreter lock: file reads, numpy copies). A batch that raises in
    the thread raises in the caller; an abandoned iteration stops the
    thread."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def work():
            try:
                for item in self.loader:
                    if not put(item):
                        return
                put(done)
            except BaseException as e:  # handed to the caller, raised there
                put(e)

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)


def _map(batch: dict, fn) -> dict:
    """``batch`` with ``fn`` applied to each array (None kept)."""
    return OrderedDict((k, _map(v, fn) if isinstance(v, dict) else None if v is None
                        else fn(v)) for k, v in batch.items())


class _BatchReader(torch.utils.data.Dataset):
    """A worker's view of the dataset: item ``idx`` is the collated batch of
    those indices (torch makes its arrays tensors and hands them back
    through shared memory: a batch of camera frames is tens of MB)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, idx):
        try:
            return stack_collate([self.dataset[int(j)] for j in idx])
        except Exception as e:
            raise RuntimeError(f"data worker failed on indices "
                               f"{list(map(int, idx))}: {e!r}") from None


class MultiprocessLoader:
    """``num_workers`` worker processes (torch's ``DataLoader``, started once
    on first iteration with ``spawn`` and kept across epochs) collate batches
    from the index batches of a seeded permutation (or the sampler's order);
    batches return in completion order, so an epoch yields each index once
    but in another order than ``DataLoader``, as numpy arrays over the shared
    memory they arrived in. Workers inherit no thread, lock or CUDA state of
    the caller, so a program that starts them guards its entry point with
    ``if __name__ == "__main__"``. A new iteration abandons the previous
    one. ``close`` stops the workers."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, sampler=None,
                 num_workers: int = 4):
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.num_workers = max(1, int(num_workers))
        self._batches = _Batches(len(dataset), self.batch_size, shuffle, seed,
                                 drop_last, sampler)
        self._loader = torch.utils.data.DataLoader(
            _BatchReader(dataset), batch_size=None, sampler=self._batches,
            num_workers=self.num_workers,
            multiprocessing_context="spawn", persistent_workers=True,
            prefetch_factor=PREFETCH, in_order=False)

    def __len__(self):
        return len(self._batches)

    def close(self):
        """Stop the worker processes (daemons: they end with the caller at
        the latest)."""
        it, self._loader._iterator = self._loader._iterator, None
        if it is not None:
            it._shutdown_workers()

    def __iter__(self):
        for batch in self._loader:
            yield _map(batch, torch.Tensor.numpy)


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
