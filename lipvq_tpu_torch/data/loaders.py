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
- ``DevicePrefetchLoader``: copies the next batches to the device on a side
  CUDA stream from pinned host memory while the caller trains.
- ``DeviceCachedLoader`` (``train.hdf5_cache_mode="device"``): the whole
  preprocessed corpus on the device, each batch one gather there.
"""

from __future__ import annotations

import collections
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


class DevicePrefetchLoader:
    """Keep ``size`` batches of ``loader`` ahead on ``device`` (the flax
    ``prefetch_to_device`` pattern of the JAX package): each batch, after the
    host-side ``transform``, is copied into pinned host memory and from there
    with ``non_blocking`` copies on a side CUDA stream, whose recorded event
    the consumer's stream waits on before the batch is handed out, so the
    copy overlaps the previous steps. On a CPU device the batches are plain
    tensors. Each batch equals the inner loader's, as tensors on the device.
    Compose outside ``PrefetchLoader``: host assembly overlaps in its thread."""

    def __init__(self, loader, device, size: int = 2, transform=None):
        self.loader = loader
        self.device = torch.device(device)
        self.size = max(1, int(size))
        self.transform = transform

    def __len__(self):
        return len(self.loader)

    def _put(self, batch, stream):
        if stream is None:
            return _map(batch, lambda a: torch.as_tensor(a, device=self.device)), None
        host = _map(batch, lambda a: torch.as_tensor(a).pin_memory())
        with torch.cuda.stream(stream):
            out = _map(host, lambda t: t.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _ready(self, item):
        out, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for _, t in _flatten(out)[0]:
                # made on the side stream, used on the consumer's: the
                # allocator must not reuse them before the consumer is done
                t.record_stream(consumer)
        return out

    def __iter__(self):
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        q: collections.deque = collections.deque()
        for batch in self.loader:
            if self.transform is not None:
                batch = self.transform(batch)
            q.append(self._put(batch, stream))
            if len(q) > self.size:
                yield self._ready(q.popleft())
        while q:
            yield self._ready(q.popleft())


def _flatten(tree, path=()):
    """(leaves [(path, array)], skeleton): the skeleton is ``tree`` with each
    array leaf replaced by its index into the leaves; None stays None."""
    if isinstance(tree, dict):
        leaves, skeleton = [], OrderedDict()
        for k, v in tree.items():
            sub, skeleton[k] = _flatten(v, path + (k,))
            leaves += sub
        return leaves, skeleton
    if tree is None:
        return [], None
    return [(path, tree)], path


def _unflatten(skeleton, values: dict):
    if isinstance(skeleton, dict):
        return OrderedDict((k, _unflatten(v, values)) for k, v in skeleton.items())
    return None if skeleton is None else values[skeleton]


class DeviceCachedLoader:
    """The device-resident corpus (``train.hdf5_cache_mode="device"``;
    counterpart of the JAX package's loader of that name).

    Every windowed item is materialized once, in chunks of ``chunk`` items,
    and run through the model's ``process_batch_for_training`` once; each
    leaf of the result is stored de-duplicated, its distinct rows (by their
    bytes) in a table and a per-item index map, both on the model's device.
    A batch is ``table[map[idx]]`` per leaf, gathered there; the host only
    draws the indices: ``numpy.random.default_rng(seed).choice(n,
    batch_size, replace=True, p=sampler.weights)``, the JAX package's draw,
    so one seed gives the same batches in both packages (a MetaDataset's
    weights carry over). Item-constant leaves such as a per-demo
    ``lang_emb`` shrink to a few rows. Batches come out preprocessed
    (``preprocessed = True``): ``run_epoch`` does not process them again."""

    preprocessed = True

    def __init__(self, dataset, batch_size: int, model, seed: int = 0,
                 sampler=None, max_bytes: float = 4e9, chunk: int = 4096):
        self.batch_size = int(batch_size)
        self.device = model.device
        self._rng = np.random.default_rng(seed)
        p = getattr(sampler, "weights", None)
        self._p = None if p is None else np.asarray(p, np.float64)
        n = len(dataset)
        skeleton = None
        uniq = tabs = maps = None
        for s in range(0, n, chunk):
            items = [dataset[i] for i in range(s, min(n, s + chunk))]
            leaves, skeleton = _flatten(model.process_batch_for_training(stack_collate(items)))
            if uniq is None:
                uniq = [{} for _ in leaves]
                tabs = [[] for _ in leaves]
                maps = [[] for _ in leaves]
            for li, (_, leaf) in enumerate(leaves):
                arr = np.ascontiguousarray(np.asarray(leaf))
                ids = np.empty(len(arr), np.int64)
                seen, tab = uniq[li], tabs[li]
                for r in range(len(arr)):
                    key = arr[r].tobytes()
                    j = seen.get(key)
                    if j is None:
                        j = len(tab)
                        seen[key] = j
                        tab.append(arr[r])
                    ids[r] = j
                maps[li].append(ids)
        del uniq
        tables = [np.stack(tab) for tab in tabs]
        nbytes = sum(t.nbytes for t in tables)
        if nbytes > max_bytes:
            raise ValueError(
                f"device corpus cache would be {nbytes / 1e9:.2f} GB "
                f"(> {max_bytes / 1e9:.1f} GB); use hdf5_cache_mode="
                f"'low_dim' for this dataset (image-scale corpora do "
                f"not fit HBM)")
        self._paths = [path for path, _ in leaves]
        self._tables = [torch.as_tensor(t, device=self.device) for t in tables]
        self._maps = [torch.as_tensor(np.concatenate(m), device=self.device) for m in maps]
        self._skeleton = skeleton
        self._n = n

    def gather(self, idx):
        """The batch of items ``idx``, gathered on the device."""
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return _unflatten(self._skeleton, {
            path: t[m[i]] for path, t, m in zip(self._paths, self._tables, self._maps)})

    def __len__(self):
        return max(1, self._n // self.batch_size)

    def __iter__(self):
        for _ in range(len(self)):
            yield self.gather(self._rng.choice(self._n, size=self.batch_size, replace=True,
                                               p=self._p))


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
