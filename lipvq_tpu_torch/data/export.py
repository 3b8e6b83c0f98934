"""The numpy export of a robomimic HDF5 dataset (no JAX counterpart).

The machine with the card has no ``h5py``, so the port reads demonstrations
from a directory that holds the HDF5 file's content as plain numpy files:

    <root>/meta.json              attributes, demo list, filter masks
    <root>/data/<demo>/<key>.npy  each dataset of a demo group, by its path
                                  inside the group (``actions.npy``,
                                  ``obs/object.npy``, ``next_obs/...``)

``meta.json`` holds ``data_attrs`` (the ``data`` group's attributes:
``env_args`` as the JSON string it is in the HDF5 file, ``total``), for each
demo in file order its attributes (``num_samples``, ``ep_meta`` as a JSON
string) and the shape of each array, and ``mask`` (each ``mask/<filter>``
demo list as strings). Arrays keep their HDF5 shape and dtype: 1-D
``actions`` or ``rewards`` stay 1-D.

``hdf5_to_export`` converts a file where ``h5py`` is installed (it imports
``h5py`` inside the function, never on import):

    python -m lipvq_tpu_torch.data.export in.hdf5 out_dir

``Export`` reads one. ``load`` copies a whole array into memory; ``read``
copies a row range and keeps no file open, so a reader over thousands of
demos holds no handle between reads. ``add_arrays`` adds arrays to the demos
of an existing export (corpus tokens, ``tokens/<key>``) and rewrites
``meta.json`` atomically; ``update_meta`` sets filter masks and attributes
(the dataset tools' splits, subsets and stamps) the same way.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

META = "meta.json"
FORMAT = "lipvq-numpy-export"
VERSION = 1


def _jsonable(x):
    """An HDF5 attribute value -> a JSON value (bytes become str)."""
    if isinstance(x, bytes):
        return x.decode("utf-8")
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()] if x.dtype.kind in "OSU" else x.tolist()
    if isinstance(x, np.generic):
        return _jsonable(x.item())
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


class ExportWriter:
    """Writes an export one demo at a time; ``finish`` writes ``meta.json``
    last, atomically, so a directory with a ``meta.json`` is complete."""

    def __init__(self, root: str):
        self.root = root
        self._demos: dict[str, dict] = {}
        os.makedirs(os.path.join(root, "data"), exist_ok=True)

    def add_demo(self, name: str, attrs: dict, arrays: dict[str, np.ndarray]) -> None:
        """``arrays`` maps a path inside the demo group (``"actions"``,
        ``"obs/object"``) to its array."""
        if name in self._demos:
            raise ValueError(f"demo {name!r} written twice")
        shapes = {}
        for key, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            path = os.path.join(self.root, "data", name, key + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, arr, allow_pickle=False)
            shapes[key] = list(arr.shape)
        self._demos[name] = {"attrs": {k: _jsonable(v) for k, v in attrs.items()},
                             "arrays": shapes}

    def finish(self, data_attrs: dict, masks: dict[str, list[str]]) -> str:
        _write_meta(self.root, {
            "format": FORMAT, "version": VERSION,
            "data_attrs": {k: _jsonable(v) for k, v in data_attrs.items()},
            "demos": self._demos,
            "mask": {k: [_jsonable(d) for d in v] for k, v in masks.items()}})
        return self.root


def _write_meta(root: str, meta: dict) -> None:
    """``meta.json`` through a temporary file and an atomic rename."""
    tmp = os.path.join(root, META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(root, META))


def add_arrays(root: str, arrays: dict[str, dict[str, np.ndarray]]) -> None:
    """Add arrays to demos of the export at ``root``, or replace them:
    ``arrays`` maps a demo to {path inside the demo group: array}. Each
    ``.npy`` goes through a temporary file and a rename, then ``meta.json``
    is rewritten once, atomically, as ``ExportWriter.finish`` writes it: a
    reader opened afterwards sees every new array."""
    with open(os.path.join(root, META)) as f:
        meta = json.load(f)
    for demo, items in arrays.items():
        if demo not in meta["demos"]:
            raise KeyError(f"{root}: no demo {demo!r}")
        for key, arr in items.items():
            arr = np.ascontiguousarray(arr)
            path = os.path.join(root, "data", demo, key + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path + ".tmp", "wb") as f:
                np.save(f, arr, allow_pickle=False)
            os.replace(path + ".tmp", path)
            meta["demos"][demo]["arrays"][key] = list(arr.shape)
    _write_meta(root, meta)


def update_meta(root: str, masks: dict[str, list[str]] | None = None,
                data_attrs: dict | None = None,
                demo_attrs: dict[str, dict] | None = None) -> None:
    """Set entries of the export's ``meta.json`` at ``root``: each filter
    mask of ``masks`` (a list of demo names), each attribute of
    ``data_attrs`` and, per demo, each attribute of ``demo_attrs`` is added
    or replaced; the others stay. ``meta.json`` is rewritten once,
    atomically."""
    with open(os.path.join(root, META)) as f:
        meta = json.load(f)
    for name, demos in (masks or {}).items():
        meta["mask"][name] = [_jsonable(d) for d in demos]
    meta["data_attrs"].update({k: _jsonable(v) for k, v in (data_attrs or {}).items()})
    for demo, attrs in (demo_attrs or {}).items():
        if demo not in meta["demos"]:
            raise KeyError(f"{root}: no demo {demo!r}")
        meta["demos"][demo]["attrs"].update({k: _jsonable(v) for k, v in attrs.items()})
    _write_meta(root, meta)


class Export:
    """Reader of an export directory."""

    def __init__(self, root: str):
        self.root = os.path.expanduser(root)
        meta_path = os.path.join(self.root, META)
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(
                f"{self.root} is not a dataset export (no {META}); convert an HDF5 "
                f"file with `python -m lipvq_tpu_torch.data.export in.hdf5 out_dir`")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT or meta.get("version") != VERSION:
            raise ValueError(f"{meta_path}: not a {FORMAT} v{VERSION} export")
        self.data_attrs: dict = meta["data_attrs"]
        self._demos: dict[str, dict] = meta["demos"]
        self._masks: dict[str, list[str]] = meta["mask"]
        self._layout: dict[tuple[str, str], tuple[int, tuple, np.dtype]] = {}

    @property
    def demos(self) -> list[str]:
        """Demo names in file order."""
        return list(self._demos)

    def demo_attrs(self, demo: str) -> dict:
        return self._demos[demo]["attrs"]

    def mask(self, name: str) -> list[str]:
        return list(self._masks[name])

    @property
    def masks(self) -> list[str]:
        """Filter mask names, in the order they were written."""
        return list(self._masks)

    def has(self, demo: str, key: str) -> bool:
        return key in self._demos[demo]["arrays"]

    def keys(self, demo: str, group: str) -> list[str]:
        """Names of the arrays directly under ``group`` (e.g. ``"obs"``)."""
        prefix = group + "/"
        return [k[len(prefix):] for k in self._demos[demo]["arrays"]
                if k.startswith(prefix) and "/" not in k[len(prefix):]]

    def shape(self, demo: str, key: str) -> tuple:
        return tuple(self._demos[demo]["arrays"][key])

    def path(self, demo: str, key: str) -> str:
        if not self.has(demo, key):
            raise KeyError(f"{self.root}: demo {demo!r} has no array {key!r}")
        return os.path.join(self.root, "data", demo, key + ".npy")

    def load(self, demo: str, key: str) -> np.ndarray:
        """The whole array, copied into memory."""
        return np.load(self.path(demo, key), allow_pickle=False)

    def _array_layout(self, demo: str, key: str):
        """(data offset, shape, dtype), read once from the .npy header."""
        layout = self._layout.get((demo, key))
        if layout is None:
            mm = np.load(self.path(demo, key), mmap_mode="r", allow_pickle=False)
            if not mm.flags.c_contiguous:
                raise ValueError(f"{self.path(demo, key)} is not in C order")
            layout = (mm.offset, mm.shape, mm.dtype)
            del mm
            self._layout[(demo, key)] = layout
        return layout

    def read(self, demo: str, key: str, begin: int, end: int) -> np.ndarray:
        """Rows [begin, end) as a new array; the file is closed on return."""
        offset, shape, dtype = self._array_layout(demo, key)
        begin, end = max(0, begin), min(shape[0], end)
        out = np.empty((max(0, end - begin),) + tuple(shape[1:]), dtype)
        row_bytes = out[:1].nbytes if len(out) else 0
        if out.nbytes:
            with open(self.path(demo, key), "rb", buffering=0) as f:
                f.seek(offset + begin * row_bytes)
                got = f.readinto(out.reshape(-1).view(np.uint8))
            if got != out.nbytes:
                raise OSError(f"{self.path(demo, key)}: read {got} of {out.nbytes} bytes")
        return out


class ExportArray:
    """One array of an export, read on demand: ``a[begin:end]`` reads those
    rows, ``np.asarray(a)`` the whole array (the role of an ``h5py.Dataset``
    in the JAX package's reads)."""

    def __init__(self, export: Export, demo: str, key: str):
        self.export, self.demo, self.key = export, demo, key
        self.shape = export.shape(demo, key)
        self.ndim = len(self.shape)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, index):
        if not isinstance(index, slice) or index.step not in (None, 1):
            raise TypeError("an export array takes a contiguous row slice")
        begin, end, _ = index.indices(self.shape[0])
        return self.export.read(self.demo, self.key, begin, end)

    def __array__(self, dtype=None, copy=None):
        a = self.export.load(self.demo, self.key)
        return a if dtype is None else a.astype(dtype, copy=False)


def hdf5_to_export(h5_path: str, out_dir: str) -> str:
    """Convert a robomimic HDF5 file into an export at ``out_dir``."""
    import h5py  # only where h5py is installed; never at import

    writer = ExportWriter(out_dir)
    with h5py.File(h5_path, "r") as f:
        data = f["data"]
        for demo in data.keys():
            group = data[demo]
            arrays = {}

            def visit(name, obj, arrays=arrays):
                if isinstance(obj, h5py.Dataset):
                    arrays[name] = obj[()]

            group.visititems(visit)
            writer.add_demo(demo, dict(group.attrs), arrays)
        masks = {}
        if "mask" in f:
            masks = {name: [_jsonable(e) for e in np.asarray(ds[()]).tolist()]
                     for name, ds in f["mask"].items()}
        return writer.finish(dict(data.attrs), masks)


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("hdf5", help="robomimic HDF5 dataset")
    parser.add_argument("out_dir", help="directory to write the export into")
    ns = parser.parse_args(args)
    print(hdf5_to_export(ns.hdf5, ns.out_dir))


if __name__ == "__main__":
    main()
