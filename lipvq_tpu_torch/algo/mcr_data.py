"""Ego4D-style video buffer for MCR representation pretraining (counterpart
of ``lipvq_tpu/algo/mcr_data.py``; reference
algo/mcr/utils/data_loaders.py:44-119).

``MCRBuffer`` samples the 5-frame TCN tuple ``(start, end, s0, s1, s2)``
(``s0 < s1 < s2`` interior indices) of a random clip with its language
label, and crops the five frames alike ("rctraj"). It reads two layouts:

- a directory of ``manifest.csv`` (columns ``path``, ``len``, ``txt``) and
  per-frame ``<path>/<t:06d>.npy`` uint8 [H, W, 3] files, t = 1..len. This
  is the layout the card's machine reads: it has no h5py;
- an HDF5 file of clips (``videos/<vid>`` [T, H, W, 3] uint8, attribute
  ``txt``); h5py is imported only where such a file is opened or written.

Every random draw is the JAX package's numpy call, in its order, so the same
seed gives the same tuples and the same crops, bit for bit. Both packages
keep a caption's leading ``"C "`` in the HDF5 layout and strip it in the
manifest layout (ROADMAP queue 3), so one corpus in the two layouts gives
different language embeddings.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def random_resized_crop(rng, frames: np.ndarray, out_hw=(112, 112),
                        scale=(0.2, 1.0)) -> np.ndarray:
    """One crop for the whole clip (reference 'rctraj', :88-96), resized by
    nearest-index sampling: [N, H, W, 3] uint8 -> [N, out_h, out_w, 3]
    float32 / 255."""
    n, h, w, _ = frames.shape
    area = h * w * rng.uniform(*scale)
    ar = rng.uniform(3 / 4, 4 / 3)
    ch = int(round(np.sqrt(area / ar)))
    cw = int(round(np.sqrt(area * ar)))
    ch, cw = min(ch, h), min(cw, w)
    y0 = rng.integers(0, h - ch + 1)
    x0 = rng.integers(0, w - cw + 1)
    crop = frames[:, y0:y0 + ch, x0:x0 + cw]
    ys = np.linspace(0, ch - 1, out_hw[0]).astype(int)
    xs = np.linspace(0, cw - 1, out_hw[1]).astype(int)
    out = crop[:, ys][:, :, xs]
    return out.astype(np.float32) / 255.0


def _open_hdf5(path: str):
    import h5py  # only where h5py is installed; never at import

    return h5py.File(path, "r")


class MCRBuffer:
    """Iterable 5-frame TCN sampler (reference MCRBuffer._sample:71-118).
    ``split`` is dropped, as in the JAX package: a train and a validation
    buffer on one ``datapath`` read the same clips (ROADMAP queue 3)."""

    def __init__(self, datapath: str, split: str = "train", alpha: float = 0.2,
                 doaug: str = "rctraj", out_hw=(112, 112), seed: int = 0):
        self.datapath = datapath
        self.alpha = alpha
        self.doaug = doaug
        self.out_hw = out_hw
        self.rng = np.random.default_rng(seed)
        self._h5 = None
        self._vids: list = []
        self._manifest: list = []
        if os.path.isdir(datapath):
            with open(os.path.join(datapath, "manifest.csv")) as f:
                self._manifest = list(csv.DictReader(f))
        else:
            self._h5 = _open_hdf5(datapath)
            self._vids = sorted(self._h5["videos"].keys())
        del split

    def __len__(self):
        return len(self._manifest) or len(self._vids)

    def _clip(self, idx):
        if self._h5 is not None:
            v = self._h5["videos"][self._vids[idx]]
            return np.asarray(v), str(v.attrs.get("txt", ""))
        m = self._manifest[idx]
        frames = []
        t = 1
        while True:
            p = os.path.join(self.datapath, m["path"], f"{t:06d}.npy")
            if not os.path.exists(p) or t > int(m["len"]):
                break
            frames.append(np.load(p, allow_pickle=False))
            t += 1
        txt = m["txt"]
        return np.stack(frames), (txt[2:] if txt.startswith("C ") else txt)

    def sample(self):
        """-> (frames [5, H, W, 3] float32, label str); frames are start,
        end, s0, s1, s2 (reference :82-86)."""
        idx = int(self.rng.integers(len(self)))
        clip, label = self._clip(idx)
        vidlen = len(clip)
        start = int(self.rng.integers(0, max(1, int(self.alpha * vidlen))))
        end = int(self.rng.integers(
            min(vidlen - 1, int((1 - self.alpha) * vidlen)), vidlen))
        s1 = int(self.rng.integers(1, vidlen - 1))
        s0 = int(self.rng.integers(0, s1))
        s2 = int(self.rng.integers(s1 + 1, vidlen + 0) if s1 + 1 < vidlen
                 else vidlen - 1)
        frames = clip[[start, end, s0, s1, s2]]
        if self.doaug in ("rc", "rctraj"):
            frames = random_resized_crop(self.rng, frames, self.out_hw)
        else:
            frames = frames.astype(np.float32) / 255.0
        return frames, label

    def sample_batch(self, batch_size: int):
        """-> (frames [B, 5, H, W, 3], labels list[str])."""
        fr, lb = zip(*(self.sample() for _ in range(batch_size)))
        return np.stack(fr), list(lb)

    def close(self):
        if self._h5 is not None:
            self._h5.close()


def _write_hdf5_clips(path: str, clips) -> None:
    import h5py  # only where h5py is installed; never at import

    with h5py.File(path, "w") as f:
        g = f.create_group("videos")
        for i, (frames, txt) in enumerate(clips):
            d = g.create_dataset(f"vid_{i}", data=frames)
            d.attrs["txt"] = txt


def _write_manifest_clips(root: str, clips) -> None:
    rows = []
    for i, (frames, txt) in enumerate(clips):
        clip_dir = os.path.join(root, f"vid_{i}")
        os.makedirs(clip_dir, exist_ok=True)
        for t, frame in enumerate(frames, start=1):
            np.save(os.path.join(clip_dir, f"{t:06d}.npy"), frame, allow_pickle=False)
        rows.append({"path": f"vid_{i}", "len": len(frames), "txt": txt})
    with open(os.path.join(root, "manifest.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["path", "len", "txt"])
        writer.writeheader()
        writer.writerows(rows)


def build_synthetic_corpus(path: str, n_videos: int = 8, length: int = 24,
                           hw=(64, 64), seed: int = 0) -> str:
    """Emit a tiny ego4d-shaped corpus (moving-square clips + captions) so
    the pretraining pipeline runs hermetically: the JAX package's HDF5 file,
    or, where ``path`` is a directory, the same clips (the same draws) in
    the manifest layout."""
    rng = np.random.default_rng(seed)
    clips = []
    for i in range(n_videos):
        frames = np.zeros((length,) + tuple(hw) + (3,), np.uint8)
        x, y = rng.integers(5, hw[1] - 15), rng.integers(5, hw[0] - 15)
        dx, dy = rng.integers(-2, 3), rng.integers(-2, 3)
        color = rng.integers(60, 255, 3)
        for t in range(length):
            xx = int(np.clip(x + dx * t, 0, hw[1] - 10))
            yy = int(np.clip(y + dy * t, 0, hw[0] - 10))
            frames[t, yy:yy + 10, xx:xx + 10] = color
        clips.append((frames, f"C moves an object across the table {i}"))
    if os.path.isdir(path):
        _write_manifest_clips(path, clips)
    else:
        _write_hdf5_clips(path, clips)
    return path
