"""Sequence dataset over a numpy export of a robomimic HDF5 file (copy of
``lipvq_tpu/data/dataset.py``).

The same windowing, padding, filter keys, caching, normalization and
samplers as the JAX package; where it opens the HDF5 file, this reads the
export of ``data/export.py`` (``hdf5_path`` is the export's directory).
Everything here is numpy on the host; the algo moves each batch to its
device. ``R2D2Dataset`` is not ported yet (ROADMAP §1 item 7).
"""

from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np

from lipvq_tpu_torch.data.export import Export, ExportArray
from lipvq_tpu_torch.utils.obs_utils import LANG_EMB_KEY
from lipvq_tpu_torch.utils.tensor_utils import pad_sequence_single


def action_stats_to_normalization_stats(action_stats: dict, action_config) -> dict:
    """Per-key (scale, offset) from raw stats (reference dataset.py:1192-1251).

    Quirk A3 reproduced: the ``gaussian`` branch stores scale=mean,
    offset=std — swapped relative to the (x-offset)/scale formula.
    """
    out = OrderedDict()
    for key, stats in action_stats.items():
        cfg = action_config.get(key, {}) if action_config else {}
        method = cfg.get("normalization", None)
        if method is None:
            out[key] = {
                "scale": np.ones_like(stats["mean"], dtype=np.float32),
                "offset": np.zeros_like(stats["mean"], dtype=np.float32),
            }
        elif method == "min_max":
            range_eps = 1e-4
            input_min = stats["min"].astype(np.float32)
            input_max = stats["max"].astype(np.float32)
            output_min, output_max = -0.999999, 0.999999
            input_range = input_max - input_min
            ignore = input_range < range_eps
            input_range[ignore] = output_max - output_min
            scale = input_range / (output_max - output_min)
            offset = input_min - scale * output_min
            offset[ignore] = input_min[ignore] - (output_max + output_min) / 2
            out[key] = {"scale": scale, "offset": offset}
        elif method == "gaussian":
            input_mean = stats["mean"].astype(np.float32)
            input_std = np.sqrt(stats["sqdiff"] / stats["n"]).astype(np.float32)
            input_std[input_std < 1e-6] = 1.0
            # reference quirk: fields swapped (dataset.py:1239-1251)
            out[key] = {"scale": input_mean, "offset": input_std}
        else:
            raise NotImplementedError(f"normalization {method!r}")
    return out


def normalize_action_dict(ac_dict: dict, stats: dict) -> dict:
    return {
        k: (np.asarray(v, np.float32) - stats[k]["offset"]) / stats[k]["scale"]
        if k in stats else np.asarray(v, np.float32)
        for k, v in ac_dict.items()
    }


class SequenceDataset:
    """Windowed trajectory dataset over one export. ``hdf5_path`` is the
    export's directory; ``hdf5_use_swmr`` is kept for the signature."""

    def __init__(
        self,
        hdf5_path: str,
        obs_keys,
        dataset_keys=("actions",),
        action_keys=("actions",),
        action_config=None,
        frame_stack: int = 1,
        seq_length: int = 1,
        pad_frame_stack: bool = True,
        pad_seq_length: bool = True,
        get_pad_mask: bool = False,
        goal_mode: str | None = None,
        hdf5_cache_mode: str | None = "all",
        hdf5_use_swmr: bool = True,
        filter_by_attribute: str | None = None,
        load_next_obs: bool = False,
        lang_encoder=None,
        dataset_lang: str | None = None,
        demos: list[str] | None = None,
    ):
        self.hdf5_path = hdf5_path
        self.obs_keys = tuple(k for k in obs_keys if k != LANG_EMB_KEY)
        self.want_lang_emb = LANG_EMB_KEY in obs_keys
        self.dataset_keys = tuple(dataset_keys)
        self.action_keys = tuple(action_keys)
        self.action_config = action_config or {}
        self.n_frame_stack = int(frame_stack)
        assert self.n_frame_stack >= 1
        self.seq_length = int(seq_length)
        assert self.seq_length >= 1
        self.pad_frame_stack = pad_frame_stack
        self.pad_seq_length = pad_seq_length
        self.get_pad_mask = get_pad_mask
        self.goal_mode = goal_mode
        if self.goal_mode is not None:
            assert self.goal_mode == "last"
        self.hdf5_cache_mode = hdf5_cache_mode
        self.hdf5_use_swmr = hdf5_use_swmr
        self.load_next_obs = load_next_obs
        self.dataset_lang = dataset_lang
        self.export = Export(hdf5_path)
        self.action_normalization_stats = None

        self._load_demo_info(filter_by_attribute, demos, lang_encoder)
        self._build_cache()

    # -- demo info (reference dataset.py:193-276) --------------------------
    def _load_demo_info(self, filter_by_attribute, demos, lang_encoder):
        f = self.export
        if demos is not None:
            self.demos = list(demos)
        elif filter_by_attribute is not None:
            self.demos = f.mask(filter_by_attribute)
        else:
            self.demos = f.demos
        self.demos.sort(key=lambda e: int(e[5:]))
        self.n_demos = len(self.demos)

        self._index_to_demo_id = {}
        self._demo_id_to_start_indices = {}
        self._demo_id_to_demo_length = {}
        self._demo_id_to_demo_lang_str = {}
        self._demo_id_to_demo_lang_emb = {}

        self.total_num_sequences = 0
        for ep in self.demos:
            attrs = f.demo_attrs(ep)
            demo_length = int(attrs["num_samples"])
            self._demo_id_to_start_indices[ep] = self.total_num_sequences
            self._demo_id_to_demo_length[ep] = demo_length

            if self.dataset_lang is not None:
                self._demo_id_to_demo_lang_str[ep] = self.dataset_lang
            else:
                ep_meta = attrs.get("ep_meta", None)
                if ep_meta is not None:
                    lang = json.loads(ep_meta).get("lang", "dummy")
                    if lang is not None:
                        self._demo_id_to_demo_lang_str[ep] = lang

            num_sequences = demo_length
            if not self.pad_frame_stack:
                num_sequences -= self.n_frame_stack - 1
            if not self.pad_seq_length:
                num_sequences -= self.seq_length - 1
            if self.pad_seq_length:
                assert demo_length >= 1
                num_sequences = max(num_sequences, 1)
            else:
                assert num_sequences >= 1
            for _ in range(num_sequences):
                self._index_to_demo_id[self.total_num_sequences] = ep
                self.total_num_sequences += 1

        if self.want_lang_emb and self._demo_id_to_demo_lang_str:
            if lang_encoder is None:
                from lipvq_tpu_torch.utils.lang_utils import LangEncoder

                lang_encoder = LangEncoder()
            for ep in self.demos:
                s = self._demo_id_to_demo_lang_str.get(ep, "dummy")
                self._demo_id_to_demo_lang_emb[ep] = np.asarray(
                    lang_encoder.get_lang_emb(s), np.float32
                )

    # -- caching -----------------------------------------------------------
    def _build_cache(self):
        """Copy the cached arrays into memory (``Export.load``), so no
        memory map or file stays open."""
        self._cache = None
        if self.hdf5_cache_mode not in ("all", "low_dim"):
            return
        f = self.export
        cache = {}
        for ep in self.demos:
            entry = {"obs": {}}
            for k in self.obs_keys:
                # low_dim mode caches only non-image keys
                if self.hdf5_cache_mode == "low_dim" and len(f.shape(ep, f"obs/{k}")) >= 3:
                    continue
                entry["obs"][k] = f.load(ep, f"obs/{k}")
            if self.load_next_obs:
                entry["next_obs"] = {
                    k: f.load(ep, f"next_obs/{k}")
                    for k in self.obs_keys
                    if f.has(ep, f"next_obs/{k}")
                }
            for k in set(self.dataset_keys) | set(self.action_keys):
                if f.has(ep, k):
                    entry[k] = f.load(ep, k)
            cache[ep] = entry
        self._cache = cache

    def _get_data(self, ep: str, key: str):
        if self._cache is not None:
            entry = self._cache[ep]
            if "/" in key:
                k1, k2 = key.split("/", 1)
                if k1 in entry and k2 in entry[k1]:
                    return entry[k1][k2]
            elif key in entry:
                return entry[key]
        return ExportArray(self.export, ep, key)

    # -- stats -------------------------------------------------------------
    def get_action_stats(self) -> dict:
        stats = {}
        for key in self.action_keys:
            mins, maxs, sums, sqsums, n = None, None, 0.0, 0.0, 0
            for ep in self.demos:
                a = np.asarray(self._get_data(ep, key), np.float64)
                if a.ndim == 1:
                    a = a[:, None]
                mins = a.min(0) if mins is None else np.minimum(mins, a.min(0))
                maxs = a.max(0) if maxs is None else np.maximum(maxs, a.max(0))
                sums = sums + a.sum(0)
                n += a.shape[0]
            mean = sums / n
            sqdiff = 0.0
            for ep in self.demos:
                a = np.asarray(self._get_data(ep, key), np.float64)
                if a.ndim == 1:
                    a = a[:, None]
                sqdiff = sqdiff + ((a - mean) ** 2).sum(0)
            stats[key] = {
                "min": mins, "max": maxs, "mean": mean,
                "sqdiff": sqdiff, "n": n,
            }
        return stats

    def get_action_normalization_stats(self) -> dict:
        if self.action_normalization_stats is None:
            self.action_normalization_stats = action_stats_to_normalization_stats(
                self.get_action_stats(), self.action_config
            )
        return self.action_normalization_stats

    def get_obs_normalization_stats(self) -> dict:
        """Per-key mean/std over the training set, as {scale, offset} so
        that ``normalize_dict``'s (x - offset)/scale is (x - mean)/std;
        accumulated in float64, cast to float32."""
        stats = {}
        for key in self.obs_keys:
            total, total_sq, n = 0.0, 0.0, 0
            for ep in self.demos:
                a = np.asarray(
                    self._get_data(ep, f"obs/{key}"), np.float64
                )
                flat = a.reshape(a.shape[0], -1)
                total = total + flat.sum(0)
                total_sq = total_sq + (flat**2).sum(0)
                n += flat.shape[0]
            mean = total / n
            std = np.sqrt(np.maximum(total_sq / n - mean**2, 1e-12))
            stats[key] = {
                "offset": mean.astype(np.float32),
                "scale": np.maximum(std, 1e-6).astype(np.float32),
            }
        return stats

    def set_action_normalization_stats(self, stats: dict):
        self.action_normalization_stats = stats

    # -- windowing (reference dataset.py:588-632) --------------------------
    def _get_sequence(self, ep: str, index_in_demo: int, keys,
                      num_frames_to_stack: int, seq_length: int):
        demo_length = self._demo_id_to_demo_length[ep]
        assert index_in_demo < demo_length
        begin = max(0, index_in_demo - num_frames_to_stack)
        end = min(demo_length, index_in_demo + seq_length)
        begin_pad = max(0, num_frames_to_stack - index_in_demo)
        end_pad = max(0, index_in_demo + seq_length - demo_length)
        if not self.pad_frame_stack:
            assert begin_pad == 0
        if not self.pad_seq_length:
            assert end_pad == 0
        seq = {}
        for k in keys:
            data = self._get_data(ep, k)
            arr = np.asarray(data[begin:end])
            seq[k] = pad_sequence_single(arr, (begin_pad, end_pad), pad_same=True)
        pad_mask = np.array(
            [0] * begin_pad + [1] * (end - begin) + [0] * end_pad, dtype=bool
        )[:, None]
        return seq, pad_mask

    # -- item --------------------------------------------------------------
    def __len__(self):
        return self.total_num_sequences

    def __getitem__(self, index: int) -> dict:
        ep = self._index_to_demo_id[index]
        start = self._demo_id_to_start_indices[ep]
        demo_length = self._demo_id_to_demo_length[ep]
        offset = 0 if self.pad_frame_stack else self.n_frame_stack - 1
        index_in_demo = index - start + offset
        end_offset = 0 if self.pad_seq_length else self.seq_length - 1
        end_index_in_demo = demo_length - end_offset

        meta, _ = self._get_sequence(
            ep, index_in_demo, self.dataset_keys,
            num_frames_to_stack=self.n_frame_stack - 1,
            seq_length=self.seq_length,
        )
        obs, pad_mask = self._get_sequence(
            ep, index_in_demo, [f"obs/{k}" for k in self.obs_keys],
            num_frames_to_stack=self.n_frame_stack - 1,
            seq_length=self.seq_length,
        )
        meta["obs"] = {k.split("/", 1)[1]: v for k, v in obs.items()}
        if self.get_pad_mask:
            meta["pad_mask"] = pad_mask

        if self.load_next_obs:
            nobs, _ = self._get_sequence(
                ep, index_in_demo, [f"next_obs/{k}" for k in self.obs_keys],
                num_frames_to_stack=self.n_frame_stack - 1,
                seq_length=self.seq_length,
            )
            meta["next_obs"] = {k.split("/", 1)[1]: v for k, v in nobs.items()}

        if self.goal_mode == "last":
            goal, _ = self._get_sequence(
                ep, end_index_in_demo - 1,
                [f"next_obs/{k}" for k in self.obs_keys],
                num_frames_to_stack=0, seq_length=1,
            )
            meta["goal_obs"] = {
                k.split("/", 1)[1]: v[0] for k, v in goal.items()
            }

        # action assembly + normalization (reference dataset.py:604-621)
        ac_dict = OrderedDict()
        for k in self.action_keys:
            ac = meta[k]
            if ac.ndim == 1:
                ac = ac.reshape(-1, 1)
            ac_dict[k] = ac
        stats = self.get_action_normalization_stats()
        ac_dict = normalize_action_dict(ac_dict, stats)
        meta["actions"] = np.concatenate(
            [ac_dict[k] for k in self.action_keys], axis=-1
        ).astype(np.float32)
        meta["index"] = index

        if ep in self._demo_id_to_demo_lang_emb:
            t = meta["actions"].shape[0]
            meta["obs"][LANG_EMB_KEY] = np.tile(
                self._demo_id_to_demo_lang_emb[ep], (t, 1)
            )
        return meta


class CustomWeightedRandomSampler:
    """Weighted sampling over dataset indices supporting >2^24 entries
    (reference dataset.py:1046: numpy-based to dodge torch multinomial's
    category limit)."""

    def __init__(self, weights, num_samples: int, seed: int = 0):
        self.weights = np.asarray(weights, np.float64)
        self.weights = self.weights / self.weights.sum()
        self.num_samples = int(num_samples)
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        idx = self._rng.choice(
            len(self.weights), size=self.num_samples, replace=True,
            p=self.weights,
        )
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class TaskPairedBatchSampler:
    """Index sampler emitting batches whose context/query halves are
    task-aligned elementwise while the batch itself still mixes tasks
    (``lipvq_tpu/data/dataset.py:434-488``, where the measured caveats are
    written down): for each of ``batch_size/2`` slots it draws one task
    (probability proportional to total item weight) and one (context,
    query) index pair from that task, emitting all contexts first, then the
    matching queries."""

    def __init__(self, boundaries, ds_weights, batch_size: int,
                 num_samples: int, seed: int = 0,
                 normalize_weights_by_ds_size: bool = False):
        self.boundaries = list(boundaries)
        lens = np.diff(self.boundaries).astype(np.float64)
        w = np.asarray(ds_weights, np.float64)
        # per-slot dataset probability = total item weight of the
        # dataset, matching item-level weighted sampling in expectation
        p = w / lens if normalize_weights_by_ds_size else w
        p = p * lens
        self.probs = p / p.sum()
        self.batch_size = int(batch_size)
        assert self.batch_size % 2 == 0, "ICL pairing needs an even batch"
        self.num_samples = int(num_samples)
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n_batches = max(1, self.num_samples // self.batch_size)
        half = self.batch_size // 2
        lo = np.asarray(self.boundaries[:-1])
        hi = np.asarray(self.boundaries[1:])
        out = []
        for _ in range(n_batches):
            ds = self._rng.choice(len(self.probs), size=half, p=self.probs)
            ctx = self._rng.integers(lo[ds], hi[ds])
            qry = self._rng.integers(lo[ds], hi[ds])
            out.append(np.concatenate([ctx, qry]))
        return iter(np.concatenate(out).tolist())

    def __len__(self):
        return max(1, self.num_samples // self.batch_size) * self.batch_size


class MetaDataset:
    """Mix of SequenceDatasets with per-dataset sampling weights
    (reference dataset.py:1063-1190): one global index space; action
    normalization stats aggregated across datasets and pushed down
    (dataset.py:1085-1088, 1134-1147)."""

    def __init__(self, datasets: list[SequenceDataset],
                 ds_weights: list[float] | None = None,
                 normalize_weights_by_ds_size: bool = False):
        assert len(datasets) > 0
        for ds in datasets:
            # reference quirk: cache mode "all" asserted unsupported under
            # MetaDataset (dataset.py:1080-1082)
            assert not (ds.hdf5_cache_mode == "all" and len(datasets) > 1), (
                "MetaDataset does not support hdf5_cache_mode='all' "
                "(reference dataset.py:1080-1082)"
            )
        self.datasets = datasets
        self.ds_lengths = [len(ds) for ds in datasets]
        self.ds_weights = list(ds_weights or [1.0] * len(datasets))
        self.normalize_weights_by_ds_size = normalize_weights_by_ds_size
        self._boundaries = np.cumsum([0] + self.ds_lengths)
        self._aggregate_action_stats()

    def __len__(self):
        return int(self._boundaries[-1])

    def _locate(self, index: int):
        ds_id = int(np.searchsorted(self._boundaries, index, side="right") - 1)
        return ds_id, index - int(self._boundaries[ds_id])

    def __getitem__(self, index: int):
        ds_id, local = self._locate(index)
        item = self.datasets[ds_id][local]
        item["ds_id"] = ds_id
        return item

    def _aggregate_action_stats(self):
        """Merge raw action stats across datasets then push shared
        normalization stats down (reference dataset.py:1134-1147)."""
        merged = None
        for ds in self.datasets:
            stats = ds.get_action_stats()
            if merged is None:
                merged = {k: dict(v) for k, v in stats.items()}
                continue
            for k, s in stats.items():
                m = merged[k]
                m["min"] = np.minimum(m["min"], s["min"])
                m["max"] = np.maximum(m["max"], s["max"])
                total_n = m["n"] + s["n"]
                new_mean = (m["mean"] * m["n"] + s["mean"] * s["n"]) / total_n
                m["sqdiff"] = (
                    m["sqdiff"] + m["n"] * (m["mean"] - new_mean) ** 2
                    + s["sqdiff"] + s["n"] * (s["mean"] - new_mean) ** 2
                )
                m["mean"] = new_mean
                m["n"] = total_n
        norm = action_stats_to_normalization_stats(
            merged, self.datasets[0].action_config
        )
        for ds in self.datasets:
            ds.set_action_normalization_stats(norm)
        self.action_normalization_stats = norm

    def get_action_normalization_stats(self):
        return self.action_normalization_stats

    def get_dataset_sampler(self, num_samples: int | None = None,
                            seed: int = 0, batch_size: int | None = None):
        """Weighted sampler iff any weight != 1 (reference :1115-1131).

        ``batch_size`` switches to :class:`TaskPairedBatchSampler`
        (task-aligned context/query halves) regardless of weights."""
        if batch_size is not None:
            return TaskPairedBatchSampler(
                self._boundaries, self.ds_weights, batch_size,
                num_samples or len(self), seed=seed,
                normalize_weights_by_ds_size=self.normalize_weights_by_ds_size,
            )
        if (all(w == 1.0 for w in self.ds_weights)
                and not self.normalize_weights_by_ds_size):
            return None
        weights = np.zeros(len(self))
        for i, (ds_len, w) in enumerate(
            zip(self.ds_lengths, self.ds_weights)
        ):
            lo, hi = self._boundaries[i], self._boundaries[i + 1]
            ww = w / ds_len if self.normalize_weights_by_ds_size else w
            weights[lo:hi] = ww
        return CustomWeightedRandomSampler(
            weights, num_samples or len(self), seed=seed
        )
