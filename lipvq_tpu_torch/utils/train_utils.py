"""Training-loop utilities (counterpart of ``lipvq_tpu/utils/train_utils.py``).

- ``dataset_factory`` / ``load_data_for_training`` (reference :94, :164)
  over dataset exports, and ``make_loaders``;
- ``run_epoch`` (reference :1238): fixed num_steps per epoch, cycling the
  loader on exhaustion, per-phase wall-clock timers emitted as ``Time_*``
  minutes (reference :1279-1328);
- ``get_exp_dir`` and ``should_save_from_rollout_logs``, the output tree
  and the checkpoint policy (reference :32-90, :1112).

``make_loaders`` picks the train loader as the JAX package does: with
``train.hdf5_cache_mode="device"`` and a model, the ``DeviceCachedLoader``
(the corpus preprocessed once and resident on the model's device); else 0
data workers an in-process ``DataLoader``, 1 a ``PrefetchLoader`` thread,
more a ``MultiprocessLoader``.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from collections.abc import Mapping

import numpy as np
import torch

from lipvq_tpu_torch.data.dataset import MetaDataset, SequenceDataset
from lipvq_tpu_torch.data.loaders import (
    CyclingIterator,
    DataLoader,
    DeviceCachedLoader,
    MultiprocessLoader,
    PrefetchLoader,
)
from lipvq_tpu_torch.utils.profile_utils import PhaseTimer


def dataset_factory(config, obs_keys, filter_by_attribute=None,
                    dataset_path=None, lang_encoder=None) -> SequenceDataset:
    """Build a SequenceDataset over an export from config (reference
    train_utils.py:164-218)."""
    if dataset_path is None:
        dataset_path = config.train.data
    return SequenceDataset(
        hdf5_path=dataset_path,
        obs_keys=obs_keys,
        dataset_keys=tuple(config.train.dataset_keys),
        action_keys=tuple(config.train.action_keys),
        action_config=config.train.action_config.to_dict()
        if hasattr(config.train.action_config, "to_dict")
        else dict(config.train.action_config),
        frame_stack=config.train.frame_stack,
        seq_length=config.train.seq_length,
        pad_frame_stack=config.train.pad_frame_stack,
        pad_seq_length=config.train.pad_seq_length,
        goal_mode=config.train.goal_mode,
        # "device" is a loader-level mode (make_loaders); the dataset
        # caches low_dim for it, as in the JAX package
        hdf5_cache_mode=("low_dim"
                         if config.train.hdf5_cache_mode == "device"
                         else config.train.hdf5_cache_mode),
        hdf5_use_swmr=config.train.hdf5_use_swmr,
        filter_by_attribute=filter_by_attribute,
        load_next_obs=config.train.hdf5_load_next_obs,
        lang_encoder=lang_encoder,
    )


def load_data_for_training(config, obs_keys, lang_encoder=None):
    """(train_dataset, valid_dataset) (reference train_utils.py:94-161).

    ``config.train.data`` may be one export path or a list of dataset specs
    ({"path": ..., "weight"?: ..., "filter_key"?: ...}); a list builds a
    MetaDataset with shared normalization stats and no validation set.
    """
    train_filter = config.train.hdf5_filter_key
    valid_filter = config.train.hdf5_validation_filter_key
    data = config.train.data

    if isinstance(data, (list, tuple)):
        datasets, weights = [], []
        for spec in data:
            if isinstance(spec, str):
                spec = {"path": spec}
            ds = dataset_factory(
                config, obs_keys,
                filter_by_attribute=spec.get("filter_key", train_filter),
                dataset_path=spec["path"], lang_encoder=lang_encoder,
            )
            datasets.append(ds)
            weights.append(float(spec.get("weight", 1.0)))
        train_ds = MetaDataset(
            datasets, ds_weights=weights,
            normalize_weights_by_ds_size=bool(
                config.train.get("normalize_weights_by_ds_size", False)
            ),
        )
        return train_ds, None

    train_ds = dataset_factory(
        config, obs_keys, filter_by_attribute=train_filter,
        lang_encoder=lang_encoder,
    )
    valid_ds = None
    if config.experiment.validate:
        valid_ds = dataset_factory(
            config, obs_keys, filter_by_attribute=valid_filter,
            lang_encoder=lang_encoder,
        )
        valid_ds.set_action_normalization_stats(
            train_ds.get_action_normalization_stats()
        )
    return train_ds, valid_ds


def make_loaders(config, train_ds, valid_ds, model=None):
    """(train_loader, valid_loader, context_loader) (reference
    train_utils.py:229-294): the train loader follows the MetaDataset's
    sampler when it has one; with ``train.hdf5_cache_mode="device"`` and a
    ``model`` it is a ``DeviceCachedLoader`` drawing from the sampler's
    weights (``group_task_batches`` raises there), else it has
    ``train.num_data_workers`` worker processes where there are more than 1
    (a thread for 1); the rollout context loader draws one training item at
    a time (reference train.py:217-224). The caller closes a
    ``MultiprocessLoader``."""
    n_workers = int(config.train.num_data_workers or 0)
    sampler = None
    if hasattr(train_ds, "get_dataset_sampler"):
        group_bs = (
            config.train.batch_size
            if config.train.get("group_task_batches", False) else None
        )
        sampler = train_ds.get_dataset_sampler(
            seed=config.train.seed, batch_size=group_bs
        )
    if config.train.hdf5_cache_mode == "device" and model is not None:
        if config.train.get("group_task_batches", False):
            raise ValueError(
                "hdf5_cache_mode='device' draws i.i.d. weighted indices "
                "and cannot honor group_task_batches; use 'low_dim'")
        train_loader = DeviceCachedLoader(
            train_ds, batch_size=config.train.batch_size, model=model,
            seed=config.train.seed, sampler=sampler)
    elif n_workers > 1:
        train_loader = MultiprocessLoader(
            train_ds, batch_size=config.train.batch_size, shuffle=True,
            seed=config.train.seed, sampler=sampler, num_workers=n_workers,
        )
    else:
        train_loader = DataLoader(
            train_ds, batch_size=config.train.batch_size, shuffle=True,
            seed=config.train.seed, sampler=sampler,
        )
        if n_workers:
            train_loader = PrefetchLoader(train_loader)
    valid_loader = None
    if valid_ds is not None:
        valid_loader = DataLoader(
            valid_ds, batch_size=config.train.batch_size, shuffle=True,
            seed=config.train.seed + 1,
        )
    context_loader = DataLoader(
        train_ds, batch_size=1, shuffle=True, seed=config.train.seed + 2,
        drop_last=False,
    )
    return train_loader, valid_loader, context_loader


def _stack_to_host(infos: list):
    """Per-step info trees of device scalars -> one tree of numpy arrays
    [steps], one device-to-host copy per leaf."""
    first = infos[0]
    if isinstance(first, Mapping):
        return {k: _stack_to_host([i[k] for i in infos]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(infos).cpu().numpy()
    return np.asarray(infos)


def _index(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def run_epoch(model, data_loader, epoch: int, validate: bool = False,
              num_steps: int | None = None):
    """One epoch of ``num_steps`` train steps (default: one pass of the
    loader), cycling it as needed (reference train_utils.py:1238-1352).

    Returns the step log: each ``log_info`` key averaged over the steps, plus
    ``Time_*`` phase minutes. A loader whose batches are ``preprocessed``
    (``DeviceCachedLoader``) skips ``process_batch_for_training``. The step
    metrics stay on the device during the epoch and are fetched once at its
    end, so the loop never waits on the card for a metric.
    """
    it = data_loader if isinstance(data_loader, CyclingIterator) else CyclingIterator(data_loader)
    inner = data_loader.loader if isinstance(data_loader, CyclingIterator) else data_loader
    if num_steps is None:
        num_steps = len(inner)
    # a device-cached loader's batches are processed already, on the device
    preprocessed = getattr(inner, "preprocessed", False)

    timer = PhaseTimer()
    infos = []
    for _ in range(num_steps):
        with timer.phase("Data_Loading", "train.data"):
            batch = next(it)
        with timer.phase("Process_Batch"):
            input_batch = batch if preprocessed else model.process_batch_for_training(batch)
        with timer.phase("Train_Batch", "train.step"):
            infos.append(model.train_on_batch(input_batch, epoch, validate=validate))

    with timer.phase("Log_Info", "train.fetch"):
        stacked = _stack_to_host(infos)
        step_log_all = defaultdict(list)
        for i in range(num_steps):
            for k, v in model.log_info(_index(stacked, i)).items():
                step_log_all[k].append(v)

    out = {k: float(np.mean(v)) for k, v in step_log_all.items()}
    out.update(timer.logs())
    return out


def get_exp_dir(config, auto_remove_exp_dir: bool = False):
    """Create the output tree log/ models/ videos/ under
    ``train.output_dir/experiment.name/<timestamp>`` (reference
    train_utils.py:32-90)."""
    base = os.path.expanduser(config.train.output_dir)
    t_str = time.strftime("%Y%m%d%H%M%S")
    exp_dir = os.path.join(base, config.experiment.name, t_str)
    log_dir = os.path.join(exp_dir, "logs")
    ckpt_dir = os.path.join(exp_dir, "models")
    video_dir = os.path.join(exp_dir, "videos")
    for d in (log_dir, ckpt_dir, video_dir):
        os.makedirs(d, exist_ok=True)
    return log_dir, ckpt_dir, video_dir


def should_save_from_rollout_logs(rollout_logs, best_return, best_success_rate,
                                  epoch_ckpt_name, save_on_best_rollout_return,
                                  save_on_best_rollout_success_rate):
    """Checkpoint decision from rollout stats (reference train_utils.py:1112)."""
    should_save = False
    for env_name, logs in rollout_logs.items():
        if logs.get("Return", -np.inf) > best_return.get(env_name, -np.inf):
            best_return[env_name] = logs["Return"]
            if save_on_best_rollout_return:
                epoch_ckpt_name += f"_{env_name}_return_{logs['Return']}"
                should_save = True
        sr = logs.get("Success_Rate", -1.0)
        if sr > best_success_rate.get(env_name, -1.0):
            best_success_rate[env_name] = sr
            if save_on_best_rollout_success_rate:
                epoch_ckpt_name += f"_{env_name}_success_{sr}"
                should_save = True
    return should_save, epoch_ckpt_name, best_return, best_success_rate
