"""Training-loop utilities (counterpart of ``lipvq_tpu/utils/train_utils.py``).

- ``run_epoch`` (reference :1238): fixed num_steps per epoch, cycling the
  loader on exhaustion, per-phase wall-clock timers emitted as ``Time_*``
  minutes (reference :1279-1328);
- ``get_exp_dir`` and ``should_save_from_rollout_logs``, the output tree
  and the checkpoint policy (reference :32-90, :1112).

The HDF5 dataset factory and the loader factory come with the data slice.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from collections.abc import Mapping

import numpy as np
import torch

from lipvq_tpu_torch.data.loaders import CyclingIterator


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
    ``Time_*`` phase minutes. The step metrics stay on the device during the
    epoch and are fetched once at its end, so the loop never waits on the
    card for a metric.
    """
    it = data_loader if isinstance(data_loader, CyclingIterator) else CyclingIterator(data_loader)
    inner = data_loader.loader if isinstance(data_loader, CyclingIterator) else data_loader
    if num_steps is None:
        num_steps = len(inner)

    timing = {"Data_Loading": 0.0, "Process_Batch": 0.0, "Train_Batch": 0.0,
              "Log_Info": 0.0}
    infos = []
    for _ in range(num_steps):
        t0 = time.time()
        batch = next(it)
        timing["Data_Loading"] += time.time() - t0

        t0 = time.time()
        input_batch = model.process_batch_for_training(batch)
        timing["Process_Batch"] += time.time() - t0

        t0 = time.time()
        infos.append(model.train_on_batch(input_batch, epoch, validate=validate))
        timing["Train_Batch"] += time.time() - t0

    t0 = time.time()
    stacked = _stack_to_host(infos)
    step_log_all = defaultdict(list)
    for i in range(num_steps):
        for k, v in model.log_info(_index(stacked, i)).items():
            step_log_all[k].append(v)
    timing["Log_Info"] += time.time() - t0

    out = {k: float(np.mean(v)) for k, v in step_log_all.items()}
    for k, v in timing.items():
        out[f"Time_{k}"] = v / 60.0
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
