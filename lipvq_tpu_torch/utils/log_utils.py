"""Logging: stdout tee + scalar logger (copy of ``lipvq_tpu/utils/log_utils.py``).

``PrintLogger`` (reference log_utils.py:21) tees stdout to log.txt;
``DataLogger`` (reference :42) records scalars to tensorboard (and wandb
when configured) with running stats. Both backends are optional and
imported only when asked for; a plain in-memory record always works, and
``close`` writes it to ``scalars.json``.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

import numpy as np


class PrintLogger:
    """Tee stdout/stderr to a log file (reference log_utils.py:21-40)."""

    def __init__(self, log_file: str):
        self.terminal = sys.stdout
        self.log_file = open(log_file, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log_file.write(message)
        self.log_file.flush()

    def flush(self):
        self.terminal.flush()
        self.log_file.flush()


_WARNING_BUFFER: list[str] = []


def log_warning(message: str, color: str = "yellow", print_now: bool = True):
    """Buffer a warning for later flush (reference log_utils.py:203-220)."""
    formatted = f"ROBOMIMIC WARNING(\n    {message}\n)"
    if print_now:
        print(formatted)
    _WARNING_BUFFER.append(formatted)


def flush_warnings():
    """Re-print all buffered warnings (reference log_utils.py:222-230)."""
    for w in _WARNING_BUFFER:
        print(w)
    _WARNING_BUFFER.clear()


class DataLogger:
    """Scalar logger with running stats (reference log_utils.py:42-172)."""

    def __init__(self, log_dir: str, config, log_tb: bool = True,
                 log_wandb: bool = False):
        self._tb = None
        self._wandb = None
        self._data = defaultdict(list)
        self._log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        if log_tb:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None
        if log_wandb:
            try:
                import wandb

                wandb.init(
                    project=config.experiment.logging.wandb_proj_name,
                    name=config.experiment.name,
                    config=config.to_dict(),
                )
                self._wandb = wandb
            except ImportError:
                self._wandb = None

    def record(self, k: str, v, epoch: int, data_type: str = "scalar",
               log_stats: bool = False):
        if data_type == "scalar":
            self._data[k].append(float(v))
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), epoch)
                if log_stats:
                    stats = self.get_stats(k)
                    for sk, sv in stats.items():
                        self._tb.add_scalar(f"{k}-{sk}", sv, epoch)
            if self._wandb is not None:
                self._wandb.log({k: float(v)}, step=epoch)

    def get_stats(self, k: str) -> dict:
        vals = np.asarray(self._data[k])
        return {
            "mean": float(vals.mean()),
            "std": float(vals.std()),
            "min": float(vals.min()),
            "max": float(vals.max()),
        }

    def close(self):
        """Also writes every recorded scalar to ``scalars.json`` in the log
        directory ({key: [value per record]}), readable without tensorboard."""
        with open(os.path.join(self._log_dir, "scalars.json"), "w") as f:
            json.dump(self._data, f)
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
