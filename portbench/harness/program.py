"""The system under test, built from a configuration file of ``configs/``:
the file names the port's algorithm (``algo``), the overrides that the
port's ``config_factory`` takes verbatim (``port_config``), the plain
reference that follows it (``reference``: ``reference/<name>.py``) and the
analytic counts of its work (``counts``: ``counts/<name>.py``). The
program is built through the port's own config and algorithm factories,
then given the benchmark's weights."""

from __future__ import annotations

import copy
import importlib
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def load_config(name: str) -> dict:
    """``configs/<name>.json``, normalized (``normalize``)."""
    return normalize(json.loads((ROOT / "configs" / f"{name}.json").read_text()))


def reference(cfg: dict):
    """The configuration's plain reference module, ``reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def counts(cfg: dict):
    """The configuration's analytic operation counts, ``counts/<name>.py``."""
    return importlib.import_module(f"portbench.counts.{cfg['counts']}")


def normalize(cfg: dict) -> dict:
    """The file's keys with ``obs`` as (key, shape) pairs, ``obs_keys`` in
    order, ``rgb_keys`` (the image observations), and the flat keys that the
    configuration's reference reads from ``port_config`` (its ``view``)."""
    cfg = dict(cfg)
    cfg["obs"] = [(k, tuple(s)) for k, s in cfg["obs"]]
    cfg["obs_keys"] = [k for k, _ in cfg["obs"]]
    cfg["rgb_keys"] = [k for k, s in cfg["obs"] if len(s) == 3]
    return reference(cfg).view(cfg)


def port_config(cfg: dict, seed: int):
    """The port's config: ``config_factory(algo, port_config)`` with the
    run's seed as the train seed."""
    from lipvq_tpu_torch.config import config_factory

    overrides = copy.deepcopy(cfg["port_config"])
    overrides.setdefault("train", {})["seed"] = int(seed)
    return config_factory(cfg["algo"], overrides)


def build_policy(cfg: dict, weights: dict, seed: int, device):
    """The port's algorithm on ``device`` with ``weights`` loaded (every
    parameter and running statistic, strictly by name)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.utils import obs_utils

    cf = port_config(cfg, seed)
    obs_utils.initialize_obs_utils_with_config(cf)
    algo = algo_factory(cfg["algo"], cf, {k: list(s) for k, s in cfg["obs"]},
                        ac_dim=cfg["ac_dim"], device=device)
    algo.nets.load_state_dict(weights, strict=True)
    return algo


def take_up_schedule(algo, step: int) -> None:
    """Every optimizer's schedule taken up at update ``step``, as a run
    resumed there with fresh moments: the step counter and each group's
    current rate."""
    for o in algo.optimizers().values():
        o.steps = int(step)
        for group in o.optimizer.param_groups:
            group["lr"] = o.schedule(o.steps)


def build_tokenizer(tok: dict, weights: dict, device):
    """The port's ``LipVQVAE`` of the corpus tokenizer, with ``weights``."""
    from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE

    model = LipVQVAE(feature_dim=tok["feature_dim"], latent_dim=tok["latent_dim"],
                     num_codes=tok["num_codes"], hidden_dim=tok["hidden_dim"]).to(device)
    model.load_state_dict(weights, strict=True)
    return model


def device_state(algo) -> dict:
    return {k: v.detach().clone() for k, v in algo.nets.state_dict().items()}


def exp_avg(algo) -> dict:
    """Each optimized parameter's first moment, by name; zeros where its
    optimizer holds none (it never stepped)."""
    names = {id(p): k for k, p in algo.nets.named_parameters()}
    out = {}
    for o in algo.optimizers().values():
        for p in o.params:
            st = o.optimizer.state.get(p, {})
            out[names[id(p)]] = (st["exp_avg"].detach().clone() if "exp_avg" in st
                                 else torch.zeros_like(p))
    return out


def betas(algo) -> dict:
    """Each parameter's Adam beta1, by name."""
    names = {id(p): k for k, p in algo.nets.named_parameters()}
    return {names[id(p)]: g["betas"][0] for o in algo.optimizers().values()
            for g in o.optimizer.param_groups for p in g["params"]}
