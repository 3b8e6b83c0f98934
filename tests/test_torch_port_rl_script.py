"""The offline-RL and hierarchical algorithms through the port's entry
points on the CPU: ``scripts/train.py`` trains TD3-BC (its template) and
HBC (its template with ``seq_length`` at the subgoal horizon, which the
template's 1 cannot reach) over a synthetic export with ``next_obs``,
``rewards`` and ``dones``, 2 epochs x 3 steps at small widths, a
checkpoint each epoch; ``policy_from_checkpoint`` rebuilds each bit-equal
to the in-process algo; a fresh algo loaded from ``latest_full.state``
takes the writer's next steps bit for bit (TD3-BC's actor-update phase
kept: the actor moves on the first of them and not on the second); each
is served through ``RolloutPolicy`` and ``rollout_with_stats`` on the
synthetic env.

A reference fault, mirrored (ROADMAP queue 3): the dataset adds the
episode's ``lang_emb`` to ``obs`` only, so with ``lang_emb`` among the obs
keys ``next_obs`` lacks it and an offline-RL step raises KeyError, in both
packages.
"""

import json
import os
import pathlib

import h5py
import numpy as np
import pytest
import torch

from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from lipvq_tpu.utils.lang_utils import LangEncoder as JaxLangEncoder
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.rollout_policy import RolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.data.dataset import SequenceDataset
from lipvq_tpu_torch.data.export import hdf5_to_export
from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
from lipvq_tpu_torch.envs.rollout import rollout_with_stats
from lipvq_tpu_torch.scripts import train as port_train
from lipvq_tpu_torch.utils import train_utils
from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint
from lipvq_tpu_torch.utils.lang_utils import LangEncoder
from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LOW_DIM = ["robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos", "object"]
HORIZON = 5
SMALL = {
    "td3_bc": {"actor": {"layer_dims": [32, 32]}, "critic": {"layer_dims": [32, 32]}},
    "hbc": {"planner": {"subgoal_horizon": HORIZON, "ae": {"planner_layer_dims": [32, 32]}},
            "actor": {"actor_layer_dims": [32, 32]}},
}


def _merge(d: dict, over: dict) -> dict:
    for k, v in over.items():
        d[k] = _merge(d.get(k, {}), v) if isinstance(v, dict) else v
    return d


def script_config(algo, data, output_dir) -> dict:
    cfg = json.loads((REPO / "exps" / "templates" / f"{algo}.json").read_text())
    _merge(cfg["algo"], SMALL[algo])
    cfg["train"].update({"data": data, "output_dir": output_dir, "num_epochs": 2,
                         "batch_size": 4, "cuda": False,
                         "seq_length": HORIZON if algo == "hbc" else 1})
    cfg["experiment"] = {"epoch_every_n_steps": 3, "validate": False, "render_video": False,
                         "rollout": {"enabled": False},
                         "save": {"enabled": True, "every_n_epochs": 1},
                         "logging": {"terminal_output_to_txt": False, "log_tb": False}}
    cfg["observation"]["modalities"]["obs"]["low_dim"] = LOW_DIM
    return cfg


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    return make_synthetic_export(str(tmp_path_factory.mktemp("rl") / "export"), n_demos=4,
                                 demo_len=20, transitions=True)


@pytest.fixture(scope="module", params=["td3_bc", "hbc"])
def run(request, export, tmp_path_factory):
    """(algo name, checkpoint dir, the script's in-process algo)."""
    algo = request.param
    root = tmp_path_factory.mktemp(f"{algo}_run")
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(script_config(algo, export, str(root / "out"))))
    seen = {}
    run_epoch = train_utils.run_epoch

    def observed(model, loader, epoch, validate=False, num_steps=None):
        seen["algo"] = model
        return run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)

    train_utils.run_epoch = observed
    try:
        ckpt_dir = port_train.main(["--config", str(cfg_path)])
    finally:
        train_utils.run_epoch = run_epoch
    return algo, ckpt_dir, seen["algo"]


def test_export_carries_transitions(export):
    meta = json.loads((pathlib.Path(export) / "meta.json").read_text())
    arrays = meta["demos"]["demo_0"]["arrays"]
    assert {f"next_obs/{k}" for k in LOW_DIM} <= set(arrays)
    demo = pathlib.Path(export) / "data" / "demo_0"
    obs, nxt = np.load(demo / "obs" / "object.npy"), np.load(demo / "next_obs" / "object.npy")
    np.testing.assert_array_equal(nxt[:-1], obs[1:])
    np.testing.assert_array_equal(nxt[-1], obs[-1])
    for key in ("rewards", "dones"):
        assert np.load(demo / f"{key}.npy").tolist() == [0.0] * 19 + [1.0]


def test_script_trains_and_checkpoints(run):
    algo, ckpt_dir, model = run
    assert sorted(os.listdir(ckpt_dir)) == ["latest_full.state", "latest_full.state.epoch",
                                           "model_epoch_1.ckpt", "model_epoch_2.ckpt"]
    with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
        logs = json.load(f)
    assert len(logs["Train/Loss"]) == 2 and all(np.isfinite(logs["Train/Loss"]))
    assert type(model).__name__ == {"td3_bc": "TD3_BC", "hbc": "HBC"}[algo]


def test_checkpoint_rebuilds_bit_equal(run):
    algo, ckpt_dir, model = run
    loaded, ckpt = policy_from_checkpoint(os.path.join(ckpt_dir, "model_epoch_2.ckpt"),
                                          device="cpu")
    assert ckpt["algo_name"] == algo
    want, got = model.serialize(), loaded.serialize()
    assert want.keys() == got.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    if algo == "td3_bc":
        assert any(k.startswith("target.actor.") for k in got)


def _raw_batch(seed):
    rng = np.random.default_rng(seed)
    shapes = dict(zip(LOW_DIM, (3, 4, 2, 14)))
    return {"obs": {k: rng.standard_normal((4, HORIZON, n), dtype=np.float32)
                    for k, n in shapes.items()},
            "next_obs": {k: rng.standard_normal((4, HORIZON, n), dtype=np.float32)
                         for k, n in shapes.items()},
            "actions": rng.uniform(-1, 1, (4, HORIZON, 12)).astype(np.float32),
            "rewards": rng.standard_normal((4, HORIZON)).astype(np.float32),
            "dones": np.zeros((4, HORIZON), np.float32)}


def test_full_state_resumes_the_writers_next_steps(run):
    algo, ckpt_dir, model = run
    fresh, _ = policy_from_checkpoint(os.path.join(ckpt_dir, "model_epoch_2.ckpt"),
                                      device="cpu")
    fresh.deserialize_full(torch.load(os.path.join(ckpt_dir, "latest_full.state"),
                                      weights_only=True))
    if algo == "td3_bc":
        assert fresh.step == model.step == 6
    for i, seed in enumerate((1, 2)):
        batch = model.process_batch_for_training(_raw_batch(seed))
        draws = {"noise": np.random.default_rng(seed).standard_normal((4, 12)).astype(
            np.float32)} if algo == "td3_bc" else None
        want = model.train_on_batch(batch, 3, draws=draws)["losses"]
        got = fresh.train_on_batch(batch, 3, draws=draws)["losses"]
        assert want.keys() == got.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        if algo == "td3_bc":  # steps 6 and 7: the actor moves on the first only
            assert (float(got["actor_loss"]) == 0.0) == (i == 1)
    want, got = model.serialize(), fresh.serialize()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_served_through_rollout_with_stats(run):
    algo, ckpt_dir, _ = run
    model, ckpt = policy_from_checkpoint(os.path.join(ckpt_dir, "model_epoch_2.ckpt"),
                                         device="cpu")
    policy = RolloutPolicy(model, action_normalization_stats=ckpt[
        "action_normalization_stats_unpacked"])
    logs, _ = rollout_with_stats(policy, {"SyntheticKitchen": SyntheticKitchenEnv(seed=3)},
                                 horizon=12, num_episodes=1)
    stats = logs["SyntheticKitchen"]
    assert stats["Horizon"] == 12 and np.isfinite(stats["Return"])
    if algo == "hbc":  # 12 requests: subgoals at calls 0 and 10
        assert model._step_counter == 12 and model.current_subgoal is not None


def test_language_obs_do_not_reach_next_obs_in_both_packages(tmp_path):
    h5 = make_synthetic_dataset(str(tmp_path / "data.hdf5"), n_demos=2, demo_len=12)
    with h5py.File(h5, "a") as f:
        for demo in f["data"].values():
            for k, v in demo["obs"].items():
                demo[f"next_obs/{k}"] = np.concatenate([v[1:], v[-1:]], axis=0)
    export = hdf5_to_export(h5, str(tmp_path / "export"))
    keys = LOW_DIM + ["lang_emb"]
    kwargs = {"dataset_keys": ("actions", "rewards", "dones"), "load_next_obs": True,
              "hdf5_cache_mode": "all"}
    items = [JaxSequenceDataset(h5, keys, lang_encoder=JaxLangEncoder(), **kwargs)[0],
             SequenceDataset(export, keys, lang_encoder=LangEncoder(), **kwargs)[0]]
    for item in items:
        assert "lang_emb" in item["obs"] and "lang_emb" not in item["next_obs"]
    shapes = {k: list(v.shape[1:]) for k, v in items[1]["obs"].items()}
    over = {"algo": {"actor": {"layer_dims": [16]}, "critic": {"layer_dims": [16]}}}
    for factory, make, item, extra in (
            (jax_config_factory, jax_algo_factory, items[0], {}),
            (config_factory, algo_factory, items[1], {"device": "cpu"})):
        cfg = factory("td3_bc", over)
        with cfg.unlocked():
            cfg.observation.modalities.obs.low_dim = keys
        algo = make("td3_bc", cfg, shapes, ac_dim=12, **extra)
        batch = {"obs": {k: v[None] for k, v in item["obs"].items()},
                 "next_obs": {k: v[None] for k, v in item["next_obs"].items()},
                 **{k: item[k][None] for k in ("actions", "rewards", "dones")}}
        with pytest.raises(KeyError, match="lang_emb"):
            algo.train_on_batch(algo.process_batch_for_training(batch), 0)
