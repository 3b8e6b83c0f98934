"""A D4RL buffer converted and trained on with gym rollouts, in both
packages: ``convert_d4rl`` writes the same episodes (the JAX script an HDF5
file, the port an export), then each package's ``scripts/train.py`` trains
the ICL flagship at a small width on the ``flat`` observation (the port
with ``--device cpu``) with batched rollouts in ``Hopper-v4``. Both must
build the env (no "Rollout disabled"), run a rollout epoch with finite
returns and a horizon within the limit, and log the same rollout keys."""

import json
import os
import re

import numpy as np
import pytest

pytest.importorskip("gymnasium")
pytest.importorskip("mujoco")  # Hopper-v4's simulator

import lipvq_tpu.scripts.train as jax_train_script  # noqa: E402
from lipvq_tpu.scripts.conversion.convert_d4rl import convert_d4rl as jax_convert_d4rl  # noqa: E402
from lipvq_tpu_torch.data.export import Export, hdf5_to_export  # noqa: E402
from lipvq_tpu_torch.scripts import train as port_train  # noqa: E402
from lipvq_tpu_torch.scripts.conversion.convert_d4rl import convert_d4rl  # noqa: E402
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides  # noqa: E402

EPISODES, EPISODE_LEN, HORIZON = 4, 40, 6
ROLLOUT_LINE = re.compile(r"^Rollout Epoch 1 \[Hopper-v4\]: (\{.*\})$", re.MULTILINE)


def _buffer(path):
    """Hopper's widths (obs 11, act 3), episodes cut by timeouts."""
    rng = np.random.default_rng(0)
    n = EPISODES * EPISODE_LEN
    timeouts = np.zeros(n)
    timeouts[EPISODE_LEN - 1::EPISODE_LEN] = 1
    np.savez(path, observations=rng.standard_normal((n, 11)).astype(np.float32),
             actions=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
             rewards=rng.standard_normal(n).astype(np.float32), terminals=np.zeros(n),
             timeouts=timeouts)
    return path


def _config(data, output_dir):
    d = icl_test_config_overrides()
    d["algo_name"] = "icl"
    d["train"].update({"data": data, "output_dir": output_dir, "num_epochs": 1, "cuda": False,
                       "batch_size": 4})
    d["experiment"].update({"validate": False, "epoch_every_n_steps": 2})
    d["experiment"]["rollout"] = {"enabled": True, "n": 2, "horizon": HORIZON, "rate": 1,
                                  "batched": True, "num_batch_envs": 2,
                                  "terminate_on_success": False}
    d["algo"]["transformer"].update({"compute_dtype": "float32", "embed_dim": 32,
                                     "num_layers": 1, "num_heads": 2})
    d["observation"]["modalities"]["obs"]["low_dim"] = ["flat"]
    return d


def test_d4rl_export_trains_with_gym_rollouts_in_both_packages(tmp_path, capsys):
    buf = _buffer(str(tmp_path / "hopper.npz"))
    h5 = str(tmp_path / "hopper.hdf5")
    export = str(tmp_path / "export")
    assert jax_convert_d4rl(buf, "Hopper-v4", h5) == convert_d4rl(buf, "Hopper-v4", export) \
        == EPISODES
    want = Export(hdf5_to_export(h5, str(tmp_path / "want")))
    assert want.data_attrs == Export(export).data_attrs

    jax_train_script.train(jax_train_script.config_factory(
        "icl", _config(h5, str(tmp_path / "jax"))))
    jax_out = capsys.readouterr().out
    cfg_path = tmp_path / "port.json"
    cfg_path.write_text(json.dumps(_config(export, str(tmp_path / "port"))))
    ckpt_dir = port_train.main(["--config", str(cfg_path), "--device", "cpu"])
    port_out = capsys.readouterr().out

    logs = []
    for out in (jax_out, port_out):
        assert "Rollout disabled" not in out
        found = ROLLOUT_LINE.findall(out)
        assert len(found) == 1, out[-3000:]
        log = json.loads(found[0])
        assert np.isfinite(log["Return"]) and 1 <= log["Horizon"] <= HORIZON, log
        logs.append(log)
    assert sorted(logs[0]) == sorted(logs[1])
    with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
        scalars = json.load(f)
    rollout_keys = sorted(k for k in scalars if k.startswith("Rollout/"))
    assert rollout_keys == sorted(f"Rollout/{k}/Hopper-v4" for k in logs[1]), rollout_keys
    assert all(np.isfinite(scalars[k]).all() for k in rollout_keys)
