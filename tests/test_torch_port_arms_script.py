"""``scripts/train.py`` builds and trains each arm of the tokenizer ablation
and ``icl_mamba`` from a config file on the CPU: one epoch of 3 steps with
validation and a wave of batched rollouts, a checkpoint that reloads through
``policy_from_checkpoint`` to bit-equal weights and buffers (the bin bounds
and step count, the spectral-norm vectors), and a ``latest_full.state``
that resumes into a fresh algo."""

import json
import os

import pytest
import torch

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.scripts import train as port_train
from lipvq_tpu_torch.utils import file_utils
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides, make_synthetic_export

torch.set_num_threads(1)

ARMS = {"bin": {"bin_enabled": True, "vq_vae_enabled": False},
        "ln_act": {"ln_act_enabled": True, "vq_vae_enabled": False},
        "raw": {"vq_vae_enabled": False},
        "vq": {}}
STEPS = 3


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    return make_synthetic_export(str(tmp_path_factory.mktemp("arms") / "export"), n_demos=6,
                                 demo_len=30)


@pytest.mark.parametrize("algo_name,arm", [("icl", "bin"), ("icl", "ln_act"), ("icl", "raw"),
                                           ("icl_mamba", "ln_act"), ("icl_mamba", "vq")])
def test_train_script_trains_each_arm(export, tmp_path, algo_name, arm):
    d = icl_test_config_overrides()
    section = d["algo"].pop("transformer")
    section.update({"compute_dtype": "float32", "embed_dim": 32, **ARMS[arm]})
    d["algo"]["mamba" if algo_name == "icl_mamba" else "transformer"] = section
    d["algo_name"] = algo_name
    d["train"].update({"data": export, "output_dir": str(tmp_path / "out"), "num_epochs": 1,
                       "cuda": False, "hdf5_filter_key": "train",
                       "hdf5_validation_filter_key": "valid"})
    d["experiment"]["epoch_every_n_steps"] = STEPS
    d["experiment"]["rollout"] = {"enabled": True, "n": 2, "horizon": 3, "rate": 1,
                                  "batched": True, "num_batch_envs": 2,
                                  "terminate_on_success": False}
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(d))
    ckpt_dir = port_train.main(["--config", str(cfg_path)])

    with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
        logs = json.load(f)
    assert len(logs["Train/Loss"]) == 1 and len(logs["Valid/Loss"]) == 1
    assert ("Train/VQ_Loss" in logs) == (arm == "vq")
    assert "Rollout/Success_Rate/SyntheticKitchen" in logs
    [name] = [n for n in os.listdir(ckpt_dir) if n.endswith(".ckpt")]
    algo, ckpt = file_utils.policy_from_checkpoint(os.path.join(ckpt_dir, name), device="cpu")
    assert ckpt["algo_name"] == algo_name
    assert type(algo.nets.net.transformer).__name__ == (
        "MambaBackbone" if algo_name == "icl_mamba" else "GPTBackbone")
    tok = algo.nets.net.encoder.action_network
    if arm == "bin":
        assert int(tok.num_step) == STEPS  # validation never advances the bounds
    if arm == "raw":
        assert not torch.equal(tok.sn1.u, torch.zeros_like(tok.sn1.u))
    state = torch.load(os.path.join(ckpt_dir, "latest_full.state"), map_location="cpu",
                       weights_only=True)
    fresh = algo_factory(algo_name, file_utils.config_from_checkpoint(ckpt),
                         json.loads(ckpt["shape_metadata"])["all_shapes"], ac_dim=12,
                         device="cpu")
    fresh.deserialize_full(state)
    for (k, v), (k2, v2) in zip(algo.nets.state_dict().items(),
                                fresh.nets.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
