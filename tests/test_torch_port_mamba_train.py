"""Training parity of ``icl_mamba`` (the ICL policy on the Mamba backbone):
the GMM algo with the ln_act and the LipVQ tokenizer and the non-GMM
``ICLTransformer`` on the Mamba backbone, 1 and 3 ``train_on_batch`` steps in
both packages from bridged identical weights, in fp32 with dropout 0.

Tolerances: losses and the gradient norm rtol 1e-4 (the Mamba scan sums its
recurrence in another order than ``associative_scan``), parameters atol
2e-5 + rtol 1e-5 (as ``test_torch_port_train.py``: Adam's first steps
amplify the last digits of tiny gradients), buffers rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.icl import ICLMambaGMM, ICLTransformer
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.models.mamba import MambaBackbone
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params
from lipvq_tpu_torch.utils.tensor_utils import stack_collate

torch.set_num_threads(1)

OBS_SHAPES = {"robot0_eef_pos": [3], "object": [14]}
AC_DIM, T, BATCH, CODES = 12, 10, 8, 16
STEPS = 2 * T - 1
LOSS_RTOL, PARAM_ATOL, PARAM_RTOL = 1e-4, 2e-5, 1e-5
CASES = {  # -> (mamba switches, gmm)
    "gmm_ln_act": ({"ln_act_enabled": True}, True),
    "gmm_lipvq": ({"vq_vae_enabled": True, "ln_act_enabled": False}, True),
    "nongmm_ln_act": ({"ln_act_enabled": True}, False),
}


def _config(factory, case: str):
    switches, gmm = CASES[case]
    cfg = factory("icl_mamba", {
        "train": {"max_grad_norm": 100.0, "seed": 3},
        "algo": {
            "optim_params": {"policy": {
                "optimizer_type": "adamw",
                "learning_rate": {"initial": 1e-3, "scheduler_type": "constant_with_warmup"},
                "regularization": {"L2": 0.01}}},
            "gmm": {"enabled": gmm},
            "loss": {"l2_weight": 1.0, "l1_weight": 0.5, "cos_weight": 0.3},
            "mamba": {"enabled": True, "supervise_all_steps": True, "pred_future_acs": True,
                      "embed_dim": 32, "num_layers": 2, "compute_dtype": "float32",
                      "emb_dropout": 0.0, **switches},
            "vq": {"num_codes": CODES},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = 2
    return cfg


def _batches(n, seed=11):
    rng = np.random.default_rng(seed)
    return [stack_collate([
        {"obs": {k: rng.standard_normal((STEPS, *s), dtype=np.float32)
                 for k, s in OBS_SHAPES.items()},
         "actions": rng.uniform(-1, 1, (STEPS, AC_DIM)).astype(np.float32)}
        for _ in range(BATCH)]) for _ in range(n)]


def _state_dict(jax_algo):
    state = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_algo.state.params))
    for tree in jax_algo.state.extra_vars.values():
        state.update(state_dict_from_jax_params(jax.tree.map(np.asarray, tree)))
    return state


def _spread_codebook(jax_algo, rng):
    """The codebook set to the latents of random actions (at random init
    every latent maps to one code)."""
    params = jax_algo.state.params
    tok = params["net"]["encoder"]["action_network"]
    codebook = JaxLipVQVAE(feature_dim=AC_DIM, latent_dim=tok["quantizer"]["codebook"].shape[1],
                           num_codes=CODES).apply(
        {"params": tok}, jnp.asarray(rng.uniform(-1, 1, (CODES, AC_DIM)).astype(np.float32)),
        method=JaxLipVQVAE.encode)
    params = {**params, "net": {**params["net"], "encoder": {
        **params["net"]["encoder"], "action_network": {**tok, "quantizer": {"codebook": codebook}}}}}
    jax_algo.state = jax_algo.state._replace(params=params, opt_state=jax_algo.tx.init(params))


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    case = request.param
    jax_algo = jax_algo_factory("icl_mamba", _config(jax_config_factory, case), OBS_SHAPES,
                                ac_dim=AC_DIM)
    if CASES[case][0].get("vq_vae_enabled"):
        _spread_codebook(jax_algo, np.random.default_rng(5))
    port = algo_factory("icl_mamba", _config(config_factory, case), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, jax_algo.state.params),
                    jax.tree.map(np.asarray, jax_algo.state.extra_vars))
    snaps = {}
    for step, raw in enumerate(_batches(3), start=1):
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)
        got = port.train_on_batch(port.process_batch_for_training(raw), 0)
        if step in (1, 3):
            snaps[step] = ({k: float(v) for k, v in want["losses"].items()},
                           {k: float(v) for k, v in got["losses"].items()},
                           _state_dict(jax_algo),
                           {k: v.clone() for k, v in port.nets.state_dict().items()})
    return case, port, snaps


@pytest.mark.parametrize("step", [1, 3])
def test_icl_mamba_train_step_matches_jax(trained, step):
    case, port, snaps = trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    assert isinstance(port, ICLMambaGMM if CASES[case][1] else ICLTransformer)
    assert isinstance(port.nets.net.transformer, MambaBackbone)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert set(got_sd) == set(want_sd)
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
    assert (port.vq_optimizer is not None) == ("lipvq" in case)
