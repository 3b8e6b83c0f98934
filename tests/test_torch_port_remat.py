"""``remat`` in the port's GPT backbone (flax ``nn.remat`` in the JAX
package): the blocks' activations are recomputed in the backward, with the
dropout masks of the forward replayed from the explicit generator. With
dropout 0.1 the outputs, every gradient and the generator's final state
equal those of the same step without remat, bit for bit (the recomputation
repeats the same ops on the same inputs); the ICL algo that raised for
``transformer.remat`` trains with it, and its fp32 step matches the JAX
step with ``nn.remat`` (losses rtol 1e-5, parameters atol 2e-5 + rtol
1e-5, as tests/test_torch_port_train.py holds the step without it)."""

import jax
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.transformer import GPTBackbone
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params

torch.set_num_threads(1)


def _step(remat: bool, train: bool = True):
    net = GPTBackbone(32, 12, causal=True, attn_dropout=0.1, block_output_dropout=0.1,
                      num_layers=3, num_heads=4, remat=remat)
    seeded_init(net, torch.Generator().manual_seed(0))
    x = torch.randn(5, 12, 32, generator=torch.Generator().manual_seed(1), requires_grad=True)
    gen = torch.Generator().manual_seed(2)
    y = net(x, train=train, generator=gen)
    (y ** 2).sum().backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    return y.detach(), x.grad.clone(), grads, gen.get_state()


@pytest.mark.parametrize("train", [True, False], ids=["dropout", "eval"])
def test_remat_gradients_equal_the_plain_backward(train):
    plain, remat = _step(False, train), _step(True, train)
    assert torch.equal(plain[0], remat[0])
    assert torch.equal(plain[1], remat[1])
    assert plain[2].keys() == remat[2].keys()
    for name in plain[2]:
        assert torch.equal(plain[2][name], remat[2][name]), name
    assert torch.equal(plain[3], remat[3])  # the forward's draws, once


def test_remat_replays_the_forward_masks():
    """Without the replay the recomputed block would draw fresh masks: the
    gradients would then differ from the plain backward."""
    net = GPTBackbone(32, 12, attn_dropout=0.5, block_output_dropout=0.5, num_layers=1,
                      num_heads=4, remat=True)
    seeded_init(net, torch.Generator().manual_seed(0))
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    calls = []
    draw = torch.rand

    def counted(*a, **kw):
        calls.append(kw.get("generator").get_state().clone())
        return draw(*a, **kw)

    torch.rand = counted
    try:
        net(x, train=True, generator=gen).sum().backward()
    finally:
        torch.rand = draw
    # 3 dropout draws in the forward and the same 3 from the same states again
    assert len(calls) == 6
    for a, b in zip(calls[:3], calls[3:]):
        assert torch.equal(a, b)


def _icl_config(factory, remat):
    cfg = factory("icl", {
        "train": {"max_grad_norm": 100.0, "seed": 1},
        "algo": {
            "optim_params": {"policy": {"optimizer_type": "adamw",
                                        "learning_rate": {"initial": 1e-3,
                                                          "scheduler_type": "constant"},
                                        "regularization": {"L2": 0.01}}},
            "gmm": {"enabled": True},
            "transformer": {"enabled": True, "supervise_all_steps": True,
                            "pred_future_acs": True, "causal": False, "embed_dim": 32,
                            "num_layers": 2, "num_heads": 4, "vq_vae_enabled": False,
                            "bin_enabled": True, "ln_act_enabled": False,
                            "compute_dtype": "float32", "remat": remat,
                            "emb_dropout": 0.0, "attn_dropout": 0.0,
                            "block_output_dropout": 0.0},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = ["robot0_eef_pos", "object"]
    return cfg


def test_icl_algo_trains_with_remat_as_jax_does():
    shapes = {"robot0_eef_pos": [3], "object": [14]}
    jax_algo = jax_algo_factory("icl", _icl_config(jax_config_factory, True), shapes, ac_dim=7)
    port = algo_factory("icl", _icl_config(config_factory, True), shapes, ac_dim=7,
                        device="cpu")
    assert port.nets.net.transformer.remat
    load_jax_params(port, jax.tree.map(np.asarray, jax_algo.state.params),
                    jax.tree.map(np.asarray, jax_algo.state.extra_vars))
    rng = np.random.default_rng(0)
    raw = {"obs": {k: rng.standard_normal((4, 19, *s), dtype=np.float32)
                   for k, s in shapes.items()},
           "actions": rng.uniform(-1, 1, (4, 19, 7)).astype(np.float32)}
    for _ in range(2):
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)["losses"]
        got = port.train_on_batch(port.process_batch_for_training(raw), 0)["losses"]
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    want_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_algo.state.params))
    for tree in jax_algo.state.extra_vars.values():
        want_sd.update(state_dict_from_jax_params(jax.tree.map(np.asarray, tree)))
    got_sd = port.nets.state_dict()
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=2e-5, rtol=1e-5,
                                   err_msg=k)
