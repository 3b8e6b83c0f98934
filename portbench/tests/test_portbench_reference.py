"""The plain reference agrees with the program in float32 at a small size on
the CPU: the served policy's GMM heads and K1 ids, one train step (losses,
the optimizer's first moments, the parameters), and corpus ids."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import program, weights
from portbench.harness.drivers.train import Items
from portbench.reference import icl as ref
from portbench.tests.tiny import MIXES, config


def _fp32(name):
    return config(name, compute_dtype="float32")


@pytest.mark.parametrize("name", ["icl_lipvq_lowdim", "icl_lipvq_image"])
def test_served_heads_and_ids(name):
    cfg = _fp32(name)
    w = weights.make(ref.param_specs(cfg), 5, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    algo = program.build_policy(cfg, w, 5, "cpu")
    g = torch.Generator().manual_seed(0)
    obs = [{k: torch.rand(4, 10, *s, generator=g) if len(s) == 3
            else torch.randn(4, 10, *s, generator=g) for k, s in cfg["obs"]} for _ in range(2)]
    acts = 0.5 * torch.randn(4, 10, cfg["ac_dim"], generator=g)
    seen = []
    algo.nets.net.encoder.action_network.quantizer.register_forward_hook(
        lambda m, i, o: seen.append(o[1]))
    with torch.no_grad():
        dists, _ = algo.nets.forward_train(obs[0], obs[1], acts, low_noise_eval=True)
        mean, _, logits, _, ids, _ = ref.policy_heads(w, cfg, obs[0], obs[1], acts)
    assert torch.equal(seen[0].long(), ids)
    assert len(torch.unique(ids)) > 4  # the seeded codebook spreads the ids
    # the image trunk's fp32 sums in another order, over 18 layers
    tol = 1e-4 if cfg["rgb_keys"] else 1e-5
    torch.testing.assert_close(dists.means, torch.tanh(mean), rtol=0, atol=tol)
    torch.testing.assert_close(dists.logits, logits, rtol=0, atol=tol)


def _first_step(cfg: dict, mix: dict, seed: int):
    """The program's and the reference's first train step on the same
    weights and items: (program's losses, reference's step, algo, weights,
    items, the batch's indices)."""
    ref = program.reference(cfg)
    w = weights.make(ref.param_specs(cfg), seed, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    algo = program.build_policy(cfg, w, seed, "cpu")
    program.take_up_schedule(algo, mix["schedule_step"])
    items = Items(cfg, mix, seed)
    idx = np.arange(mix["batch_size"])
    batch = algo.process_batch_for_training(
        {"obs": {k: np.stack([items[i]["obs"][k] for i in idx]) for k in items[0]["obs"]},
         "actions": np.stack([items[i]["actions"] for i in idx])})
    info = algo.train_on_batch(batch, 0)
    trainer = ref.Trainer(w, cfg, seed=seed, device="cpu", start=mix["schedule_step"])
    r = trainer.step(items.batch(idx, "cpu"))
    assert float(info["losses"]["action_loss"]) == pytest.approx(r["action_loss"], rel=1e-5)
    assert float(info["losses"]["vq_loss"]) == pytest.approx(r["vq_loss"], rel=1e-5)
    return trainer, r, algo, w, items, idx


# the image case with dropout 0: its trunks' train-mode BatchNorm amplifies
# rounding through the backward, and dropout's scaling by 1 / 0.9 more so;
# test_image_train_step_follows_crops_and_dropout covers it with dropout
TRAIN_CASES = {"icl_lipvq_lowdim": {},
               "icl_lipvq_image": {"emb_dropout": 0.0, "attn_dropout": 0.0,
                                   "block_output_dropout": 0.0}}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_step(name):
    cfg = config(name, compute_dtype="float32", **TRAIN_CASES[name])
    trainer, r, algo, w, items, idx = _first_step(cfg, MIXES["train"], 6)
    if not cfg["rgb_keys"]:
        # the published dropout is on, and the masks are the ones that count
        assert cfg["emb_dropout"] == cfg["attn_dropout"] == cfg["block_output_dropout"] == 0.1
        other = ref.Trainer(w, cfg, seed=7, device="cpu", start=MIXES["train"]["schedule_step"])
        other_loss = other.step(items.batch(idx, "cpu"))["action_loss"]
        assert abs(other_loss - r["action_loss"]) > 1e-4 * abs(r["action_loss"])
    beta1 = program.betas(algo)
    # fp32 sums in another order: each leaf within 1e-5 of its norm, 1e-4
    # with images; the trunks' leaves within 1e-2, as their train-mode
    # BatchNorm amplifies rounding through the backward
    for k, m in program.exp_avg(algo).items():
        tol = 1e-2 if "core_" in k else 1e-4 if cfg["rgb_keys"] else 1e-5
        diff = torch.linalg.vector_norm(m / (1 - beta1[k]) - r["grads"][k])
        assert diff <= tol * torch.linalg.vector_norm(r["grads"][k]) + 1e-6, k  # exact zeros
    state = algo.nets.state_dict()
    # with a trunk, an element whose gradient is near 0 may take Adam's first step
    # (+-lr) the other way
    lr = cfg["optimizer"]["lr"]
    for k, v in trainer.W.items():
        if not k.endswith((".mean", ".var")):  # BatchNorm's running statistics
            atol = 2.1 * lr if cfg["rgb_keys"] else 1e-5
            torch.testing.assert_close(state[k], v, rtol=0, atol=atol)


def test_image_train_step_follows_crops_and_dropout():
    """With the published dropout, the crops and the masks come from one
    generator in the forward's order: the losses agree, and every leaf
    outside the trunks within 1e-4 of its norm."""
    cfg = config("icl_lipvq_image", compute_dtype="float32")
    assert cfg["emb_dropout"] == 0.1
    _, r, algo, _, _, _ = _first_step(cfg, MIXES["train"], 6)
    beta1 = program.betas(algo)
    for k, m in program.exp_avg(algo).items():
        if "core_" not in k:
            diff = torch.linalg.vector_norm(m / (1 - beta1[k]) - r["grads"][k])
            assert diff <= 1e-4 * torch.linalg.vector_norm(r["grads"][k]) + 1e-6, k


def test_corpus_ids():
    from lipvq_tpu_torch.parallel.corpus import tokenize_array

    tok = config("icl_lipvq_lowdim")["corpus_tokenizer"]
    specs = ref.lipvq_specs("", tok["feature_dim"], tok["latent_dim"], tok["num_codes"],
                            tok["hidden_dim"])
    w = weights.make(specs, 7, "cpu", ref.lipvq_encode, codebooks=[""])
    model = program.build_tokenizer(tok, w, "cpu")
    x = (0.5 * np.random.default_rng(7).standard_normal((999, 12))).astype(np.float32)
    ids = torch.as_tensor(tokenize_array(model, x, device="cpu", chunk=256))
    z = ref.lipvq_encode(w, "", torch.as_tensor(x))
    assert ref.id_gap(z, w["quantizer.codebook"], ids) < 1e-5
    assert len(torch.unique(ids)) > 16
