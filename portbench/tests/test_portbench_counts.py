"""The analytic FLOP counts of ``counts/flops.py`` equal what
``FlopCounterMode`` counts over the plain reference at a small size: the
served forward and the train step of both configurations, and a corpus
call. The counts depend on shapes only, never on the program's ops."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import flops
from portbench.harness import weights
from portbench.reference import icl as ref
from portbench.tests.tiny import config

B, T = 3, 10


def _obs(cfg, n, steps=T):
    return {k: torch.rand(n, steps, *s) if len(s) == 3 else torch.randn(n, steps, *s)
            for k, s in cfg["obs"]}


@pytest.mark.parametrize("name", ["icl_lipvq_lowdim", "icl_lipvq_image"])
def test_served_forward(name):
    cfg = config(name)
    w = weights.make(ref.param_specs(cfg), 1, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.policy_heads(w, cfg, _obs(cfg, B), _obs(cfg, B), torch.randn(B, T, cfg["ac_dim"]))
    assert fc.get_total_flops() == sum(flops.policy(cfg, B).values())


@pytest.mark.parametrize("name", ["icl_lipvq_lowdim", "icl_lipvq_image"])
def test_train_step(name):
    cfg = config(name)
    w = weights.make(ref.param_specs(cfg), 2, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    trainer = ref.Trainer(w, cfg)
    steps = 2 * T - 1
    batch = {"obs": _obs(cfg, 2 * B, steps), "actions": torch.randn(2 * B, steps, cfg["ac_dim"])}
    with FlopCounterMode(display=False) as fc:
        trainer.step(batch)
    assert fc.get_total_flops() == sum(flops.policy(cfg, B, train=True).values())


def test_corpus_call():
    tok = config("icl_lipvq_lowdim")["corpus_tokenizer"]
    specs = ref.lipvq_specs("", tok["feature_dim"], tok["latent_dim"], tok["num_codes"],
                            tok["hidden_dim"])
    w = weights.make(specs, 3, "cpu", ref.lipvq_encode, codebooks=[""])
    x = torch.randn(100, tok["feature_dim"])
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.nearest(ref.lipvq_encode(w, "", x), w["quantizer.codebook"])
    assert fc.get_total_flops() == sum(flops.corpus_call(tok, 100).values())


def test_k1_bound_counts_the_work_once():
    c = flops.k1(8, 4, 2)
    assert c["ops"] == 2 * 8 * 4 * 2
    assert c["bytes"] == 4 * (8 * 2 + 4 * 2 + 8)
