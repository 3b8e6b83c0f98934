"""Faults planted in the timed path underneath the harness, each a context
manager: the check of a cell that can have the fault has to come out not
correct. ``tests/test_portbench_faults.py`` plants them in tiny cells on
the CPU; ``control.py --reading fault:<name>`` reads one at a cell's own
size on the card."""

from __future__ import annotations

import contextlib

import torch


def _farthest(codebook, i: int) -> int:
    """The code farthest from code ``i``: a token that is surely wrong."""
    c = codebook.detach().float()
    return int(((c - c[i]) ** 2).sum(1).argmax())


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def altered_action():
    """A served action altered where ``get_action`` produces it."""
    from lipvq_tpu_torch.algo.icl import ICLTransformerGMM

    def make(orig):
        def get_action(self, *a, **k):
            out = orig(self, *a, **k)
            out[0, 0] += 0.25
            return out
        return get_action

    return _patched(ICLTransformerGMM, "get_action", make)


def altered_id():
    """A K1 id altered where the quantizer produces it: the first row's id
    becomes the code farthest from it."""
    from lipvq_tpu_torch.models.tokenizers.lipvq import LFQQuantizer

    def make(orig):
        def forward(self, z_e):
            _, ids = orig(self, z_e)
            ids = ids.clone()
            ids[0] = _farthest(self.codebook, int(ids[0]))
            return self.codebook[ids], ids
        return forward

    return _patched(LFQQuantizer, "forward", make)


def state_unchanged():
    """A step that returns its state unchanged: no optimizer steps."""
    from lipvq_tpu_torch.algo.base import ScheduledOptimizer

    return _patched(ScheduledOptimizer, "step", lambda orig: lambda self: None)


def half_batch():
    """Half of the batch left out, the mean taken over the rest: a quarter
    of the contexts and the same quarter of the queries."""
    from lipvq_tpu_torch.algo.icl import ICLTransformerGMM

    def make(orig):
        def train_on_batch(self, batch, epoch, validate=False):
            rows = batch["actions"].shape[0]
            h = rows // 2
            keep = torch.cat([torch.arange(h // 2), h + torch.arange(h // 2)]).to(
                batch["actions"].device)

            def cut(tree):
                if isinstance(tree, dict):
                    return {k: cut(v) for k, v in tree.items()}
                return None if tree is None else tree[keep]

            return orig(self, cut(batch), epoch, validate=validate)
        return train_on_batch

    return _patched(ICLTransformerGMM, "train_on_batch", make)


def altered_corpus_id():
    """A corpus id altered where ``tokenize_array`` produces it: the first
    row's id becomes the code farthest from it."""
    from lipvq_tpu_torch.parallel import corpus

    def make(orig):
        def tokenize_array(model, actions, **k):
            ids = orig(model, actions, **k)
            ids[0] = _farthest(model.quantizer.codebook, int(ids[0]))
            return ids
        return tokenize_array

    return _patched(corpus, "tokenize_array", make)


# the faults each mix kind can have on one chip (no exchange between chips)
BY_KIND = {
    "closed_loop": [altered_action, altered_id],
    "train": [state_unchanged, half_batch],
    "corpus": [altered_corpus_id],
}
