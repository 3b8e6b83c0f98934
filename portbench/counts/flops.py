"""Analytic operation and byte counts, from a configuration's shapes alone.

Only products are counted, 2 per multiply-add: the matrix products of every
linear layer and of attention, the convolutions, and K1's distance products
2 B N D. A backward counts the weight gradient of every product and the
input gradient where the input needs one (not for the observations, the
context actions, or the codes, which reach the policy detached). No count
depends on which kernels the program runs, so a faster implementation of
the same work cannot raise it.
"""

from __future__ import annotations

import math


def _conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet18_frame(crop: int, lang: int, num_kp: int, features: int) -> dict:
    """Per frame: {"conv": FLOPs of the trunk's and the keypoints'
    convolutions, "first_conv": of the stem alone, "film": the FiLM layers'
    products, "proj": the keypoints' projection}."""
    conv = 0
    s = _conv_out(crop, 7, 2, 3)
    stem = 2 * 64 * s * s * 3 * 49
    conv += stem
    s = _conv_out(s, 3, 2, 1)  # max-pool
    width, film = 64, 0
    for stage, feats in enumerate((64, 128, 256, 512), 1):
        for b in range(2):
            stride = 2 if (stage > 1 and b == 0) else 1
            so = _conv_out(s, 3, stride, 1)
            conv += 2 * feats * so * so * width * 9 + 2 * feats * so * so * feats * 9
            if width != feats or stride != 1:
                conv += 2 * feats * so * so * width
            s, width = so, feats
        film += 2 * lang * 2 * feats
    conv += 2 * num_kp * s * s * 512
    return {"conv": conv, "first_conv": stem, "film": film, "proj": 2 * 2 * num_kp * features}


def lipvq_rows(feature: int, latent: int, hidden: int) -> dict:
    """Per row: the encoder's and the decoder's products."""
    enc = 2 * (feature * 64 + 64 * hidden + hidden * latent)
    dec = 2 * (latent * 64 + 64 * hidden + hidden * feature)
    return {"enc": enc, "dec": dec}


def k1(b: int, n: int, d: int) -> dict:
    """K1 over b rows, n codes of width d: products 2 b n d; bytes: z and the
    codebook read once (fp32), the ids written once (int32)."""
    return {"ops": 2 * b * n * d, "bytes": 4 * (b * d + n * d + b)}


def _obs_dim(cfg: dict) -> int:
    rgb = set(cfg.get("rgb_keys", ()))
    return sum(cfg["visual"]["feature_dimension"] if k in rgb else math.prod(s)
               for k, s in cfg["obs"])


def policy(cfg: dict, b: int, train: bool = False) -> dict:
    """FLOPs of the policy on b query windows with b context windows of T
    steps: one forward (``train`` False, the served request) or one train
    step (forward and backward; b is then half the batch). Parts: trunk,
    backbone, tokenizer, heads, k1."""
    t, d = cfg["context_length"], cfg["embed_dim"]
    m, a = cfg["num_modes"], cfg["ac_dim"]
    lat = _obs_dim(cfg)
    rows = b * t
    parts = {"trunk": 0, "backbone": 0, "tokenizer": 0, "heads": 0, "k1": 0}
    shapes = dict(cfg["obs"])
    for key in cfg.get("rgb_keys", ()):
        v = cfg["visual"]
        f = resnet18_frame(v["crop"], math.prod(shapes["lang_emb"]), v["num_kp"],
                           v["feature_dimension"])
        if train:
            # no input gradient for the stem (frames) or FiLM (lang_emb)
            per = 3 * (f["conv"] + f["proj"]) - f["first_conv"] + 2 * f["film"]
        else:
            per = f["conv"] + f["proj"] + f["film"]
        parts["trunk"] += 2 * rows * per
    tok = lipvq_rows(a, lat, cfg["vq_hidden_dim"])
    first = 2 * a * 64  # enc1, whose input (the actions) needs no gradient
    parts["tokenizer"] = rows * ((3 * (tok["enc"] + tok["dec"]) - first) if train
                                 else tok["enc"] + tok["dec"])
    parts["k1"] = k1(rows, cfg["num_codes"], lat)["ops"]
    # three embedded streams; their inputs need no gradient in the low-dim
    # policy, and the query and context features do where a trunk makes them
    emb = 2 * rows * lat * d
    trunk_grad = bool(cfg.get("rgb_keys"))
    parts["backbone"] = 3 * emb + ((3 * emb + 2 * emb * trunk_grad) if train else 0)
    s = 3 * t
    layer = b * (2 * s * d * 3 * d + 2 * 2 * s * s * d + 2 * s * d * d + 2 * 2 * s * d * 4 * d)
    parts["backbone"] += cfg["num_layers"] * layer * (3 if train else 1)
    parts["heads"] = 2 * rows * d * (2 * m * a + m) * (3 if train else 1)
    return parts


def corpus_call(tok: dict, rows: int) -> dict:
    """FLOPs of one tokenization of ``rows`` action rows: encoder + K1."""
    enc = lipvq_rows(tok["feature_dim"], tok["latent_dim"], tok["hidden_dim"])["enc"]
    return {"tokenizer": rows * enc,
            "k1": k1(rows, tok["num_codes"], tok["latent_dim"])["ops"]}
