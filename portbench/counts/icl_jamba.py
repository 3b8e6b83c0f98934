"""Analytic operation and byte counts of the ICL policy on the Jamba hybrid
backbone, from a configuration's shapes alone.

As ``flops.py``: products counted 2 per multiply-add, the weight gradient
of every product in a backward and the input gradient where the input needs
one; the tokenizer, the embeddings, the heads and K1 are the flagship's.
The backbone's parts are its matrix products (``backbone``: the Dense
layers and attention's two products over all 3T x 3T scores, as the plain
reference computes them, masked after) and the elementwise work of the
Mamba mixers (``ssm``: the depthwise convolution's products and the scan's
operations, ``scan``). No count depends on which kernels the program runs.
"""

from __future__ import annotations

import math

from portbench.counts.flops import k1, lipvq_rows  # noqa: F401  (k1 re-exported)

# the scan's operations per element (b, t, d, n), as ``scan`` derives them
SCAN_FWD_OPS = 7
SCAN_BWD_OPS = 23


def scan(b: int, t: int, d: int, n: int) -> dict:
    """The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t
    + D x_t over b sequences of t steps, d channels and n states, forward and
    backward, whatever implements it.

    ops, per element (b, t, d, n), each multiply, add and exponential one
    operation, a multiply-add two: forward 7 (dt A, its exponential, the
    update's multiply-add, dt B x, C . h's multiply-add); backward 23 (the
    forward's 5 to recompute the state, dh's multiply-add 2, dC's product 1,
    dB's product and sum 2, ddt's h A exp(dt A) + B x and its product with
    dh 5 and sum 1, dx's dt B dh 2 and sum 1, dA's product chain and sum 4,
    the carried exp(dt A) dh 1). Per-channel terms (dt x, D x) are left out.

    bytes, the least traffic of device memory in fp32: the forward reads x,
    dt, B and C and writes y; the backward reads x, dt, B, C and dy and
    writes dx, ddt, dB and dC; each tensor counted once (the backward's
    second read of the inputs is not required of an implementation that
    keeps them on chip), and A, D, dA and dD once each:
    4 (6 b t d + 4 b t n + 2 d n + 2 d)."""
    e = b * t * d * n
    return {"ops": (SCAN_FWD_OPS + SCAN_BWD_OPS) * e,
            "bytes": 4 * (6 * b * t * d + 4 * b * t * n + 2 * d * n + 2 * d)}


def _is_attention(cfg: dict, i: int) -> bool:
    period = cfg["attn_layer_period"]
    return period > 0 and i % period == cfg["attn_layer_offset"]


def policy(cfg: dict, b: int, train: bool = False) -> dict:
    """FLOPs of the policy on b query windows with b context windows of T
    steps: one forward (``train`` False) or one train step (b is then half
    the batch). Parts: trunk (none), backbone, ssm, tokenizer, heads, k1."""
    t, d = cfg["context_length"], cfg["embed_dim"]
    m, a = cfg["num_modes"], cfg["ac_dim"]
    lat = sum(math.prod(s) for _, s in cfg["obs"])
    rows = b * t
    s = 3 * t
    parts = {"trunk": 0, "backbone": 0, "ssm": 0, "tokenizer": 0, "heads": 0, "k1": 0}
    tok = lipvq_rows(a, lat, cfg["vq_hidden_dim"])
    first = 2 * a * 64  # enc1, whose input (the actions) needs no gradient
    parts["tokenizer"] = rows * ((3 * (tok["enc"] + tok["dec"]) - first) if train
                                 else tok["enc"] + tok["dec"])
    parts["k1"] = k1(rows, cfg["num_codes"], lat)["ops"]
    # three embedded streams whose inputs need no gradient
    emb = 2 * rows * lat * d
    parts["backbone"] = 3 * emb * (2 if train else 1)
    mult = 3 if train else 1
    nh, kvh = cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // nh
    di, n, r, f = cfg["expand"] * d, cfg["d_state"], cfg["dt_rank"], cfg["mlp_dim"]
    for i in range(cfg["num_layers"]):
        if _is_attention(cfg, i):
            proj = 2 * s * d * (2 * d + 2 * kvh * hd)
            att = 2 * 2 * nh * s * s * hd
            parts["backbone"] += b * (proj + att) * mult
        else:
            proj = 2 * s * (d * 2 * di + di * (r + 2 * n) + r * di + di * d)
            parts["backbone"] += b * proj * mult
            parts["ssm"] += b * 2 * s * di * cfg["d_conv"] * mult
            parts["ssm"] += (scan(b, s, di, n)["ops"] if train
                             else SCAN_FWD_OPS * b * s * di * n)
        parts["backbone"] += b * 3 * 2 * s * d * f * mult
    parts["heads"] = 2 * rows * d * (2 * m * a + m) * mult
    return parts

