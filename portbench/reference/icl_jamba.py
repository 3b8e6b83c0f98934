"""Plain reference of the ICL GMM policy on a Jamba hybrid backbone, with the
LipVQ-VAE action tokenizer.

Written from the published description of Jamba (AI21's "Jamba: A Hybrid
Transformer-Mamba Language Model" and the Jamba2-3B ``config.json``) and of
Mamba-1 (Gu and Dao, "Mamba: Linear-Time Sequence Modeling with Selective
State Spaces"), in plain PyTorch over a dict of named tensors. It imports no
module of the program under test. The tokenizer, the embedding, the GMM
loss, AdamW, the schedule and the random draws are the flagship
reference's (``icl.py``).

- Layer i is attention where i % attn_layer_period == attn_layer_offset and
  a Mamba-1 mixer elsewhere; x = x + mixer(RMSNorm(x)), then x = x +
  MLP(RMSNorm(x)); a final RMSNorm. RMSNorm: x / sqrt(mean(x^2) + eps) * w.
- Mamba-1 mixer: in_proj (no bias) -> x, z; a causal depthwise convolution
  of width d_conv with bias (``F.conv1d``, groups = d_inner, left padding
  d_conv - 1) -> SiLU -> x_proj (no bias) -> dt [dt_rank], B, C [d_state];
  RMSNorm on each of dt, B and C; dt = softplus(dt_proj(dt)) (with bias);
  A = -exp(A_log); the scan by its definition, one step after another:
  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t + D x_t; then
  y * SiLU(z) -> out_proj (no bias).
- Attention: q [heads x head_dim], k and v [kv_heads x head_dim], each key
  and value head repeated for its group of query heads, no biases, no
  positions, causal softmax(q k^T / sqrt(head_dim)) v -> o_proj.
- MLP: down_proj(SiLU(gate_proj(x)) * up_proj(x)), no biases.
- Departures from the published model, as in the program: the token
  embedding and the LM head give way to the ICL composite's embedding and
  GMM heads; the 3T interleaved tokens run causally, the query tokens
  last; no dropout inside the backbone (Jamba's attention dropout is 0).

Training: the step of ``icl.py`` (one backward, the policy's gradients
clipped to a global norm, AdamW on the policy and on the tokenizer), with
the policy computed in micro-batches of ``MICRO`` context-query pairs so
that it fits on the card beside the freed program: the tokenizer runs on the
whole batch once, the embeddings' dropout masks are drawn for the whole
batch in the order of the program's forward (query, context observations,
context actions), and each micro-batch's loss is weighted by its share of
the rows, so the loss and the gradients are those of the whole batch.

Precision: float32 with TF32 off (``set_fp32``); ``Lower`` gives the
control, as in ``icl.py``: the Dense layers on float8 operands, TF32
elsewhere.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.icl import (  # noqa: F401  (re-exported for the harness)
    TOK,
    AdamW,
    Draws,
    Lower,
    _is_buffer,
    dense,
    gmm_nll,
    latent_dim,
    linear,
    lipvq_decode,
    lipvq_encode,
    lipvq_specs,
    lr_schedule,
    nearest,
    set_fp32,
    split_batch,
)
from portbench.reference.icl import layer_norm as _layer_norm

# the fault of this configuration's scan joins ``faults.py``'s, where
# ``control.py`` finds it (``drivers/train_ssm.py``; the harness, not the program)
from portbench.harness.drivers import train_ssm as _train_ssm  # noqa: E402,F401

MICRO = 16  # context-query pairs per micro-batch of the training step
BB = "net.transformer."


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def is_attention(cfg: dict, i: int) -> bool:
    period = cfg["attn_layer_period"]
    return period > 0 and i % period == cfg["attn_layer_offset"]


def selective_scan(x, dt, A, B, C, D):
    """x, dt [b, t, d]; A [d, n]; B, C [b, t, n]; D [d] -> y [b, t, d], one
    step after another."""
    h = torch.zeros(x.shape[0], x.shape[2], A.shape[1], dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * x[:, t])[:, :, None] * B[:, t, None]
        ys.append((h * C[:, t, None]).sum(-1))
    return torch.stack(ys, 1) + x * D


def mamba_mixer(W: dict, p: str, cfg: dict, x, lower):
    n, r, k = cfg["d_state"], cfg["dt_rank"], cfg["d_conv"]
    eps = cfg["norm_eps"]
    xs, z = dense(x, W[p + "in_proj.weight"], None, lower).chunk(2, dim=-1)
    di = xs.shape[-1]
    xs = F.conv1d(F.pad(xs.transpose(1, 2), (k - 1, 0)), W[p + "conv_kernel"].t()[:, None, :],
                  W[p + "conv_bias"], groups=di).transpose(1, 2)
    xs = F.silu(xs)
    dt, B, C = dense(xs, W[p + "x_proj.weight"], None, lower).split([r, n, n], dim=-1)
    dt = rms_norm(dt, W[p + "dt_norm.weight"], eps)
    B = rms_norm(B, W[p + "b_norm.weight"], eps)
    C = rms_norm(C, W[p + "c_norm.weight"], eps)
    dt = F.softplus(dense(dt, W[p + "dt_proj.weight"], W[p + "dt_proj.bias"], lower))
    y = selective_scan(xs, dt, -torch.exp(W[p + "A_log"]), B, C, W[p + "D"])
    return dense(y * F.silu(z), W[p + "out_proj.weight"], None, lower)


def attention(W: dict, p: str, cfg: dict, x, lower):
    b, t, d = x.shape
    nh, kvh = cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // nh
    q = dense(x, W[p + "q_proj.weight"], None, lower).reshape(b, t, nh, hd).transpose(1, 2)
    k, v = (dense(x, W[p + f"{s}_proj.weight"], None, lower).reshape(b, t, kvh, hd)
            .transpose(1, 2).repeat_interleave(nh // kvh, dim=1) for s in "kv")
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
    y = (att @ v).transpose(1, 2).reshape(b, t, d)
    return dense(y, W[p + "o_proj.weight"], None, lower)


def mlp(W: dict, p: str, x, lower):
    g = dense(x, W[p + "gate_proj.weight"], None, lower)
    u = dense(x, W[p + "up_proj.weight"], None, lower)
    return dense(F.silu(g) * u, W[p + "down_proj.weight"], None, lower)


def backbone(W: dict, cfg: dict, x, lower):
    eps = cfg["norm_eps"]
    for i in range(cfg["num_layers"]):
        h = rms_norm(x, W[f"{BB}ln_{i}.weight"], eps)
        if is_attention(cfg, i):
            x = x + attention(W, f"{BB}attn_{i}.", cfg, h, lower)
        else:
            x = x + mamba_mixer(W, f"{BB}mamba_{i}.", cfg, h, lower)
        x = x + mlp(W, f"{BB}mlp_{i}.", rms_norm(x, W[f"{BB}mlp_ln_{i}.weight"], eps), lower)
    return rms_norm(x, W[BB + "out_ln.weight"], eps)


def embed(W: dict, feats, keep=None, p: float = 0.0):
    """Linear + timestep offset + LayerNorm; with ``keep`` (uniform draws of
    the output's shape) dropout at rate ``p``."""
    e = linear(feats, W["net.embed_encoder.weight"], W["net.embed_encoder.bias"])
    e = _layer_norm(e + W["net.embed_timestep"], W["net.embed_ln.weight"], W["net.embed_ln.bias"])
    if keep is None or p == 0.0:
        return e
    return torch.where(keep < 1.0 - p, e / (1.0 - p), torch.zeros((), dtype=e.dtype,
                                                                  device=e.device))


def tokenize(W: dict, ctx_actions):
    """Context actions [B, T, A] -> (codes [B, T, L], tokenizer loss, ids)."""
    b, t = ctx_actions.shape[:2]
    x = ctx_actions.reshape(b * t, -1)
    z = lipvq_encode(W, TOK, x)
    codebook = W[TOK + "quantizer.codebook"]
    ids = nearest(z, codebook)
    zq = codebook[ids]
    aux = (((lipvq_decode(W, TOK, zq) - x) ** 2).mean() + 0.25 * ((zq.detach() - z) ** 2).mean()
           + 0.25 * ((zq - z.detach()) ** 2).mean())
    return zq.reshape(b, t, -1), aux, ids


def policy_heads(W: dict, cfg: dict, obs_f, ctx_obs_f, codes, lower=None, keeps=(None,) * 3):
    """Query and context observation features [B, T, F] and the context
    codes [B, T, L] -> (raw means [B, T, M, A], raw scales, logits [B, T, M]);
    ``keeps`` the three embeddings' dropout draws (training)."""
    b, t = codes.shape[:2]
    m, a, d = cfg["num_modes"], cfg["ac_dim"], cfg["embed_dim"]
    p = cfg["emb_dropout"]
    qe = embed(W, obs_f, keeps[0], p)
    ce = embed(W, ctx_obs_f, keeps[1], p)
    ae = embed(W, codes.detach(), keeps[2], p)
    tokens = torch.cat([torch.stack([ce, ae], dim=2).reshape(b, 2 * t, d), qe], dim=1)
    hidden = backbone(W, cfg, tokens, lower)[:, -t:]
    heads = [linear(hidden, W[f"net.decoder.head_{h}.weight"], W[f"net.decoder.head_{h}.bias"])
             for h in ("mean", "scale", "logits")]
    return heads[0].reshape(b, t, m, a), heads[1].reshape(b, t, m, a), heads[2]


def _features(obs: dict, cfg: dict):
    """Low-dim observation leaves [B, T, ...] -> [B, T, F], keys in order."""
    return torch.cat([obs[k].reshape(*obs[k].shape[:2], -1) for k in cfg["obs_keys"]], dim=-1)


class Trainer:
    """The reference's train state: its own copy of the weights and both
    optimizers' moments."""

    def __init__(self, W: dict, cfg: dict, lower: Lower | None = None, seed: int = 0,
                 device="cpu", start: int = 0, micro: int = MICRO):
        self.cfg, self.lower, self.micro = cfg, lower, micro
        self.draws = Draws(seed, device)
        self.W = {k: v.detach().clone() for k, v in W.items()}
        self.tok = {k: v for k, v in self.W.items() if k.startswith(TOK)}
        self.pol = {k: v for k, v in self.W.items()
                    if not k.startswith(TOK) and not _is_buffer(k)}
        opt, vq = cfg["optimizer"], cfg["vq_optimizer"]
        self.pol_opt = AdamW(self.pol, lr_schedule(opt, start), float(opt["L2"]))
        self.tok_opt = AdamW(self.tok, lambda step: float(vq["lr"]), float(vq["wd"]))
        self.max_norm = float(opt["max_grad_norm"])

    def step(self, batch: dict) -> dict:
        """One step on a batch of items; returns the losses and the gradients
        the optimizers were given (the policy's after the clip)."""
        cfg = self.cfg
        qry, ctx, ctx_act, target = split_batch(batch, cfg["context_length"])
        b, t = ctx_act.shape[:2]
        for v in self.tok.values():
            v.requires_grad_(True)
        codes, aux, _ = tokenize(self.W, ctx_act)
        tok_names = list(self.tok)
        grads = dict(zip(tok_names, torch.autograd.grad(aux, [self.W[k] for k in tok_names])))
        for v in self.tok.values():
            v.requires_grad_(False)
        codes = codes.detach()
        keeps = [torch.rand((b, t, cfg["embed_dim"]), generator=self.draws.gen,
                            device=codes.device) for _ in range(3)]
        obs_f, ctx_f = _features(qry, cfg), _features(ctx, cfg)
        names = list(self.pol)
        params = [self.W[k] for k in names]
        for v in params:
            v.requires_grad_(True)
        action_loss = 0.0
        pol_grads = [torch.zeros_like(v) for v in params]
        for r0 in range(0, b, self.micro):
            r = slice(r0, min(r0 + self.micro, b))
            mean, scale, logits = policy_heads(self.W, cfg, obs_f[r], ctx_f[r], codes[r],
                                               self.lower, [k[r] for k in keeps])
            loss = gmm_nll(mean, scale, logits, target[r], cfg["min_std"]) * (
                (r.stop - r.start) / b)
            for acc, g in zip(pol_grads, torch.autograd.grad(loss, params, allow_unused=True)):
                if g is not None:
                    acc += g
            action_loss += float(loss.detach())
        for v in params:
            v.requires_grad_(False)
        grads.update(zip(names, pol_grads))
        norm = torch.sqrt(sum((grads[k].double() ** 2).sum() for k in self.pol)).float()
        if norm >= self.max_norm:
            for k in self.pol:
                grads[k] = grads[k] * (self.max_norm / norm)
        self.pol_opt.step(grads)
        self.tok_opt.step(grads)
        return {"action_loss": action_loss, "vq_loss": float(aux.detach()), "grads": grads}


# -- the configuration ---------------------------------------------------------
# options of the configuration's mamba section that this reference follows,
# and the values it follows them at
FOLLOWS = {"enabled": True, "causal": True, "supervise_all_steps": True,
           "pred_future_acs": True, "vq_vae_enabled": True, "ln_act_enabled": False,
           "fast_enabled": False, "bin_enabled": False, "sinusoidal_embedding": False,
           "nn_parameter_for_timesteps": True}
HYBRID_FOLLOWS = {"norm": "rms", "dt_bc_norm": True}


def view(cfg: dict) -> dict:
    """The sizes, rates and options of a configuration file, read from its
    ``port_config`` (``algo.mamba`` and its ``hybrid`` sub-section) as flat
    keys: those of ``icl.view`` and ``d_state``, ``d_conv``, ``expand``,
    ``dt_rank``, ``attn_layer_period``, ``attn_layer_offset``,
    ``num_kv_heads``, ``mlp_dim`` and ``norm_eps``. Raises where the
    configuration asks for an option that this reference does not follow."""
    pc = cfg["port_config"]
    algo = pc["algo"]
    s = algo["mamba"]
    hy = s.get("hybrid", {})
    if cfg["algo"] != "icl_mamba" or not algo["gmm"]["enabled"]:
        raise ValueError("the icl_jamba reference follows the ICL GMM policy on icl_mamba only")
    for k, v in FOLLOWS.items():
        if s.get(k, v) != v:
            raise ValueError(f"the icl_jamba reference follows mamba.{k} = {v!r} only")
    for k, v in HYBRID_FOLLOWS.items():
        if hy.get(k) != v:
            raise ValueError(f"the icl_jamba reference follows mamba.hybrid.{k} = {v!r} only")
    if not hy.get("mlp_dim") or not hy.get("attn_layer_period"):
        raise ValueError("the icl_jamba reference follows an MLP after each mixer and "
                         "attention layers only")
    if algo["vq"].get("ema_codebook", False):
        raise ValueError("the icl_jamba reference follows the loss codebook only")
    if pc["observation"]["modalities"]["obs"].get("rgb", []):
        raise ValueError("the icl_jamba reference follows low-dim observations only")
    pol = algo["optim_params"]["policy"]
    if pol["optimizer_type"] != "adamw":
        raise ValueError("the icl_jamba reference follows AdamW only")
    lr = pol["learning_rate"]
    out = dict(cfg)
    d = s["embed_dim"]
    out.update(
        context_length=s["context_length"], embed_dim=d, num_layers=s["num_layers"],
        num_heads=s["num_heads"], emb_dropout=s["emb_dropout"],
        d_state=s["d_state"], d_conv=s["d_conv"], expand=s["expand"],
        dt_rank=hy.get("dt_rank") or math.ceil(d / 16),
        attn_layer_period=hy["attn_layer_period"],
        attn_layer_offset=hy.get("attn_layer_offset", 0),
        num_kv_heads=hy.get("num_kv_heads", 1), mlp_dim=hy["mlp_dim"],
        norm_eps=hy.get("norm_eps", 1e-6),
        num_modes=algo["gmm"]["num_modes"], min_std=algo["gmm"]["min_std"],
        num_codes=algo["vq"]["num_codes"], vq_hidden_dim=algo["vq"]["hidden_dim"],
        frame_stack=pc["train"]["frame_stack"],
        optimizer={"lr": lr["initial"], "scheduler_type": lr["scheduler_type"],
                   "num_warmup_steps": cfg["num_warmup_steps"],
                   "L2": pol["regularization"]["L2"],
                   "max_grad_norm": pc["train"]["max_grad_norm"]},
        vq_optimizer={"lr": algo["vq"]["optimizer_lr"], "wd": algo["vq"]["optimizer_wd"]})
    return out


# -- the parameter layout -------------------------------------------------------
def param_specs(cfg: dict) -> list:
    """[(name, shape, kind)] of every parameter of the policy, named as the
    program names them; kinds of ``harness/weights.py``. The cell's driver
    then sets each mixer's ``A_log`` and ``dt_proj.bias`` as Mamba
    initializes them (``drivers/train_ssm.py::published_ssm``)."""
    d, t = cfg["embed_dim"], cfg["context_length"]
    m, a = cfg["num_modes"], cfg["ac_dim"]
    n, r, k = cfg["d_state"], cfg["dt_rank"], cfg["d_conv"]
    di, kvd, f = cfg["expand"] * d, cfg["num_kv_heads"] * (d // cfg["num_heads"]), cfg["mlp_dim"]
    lat = latent_dim(cfg)
    out = lipvq_specs(TOK, a, lat, cfg["num_codes"], cfg["vq_hidden_dim"])
    out += [("net.embed_encoder.weight", (d, lat), "fan_in"),
            ("net.embed_encoder.bias", (d,), "small"),
            ("net.embed_ln.weight", (d,), "one"), ("net.embed_ln.bias", (d,), "small"),
            ("net.embed_timestep", (1, t, d), "gpt")]
    for i in range(cfg["num_layers"]):
        out.append((f"{BB}ln_{i}.weight", (d,), "one"))
        if is_attention(cfg, i):
            p = f"{BB}attn_{i}."
            out += [(p + "q_proj.weight", (d, d), "gpt"), (p + "k_proj.weight", (kvd, d), "gpt"),
                    (p + "v_proj.weight", (kvd, d), "gpt"), (p + "o_proj.weight", (d, d), "gpt")]
        else:
            p = f"{BB}mamba_{i}."
            out += [(p + "conv_kernel", (k, di), "small"), (p + "conv_bias", (di,), "small"),
                    (p + "A_log", (di, n), "small"), (p + "D", (di,), "one"),
                    (p + "in_proj.weight", (2 * di, d), "gpt"),
                    (p + "x_proj.weight", (r + 2 * n, di), "gpt"),
                    (p + "dt_proj.weight", (di, r), "gpt"), (p + "dt_proj.bias", (di,), "small"),
                    (p + "out_proj.weight", (d, di), "gpt"),
                    (p + "dt_norm.weight", (r,), "one"), (p + "b_norm.weight", (n,), "one"),
                    (p + "c_norm.weight", (n,), "one")]
        p = f"{BB}mlp_{i}."
        out += [(f"{BB}mlp_ln_{i}.weight", (d,), "one"),
                (p + "gate_proj.weight", (f, d), "gpt"), (p + "up_proj.weight", (f, d), "gpt"),
                (p + "down_proj.weight", (d, f), "gpt")]
    out.append((BB + "out_ln.weight", (d,), "one"))
    for head, width in (("mean", m * a), ("scale", m * a), ("logits", m)):
        out += [(f"net.decoder.head_{head}.weight", (width, d), "fan_in"),
                (f"net.decoder.head_{head}.bias", (width,), "small")]
    return out
