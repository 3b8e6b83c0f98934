"""Plain reference of the ICL GMM policy with the LipVQ-VAE action tokenizer.

Written from the model's description (the in-context imitation policy of
"Action Tokenizer Matters in In-Context Imitation Learning" and its robomimic
configuration), in plain PyTorch over a dict of named tensors. It imports no
module of the program under test.

- LipVQ encoder: Linear(A, 64) -> GELU -> Linear(64, H) -> GELU -> Lipschitz
  linear (each weight row scaled by min(1, softplus(ci) / sum|row|)) ->
  sigmoid; the nearest code by squared L2 distance, worked out in float64.
- Image trunk: ResNet-18, FiLM after each stage from ``lang_emb``,
  spatial-softmax keypoints, a linear layer and ReLU; served: the centre
  crop and BatchNorm from its running statistics; in training: a random
  crop per frame and BatchNorm over the batch.
- Policy: the observation features of the query and context windows and
  the context actions' codes, each embedded (Linear + timestep offset +
  LayerNorm), interleaved [ctx_obs_t, ctx_act_t]... then the query tokens; a
  pre-LN GPT (bidirectional attention, GELU MLP 4x); GMM heads on the last
  T tokens: tanh means, softplus scales + min_std (1e-4 at low-noise eval),
  logits. In training, dropout after each embedding's LayerNorm, on the
  attention weights, after the attention's output Dense and after the MLP.
- Training's random draws (``Draws``): the configuration's rule gives the
  crops and the dropout masks one ``torch.Generator`` on the device, seeded
  with the train seed + 1; the crop offsets are uniform integers, a mask
  keeps an element where a uniform draw of its shape lies under 1 - p and
  scales it by 1 / (1 - p). The draws come in the order of the forward:
  the query's crops, the context's, then the embeddings (query, context
  observations, context actions) and the blocks.
- Loss: the mean GMM negative log-likelihood of the query actions plus the
  tokenizer's recon + 0.25 commit + 0.25 codebook loss; the codes reach the
  policy detached.
- Train step: one backward; the policy's gradients clipped to a global norm,
  AdamW on the policy (its rate from the schedule: a linear warm-up from 0
  to the initial rate, then constant) and AdamW on the tokenizer, written
  out here.

``view`` reads the sizes, rates and options from a configuration file's
``port_config`` (the robomimic config's keys) and refuses a configuration
whose options this reference does not follow.

Precision: float32 with TF32 off (``set_fp32``). ``Lower`` gives the control:
the backbone's Dense layers on per-tensor scaled float8 (e4m3) operands,
and TF32 for every other float32 product on the card.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
BN_EPS = 1e-5


def set_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Lower:
    """The control's precision: Dense operands in float8 e4m3 with a
    per-tensor scale (straight-through in a backward), TF32 elsewhere."""

    def __init__(self, dense_fp8: bool = True, tf32: bool = True):
        self.dense_fp8, self.tf32 = dense_fp8, tf32

    @contextlib.contextmanager
    def scope(self):
        before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def dense(x, w, b, lower: Lower | None):
    if lower is not None and lower.dense_fp8:
        x, w = _fp8(x), _fp8(w)
    return linear(x, w, b)


def layer_norm(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


# -- the LipVQ tokenizer ------------------------------------------------------
def lipvq_encode(W: dict, p: str, x):
    h = gelu(linear(x, W[p + "enc1.weight"], W[p + "enc1.bias"]))
    h = gelu(linear(h, W[p + "enc2.weight"], W[p + "enc2.bias"]))
    w = W[p + "to_latent.W"]
    scale = torch.clamp(F.softplus(W[p + "to_latent.ci"])[:, None] / w.abs().sum(1, keepdim=True),
                        max=1.0)
    return torch.sigmoid(linear(h, w * scale, W[p + "to_latent.b"]))


def lipvq_decode(W: dict, p: str, zq):
    h = gelu(linear(zq, W[p + "dec1.weight"], W[p + "dec1.bias"]))
    h = gelu(linear(h, W[p + "dec2.weight"], W[p + "dec2.bias"]))
    return linear(h, W[p + "to_output.weight"], W[p + "to_output.bias"])


def distances(z, codebook, rows: int = 1 << 15):
    """Squared L2 distances [B, N] in float64, ||z||^2 - 2 z.c + ||c||^2,
    in blocks of ``rows``."""
    c = codebook.double()
    cn = (c * c).sum(1)
    out = []
    for zb in z.split(rows):
        zb = zb.double()
        out.append((zb * zb).sum(1, keepdim=True) - 2.0 * (zb @ c.t()) + cn)
    return torch.cat(out)


def nearest(z, codebook, rows: int = 1 << 15):
    return torch.cat([distances(zb, codebook).argmin(1) for zb in z.split(rows)])


def nearest_fp32(z, codebook, rows: int = 1 << 15):
    """The nearest codes from float32 distances ||c||^2 - 2 z.c (the control's
    lookup: with TF32 on, the products lose precision)."""
    cn = (codebook * codebook).sum(1)
    return torch.cat([(cn - 2.0 * (zb @ codebook.t())).argmin(1) for zb in z.split(rows)])


def id_gap(z, codebook, ids, rows: int = 1 << 15) -> float:
    """Largest distance by which a given id's code lies farther from its row
    than the nearest code (0 where every id is a nearest code)."""
    worst = 0.0
    for zb, ib in zip(z.split(rows), ids.split(rows)):
        d = distances(zb, codebook)
        gap = d.gather(1, ib.long()[:, None])[:, 0] - d.min(1).values
        worst = max(worst, float(gap.max()))
    return worst


# -- the image trunk ----------------------------------------------------------
class Draws:
    """Training's random draws, from one generator on the device seeded with
    the train seed + 1: the random crops' offsets (rows, then columns, as
    uniform integers) and the dropout masks, in the order of the forward."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed) + 1)

    def offsets(self, n: int, hi_rows: int, hi_cols: int, device):
        return tuple(torch.randint(0, hi, (n,), generator=self.gen, device=device)
                     for hi in (hi_rows, hi_cols))

    def dropout(self, x, p: float):
        if p == 0.0:
            return x
        keep = 1.0 - p
        u = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _bn(W, p, x, train: bool = False):
    """BatchNorm: in training over the batch's mean and biased variance,
    else over the running statistics."""
    shape = (1, -1, 1, 1)
    if train:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    else:
        mean, var = W[p + ".mean"].reshape(shape), W[p + ".var"].reshape(shape)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * W[p + ".weight"].reshape(shape)
            + W[p + ".bias"].reshape(shape))


def resnet18_film(W: dict, p: str, x, cond, train: bool = False):
    """x [B, 3, H, W] -> [B, 512, H/32, W/32]; FiLM from ``cond`` after each stage."""
    x = F.relu(_bn(W, p + "stem_bn", F.conv2d(x, W[p + "stem_conv.weight"], stride=2, padding=3),
                   train))
    x = F.max_pool2d(x, 3, 2, 1)
    for s in range(1, 5):
        for b in range(2):
            q = f"{p}layer{s}_{b}."
            stride = 2 if (s > 1 and b == 0) else 1
            y = F.relu(_bn(W, q + "bn1", F.conv2d(x, W[q + "conv1.weight"], stride=stride,
                                                  padding=1), train))
            y = _bn(W, q + "bn2", F.conv2d(y, W[q + "conv2.weight"], padding=1), train)
            if q + "downsample_conv.weight" in W:
                x = _bn(W, q + "downsample_bn", F.conv2d(x, W[q + "downsample_conv.weight"],
                                                         stride=stride), train)
            x = F.relu(y + x)
        film = f"{p}film{s}.TorchLinear_0."
        gb = linear(cond, W[film + "weight"], W[film + "bias"])
        gamma, beta = gb.chunk(2, dim=-1)
        x = gamma[:, :, None, None] * x + beta[:, :, None, None]
    return x


def spatial_softmax(W: dict, p: str, x):
    x = F.conv2d(x, W[p + "kp_conv.weight"], W[p + "kp_conv.bias"])
    b, c, h, w = x.shape
    att = torch.softmax(x.reshape(b, c, h * w), dim=-1)
    px = torch.linspace(-1.0, 1.0, w, device=x.device).repeat(h)
    py = torch.linspace(-1.0, 1.0, h, device=x.device).repeat_interleave(w)
    return torch.stack([(att * px).sum(-1), (att * py).sum(-1)], dim=-1).reshape(b, 2 * c)


def visual_core(W: dict, p: str, frames, lang, crop: int, crops: Draws | None = None):
    """frames [B, H, W, 3] in [0, 1] -> features [B, F]: the centre crop and
    the running statistics, or with ``crops`` (training) a random crop per
    frame and the batch's statistics."""
    b, h, w = frames.shape[:3]
    if crops is None:
        y0, x0 = (h - crop) // 2, (w - crop) // 2
        x = frames[:, y0:y0 + crop, x0:x0 + crop]
    else:
        ys, xs = crops.offsets(b, h - crop + 1, w - crop + 1, frames.device)
        r = torch.arange(crop, device=frames.device)
        x = frames[torch.arange(b, device=frames.device)[:, None, None],
                   (ys[:, None] + r)[:, :, None], (xs[:, None] + r)[:, None, :]]
    feat = resnet18_film(W, p + "backbone.", x.permute(0, 3, 1, 2).contiguous(), lang,
                         crops is not None)
    return F.relu(linear(spatial_softmax(W, p + "pool.", feat), W[p + "proj.weight"],
                         W[p + "proj.bias"]))


# -- the policy ---------------------------------------------------------------
ENC = "net.encoder.group_encoder.enc_obs."
TOK = "net.encoder.action_network."


def obs_features(W: dict, cfg: dict, obs: dict, rows: int = 512, crops: Draws | None = None):
    """obs leaves [R, ...] (frames [R, H, W, 3] float in [0, 1]) -> [R, D_obs],
    keys in the configuration's order; the eval trunk in blocks of ``rows``,
    the training trunk (``crops``) over the whole batch."""
    feats = []
    for key in cfg["obs_keys"]:
        x = obs[key]
        if key in cfg.get("rgb_keys", ()):
            lang = obs["lang_emb"]
            n = rows if crops is None else x.shape[0]
            crop = cfg["visual"]["crop"]
            feats.append(torch.cat([visual_core(W, f"{ENC}core_{key}.", xb, lb, crop, crops)
                                    for xb, lb in zip(x.split(n), lang.split(n))]))
        else:
            feats.append(x.reshape(x.shape[0], -1))
    return torch.cat(feats, dim=-1)


def embed(W, cfg: dict, feats, draws: Draws | None = None):
    e = linear(feats, W["net.embed_encoder.weight"], W["net.embed_encoder.bias"])
    e = e + W["net.embed_timestep"]
    e = layer_norm(e, W["net.embed_ln.weight"], W["net.embed_ln.bias"])
    return e if draws is None else draws.dropout(e, cfg["emb_dropout"])


def gpt(W: dict, cfg: dict, x, lower: Lower | None, draws: Draws | None = None):
    """The blocks and the output LayerNorm; with ``draws`` (training) the
    dropout of each block: attention weights, attention output, MLP output."""
    drop = (lambda y, p: y) if draws is None else draws.dropout
    nh = cfg["num_heads"]
    b, t, d = x.shape
    dh = d // nh
    for i in range(cfg["num_layers"]):
        p = f"net.transformer.block_{i}."
        h = layer_norm(x, W[p + "ln1.weight"], W[p + "ln1.bias"])
        q, k, v = dense(h, W[p + "attention.qkv.weight"], None, lower).chunk(3, dim=-1)
        q, k, v = (a.reshape(b, t, nh, dh).transpose(1, 2) for a in (q, k, v))
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        att = drop(att, cfg["attn_dropout"])
        y = (att @ v).transpose(1, 2).reshape(b, t, d)
        y = dense(y, W[p + "attention.output.weight"], W[p + "attention.output.bias"], lower)
        x = x + drop(y, cfg["block_output_dropout"])
        h = layer_norm(x, W[p + "ln2.weight"], W[p + "ln2.bias"])
        h = gelu(dense(h, W[p + "mlp_fc.weight"], W[p + "mlp_fc.bias"], lower))
        h = dense(h, W[p + "mlp_proj.weight"], W[p + "mlp_proj.bias"], lower)
        x = x + drop(h, cfg["block_output_dropout"])
    return layer_norm(x, W["net.transformer.output_ln.weight"], W["net.transformer.output_ln.bias"])


def policy_heads(W: dict, cfg: dict, obs: dict, ctx_obs: dict, ctx_actions, ctx_ids=None,
                 lower: Lower | None = None, draws: Draws | None = None):
    """Query and context obs leaves [B, T, ...], context actions [B, T, A] ->
    (raw means [B, T, M, A], raw scales [B, T, M, A], logits [B, T, M],
    tokenizer loss, ids [B*T], latents [B*T, L]). ``ctx_ids`` (judged
    beforehand) stand for the nearest codes of the context latents; with
    ``draws`` the forward is training's (random crops, batch statistics,
    dropout)."""
    b, t = ctx_actions.shape[:2]
    m, a = cfg["num_modes"], cfg["ac_dim"]
    flat = {k: v.reshape(b * t, *v.shape[2:]) for k, v in obs.items()}
    ctx_flat = {k: v.reshape(b * t, *v.shape[2:]) for k, v in ctx_obs.items()}
    obs_f = obs_features(W, cfg, flat, crops=draws)
    ctx_obs_f = obs_features(W, cfg, ctx_flat, crops=draws)
    x = ctx_actions.reshape(b * t, -1)
    z = lipvq_encode(W, TOK, x)
    codebook = W[TOK + "quantizer.codebook"]
    ids = nearest(z, codebook) if ctx_ids is None else ctx_ids.long()
    zq = codebook[ids]
    recon = ((lipvq_decode(W, TOK, zq) - x) ** 2).mean()
    commit = ((zq.detach() - z) ** 2).mean()
    book = ((zq - z.detach()) ** 2).mean()
    aux = recon + 0.25 * commit + 0.25 * book
    d = cfg["embed_dim"]
    qe = embed(W, cfg, obs_f.reshape(b, t, -1), draws)
    ce = embed(W, cfg, ctx_obs_f.reshape(b, t, -1), draws)
    ae = embed(W, cfg, zq.detach().reshape(b, t, -1), draws)
    tokens = torch.cat([torch.stack([ce, ae], dim=2).reshape(b, 2 * t, d), qe], dim=1)
    hidden = gpt(W, cfg, tokens, lower, draws)[:, -t:]
    mean = linear(hidden, W["net.decoder.head_mean.weight"], W["net.decoder.head_mean.bias"])
    scale = linear(hidden, W["net.decoder.head_scale.weight"], W["net.decoder.head_scale.bias"])
    logits = linear(hidden, W["net.decoder.head_logits.weight"], W["net.decoder.head_logits.bias"])
    return (mean.reshape(b, t, m, a), scale.reshape(b, t, m, a), logits, aux, ids, z)


def gmm_nll(mean_raw, scale_raw, logits, target, min_std: float):
    means = torch.tanh(mean_raw)
    scales = F.softplus(scale_raw) + min_std
    x = target[..., None, :]
    comp = (-0.5 * ((x - means) / scales) ** 2 - torch.log(scales)
            - 0.5 * math.log(2.0 * math.pi)).sum(-1)
    return -torch.logsumexp(comp + torch.log_softmax(logits, dim=-1), dim=-1).mean()


# -- the train step -------------------------------------------------------------
def split_batch(batch: dict, h: int):
    """A batch of items (obs leaves [B, 2h - 1, ...], actions [B, 2h - 1, A])
    -> (query obs, context obs, context actions, query targets): the first
    h steps of obs, actions h - 1 .. 2h - 2, the first half of the rows as
    contexts and the second as queries."""
    obs = {k: v[:, :h] for k, v in batch["obs"].items()}
    actions = batch["actions"][:, h - 1:2 * h - 1]
    mid = actions.shape[0] // 2
    return ({k: v[mid:] for k, v in obs.items()}, {k: v[:mid] for k, v in obs.items()},
            actions[:mid], actions[mid:])


class AdamW:
    """torch-style AdamW: decoupled decay p *= 1 - lr * wd, bias-corrected
    moments, eps added to the corrected square root."""

    def __init__(self, params: dict, lr, wd: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, wd, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        lr = self.lr(self.t)
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * self.wd)
            p.sub_(lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps))


def lr_schedule(opt: dict, start: int = 0):
    """The policy's rate at each of this trainer's steps 0, 1, ..., the
    schedule taken up at step ``start``: a constant rate, or a linear
    warm-up from 0 over ``num_warmup_steps``, then constant."""
    lr = float(opt["lr"])
    if opt["scheduler_type"] == "constant":
        return lambda step: lr
    if opt["scheduler_type"] != "constant_with_warmup":
        raise ValueError(f"the reference follows no {opt['scheduler_type']!r} schedule")
    warmup = int(opt["num_warmup_steps"])

    def rate(step: int) -> float:
        s = start + step
        return (0.0 - lr) * (1 - min(max(s, 0), warmup) / warmup) + lr if s < warmup else lr

    return rate


class Trainer:
    """The reference's train state: its own copy of the weights and both
    optimizers' moments."""

    def __init__(self, W: dict, cfg: dict, lower: Lower | None = None, seed: int = 0,
                 device="cpu", start: int = 0):
        self.cfg, self.lower = cfg, lower
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
        for v in self.pol.values():
            v.requires_grad_(True)
        for v in self.tok.values():
            v.requires_grad_(True)
        qry, ctx, ctx_act, target = split_batch(batch, self.cfg["context_length"])
        mean, scale, logits, aux, _, _ = policy_heads(self.W, self.cfg, qry, ctx, ctx_act,
                                                      lower=self.lower, draws=self.draws)
        action_loss = gmm_nll(mean, scale, logits, target, self.cfg["min_std"])
        names = list(self.pol) + list(self.tok)
        grads = torch.autograd.grad(action_loss + aux, [self.W[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(self.W[k]) if g is None else g for k, g in zip(names, grads)}
        for v in self.W.values():
            v.requires_grad_(False)
        norm = torch.sqrt(sum((grads[k].double() ** 2).sum() for k in self.pol)).float()
        if norm >= self.max_norm:
            for k in self.pol:
                grads[k] = grads[k] * (self.max_norm / norm)
        self.pol_opt.step(grads)
        self.tok_opt.step(grads)
        return {"action_loss": float(action_loss.detach()), "vq_loss": float(aux.detach()),
                "grads": grads}


def _is_buffer(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


# -- the configuration ---------------------------------------------------------
# options of the configuration's transformer section that this reference
# follows, and the values it follows them at
FOLLOWS = {"enabled": True, "causal": False, "supervise_all_steps": True,
           "pred_future_acs": True, "vq_vae_enabled": True, "ln_act_enabled": False,
           "fast_enabled": False, "bin_enabled": False, "sinusoidal_embedding": False,
           "activation": "gelu", "nn_parameter_for_timesteps": True}


def view(cfg: dict) -> dict:
    """The sizes, rates and options of a configuration file, read from its
    ``port_config`` (the robomimic config's keys, as the template states
    them), as flat keys: ``context_length``, ``embed_dim``, ``num_layers``,
    ``num_heads``, the three dropouts, ``num_modes``, ``min_std``,
    ``num_codes``, ``vq_hidden_dim``, ``frame_stack``, ``optimizer``,
    ``vq_optimizer`` and, with cameras, ``visual``. Raises where the
    configuration asks for an option that this reference does not follow."""
    pc = cfg["port_config"]
    algo, t = pc["algo"], pc["algo"]["transformer"]
    if cfg["algo"] != "icl" or not algo["gmm"]["enabled"]:
        raise ValueError("the icl reference follows the ICL GMM policy only")
    for k, v in FOLLOWS.items():
        if t.get(k, v) != v:
            raise ValueError(f"the icl reference follows transformer.{k} = {v!r} only")
    if algo["vq"].get("ema_codebook", False):
        raise ValueError("the icl reference follows the loss codebook only")
    pol = algo["optim_params"]["policy"]
    if pol["optimizer_type"] != "adamw":
        raise ValueError("the icl reference follows AdamW only")
    lr = pol["learning_rate"]
    out = dict(cfg)
    out.update(
        context_length=t["context_length"], embed_dim=t["embed_dim"],
        num_layers=t["num_layers"], num_heads=t["num_heads"],
        emb_dropout=t["emb_dropout"], attn_dropout=t["attn_dropout"],
        block_output_dropout=t["block_output_dropout"],
        num_modes=algo["gmm"]["num_modes"], min_std=algo["gmm"]["min_std"],
        num_codes=algo["vq"]["num_codes"], vq_hidden_dim=algo["vq"]["hidden_dim"],
        frame_stack=pc["train"]["frame_stack"],
        optimizer={"lr": lr["initial"], "scheduler_type": lr["scheduler_type"],
                   "num_warmup_steps": cfg["num_warmup_steps"],
                   "L2": pol["regularization"]["L2"],
                   "max_grad_norm": pc["train"]["max_grad_norm"]},
        vq_optimizer={"lr": algo["vq"]["optimizer_lr"], "wd": algo["vq"]["optimizer_wd"]})
    rgb = pc["observation"]["modalities"]["obs"].get("rgb", [])
    if rgb:
        enc = pc["observation"]["encoder"]["rgb"]
        kw = enc["core_kwargs"]
        if (enc["core_class"], kw["backbone_class"], kw["pool_class"],
                enc["obs_randomizer_class"]) != ("VisualCoreLanguageConditioned",
                                                 "ResNet18ConvFiLM", "SpatialSoftmax",
                                                 "CropRandomizer"):
            raise ValueError("the icl reference follows the FiLM ResNet-18 trunk only")
        crop = enc["obs_randomizer_kwargs"]
        if crop["crop_height"] != crop["crop_width"] or crop.get("num_crops", 1) != 1:
            raise ValueError("the icl reference follows one square crop only")
        out["visual"] = {"feature_dimension": kw["feature_dimension"],
                         "num_kp": kw["pool_kwargs"]["num_kp"], "crop": crop["crop_height"]}
    return out


# -- the parameter layout -------------------------------------------------------
def latent_dim(cfg: dict) -> int:
    """The width of the observation features, which the action codes share."""
    rgb = set(cfg.get("rgb_keys", ()))
    return sum(cfg["visual"]["feature_dimension"] if k in rgb else math.prod(s)
               for k, s in cfg["obs"])


def lipvq_specs(p: str, feature: int, latent: int, codes: int, hidden: int) -> list:
    return [
        (p + "enc1.weight", (64, feature), "fan_in"), (p + "enc1.bias", (64,), "small"),
        (p + "enc2.weight", (hidden, 64), "fan_in"), (p + "enc2.bias", (hidden,), "small"),
        (p + "to_latent.W", (latent, hidden), "unit"), (p + "to_latent.b", (latent,), "small"),
        (p + "to_latent.ci", (latent,), "ci"),
        (p + "quantizer.codebook", (codes, latent), "codebook"),
        (p + "dec1.weight", (64, latent), "fan_in"), (p + "dec1.bias", (64,), "small"),
        (p + "dec2.weight", (hidden, 64), "fan_in"), (p + "dec2.bias", (hidden,), "small"),
        (p + "to_output.weight", (feature, hidden), "fan_in"),
        (p + "to_output.bias", (feature,), "small"),
    ]


def _bn_specs(p: str, c: int) -> list:
    return [(p + ".weight", (c,), "one"), (p + ".bias", (c,), "small"),
            (p + ".mean", (c,), "small"), (p + ".var", (c,), "var")]


def core_specs(p: str, lang: int, num_kp: int, features: int) -> list:
    out = [(p + "backbone.stem_conv.weight", (64, 3, 7, 7), "conv")]
    out += _bn_specs(p + "backbone.stem_bn", 64)
    width = 64
    for s, feats in enumerate((64, 128, 256, 512), 1):
        for b in range(2):
            q = f"{p}backbone.layer{s}_{b}."
            stride = 2 if (s > 1 and b == 0) else 1
            out.append((q + "conv1.weight", (feats, width, 3, 3), "conv"))
            out += _bn_specs(q + "bn1", feats)
            out.append((q + "conv2.weight", (feats, feats, 3, 3), "conv"))
            out += _bn_specs(q + "bn2", feats)
            if width != feats or stride != 1:
                out.append((q + "downsample_conv.weight", (feats, width, 1, 1), "conv"))
                out += _bn_specs(q + "downsample_bn", feats)
            width = feats
        out += [(f"{p}backbone.film{s}.TorchLinear_0.weight", (2 * feats, lang), "film_w"),
                (f"{p}backbone.film{s}.TorchLinear_0.bias", (2 * feats,), "film_b")]
    out += [(p + "pool.kp_conv.weight", (num_kp, 512, 1, 1), "conv"),
            (p + "pool.kp_conv.bias", (num_kp,), "small"),
            (p + "proj.weight", (features, 2 * num_kp), "fan_in"),
            (p + "proj.bias", (features,), "small")]
    return out


def param_specs(cfg: dict) -> list:
    """[(name, shape, kind)] of every parameter and running statistic of the
    policy, named as the program names them."""
    d, t = cfg["embed_dim"], cfg["context_length"]
    m, a = cfg["num_modes"], cfg["ac_dim"]
    lat = latent_dim(cfg)
    shapes = dict(cfg["obs"])
    out = []
    for key in cfg.get("rgb_keys", ()):
        v = cfg["visual"]
        out += core_specs(f"{ENC}core_{key}.", math.prod(shapes["lang_emb"]), v["num_kp"],
                          v["feature_dimension"])
    out += lipvq_specs(TOK, a, lat, cfg["num_codes"], cfg["vq_hidden_dim"])
    out += [("net.embed_encoder.weight", (d, lat), "fan_in"),
            ("net.embed_encoder.bias", (d,), "small"),
            ("net.embed_ln.weight", (d,), "one"), ("net.embed_ln.bias", (d,), "small"),
            ("net.embed_timestep", (1, t, d), "gpt")]
    for i in range(cfg["num_layers"]):
        p = f"net.transformer.block_{i}."
        out += [(p + "attention.qkv.weight", (3 * d, d), "gpt"),
                (p + "attention.output.weight", (d, d), "gpt"),
                (p + "attention.output.bias", (d,), "gpt"),
                (p + "ln1.weight", (d,), "one"), (p + "ln1.bias", (d,), "small"),
                (p + "ln2.weight", (d,), "one"), (p + "ln2.bias", (d,), "small"),
                (p + "mlp_fc.weight", (4 * d, d), "gpt"), (p + "mlp_fc.bias", (4 * d,), "gpt"),
                (p + "mlp_proj.weight", (d, 4 * d), "gpt"), (p + "mlp_proj.bias", (d,), "gpt")]
    out += [("net.transformer.output_ln.weight", (d,), "one"),
            ("net.transformer.output_ln.bias", (d,), "small")]
    for head, width in (("mean", m * a), ("scale", m * a), ("logits", m)):
        out += [(f"net.decoder.head_{head}.weight", (width, d), "fan_in"),
                (f"net.decoder.head_{head}.bias", (width,), "small")]
    return out
