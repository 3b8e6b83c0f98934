"""minGPT-style transformer backbone (counterpart of
``lipvq_tpu/models/transformer.py``).

Pre-LN blocks, QKV projection without bias, causal-or-full mask
(``causal=False`` is *bidirectional* attention, which the ICL template
uses), GELU or GEGLU MLP with hidden 4x, final LayerNorm, N(0, 0.02) linear
init. LayerNorm eps is flax's 1e-6, not torch's 1e-5.

``compute_dtype=torch.bfloat16`` follows the JAX package's mixed precision
exactly: each Dense casts its input, weight and bias to bf16 and returns
bf16; the attention scores and the attention-weighted values are
accumulated in fp32 from bf16 operands; softmax, LayerNorm and the residual
stream stay fp32 (bf16 with ``activation_dtype=torch.bfloat16``).

Attention runs over 30 tokens at the ICL scale, so it is a plain matmul +
softmax: the JAX package leaves it to XLA too. Dropout sits where flax puts
it: on the fp32 softmax (before the bf16 cast), after the attention output
Dense, and after ``mlp_proj`` once cast to the residual dtype. It is active
only with ``train=True`` and draws its masks from the ``generator`` passed
down with it.

``remat=True`` recomputes each block in the backward instead of keeping its
activations (flax ``nn.remat``), through ``torch.utils.checkpoint``. The
recomputation replays the block's dropout masks: it restores the
generator's state from before the block's forward, runs, and puts the
generator back where it was (``preserve_rng_state`` covers only the global
generators, not an explicit one).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from lipvq_tpu_torch.models.base_nets import dropout, gelu_exact

LN_EPS = 1e-6  # flax nn.LayerNorm default


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=compute_dtype)`` with the GPT init: weight
    [out, in] ~ N(0, 0.02), zero bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return cast_linear(x, self.weight, self.bias, self.compute_dtype)


def cast_linear(x, weight, bias, compute_dtype: torch.dtype | None):
    """``F.linear``, or with ``compute_dtype`` its operands cast to it."""
    if compute_dtype is None:
        return F.linear(x, weight, bias)
    bias = bias.to(compute_dtype) if bias is not None else None
    return F.linear(x.to(compute_dtype), weight.to(compute_dtype), bias)


def layer_norm(ln: nn.LayerNorm, x):
    """LayerNorm in fp32 with fp32 output, as flax computes it."""
    return ln(x.float())


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight over the last axis, in fp32 with
    fp32 output; ``weight`` starts at ones."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


class GatedMLP(nn.Module):
    """``down_proj(silu(gate_proj(x)) * up_proj(x))`` without biases (the
    SiLU-gated feed-forward of Jamba and Llama); the gate's product in fp32,
    each Dense in ``compute_dtype``."""

    def __init__(self, embed_dim: int, width: int, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.gate_proj = Dense(embed_dim, width, bias=False, compute_dtype=compute_dtype)
        self.up_proj = Dense(embed_dim, width, bias=False, compute_dtype=compute_dtype)
        self.down_proj = Dense(width, embed_dim, bias=False, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x).float()) * self.up_proj(x).float())


class GEGLU(nn.Module):
    """a * gelu(b) over a channel split."""

    def forward(self, x):
        a, b = x.chunk(2, dim=-1)
        return a * gelu_exact(b)


def sinusoidal_position_encoding(timesteps: torch.Tensor, embed_dim: int) -> torch.Tensor:
    """Standard sin/cos positional encoding: timesteps [B, T] float ->
    [B, T, embed_dim]."""
    half = torch.as_tensor(np.arange(0, embed_dim, 2), dtype=torch.float32,
                           device=timesteps.device)
    div_term = torch.exp(half * (-math.log(10000.0) / embed_dim))
    args = timesteps[..., None].float() * div_term
    pe = torch.zeros(timesteps.shape + (embed_dim,), device=timesteps.device)
    pe[..., 0::2] = torch.sin(args)
    pe[..., 1::2] = torch.cos(args)
    return pe


class SelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, context_length: int,
                 causal: bool = True, attn_dropout: float = 0.1,
                 output_dropout: float = 0.1,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.context_length = context_length
        self.causal = causal
        self.attn_dropout = attn_dropout
        self.output_dropout = output_dropout
        self.compute_dtype = compute_dtype
        self.qkv = Dense(embed_dim, 3 * embed_dim, bias=False, compute_dtype=compute_dtype)
        self.output = Dense(embed_dim, embed_dim, compute_dtype=compute_dtype)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        b, t, d = x.shape
        if d != self.embed_dim or t > self.context_length:
            raise ValueError(f"attention takes [B, <={self.context_length}, "
                             f"{self.embed_dim}], got {tuple(x.shape)}")
        nh = self.num_heads
        dh = d // nh
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q, k, v = (a.reshape(b, t, nh, dh).transpose(1, 2) for a in (q, k, v))
        # fp32 accumulation of bf16 operands: the products are exact in fp32
        att = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        if self.causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            att = att.masked_fill(~mask, float("-inf"))
        att = torch.softmax(att, dim=-1)
        att = dropout(att, self.attn_dropout, generator, train)
        if self.compute_dtype is not None:
            att = att.to(self.compute_dtype)  # fp32 softmax result -> bf16 operand
        y = (att.float() @ v.float()).to(x.dtype)
        y = y.transpose(1, 2).reshape(b, t, d)
        return dropout(self.output(y), self.output_dropout, generator, train)


class GroupedQueryAttention(nn.Module):
    """Attention with ``num_kv_heads`` key/value heads, each shared by
    ``num_heads / num_kv_heads`` query heads (one: multi-query attention),
    no biases and no positions (Jamba's attention layers): ``q_proj``,
    ``k_proj``, ``v_proj``, ``o_proj``. The scores and the weighted values
    are accumulated in fp32 from the Dense layers' outputs, the softmax in
    fp32, as ``SelfAttention`` does; no dropout."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int = 1,
                 causal: bool = True, compute_dtype: torch.dtype | None = None):
        super().__init__()
        if embed_dim % num_heads or num_heads % num_kv_heads:
            raise ValueError(f"{num_heads} query heads need to divide the width {embed_dim} "
                             f"and be a multiple of the {num_kv_heads} key/value heads")
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.compute_dtype = compute_dtype
        kv = num_kv_heads * self.head_dim
        self.q_proj = Dense(embed_dim, embed_dim, bias=False, compute_dtype=compute_dtype)
        self.k_proj = Dense(embed_dim, kv, bias=False, compute_dtype=compute_dtype)
        self.v_proj = Dense(embed_dim, kv, bias=False, compute_dtype=compute_dtype)
        self.o_proj = Dense(embed_dim, embed_dim, bias=False, compute_dtype=compute_dtype)

    def forward(self, x):
        b, t, d = x.shape
        kvh, dh = self.num_kv_heads, self.head_dim
        group = self.num_heads // kvh
        # [b, kv heads, group * t, dh]: the query heads that share a key/value
        # head stacked along the rows
        q = self.q_proj(x).reshape(b, t, kvh, group, dh).permute(0, 2, 3, 1, 4)
        q = q.reshape(b, kvh, group * t, dh)
        k, v = (p(x).reshape(b, t, kvh, dh).transpose(1, 2) for p in (self.k_proj, self.v_proj))
        att = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        if self.causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril().repeat(group, 1)
            att = att.masked_fill(~mask, float("-inf"))
        att = torch.softmax(att, dim=-1)
        if self.compute_dtype is not None:
            att = att.to(self.compute_dtype)  # fp32 softmax result -> bf16 operand
        y = (att.float() @ v.float()).to(x.dtype)  # [b, kv heads, group * t, dh]
        y = y.reshape(b, kvh, group, t, dh).permute(0, 3, 1, 2, 4).reshape(b, t, d)
        return self.o_proj(y)


class SelfAttentionBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, embed_dim: int, num_heads: int, context_length: int,
                 causal: bool = True, attn_dropout: float = 0.1,
                 output_dropout: float = 0.1, activation: str = "gelu",
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.output_dropout = output_dropout
        self.attention = SelfAttention(embed_dim, num_heads, context_length,
                                       causal=causal, attn_dropout=attn_dropout,
                                       output_dropout=output_dropout,
                                       compute_dtype=compute_dtype)
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        mult = 2 if activation == "geglu" else 1
        self.mlp_fc = Dense(embed_dim, 4 * embed_dim * mult, compute_dtype=compute_dtype)
        self.mlp_act = GEGLU() if activation == "geglu" else gelu_exact
        self.mlp_proj = Dense(4 * embed_dim, embed_dim, compute_dtype=compute_dtype)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        # torch promotes bf16 + fp32 to fp32 as JAX does, so the residual
        # stream keeps the dtype the JAX block gives it
        x = x + self.attention(layer_norm(self.ln1, x), train, generator)
        h = self.mlp_proj(self.mlp_act(self.mlp_fc(layer_norm(self.ln2, x))))
        return x + dropout(h.to(x.dtype), self.output_dropout, generator, train)


class GPTBackbone(nn.Module):
    """Stack of SelfAttentionBlocks (``block_{i}``) + output LayerNorm."""

    def __init__(self, embed_dim: int, context_length: int, causal: bool = True,
                 attn_dropout: float = 0.1, block_output_dropout: float = 0.1,
                 num_layers: int = 6, num_heads: int = 8, activation: str = "gelu",
                 remat: bool = False, compute_dtype: torch.dtype | None = None,
                 activation_dtype: torch.dtype | None = None):
        super().__init__()
        self.remat = remat
        self.embed_dim = embed_dim
        self.context_length = context_length
        self.num_layers = num_layers
        self.activation_dtype = activation_dtype
        for i in range(num_layers):
            self.add_module(f"block_{i}", SelfAttentionBlock(
                embed_dim, num_heads, context_length, causal=causal,
                attn_dropout=attn_dropout, output_dropout=block_output_dropout,
                activation=activation, compute_dtype=compute_dtype))
        self.output_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        if tuple(x.shape[1:]) != (self.context_length, self.embed_dim):
            raise ValueError(f"backbone takes [B, {self.context_length}, "
                             f"{self.embed_dim}], got {tuple(x.shape)}")
        if self.activation_dtype is not None:
            x = x.to(self.activation_dtype)
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            if self.remat and torch.is_grad_enabled():
                x = _rematerialized(block, x, train, generator)
            else:
                x = block(x, train, generator)
        return layer_norm(self.output_ln, x)


def _rematerialized(block: nn.Module, x, train: bool, generator: torch.Generator | None):
    """``block(x, train, generator)`` whose activations are recomputed in the
    backward, with the same dropout masks as the forward drew."""
    if not train or generator is None:
        return torch.utils.checkpoint.checkpoint(block, x, train, None, use_reentrant=False,
                                                 preserve_rng_state=False)
    before = generator.get_state()
    calls = []

    def run(x):
        if not calls:  # the forward
            calls.append(1)
            return block(x, train, generator)
        after = generator.get_state()  # the recomputation: replay the forward's draws
        generator.set_state(before)
        try:
            return block(x, train, generator)
        finally:
            generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             preserve_rng_state=False)
