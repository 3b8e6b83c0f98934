"""CLIP text tower (counterpart of ``lipvq_tpu/models/clip_text.py``).

Token + position embeddings, pre-LN residual blocks with quick-GELU MLPs,
causal attention (masked scores set to the dtype's most negative value), a
final LayerNorm, pooling at each row's first EOS token and the text
projection, all in fp32 (the JAX tower forces fp32 matmuls). The module
tree mirrors the flax one, so ``utils/jax_weights.py`` bridges a JAX
tower's params leaf for leaf: ``token_embedding.embedding`` [V, H],
``position_embedding`` [P, H] and ``text_projection`` [H, proj] keep their
names and flax layouts.

``import_clip_text_state_dict`` maps a HF ``CLIPTextModelWithProjection``
state_dict onto the tower; ``load_pretrained_clip`` loads cached weights
through ``transformers``, which it alone imports.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from lipvq_tpu_torch.models.base_nets import TorchLinear


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768  # ViT-L/14 text width
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


def quick_gelu(x):
    """CLIP's activation (HF activations.py quick_gelu)."""
    return x * torch.sigmoid(1.702 * x)


class Embed(nn.Module):
    """flax ``nn.Embed``: a table ``embedding`` [num, features]; N(0, 0.02)
    init (HF CLIP's)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, ids):
        return self.embedding[ids]


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        h = cfg.hidden_size
        self.q_proj, self.k_proj = TorchLinear(h, h), TorchLinear(h, h)
        self.v_proj, self.out_proj = TorchLinear(h, h), TorchLinear(h, h)

    def forward(self, x, mask):
        b, t, width = x.shape
        head = width // self.num_heads

        def split(y):
            return y.reshape(b, t, self.num_heads, head).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        att = q @ k.transpose(-1, -2) / head ** 0.5
        att = torch.where(mask, att, torch.finfo(att.dtype).min)
        out = torch.softmax(att, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, width))


class _Block(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg)
        self.layer_norm2 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.fc1 = TorchLinear(h, cfg.intermediate_size)
        self.fc2 = TorchLinear(cfg.intermediate_size, h)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPTextTower(nn.Module):
    """input_ids [B, T] -> text_embeds [B, projection_dim] (HF
    ``CLIPTextModelWithProjection`` semantics: the pooled state is the
    hidden state at each row's first ``eos_token_id``)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = Embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", _Block(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.text_projection = nn.Parameter(torch.empty(cfg.hidden_size, cfg.projection_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.01) for the position table and the projection (the JAX
        tower's initializers)."""
        with torch.no_grad():
            self.position_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, 0.01, generator=generator)

    def forward(self, input_ids):
        c = self.cfg
        b, t = input_ids.shape
        x = self.token_embedding(input_ids) + self.position_embedding[None, :t]
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, None]
        for i in range(c.num_layers):
            x = getattr(self, f"layers_{i}")(x, causal)
        x = self.final_layer_norm(x)
        eos_idx = (input_ids == c.eos_token_id).int().argmax(dim=-1)  # the first EOS
        pooled = x[torch.arange(b, device=x.device), eos_idx]
        return pooled @ self.text_projection


def import_clip_text_state_dict(sd: dict, cfg: CLIPTextConfig) -> dict[str, torch.Tensor]:
    """HF ``CLIPTextModelWithProjection`` state_dict -> the tower's
    state_dict (HF Linear weights are [out, in], as ``TorchLinear``'s; the
    projection is transposed to the flax layout)."""
    def g(key):
        return torch.as_tensor(sd[key]).detach().float().cpu()

    out = {
        "token_embedding.embedding": g("text_model.embeddings.token_embedding.weight"),
        "position_embedding": g("text_model.embeddings.position_embedding.weight"),
        "final_layer_norm.weight": g("text_model.final_layer_norm.weight"),
        "final_layer_norm.bias": g("text_model.final_layer_norm.bias"),
        "text_projection": g("text_projection.weight").T.contiguous(),
    }
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        names = [f"layer_norm{j}.{p}" for j in (1, 2) for p in ("weight", "bias")]
        names += [f"self_attn.{proj}.{p}" for proj in ("q_proj", "k_proj", "v_proj", "out_proj")
                  for p in ("weight", "bias")]
        out.update({f"layers_{i}.{n}": g(f"{pre}.{n}") for n in names})
        out.update({f"layers_{i}.{n}.{p}": g(f"{pre}.mlp.{n}.{p}")
                    for n in ("fc1", "fc2") for p in ("weight", "bias")})
    return out


def load_pretrained_clip(model_name: str = "openai/clip-vit-large-patch14",
                         local_files_only: bool = True):
    """The tower with HF weights of ``model_name`` and its tokenizer:
    (tower, tokenizer). Reads the local HF cache unless ``local_files_only``
    is False; raises where the weights cannot be had."""
    from transformers import AutoTokenizer, CLIPTextModelWithProjection

    hf = CLIPTextModelWithProjection.from_pretrained(model_name,
                                                     local_files_only=local_files_only)
    tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=local_files_only)
    h = hf.config
    cfg = CLIPTextConfig(vocab_size=h.vocab_size, hidden_size=h.hidden_size,
                         num_layers=h.num_hidden_layers, num_heads=h.num_attention_heads,
                         intermediate_size=h.intermediate_size,
                         max_positions=h.max_position_embeddings,
                         projection_dim=h.projection_dim, eos_token_id=h.eos_token_id)
    tower = CLIPTextTower(cfg)
    tower.load_state_dict(import_clip_text_state_dict(hf.state_dict(), cfg), strict=True)
    return tower.eval(), tokenizer
