"""Observation encoder/decoder stack + ICL composite (counterpart of
``lipvq_tpu/models/obs_nets.py``).

- ``ObservationEncoder``         — low-dim keys flattened in spec order
- ``ObservationGroupEncoder``    — one encoder per obs group, concat
- ``ObservationDecoder``         — one linear head per output key
- ``ICLObservationGroupEncoder`` — group encoder + the selected action
  tokenizer on the context action stream
- ``ICLMIMOTransformer``         — 3-stream embed, [ctx_obs, ctx_act]
  interleave + query obs -> GPT over 3T tokens -> decode the last T

Only the LipVQ-VAE tokenizer and low-dim observations are ported so far; the
other tokenizers and the visual cores raise ``NotImplementedError`` naming
their ROADMAP item. ``train=True`` turns on the embedding and backbone
dropout (masks from the ``generator`` passed with it) and the tokenizer's
EMA codebook statistics.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from lipvq_tpu_torch.models.base_nets import TorchLinear, dropout, get_activation
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.models.transformer import LN_EPS, GPTBackbone

# (key, shape) static spec type used across modules
ObsSpec = tuple  # tuple[tuple[str, tuple[int, ...]], ...]


def obs_spec(shapes: dict | Sequence) -> ObsSpec:
    """Normalize {key: shape} to a hashable ((key, shape), ...) spec."""
    items = shapes.items() if isinstance(shapes, dict) else shapes
    return tuple((k, tuple(v)) for k, v in items)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def spec_flat_dim(spec: ObsSpec) -> int:
    return sum(_numel(shape) for _, shape in spec)


def spec_encoded_dim(spec: ObsSpec, encoder_cores: ObsSpec = ()) -> int:
    """Post-encoder feature dim: visual-core keys contribute their
    feature_dimension, low-dim keys their flat size."""
    core_map = dict(encoder_cores)
    total = 0
    for key, shape in spec:
        core = core_map.get(key)
        if core:
            feat = 64
            if ":" in core:
                for pair in core.split(":", 1)[1].split(","):
                    k, v = pair.split("=")
                    if k == "feature_dimension":
                        feat = int(v)
            total += feat
        else:
            total += _numel(shape)
    return total


class ObservationEncoder(nn.Module):
    """Encode an observation dict into one flat feature vector, keys in
    spec order. Low-dim keys pass through flattened."""

    def __init__(self, spec: ObsSpec, feature_activation: str | None = "relu",
                 encoder_cores: ObsSpec = ()):
        super().__init__()
        if encoder_cores:
            raise NotImplementedError(
                "visual observation cores are ROADMAP queue 1, item 11; "
                "not ported yet")
        self.spec = spec
        self.feature_activation = feature_activation

    def forward(self, obs_dict):
        feats = [obs_dict[key].reshape(obs_dict[key].shape[0], -1)
                 for key, _ in self.spec]
        out = torch.cat(feats, dim=-1)
        if self.feature_activation:
            out = get_activation(self.feature_activation)(out)
        return out


class ObservationGroupEncoder(nn.Module):
    """One ObservationEncoder per group (``enc_{group}``); concat outputs."""

    def __init__(self, group_specs: ObsSpec, feature_activation: str | None = None,
                 encoder_cores: ObsSpec = ()):
        super().__init__()
        self.groups = [group for group, _ in group_specs]
        for group, spec in group_specs:
            self.add_module(f"enc_{group}", ObservationEncoder(
                spec, feature_activation=feature_activation,
                encoder_cores=encoder_cores))

    def forward(self, **inputs):
        return torch.cat([getattr(self, f"enc_{g}")(inputs[g]) for g in self.groups],
                         dim=-1)


class ObservationDecoder(nn.Module):
    """One linear head per output key (``head_{key}``), reshaped to the key's
    shape."""

    def __init__(self, in_features: int, spec: ObsSpec):
        super().__init__()
        self.spec = spec
        for key, shape in spec:
            self.add_module(f"head_{key}", TorchLinear(in_features, _numel(shape)))

    def forward(self, feats):
        out = {}
        for key, shape in self.spec:
            y = getattr(self, f"head_{key}")(feats)
            out[key] = y.reshape(y.shape[:-1] + tuple(shape))
        return out


class ICLObservationGroupEncoder(nn.Module):
    """Group encoder + context-action tokenizer. The tokenizer switches take
    precedence in the order fast -> bin -> vq -> ln_act, as in the JAX
    package; all false selects the raw-action tokenizer."""

    def __init__(self, group_specs: ObsSpec, action_input_shape: int,
                 vq_vae_enabled: bool = False, bin_enabled: bool = False,
                 fast_enabled: bool = False, ln_act_enabled: bool = False,
                 vq_num_codes: int = 1024, vq_hidden_dim: int = 128,
                 vq_ema_codebook: bool = False, vq_ema_decay: float = 0.99,
                 encoder_cores: ObsSpec = ()):
        super().__init__()
        self.group_encoder = ObservationGroupEncoder(
            group_specs, feature_activation=None, encoder_cores=encoder_cores)
        self.output_dim = sum(spec_encoded_dim(spec, encoder_cores)
                              for _, spec in group_specs)
        if fast_enabled:
            raise NotImplementedError("the FAST tokenizer is ROADMAP queue 1, "
                                      "item 10; not ported yet")
        if bin_enabled:
            raise NotImplementedError("the bin tokenizer is ROADMAP queue 1, "
                                      "item 10; not ported yet")
        if not vq_vae_enabled:
            arm = "ln_act" if ln_act_enabled else "raw"
            raise NotImplementedError(f"the {arm} tokenizer is ROADMAP queue 1, "
                                      f"item 10; not ported yet")
        self.action_network = LipVQVAE(
            feature_dim=action_input_shape, latent_dim=self.output_dim,
            num_codes=vq_num_codes, hidden_dim=vq_hidden_dim,
            ema_codebook=vq_ema_codebook, ema_decay=vq_ema_decay)

    def forward(self, obs, prompt_obs, prompt_actions, goal=None, train: bool = False):
        """Flattened [B*T, ...] inputs -> (obs_feat, ctx_obs_feat,
        ctx_act_feat, vq_aux_loss). ``train`` reaches the tokenizer (EMA
        codebook statistics)."""
        groups = {"obs": obs}
        ctx_groups = {"obs": prompt_obs}
        if goal is not None:
            groups["goal"] = ctx_groups["goal"] = goal
        obs_feat = self.group_encoder(**groups)
        ctx_obs_feat = self.group_encoder(**ctx_groups)
        ctx_act_feat, aux_loss, _ids = self.action_network(prompt_actions, train=train)
        return obs_feat, ctx_obs_feat, ctx_act_feat, aux_loss


class ICLMIMOTransformer(nn.Module):
    """ICL composite: 3-stream embedding -> interleave -> GPT -> decode."""

    def __init__(self, group_specs: ObsSpec, output_spec: ObsSpec,
                 backbone: str = "transformer", embed_dim: int = 512,
                 num_layers: int = 6, num_heads: int = 8, context_length: int = 10,
                 causal: bool = False, emb_dropout: float = 0.1,
                 attn_dropout: float = 0.1, block_output_dropout: float = 0.1,
                 sinusoidal_embedding: bool = False,
                 nn_parameter_for_timesteps: bool = True, activation: str = "gelu",
                 remat: bool = False, compute_dtype: torch.dtype | None = None,
                 activation_dtype: torch.dtype | None = None,
                 action_input_shape: int = 12, vq_vae_enabled: bool = False,
                 bin_enabled: bool = False, fast_enabled: bool = False,
                 ln_act_enabled: bool = False, vq_num_codes: int = 1024,
                 vq_hidden_dim: int = 128, vq_ema_codebook: bool = False,
                 vq_ema_decay: float = 0.99, encoder_cores: ObsSpec = ()):
        super().__init__()
        if backbone != "transformer":
            raise NotImplementedError("the Mamba backbone is ROADMAP queue 1, "
                                      "item 10; not ported yet")
        if sinusoidal_embedding or not nn_parameter_for_timesteps:
            raise NotImplementedError("sinusoidal and table timestep embeddings are "
                                      "ROADMAP queue 1, item 5; not ported yet")
        self.embed_dim = embed_dim
        self.context_length = context_length
        self.emb_dropout = emb_dropout
        self.encoder = ICLObservationGroupEncoder(
            group_specs, action_input_shape, vq_vae_enabled=vq_vae_enabled,
            bin_enabled=bin_enabled, fast_enabled=fast_enabled,
            ln_act_enabled=ln_act_enabled, vq_num_codes=vq_num_codes,
            vq_hidden_dim=vq_hidden_dim, vq_ema_codebook=vq_ema_codebook,
            vq_ema_decay=vq_ema_decay, encoder_cores=encoder_cores)
        self.embed_encoder = TorchLinear(self.encoder.output_dim, embed_dim)
        self.embed_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.embed_timestep = nn.Parameter(torch.empty(1, context_length, embed_dim))
        self.transformer = GPTBackbone(
            embed_dim=embed_dim, context_length=3 * context_length, causal=causal,
            attn_dropout=attn_dropout, block_output_dropout=block_output_dropout,
            num_layers=num_layers, num_heads=num_heads, activation=activation,
            remat=remat, compute_dtype=compute_dtype, activation_dtype=activation_dtype)
        self.decoder = ObservationDecoder(embed_dim, output_spec)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embed_timestep.zero_()

    def input_embedding(self, feats, train: bool = False,
                        generator: torch.Generator | None = None):
        """Linear embed + learned per-timestep offset + LN + dropout.
        feats [B, T, D_in]."""
        emb = self.embed_ln(self.embed_encoder(feats) + self.embed_timestep)
        return dropout(emb, self.emb_dropout, generator, train)

    def forward(self, obs, prompt_obs, prompt_actions, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        """All obs leaves [B, T, ...]; prompt_actions [B, T, A].
        Returns (outputs dict of [B, T, ...], vq_aux_loss)."""
        b, t = next(iter(obs.values())).shape[:2]

        def flat(tree):
            return {k: v.reshape((b * t,) + tuple(v.shape[2:])) for k, v in tree.items()}

        obs_f, ctx_obs_f, ctx_act_f, aux = self.encoder(
            flat(obs), flat(prompt_obs), prompt_actions.reshape(b * t, -1),
            goal=flat(goal) if goal is not None else None, train=train)
        obs_emb = self.input_embedding(obs_f.reshape(b, t, -1), train, generator)
        ctx_obs_emb = self.input_embedding(ctx_obs_f.reshape(b, t, -1), train, generator)
        ctx_act_emb = self.input_embedding(ctx_act_f.reshape(b, t, -1), train, generator)
        # interleave [ctx_obs_0, ctx_act_0, ctx_obs_1, ...], then the T
        # query-obs tokens
        interleaved = torch.stack([ctx_obs_emb, ctx_act_emb], dim=2).reshape(
            b, 2 * t, self.embed_dim)
        tokens = torch.cat([interleaved, obs_emb], dim=1)  # [B, 3T, D]
        hidden = self.transformer(tokens, train, generator)
        return self.decoder(hidden[:, -t:]), aux
