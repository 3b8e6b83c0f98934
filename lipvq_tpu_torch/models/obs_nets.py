"""Observation encoder/decoder stack + ICL composite (counterpart of
``lipvq_tpu/models/obs_nets.py``).

- ``ObservationEncoder``         — low-dim keys flattened, keys with an
  encoder core (``obs_core.py``: the visual cores, ``ScanCore``) through it,
  in spec order
- ``ObservationGroupEncoder``    — one encoder per obs group, concat
- ``ObservationDecoder``         — one linear head per output key
- ``RawActionTokenizer``         — the all-switches-false arm: spectral-norm
  MLP + 4 post-LN encoder layers over B*T as one sequence
- ``LnActTokenizer``             — the ln_act arm: a Mamba block over the
  [B, T, A] actions + MLP
- ``ICLObservationGroupEncoder`` — group encoder + the selected action
  tokenizer on the context action stream
- ``ICLMIMOTransformer``         — 3-stream embed, [ctx_obs, ctx_act]
  interleave + query obs -> GPT or Mamba over 3T tokens -> decode the last T
- ``MIMOTransformer``            — the non-ICL composite of the BC
  transformer baseline: embed each timestep's obs -> GPT over T tokens ->
  decode every timestep

Low-dim and image observations and every tokenizer arm (LipVQ, bin,
ln_act, raw and FAST, whose token features the algo computes on the host)
are ported. ``train=True`` turns on the embedding and backbone dropout and
the visual cores' randomizers (drawing from the ``generator`` passed with
it) and the running statistics: the visual cores' BatchNorm, the EMA
codebook, the bin bounds and the spectral-norm vectors.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from lipvq_tpu_torch.models.base_nets import (
    MultiHeadDotProductAttention,
    SpectralNormLinear,
    TorchLinear,
    dropout,
    gelu_exact,
    get_activation,
)
from lipvq_tpu_torch.models.mamba import MambaBackbone, MambaBlock
from lipvq_tpu_torch.models.obs_core import build_core, parse_core
from lipvq_tpu_torch.models.tokenizers.bin_action import AdaptiveBinActionEmbedding
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.models.transformer import (
    LN_EPS,
    GPTBackbone,
    sinusoidal_position_encoding,
)
from lipvq_tpu_torch.utils.obs_utils import LANG_EMB_KEY
from lipvq_tpu_torch.utils.profile_utils import span

# (key, shape) static spec type used across modules
ObsSpec = tuple  # tuple[tuple[str, tuple[int, ...]], ...]

# width of the FAST arm's context features: text embeddings of the context
# actions' FAST token strings, cut to 512 (the JAX algo's _FAST_FEAT_DIM)
FAST_FEAT_DIM = 512


def obs_spec(shapes: dict | Sequence) -> ObsSpec:
    """Normalize {key: shape} to a hashable ((key, shape), ...) spec."""
    items = shapes.items() if isinstance(shapes, dict) else shapes
    return tuple((k, tuple(v)) for k, v in items)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def flatten_time(tree, b: int, t: int):
    """Every leaf of a (nested) dict [B, T, ...] -> [B * T, ...]."""
    if isinstance(tree, dict):
        return {k: flatten_time(v, b, t) for k, v in tree.items()}
    return tree.reshape((b * t,) + tuple(tree.shape[2:]))


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
            total += parse_core(core)[1].get("feature_dimension", 64)
        else:
            total += _numel(shape)
    return total


class ObservationEncoder(nn.Module):
    """Encode an observation dict into one flat feature vector, keys in
    spec order. Low-dim keys pass through flattened; a key with an encoder
    core (``core_{key}``, built by ``obs_core.build_core``) goes through it,
    a language-conditioned core with the dict's ``lang_emb``."""

    def __init__(self, spec: ObsSpec, feature_activation: str | None = "relu",
                 encoder_cores: ObsSpec = ()):
        super().__init__()
        self.spec = spec
        self.feature_activation = feature_activation
        shapes = dict(spec)
        lang_dim = _numel(shapes[LANG_EMB_KEY]) if LANG_EMB_KEY in shapes else None
        self.conditioned = set()
        for key, core_name in encoder_cores:
            if key not in shapes:
                continue
            conditioned = "LanguageConditioned" in core_name
            self.add_module(f"core_{key}", build_core(
                core_name, shapes[key], lang_dim=lang_dim if conditioned else None))
            if conditioned:
                self.conditioned.add(key)

    def forward(self, obs_dict, train: bool = False,
                generator: torch.Generator | None = None):
        """``train`` advances the cores' BatchNorm statistics and turns on
        their randomizers, which draw from ``generator``."""
        feats = []
        for key, _ in self.spec:
            x = obs_dict[key]
            core = getattr(self, f"core_{key}", None)
            if core is None:
                feats.append(x.flatten(1))
            else:
                feats.append(core(x, train, generator, lang_emb=obs_dict.get(LANG_EMB_KEY)
                                  if key in self.conditioned else None))
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

    def forward(self, train: bool = False, generator: torch.Generator | None = None,
                **inputs):
        return torch.cat([getattr(self, f"enc_{g}")(inputs[g], train, generator)
                          for g in self.groups], dim=-1)


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


class RawActionTokenizer(nn.Module):
    """The default arm (every tokenizer switch false): a spectral-norm MLP
    ``action_dim -> 64 -> 128 -> output_dim`` (``sn1``..``sn3``), then
    ``num_layers`` post-LN encoder layers (torch ``TransformerEncoderLayer``
    defaults: MHA with bias, a GELU feed-forward of 256) and a linear
    ``out``. As in the reference and the JAX package, the [B*T, D] input is
    ONE sequence of length B*T: attention mixes every timestep of every
    batch element, so one element's result depends on the whole batch. The
    head count falls back to 1 where 8 does not divide ``output_dim`` (1 head
    of 791 at the flagship's width)."""

    def __init__(self, action_dim: int, output_dim: int, num_layers: int = 4,
                 num_heads: int = 8, dim_feedforward: int = 256):
        super().__init__()
        self.num_layers = num_layers
        self.sn1 = SpectralNormLinear(action_dim, 64)
        self.sn2 = SpectralNormLinear(64, 128)
        self.sn3 = SpectralNormLinear(128, output_dim)
        heads = num_heads if output_dim % num_heads == 0 else 1
        for i in range(num_layers):
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(output_dim, heads))
            self.add_module(f"ln1_{i}", nn.LayerNorm(output_dim, eps=LN_EPS))
            self.add_module(f"ff1_{i}", TorchLinear(output_dim, dim_feedforward))
            self.add_module(f"ff2_{i}", TorchLinear(dim_feedforward, output_dim))
            self.add_module(f"ln2_{i}", nn.LayerNorm(output_dim, eps=LN_EPS))
        self.out = TorchLinear(output_dim, output_dim)

    def forward(self, actions, train: bool = False):
        """actions [B*T, A] -> [B*T, output_dim]; ``train`` advances the
        spectral-norm vectors."""
        h = gelu_exact(self.sn1(actions, update_stats=train))
        h = gelu_exact(self.sn2(h, update_stats=train))
        x = self.sn3(h, update_stats=train)
        for i in range(self.num_layers):
            x = getattr(self, f"ln1_{i}")(x + getattr(self, f"attn_{i}")(x))
            ff = getattr(self, f"ff2_{i}")(gelu_exact(getattr(self, f"ff1_{i}")(x)))
            x = getattr(self, f"ln2_{i}")(x + ff)
        return self.out(x)


class LnActTokenizer(nn.Module):
    """The ln_act arm: a Mamba block (``mamba``) over the [B, T, A] action
    windows, then ``p1``..``p3``: ``A -> 64 -> 128 -> output_dim`` with
    GELU."""

    def __init__(self, action_dim: int, output_dim: int, seq_len: int = 10,
                 d_state: int = 8, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.action_dim, self.seq_len = action_dim, seq_len
        self.mamba = MambaBlock(action_dim, d_state=d_state, d_conv=d_conv, expand=expand)
        self.p1 = TorchLinear(action_dim, 64)
        self.p2 = TorchLinear(64, 128)
        self.p3 = TorchLinear(128, output_dim)

    def forward(self, actions):
        """actions [B*T, A] -> [B*T, output_dim]."""
        bt = actions.shape[0]
        xs = self.mamba(actions.reshape(bt // self.seq_len, self.seq_len, self.action_dim))
        h = gelu_exact(self.p1(xs.reshape(bt, self.action_dim)))
        h = gelu_exact(self.p2(h))
        return self.p3(h)


class ICLObservationGroupEncoder(nn.Module):
    """Group encoder + context-action tokenizer. The tokenizer switches take
    precedence in the order fast -> bin -> vq -> ln_act, as in the JAX
    package; all false selects the raw-action tokenizer. The FAST arm takes
    [B*T, FAST_FEAT_DIM] text features in place of actions and projects them
    by ``fast_proj_0..2`` (512 -> 64 -> 128 -> output_dim, GELU between)."""

    def __init__(self, group_specs: ObsSpec, action_input_shape: int,
                 vq_vae_enabled: bool = False, bin_enabled: bool = False,
                 fast_enabled: bool = False, ln_act_enabled: bool = False,
                 seq_len: int = 10, vq_num_codes: int = 1024, vq_hidden_dim: int = 128,
                 vq_ema_codebook: bool = False, vq_ema_decay: float = 0.99,
                 encoder_cores: ObsSpec = ()):
        super().__init__()
        self.group_encoder = ObservationGroupEncoder(
            group_specs, feature_activation=None, encoder_cores=encoder_cores)
        self.output_dim = sum(spec_encoded_dim(spec, encoder_cores)
                              for _, spec in group_specs)
        if fast_enabled:
            # the context actions arrive as FAST_FEAT_DIM-wide text features
            # of their DCT + BPE tokens, computed on the host by the algo
            self.arm = "fast"
            widths = (FAST_FEAT_DIM, 64, 128, self.output_dim)
            for i in range(3):
                self.add_module(f"fast_proj_{i}", TorchLinear(widths[i], widths[i + 1]))
        elif bin_enabled:
            self.arm = "bin"
            self.action_network = AdaptiveBinActionEmbedding(action_input_shape,
                                                             self.output_dim)
        elif vq_vae_enabled:
            self.arm = "vq"
            self.action_network = LipVQVAE(
                feature_dim=action_input_shape, latent_dim=self.output_dim,
                num_codes=vq_num_codes, hidden_dim=vq_hidden_dim,
                ema_codebook=vq_ema_codebook, ema_decay=vq_ema_decay)
        elif ln_act_enabled:
            self.arm = "ln_act"
            self.action_network = LnActTokenizer(action_input_shape, self.output_dim,
                                                 seq_len=seq_len)
        else:
            self.arm = "raw"
            self.action_network = RawActionTokenizer(action_input_shape, self.output_dim)

    def forward(self, obs, prompt_obs, prompt_actions, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        """Flattened [B*T, ...] inputs -> (obs_feat, ctx_obs_feat,
        ctx_act_feat, vq_aux_loss). ``train`` reaches the tokenizer's running
        statistics (EMA codebook, bin bounds, spectral-norm vectors) and the
        visual cores' (BatchNorm; randomizers drawing from ``generator``)."""
        groups = {"obs": obs}
        ctx_groups = {"obs": prompt_obs}
        if goal is not None:
            groups["goal"] = ctx_groups["goal"] = goal
        # query first, then context: the BatchNorm statistics advance in
        # this order, as flax applies the two calls' updates
        with span("model.trunks"):
            obs_feat = self.group_encoder(train, generator, **groups)
            ctx_obs_feat = self.group_encoder(train, generator, **ctx_groups)
        with span("model.tokenizer"):
            aux_loss = torch.zeros((), device=prompt_actions.device)
            if self.arm == "fast":
                h = gelu_exact(self.fast_proj_0(prompt_actions))
                ctx_act_feat = self.fast_proj_2(gelu_exact(self.fast_proj_1(h)))
            elif self.arm == "vq":
                ctx_act_feat, aux_loss, _ids = self.action_network(prompt_actions, train=train)
            elif self.arm == "bin":
                ctx_act_feat = self.action_network(prompt_actions, update_stats=train)
            elif self.arm == "ln_act":
                ctx_act_feat = self.action_network(prompt_actions)
            else:
                ctx_act_feat = self.action_network(prompt_actions, train=train)
        return obs_feat, ctx_obs_feat, ctx_act_feat, aux_loss


class ICLMIMOTransformer(nn.Module):
    """ICL composite: 3-stream embedding -> interleave -> backbone (GPT, or
    Mamba with ``backbone="mamba"``) -> decode. The timestep embedding is
    the learned offset ``embed_timestep`` (zeros) by default, the sinusoidal
    encoding with ``sinusoidal_embedding``, else the learned table
    ``embed_timestep_table`` (N(0, 1)). ``mamba_hybrid`` (``MambaBackbone``'s
    hybrid keywords) gives the Mamba backbone its hybrid layout, with
    ``num_heads``, ``causal`` and ``compute_dtype``; without it the Mamba
    backbone is fp32, as the JAX package's."""

    def __init__(self, group_specs: ObsSpec, output_spec: ObsSpec,
                 backbone: str = "transformer", mamba_d_state: int = 8,
                 mamba_d_conv: int = 4, mamba_expand: int = 2,
                 mamba_hybrid: dict | None = None, embed_dim: int = 512,
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
        if backbone not in ("transformer", "mamba"):
            raise ValueError(f"backbone is 'transformer' or 'mamba', got {backbone!r}")
        if nn_parameter_for_timesteps and sinusoidal_embedding:
            raise ValueError("sinusoidal_embedding needs nn_parameter_for_timesteps off")
        self.embed_dim = embed_dim
        self.context_length = context_length
        self.emb_dropout = emb_dropout
        self.sinusoidal_embedding = sinusoidal_embedding
        self.encoder = ICLObservationGroupEncoder(
            group_specs, action_input_shape, vq_vae_enabled=vq_vae_enabled,
            bin_enabled=bin_enabled, fast_enabled=fast_enabled,
            ln_act_enabled=ln_act_enabled, seq_len=context_length,
            vq_num_codes=vq_num_codes, vq_hidden_dim=vq_hidden_dim,
            vq_ema_codebook=vq_ema_codebook, vq_ema_decay=vq_ema_decay,
            encoder_cores=encoder_cores)
        self.embed_encoder = TorchLinear(self.encoder.output_dim, embed_dim)
        self.embed_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.embed_timestep = self.embed_timestep_table = None
        if nn_parameter_for_timesteps:
            self.embed_timestep = nn.Parameter(torch.empty(1, context_length, embed_dim))
        elif not sinusoidal_embedding:
            self.embed_timestep_table = nn.Parameter(torch.empty(context_length, embed_dim))
        if backbone == "mamba":
            hybrid = ({} if mamba_hybrid is None else
                      dict(mamba_hybrid, num_heads=num_heads, causal=causal,
                           compute_dtype=compute_dtype))
            self.transformer = MambaBackbone(
                embed_dim, num_layers=num_layers, d_state=mamba_d_state,
                d_conv=mamba_d_conv, expand=mamba_expand, **hybrid)
        else:
            self.transformer = GPTBackbone(
                embed_dim=embed_dim, context_length=3 * context_length, causal=causal,
                attn_dropout=attn_dropout, block_output_dropout=block_output_dropout,
                num_layers=num_layers, num_heads=num_heads, activation=activation,
                remat=remat, compute_dtype=compute_dtype, activation_dtype=activation_dtype)
        self.decoder = ObservationDecoder(embed_dim, output_spec)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.embed_timestep is not None:
                self.embed_timestep.zero_()
            if self.embed_timestep_table is not None:
                self.embed_timestep_table.normal_(0.0, 1.0, generator=generator)

    def input_embedding(self, feats, train: bool = False,
                        generator: torch.Generator | None = None):
        """Linear embed + timestep embedding + LN + dropout. feats
        [B, T, D_in]."""
        emb = self.embed_encoder(feats)
        b, t = emb.shape[:2]
        if self.sinusoidal_embedding:
            ts = torch.arange(t, dtype=torch.float32, device=emb.device).expand(b, t)
            emb = emb + sinusoidal_position_encoding(ts, self.embed_dim)
        elif self.embed_timestep is not None:
            emb = emb + self.embed_timestep
        else:
            emb = emb + self.embed_timestep_table[None, :t]
        return dropout(self.embed_ln(emb), self.emb_dropout, generator, train)

    def forward(self, obs, prompt_obs, prompt_actions, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        """All obs leaves [B, T, ...]; prompt_actions [B, T, A].
        Returns (outputs dict of [B, T, ...], vq_aux_loss)."""
        b, t = next(iter(obs.values())).shape[:2]
        obs_f, ctx_obs_f, ctx_act_f, aux = self.encoder(
            flatten_time(obs, b, t), flatten_time(prompt_obs, b, t),
            prompt_actions.flatten(0, 1),
            goal=flatten_time(goal, b, t) if goal is not None else None, train=train,
            generator=generator)
        obs_emb = self.input_embedding(obs_f.unflatten(0, (b, t)), train, generator)
        ctx_obs_emb = self.input_embedding(ctx_obs_f.unflatten(0, (b, t)), train, generator)
        ctx_act_emb = self.input_embedding(ctx_act_f.unflatten(0, (b, t)), train, generator)
        # interleave [ctx_obs_0, ctx_act_0, ctx_obs_1, ...], then the T
        # query-obs tokens
        interleaved = torch.stack([ctx_obs_emb, ctx_act_emb], dim=2).reshape(
            b, 2 * t, self.embed_dim)
        tokens = torch.cat([interleaved, obs_emb], dim=1)  # [B, 3T, D]
        with span("model.backbone"):
            hidden = self.transformer(tokens, train, generator)
        with span("model.head"):
            return self.decoder(hidden[:, -t:]), aux


class MIMOTransformer(nn.Module):
    """Non-ICL MIMO transformer (the JAX package's ``MIMOTransformer``, used by
    the BC transformer baseline): encode the obs of each timestep, linear
    embed + timestep embedding + LN + dropout, GPT over the T tokens, one
    decoder head per output key at every timestep. The timestep embedding
    is sinusoidal with ``sinusoidal_embedding``, else the learned offset
    ``embed_timestep`` (zeros) with ``nn_parameter_for_timesteps``, else
    none; the parameter exists whenever ``nn_parameter_for_timesteps`` is
    set, as in flax. Its GPT runs in fp32 without remat, as the JAX
    package's only caller builds it (ROADMAP queue 3, fault (e))."""

    def __init__(self, group_specs: ObsSpec, output_spec: ObsSpec, embed_dim: int = 512,
                 num_layers: int = 6, num_heads: int = 8, context_length: int = 10,
                 causal: bool = True, emb_dropout: float = 0.1, attn_dropout: float = 0.1,
                 block_output_dropout: float = 0.1, sinusoidal_embedding: bool = False,
                 nn_parameter_for_timesteps: bool = True, activation: str = "gelu",
                 encoder_cores: ObsSpec = ()):
        super().__init__()
        self.embed_dim = embed_dim
        self.emb_dropout = emb_dropout
        self.sinusoidal_embedding = sinusoidal_embedding
        self.encoder = ObservationGroupEncoder(group_specs, feature_activation=None,
                                               encoder_cores=encoder_cores)
        in_dim = sum(spec_encoded_dim(spec, encoder_cores) for _, spec in group_specs)
        self.embed_encoder = TorchLinear(in_dim, embed_dim)
        self.embed_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.embed_timestep = (nn.Parameter(torch.empty(1, context_length, embed_dim))
                               if nn_parameter_for_timesteps else None)
        self.transformer = GPTBackbone(
            embed_dim=embed_dim, context_length=context_length, causal=causal,
            attn_dropout=attn_dropout, block_output_dropout=block_output_dropout,
            num_layers=num_layers, num_heads=num_heads, activation=activation)
        self.decoder = ObservationDecoder(embed_dim, output_spec)

    def init_weights(self, generator: torch.Generator) -> None:
        if self.embed_timestep is not None:
            with torch.no_grad():
                self.embed_timestep.zero_()

    def forward(self, obs, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        """obs (and goal) leaves [B, T, ...] -> outputs dict of [B, T, ...];
        ``train`` turns on dropout, drawing from ``generator``."""
        b, t = next(iter(obs.values())).shape[:2]
        groups = {"obs": flatten_time(obs, b, t)}
        if goal is not None:
            groups["goal"] = flatten_time(goal, b, t)
        emb = self.embed_encoder(self.encoder(train, generator, **groups).reshape(b, t, -1))
        if self.sinusoidal_embedding:
            ts = torch.arange(t, dtype=torch.float32, device=emb.device).expand(b, t)
            emb = emb + sinusoidal_position_encoding(ts, self.embed_dim)
        elif self.embed_timestep is not None:
            emb = emb + self.embed_timestep[:, :t]
        emb = dropout(self.embed_ln(emb), self.emb_dropout, generator, train)
        return self.decoder(self.transformer(emb, train, generator))
