"""ICL (in-context imitation learning) policies (counterpart of
``lipvq_tpu/algo/icl.py``): ``ICLTransformerGMM``, ``ICLMambaGMM`` (the same
with the Mamba backbone, the ``icl_mamba`` algo) and the non-GMM
``ICLTransformer`` (either backbone).

- networks built from the config's sequence section (``algo.transformer``,
  or ``algo.mamba`` for the Mamba backbone), initialized from
  ``train.seed``;
- with the LipVQ tokenizer two optimizers: the policy's (Adam with L2 or
  AdamW, schedule, global-norm clip) over every parameter outside the
  action tokenizer, and the tokenizer's AdamW(``vq.optimizer_lr``, wd
  ``vq.optimizer_wd``), no clip (reference icl.py:885-889); with any other
  arm the policy optimizer covers every parameter, the tokenizer's too;
- the running statistics (the visual cores' BatchNorm, the EMA codebook,
  the bin bounds, the spectral-norm vectors: the JAX package's mutable
  collections) are buffers that advance in a training step only, never in
  validation or ``get_action``; the explicit ``train`` flag decides, not
  ``nn.Module.training``. The visual cores' randomizers (crop, colour,
  noise) draw from the dropout generator in a training step only;
- camera frames: ``process_batch_for_training`` keeps uint8 frames uint8
  and ``_put_batch`` divides them by 255 on the device (bit-equal to the
  JAX package's host division, a quarter of the bytes to copy);
- ``train_on_batch``: the first half of the batch is the context, the second
  the queries (reference icl.py:904-911); GMM NLL of the query actions (the
  non-GMM head: weighted L2 + SmoothL1 + cosine) plus the tokenizer's loss,
  one backward, the optimizers stepped; with the EMA codebook the smoothed
  EMA means overwrite the touched codes last;
- ``process_batch_for_training`` slices the context window and picks the
  current/future action windows (reference icl.py:759-794);
- ``get_action`` runs the eval forward under ``torch.inference_mode()`` with
  low-noise GMM sampling (the non-GMM head's actions as they are) and takes
  ``[:, 0]`` when ``pred_future_acs`` else ``[:, -1]`` (reference
  icl.py:845-852);
- the FAST arm (``fast_enabled``): the context stream takes host-computed
  text features of the context actions' DCT + BPE tokens
  (``ctx_act_feat``, [B, T, 512]) while the targets stay raw actions. The
  FAST tokenizer refits over the accumulated early batches, every
  ``process_batch_for_training`` call counting, and freezes at 2048
  windows or 8 batches; the fitted tokenizer (bounds and BPE bytes) rides
  in ``serialize`` as tensors, and a FAST algo loaded without it raises
  rather than fit an unrelated vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch

from lipvq_tpu_torch.algo.base import (
    PolicyAlgo,
    ScheduledOptimizer,
    global_norm,
    optimizer_from_optim_params,
    register_algo_factory_func,
)
from lipvq_tpu_torch.models.base_nets import batch_mean, seeded_init
from lipvq_tpu_torch.models.distributions import (
    GMMParams,
    gmm_log_prob,
    gmm_sample,
    gmm_sample_from_draws,
)
from lipvq_tpu_torch.models.obs_nets import FAST_FEAT_DIM, obs_spec
from lipvq_tpu_torch.models.policy_nets import ICLActorNetwork, ICLGMMActorNetwork
from lipvq_tpu_torch.models.tokenizers.fast import FastActionTokenizer
from lipvq_tpu_torch.utils.lang_utils import LangEncoder
from lipvq_tpu_torch.utils.obs_utils import encoder_cores_from_config, process_obs_for_device


@register_algo_factory_func("icl")
def algo_config_to_class(algo_config):
    """transformer + gmm -> ICLTransformerGMM, else ICLTransformer."""
    if not algo_config.transformer.enabled:
        raise ValueError("the icl algo needs algo.transformer.enabled")
    if algo_config.gmm.enabled:
        return ICLTransformerGMM, {}
    return ICLTransformer, {}


@register_algo_factory_func("icl_mamba")
def mamba_algo_config_to_class(algo_config):
    """gmm -> ICLMambaGMM, else ICLTransformer on the Mamba backbone."""
    if algo_config.gmm.enabled:
        return ICLMambaGMM, {}
    return ICLTransformer, {"backbone": "mamba"}


def _seq_section(algo_config, backbone: str):
    return algo_config.mamba if backbone == "mamba" else algo_config.transformer


# the FAST tokenizer's fit: refit on every early batch, frozen from this many
# accumulated windows or batches on (reference algo/icl.py:282-306)
FAST_FREEZE_WINDOWS, FAST_FREEZE_BATCHES = 2048, 8
FAST_VOCAB_SIZE = 1024
# the FAST tokenizer's fields in a ``serialize`` payload
_FAST_KEYS = ("fast_tokenizer.lo", "fast_tokenizer.hi", "fast_tokenizer.vocab_size",
              "fast_tokenizer.bpe")


def _torch_dtype(name: str) -> torch.dtype | None:
    """Config dtype string -> torch dtype; "float32" means no cast (None)."""
    if str(name) == "float32":
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


class ICLTransformerGMM(PolicyAlgo):
    """ICL policy with a GMM head over the transformer (or Mamba) backbone.
    As in the JAX package, ``algo.mamba.{d_state,d_conv,expand}`` are not
    read: the Mamba backbone takes ICLMIMOTransformer's defaults (8, 4, 2)."""

    backbone = "transformer"
    net_cls = ICLGMMActorNetwork

    def __init__(self, *args, backbone: str | None = None, **kwargs):
        if backbone is not None:
            self.backbone = backbone
        super().__init__(*args, **kwargs)

    def _head_kwargs(self) -> dict:
        gmm = self.algo_config.gmm
        return {"num_modes": int(gmm.num_modes), "min_std": float(gmm.min_std),
                "std_activation": str(gmm.std_activation),
                "low_noise_eval": bool(gmm.low_noise_eval)}

    def _create_networks(self):
        tc = _seq_section(self.algo_config, self.backbone)
        self.context_length = int(tc.context_length)
        self.supervise_all_steps = bool(tc.supervise_all_steps)
        self.pred_future_acs = bool(tc.pred_future_acs)
        if self.pred_future_acs and not self.supervise_all_steps:
            raise ValueError("pred_future_acs needs supervise_all_steps")
        self.vq_vae_enabled = bool(tc.vq_vae_enabled)
        self.fast_enabled = bool(tc.fast_enabled)
        self._fast_tok = None
        self._fast_lang = None
        self._fast_frozen = False
        self._fast_fit_buf: list = []
        self._fast_missing_from_ckpt = False

        group_specs = [("obs", obs_spec(self.obs_shapes))]
        if self.goal_shapes:
            group_specs.append(("goal", obs_spec(self.goal_shapes)))
        vq_cfg = self.algo_config.get("vq", {})
        self.vq_ema = self.vq_vae_enabled and bool(vq_cfg.get("ema_codebook", False))
        self.nets = self.net_cls(
            group_specs=tuple(group_specs),
            ac_dim=self.ac_dim,
            **self._head_kwargs(),
            backbone=self.backbone,
            embed_dim=int(tc.embed_dim),
            num_layers=int(tc.num_layers),
            num_heads=int(tc.num_heads),
            context_length=self.context_length,
            causal=bool(tc.causal),
            emb_dropout=float(tc.emb_dropout),
            attn_dropout=float(tc.attn_dropout),
            block_output_dropout=float(tc.block_output_dropout),
            sinusoidal_embedding=bool(tc.sinusoidal_embedding),
            nn_parameter_for_timesteps=bool(tc.nn_parameter_for_timesteps),
            activation=str(tc.activation),
            remat=bool(tc.get("remat", False)),
            compute_dtype=_torch_dtype(tc.get("compute_dtype", "float32")),
            activation_dtype=_torch_dtype(tc.get("activation_dtype", "float32")),
            action_input_shape=self.ac_dim,
            vq_vae_enabled=self.vq_vae_enabled,
            bin_enabled=bool(tc.bin_enabled),
            fast_enabled=self.fast_enabled,
            ln_act_enabled=bool(tc.ln_act_enabled),
            vq_num_codes=int(vq_cfg.get("num_codes", 1024)),
            vq_hidden_dim=int(vq_cfg.get("hidden_dim", 128)),
            vq_ema_codebook=self.vq_ema,
            vq_ema_decay=float(vq_cfg.get("ema_decay", 0.99)),
            encoder_cores=encoder_cores_from_config(self.obs_config, self.obs_shapes),
        )
        # initialize on the CPU, then move: one seed, the same weights on
        # every device
        seed = int(self.global_config.train.seed)
        seeded_init(self.nets, torch.Generator().manual_seed(seed))
        self.nets.to(self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 2)
        self._dropout_generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _create_optimizers(self):
        """Policy optimizer over every parameter outside the tokenizer, VQ
        AdamW over the tokenizer (reference icl.py:885-889)."""
        vq_params = []
        if self.vq_vae_enabled:
            vq_params = list(self.nets.net.encoder.action_network.parameters())
        vq_ids = {id(p) for p in vq_params}
        policy_params = [p for p in self.nets.parameters() if id(p) not in vq_ids]
        self.policy_optimizer = optimizer_from_optim_params(
            policy_params, self.algo_config.optim_params.policy,
            max_grad_norm=self.global_config.train.max_grad_norm)
        self.vq_optimizer = None
        if vq_params:
            vq_cfg = self.algo_config.get("vq", {})
            lr = float(vq_cfg.get("optimizer_lr", 1e-3))
            self.vq_optimizer = ScheduledOptimizer(
                vq_params, torch.optim.AdamW, lambda step: lr,
                weight_decay=float(vq_cfg.get("optimizer_wd", 1e-4)), eps=1e-8)

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        out = {"policy": self.policy_optimizer}
        if self.vq_optimizer is not None:
            out["vq"] = self.vq_optimizer
        return out

    def generators(self) -> dict[str, torch.Generator]:
        return {"dropout": self._dropout_generator, "sample": self._generator}

    # -- data prep (host side, numpy) --------------------------------------
    def process_batch_for_training(self, batch):
        """Slice the context window + pick action targets
        (reference icl.py:759-794). Camera frames stay uint8 until
        ``_put_batch`` divides them on the device."""
        h = self.context_length
        out = {}
        out["obs"] = {
            k: process_obs_for_device(np.asarray(v)[:, :h], obs_key=k)
            for k, v in batch["obs"].items()
        }
        out["goal_obs"] = batch.get("goal_obs", None)
        actions = np.asarray(batch["actions"])
        if self.supervise_all_steps:
            ac_start = h - 1 if self.pred_future_acs else 0
            out["actions"] = actions[:, ac_start : ac_start + h]
            if self.pred_future_acs and out["actions"].shape[1] != h:
                raise ValueError(f"pred_future_acs needs {2 * h - 1} action "
                                 f"steps, got {actions.shape[1]}")
        else:
            # the context stream needs the [B, T, A] window; training
            # supervises only the final timestep
            out["actions"] = actions[:, :h]
        if self.fast_enabled:
            out["ctx_act_feat"] = self._fast_features(out["actions"])
        return out

    def _fast_features(self, actions) -> np.ndarray:
        """[B, T, A] action windows -> [B, T, FAST_FEAT_DIM] text features of
        their FAST token strings (reference obs_nets.py:1306-1334, batched).
        Until the fit freezes, each call first refits the tokenizer over every
        window seen so far. A string's embedding does not depend on the
        vocabulary, so the LangEncoder's per-string cache outlives the refits."""
        chunks = np.asarray(actions, np.float32)
        if self._fast_tok is None and self._fast_missing_from_ckpt:
            # fitting here would serve a vocabulary unrelated to training
            raise RuntimeError("this fast_enabled checkpoint carries no FAST tokenizer; "
                               "re-save it from a FAST training run")
        if self._fast_tok is None or not self._fast_frozen:
            self._fast_fit_buf.append(chunks)
            corpus = np.concatenate(self._fast_fit_buf, axis=0)
            tok = FastActionTokenizer(vocab_size=FAST_VOCAB_SIZE)
            tok.fit(corpus)
            self._fast_tok = tok
            self._fast_frozen = (corpus.shape[0] >= FAST_FREEZE_WINDOWS
                                 or len(self._fast_fit_buf) >= FAST_FREEZE_BATCHES)
            if self._fast_frozen:
                self._fast_fit_buf = []
        if self._fast_lang is None:
            self._fast_lang = LangEncoder(device=self.device)
        return self._fast_tok.features_for_policy(
            chunks, self._fast_lang,
            seq_len=chunks.shape[1], feat_dim=FAST_FEAT_DIM)

    # -- head-specific pieces (overridden by the non-GMM variant) ----------
    def _slice_last_step(self, dists: GMMParams) -> GMMParams:
        return GMMParams(*(a[:, -1] for a in dists))

    def _policy_loss(self, dists: GMMParams, target_act) -> torch.Tensor:
        """GMM NLL (reference icl.py:947-974)."""
        return -batch_mean(gmm_log_prob(dists, target_act))

    def _action_from_head(self, dists: GMMParams, draws=None) -> torch.Tensor:
        """GMM: sample (reference policy_nets.py:2583-2599) from the sample
        generator, or from ``draws`` = (u, eps) of ``gmm_draws``."""
        if draws is not None:
            return gmm_sample_from_draws(dists, *draws)
        return gmm_sample(dists, self._generator)

    # -- data-parallel layout ------------------------------------------------
    def _shard_rows(self, rows: int):
        """The batch is context demos then query demos, and demo i of the two
        halves is a pair: ranks split the pairs (as evenly as they go: B = 6
        over 2 ranks gives 2 and 1, B = 2 one and none) and take the same
        pairs of both halves, so context row i stays paired with query row
        i, as GSPMD's slices of the global halves keep them."""
        h = rows // 2
        return h, torch.tensor_split(torch.arange(h), self.mesh.shape["data"])[
            self.mesh.data_index]

    def _batch_rows(self, rows: int) -> torch.Tensor:
        h, mine = self._shard_rows(rows)
        return torch.cat([mine, mine + h])

    def _loss_share(self) -> float | None:
        """Under a mesh, the factor that makes the ranks' averaged losses the
        global batch's: (ranks x this rank's pairs / all pairs), this rank's
        means being over its own pairs."""
        if self.mesh is None:
            return None
        total, mine = self._shard
        return self.mesh.shape["data"] * len(mine) / total

    # -- training ----------------------------------------------------------
    def train_on_batch(self, batch, epoch, validate: bool = False):
        """One step on a processed batch (``process_batch_for_training``).
        Returns {"losses": {action_loss, log_probs, vq_loss,
        policy_grad_norms}} as device scalars: nothing is fetched to the
        host. ``validate=True`` runs the loss without dropout, EMA update or
        parameter change, with ``policy_grad_norms`` 0."""
        batch = self._put_batch(batch)
        obs, actions, goal = batch["obs"], batch["actions"], batch.get("goal_obs")
        mid = next(iter(obs.values())).shape[0] // 2
        ctx_obs = {k: v[:mid] for k, v in obs.items()}
        qry_obs = {k: v[mid:] for k, v in obs.items()}
        # FAST: the context stream takes the token features, the targets stay
        # the raw actions
        ctx_src = batch["ctx_act_feat"] if self.fast_enabled else actions
        ctx_act, qry_act = ctx_src[:mid], actions[mid:]
        train = not validate
        with torch.set_grad_enabled(train):
            dists, aux = self.nets.forward_train(
                qry_obs, ctx_obs, ctx_act, goal=goal, train=train, low_noise_eval=False,
                generator=self._dropout_generator if train else None)
            if not self.supervise_all_steps:
                dists, qry_act = self._slice_last_step(dists), qry_act[:, -1]
            action_loss = self._policy_loss(dists, qry_act)
            share = self._loss_share()
            if share is not None:
                action_loss, aux = action_loss * share, aux * share
        if validate:
            grad_norm = torch.zeros((), device=self.device)
        else:
            (action_loss + aux).backward()
            optimizers = [o for o in (self.policy_optimizer, self.vq_optimizer) if o]
            # the norm of every grad, taken before the policy's clip
            grad_norm = global_norm([g for o in optimizers for g in o.grads()])
            for o in optimizers:
                o.step()
                o.zero_grad()
            if self.vq_ema:
                self.nets.net.encoder.action_network.apply_ema_codebook()
        action_loss = action_loss.detach()
        return {"losses": {"action_loss": action_loss, "log_probs": -action_loss,
                           "vq_loss": aux.detach(), "policy_grad_norms": grad_norm}}

    def log_info(self, info) -> dict:
        losses = info["losses"]
        log = {"Loss": float(losses["action_loss"]),
               "Log_Likelihood": float(losses["log_probs"])}
        if self.vq_vae_enabled:
            log["VQ_Loss"] = float(losses["vq_loss"])
        if "policy_grad_norms" in losses:
            log["Policy_Grad_Norms"] = float(losses["policy_grad_norms"])
        return log

    # -- inference ---------------------------------------------------------
    def _get_action_impl(self, obs, ctx_obs, ctx_act, goal, draws=None):
        """The served forward (``serve_fn`` of the JAX export); ``draws``
        stand for the sample generator's (``scripts/export_policy.py``)."""
        dists, _ = self.nets.forward_train(obs, ctx_obs, ctx_act, goal=goal,
                                           low_noise_eval=True)
        out = self._action_from_head(dists, draws)
        if self.supervise_all_steps and self.pred_future_acs:
            return out[:, 0]
        return out[:, -1]

    def get_action(self, obs_dict, context_batch, goal_dict=None):
        """obs_dict leaves [B, T, ...]; context_batch holds obs/actions
        leaves [B, T, ...] (reference icl.py:827-853) -> actions [B, A]."""
        ctx_act = context_batch["actions"]
        if self.fast_enabled:
            # contexts from process_batch_for_training carry the features;
            # raw contexts are converted here
            ctx_act = context_batch.get("ctx_act_feat")
            if ctx_act is None:
                actions = context_batch["actions"]
                if isinstance(actions, torch.Tensor):
                    actions = actions.cpu().numpy()
                ctx_act = self._fast_features(actions)
        with torch.inference_mode():
            act = self._get_action_impl(
                self._put_infer(obs_dict),
                self._put_infer(context_batch["obs"]),
                self._put_infer(ctx_act),
                self._put_infer(goal_dict) if goal_dict else None,
            )
            return act.cpu().numpy()

    # -- checkpointing: the fitted FAST tokenizer rides along ----------------
    def serialize(self) -> dict[str, torch.Tensor]:
        """The nets' state_dict and, once a FAST tokenizer is fitted, its
        quantile bounds, vocabulary size and BPE bytes (as a uint8 tensor: a
        checkpoint holds tensors only, so ``weights_only=True`` reads it)."""
        payload = super().serialize()
        if self.fast_enabled and self._fast_tok is not None:
            tok = self._fast_tok
            bpe = torch.frombuffer(bytearray(tok.bpe.to_bytes()), dtype=torch.uint8)
            payload.update(zip(_FAST_KEYS, (
                torch.from_numpy(np.asarray(tok.lo, np.float32).copy()),
                torch.from_numpy(np.asarray(tok.hi, np.float32).copy()),
                torch.tensor(int(tok.vocab_size), dtype=torch.int64), bpe)))
        return payload

    def deserialize(self, payload) -> None:
        """Load a ``serialize`` payload; a FAST tokenizer in it is restored,
        frozen. A FAST algo given a payload without one raises at its next
        feature computation unless it has fitted its own."""
        payload = dict(payload)
        fields = [payload.pop(k, None) for k in _FAST_KEYS]
        super().deserialize(payload)
        if any(f is None for f in fields):
            if any(f is not None for f in fields):
                raise KeyError(f"the FAST tokenizer's payload is incomplete: "
                               f"{[k for k, f in zip(_FAST_KEYS, fields) if f is None]} "
                               f"missing")
            self._fast_missing_from_ckpt = self.fast_enabled
            return
        lo, hi, vocab_size, bpe = fields
        tok = FastActionTokenizer(vocab_size=int(vocab_size))
        tok.lo, tok.hi = lo.numpy().copy(), hi.numpy().copy()
        tok.bpe.from_bytes(bpe.numpy().tobytes())
        self._fast_tok = tok
        self._fast_frozen = True


class ICLMambaGMM(ICLTransformerGMM):
    """ICLTransformerGMM on the Mamba backbone (the ``icl_mamba`` algo)."""

    backbone = "mamba"


class ICLTransformer(ICLTransformerGMM):
    """Non-GMM ICL: a deterministic tanh actor trained with the weighted L2 +
    SmoothL1 + cosine loss (reference icl.py:187-201, weights
    ``algo.loss.*``), on either backbone."""

    net_cls = ICLActorNetwork

    def _head_kwargs(self) -> dict:
        return {}

    def _slice_last_step(self, preds):
        return preds[:, -1]

    def _policy_loss(self, preds, target_act) -> torch.Tensor:
        """l2_weight * MSE + l1_weight * SmoothL1 (beta 1) + cos_weight *
        (1 - cosine similarity of the first 3 dims) (loss_utils.py:11-23)."""
        lw = self.algo_config.loss
        diff = preds - target_act
        l2 = batch_mean(diff ** 2)
        ad = diff.abs()
        l1 = batch_mean(torch.where(ad < 1.0, 0.5 * diff ** 2, ad - 0.5))
        p3, t3 = preds[..., :3], target_act[..., :3]
        sim = (p3 * t3).sum(-1) / (torch.linalg.vector_norm(p3, dim=-1)
                                   * torch.linalg.vector_norm(t3, dim=-1) + 1e-8)
        cos = -batch_mean(sim - 1.0)
        return (float(lw.l2_weight) * l2 + float(lw.l1_weight) * l1
                + float(lw.cos_weight) * cos)

    def _action_from_head(self, preds, draws=None) -> torch.Tensor:
        return preds
