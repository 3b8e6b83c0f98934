"""Behavior cloning family (counterpart of ``lipvq_tpu/algo/bc.py``).

- ``BC``                — deterministic MLP actor, weighted L2 + L1 + cosine
- ``BCGaussian``        — a 1-mode GMM with the ``gaussian`` section's std
- ``BCGMM``             — MLP GMM actor, NLL
- ``BCVAE``             — cVAE over actions conditioned on the obs, ELBO
- ``BCRNNGMM``          — LSTM GMM over obs sequences, NLL at every step
- ``BCTransformerGMM``  — ``MIMOTransformer`` GMM over obs sequences, NLL at
  the last step (every step with ``supervise_all_steps``)

The factory dispatches in the JAX package's order: transformer + gmm, rnn +
gmm, vae, gmm, gaussian, else BC. One policy optimizer (the schedule, L2
and global-norm clip of ``optim_params.policy``) over every parameter; the
train step returns device scalars with the gradient norm taken before the
clip. The sequence variants take ``train.seq_length`` windows cut to the
context length (transformer) or the RNN horizon and, in ``get_action``, the
last step of the predicted sequence. Random draws (dropout masks, GMM and
prior samples, the VAE's reparameterization) come from the algo's
generators; ``train_on_batch(..., draws=)`` hands BC-VAE its noise instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lipvq_tpu_torch.algo.base import (
    PolicyAlgo,
    ScheduledOptimizer,
    global_norm,
    optimizer_from_optim_params,
    register_algo_factory_func,
)
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.distributions import GMMParams, gmm_log_prob, gmm_sample
from lipvq_tpu_torch.models.obs_nets import ObservationGroupEncoder, obs_spec, spec_flat_dim
from lipvq_tpu_torch.models.policy_nets import (
    ActorNetwork,
    GMMActorNetwork,
    RNNGMMActorNetwork,
    TransformerGMMActorNetwork,
)
from lipvq_tpu_torch.models.vae_nets import VAE
from lipvq_tpu_torch.utils.obs_utils import encoder_cores_from_config, process_obs_for_device


@register_algo_factory_func("bc")
def algo_config_to_class(algo_config):
    """Dispatch on the enabled sections (reference bc.py:30-60)."""
    if algo_config.transformer.enabled and algo_config.gmm.enabled:
        return BCTransformerGMM, {}
    if algo_config.rnn.enabled and algo_config.gmm.enabled:
        return BCRNNGMM, {}
    if algo_config.vae.enabled:
        return BCVAE, {}
    if algo_config.gmm.enabled:
        return BCGMM, {}
    if algo_config.gaussian.enabled:
        return BCGaussian, {}
    return BC, {}


class BC(PolicyAlgo):
    """Vanilla BC: deterministic actor, l2_weight * MSE + l1_weight * MAE +
    cos_weight * (1 - mean cosine similarity)."""

    sequence = False  # obs [B, ...] (one step)

    def _create_networks(self):
        group_specs = [("obs", obs_spec(self.obs_shapes))]
        if self.goal_shapes:
            group_specs.append(("goal", obs_spec(self.goal_shapes)))
        self.group_specs = tuple(group_specs)
        self.encoder_cores = encoder_cores_from_config(self.obs_config, self.obs_shapes)
        self.nets = self._build_net()
        # initialize on the CPU, then move: one seed, the same weights on
        # every device
        seed = int(self.global_config.train.seed)
        seeded_init(self.nets, torch.Generator().manual_seed(seed))
        self.nets.to(self.device)
        self._dropout_generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 3)

    def _build_net(self) -> nn.Module:
        return ActorNetwork(self.group_specs, self.ac_dim,
                            layer_dims=tuple(self.algo_config.actor_layer_dims),
                            encoder_cores=self.encoder_cores)

    def _seq_len(self) -> int:
        if self.algo_config.transformer.enabled:
            return int(self.algo_config.transformer.context_length)
        if self.algo_config.rnn.enabled:
            return int(self.algo_config.rnn.horizon)
        return 1

    def _create_optimizers(self):
        self.policy_optimizer = optimizer_from_optim_params(
            self.nets.parameters(), self.algo_config.optim_params.policy,
            max_grad_norm=self.global_config.train.max_grad_norm)

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return {"policy": self.policy_optimizer}

    def generators(self) -> dict[str, torch.Generator]:
        return {"dropout": self._dropout_generator, "sample": self._generator}

    # -- batch prep ----------------------------------------------------------
    def process_batch_for_training(self, batch):
        """The first step (or the first ``_seq_len()`` steps of a sequence
        variant) of obs and actions; camera frames stay uint8 until
        ``_put_batch`` divides them on the device."""
        out = {"goal_obs": batch.get("goal_obs", None)}
        if self.sequence:
            t = self._seq_len()
            out["obs"] = {k: process_obs_for_device(np.asarray(v)[:, :t], obs_key=k)
                          for k, v in batch["obs"].items()}
            out["actions"] = np.asarray(batch["actions"])[:, :t]
        else:
            out["obs"] = {k: process_obs_for_device(np.asarray(v)[:, 0], obs_key=k)
                          for k, v in batch["obs"].items()}
            out["actions"] = np.asarray(batch["actions"])[:, 0]
        return out

    # -- losses ----------------------------------------------------------------
    def _loss(self, batch, train: bool, draws=None):
        actions = batch["actions"]
        pred = self.nets(batch["obs"], goal=batch["goal_obs"], train=train,
                         generator=self._dropout_generator if train else None)
        diff = pred - actions
        l2 = torch.mean(diff ** 2)
        l1 = torch.mean(diff.abs())
        cos = 1.0 - torch.mean(
            (pred * actions).sum(-1) / (torch.linalg.vector_norm(pred, dim=-1)
                                        * torch.linalg.vector_norm(actions, dim=-1) + 1e-8))
        lw = self.algo_config.loss
        loss = (float(lw.l2_weight) * l2 + float(lw.l1_weight) * l1
                + float(lw.cos_weight) * cos)
        return loss, {"action_loss": loss, "l2_loss": l2, "l1_loss": l1, "cos_loss": cos}

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One step on a processed batch -> {"losses": device scalars}, with
        ``policy_grad_norms`` (before the clip) in a training step.
        ``validate=True`` computes the losses only."""
        batch = self._put_batch(batch)
        train = not validate
        with torch.set_grad_enabled(train):
            loss, metrics = self._loss(batch, train, draws)
        if train:
            loss.backward()
            metrics["policy_grad_norms"] = global_norm(self.policy_optimizer.grads())
            self.policy_optimizer.step()
            self.policy_optimizer.zero_grad()
        return {"losses": {k: v.detach() for k, v in metrics.items()}}

    def log_info(self, info) -> dict:
        losses = info["losses"]
        log = {"Loss": float(losses["action_loss"])}
        for k in ("l2_loss", "l1_loss", "cos_loss", "log_probs"):
            if k in losses:
                log[k.title()] = float(losses[k])
        return log

    # -- inference ---------------------------------------------------------------
    def _action(self, obs, goal):
        return self.nets(obs, goal=goal)

    def get_action(self, obs_dict, goal_dict=None):
        """obs leaves [B, ...] ([B, T, ...] for the sequence variants) ->
        actions [B, A] (a sequence variant's last step)."""
        with torch.inference_mode():
            act = self._action(self._put_infer(obs_dict),
                               self._put_infer(goal_dict) if goal_dict else None)
            act = act.cpu().numpy()
        if self.sequence and act.ndim == 3:
            act = act[:, -1]
        return act


class BCVAENet(nn.Module):
    """BC-VAE's network: ``obs_enc`` (low-dim obs flattened, as the JAX
    package builds it: no encoder cores) and ``vae``, conditioned on the
    obs features."""

    def __init__(self, group_specs, ac_dim: int, vae_config):
        super().__init__()
        vc, prior = vae_config, vae_config.prior
        self.obs_enc = ObservationGroupEncoder(group_specs, feature_activation=None)
        self.vae = VAE(
            input_dim=ac_dim, latent_dim=int(vc.latent_dim),
            cond_dim=sum(spec_flat_dim(s) for _, s in group_specs),
            encoder_layer_dims=tuple(vc.encoder_layer_dims),
            decoder_layer_dims=tuple(vc.decoder_layer_dims),
            decoder_is_conditioned=bool(vc.decoder.is_conditioned),
            prior_learn=bool(prior.learn), prior_is_conditioned=bool(prior.is_conditioned),
            prior_use_gmm=bool(prior.use_gmm), prior_gmm_num_modes=int(prior.gmm_num_modes),
            prior_gmm_learn_weights=bool(prior.gmm_learn_weights),
            prior_use_categorical=bool(prior.use_categorical),
            prior_categorical_dim=int(prior.categorical_dim),
            prior_categorical_gumbel_temp=float(prior.categorical_init_temp),
            prior_layer_dims=tuple(vc.prior_layer_dims))

    def forward(self, obs, actions=None, goal=None, train: bool = False, noise=None,
                generator: torch.Generator | None = None):
        """With ``actions``: the VAE's outputs dict; else decoded prior draws."""
        groups = {"obs": obs}
        if goal is not None:
            groups["goal"] = goal
        cond = self.obs_enc(train, None, **groups)
        if actions is not None:
            return self.vae(actions, cond=cond, noise=noise, generator=generator)
        return self.vae.sample_prior(cond.shape[0], cond=cond, noise=noise,
                                     generator=generator)


class BCVAE(BC):
    """cVAE BC: the decoder reconstructs the actions from z and the obs
    features; loss = reconstruction MSE + kl_weight * KL. ``draws``: the
    VAE's ``noise`` (standard normals [B, latent], or Gumbel uniforms)."""

    def _build_net(self):
        return BCVAENet(self.group_specs, self.ac_dim, self.algo_config.vae)

    def _loss(self, batch, train: bool, draws=None):
        out = self.nets(batch["obs"], batch["actions"], goal=batch["goal_obs"], train=train,
                        noise=None if draws is None else self._put_infer(draws["noise"]),
                        generator=self._generator)
        loss = out["reconstruction_loss"] + float(self.algo_config.vae.kl_weight) * out["kl_loss"]
        return loss, {"action_loss": loss, "recons_loss": out["reconstruction_loss"],
                      "kl_loss": out["kl_loss"]}

    def _action(self, obs, goal):
        return self.nets(obs, None, goal=goal, generator=self._generator)


class BCGMM(BC):
    """GMM BC: negative log-likelihood of the actions."""

    def _gmm_kwargs(self) -> dict:
        g = self.algo_config.gmm
        return {"num_modes": int(g.num_modes), "min_std": float(g.min_std),
                "std_activation": str(g.std_activation),
                "low_noise_eval": bool(g.low_noise_eval)}

    def _build_net(self):
        return GMMActorNetwork(self.group_specs, self.ac_dim,
                               layer_dims=tuple(self.algo_config.actor_layer_dims),
                               encoder_cores=self.encoder_cores, **self._gmm_kwargs())

    def _dists(self, batch, train: bool) -> GMMParams:
        return self.nets.forward_train(batch["obs"], goal=batch["goal_obs"], train=train,
                                       generator=self._dropout_generator if train else None)

    def _loss(self, batch, train: bool, draws=None):
        loss = -torch.mean(gmm_log_prob(self._dists(batch, train), batch["actions"]))
        return loss, {"action_loss": loss, "log_probs": -loss}

    def _action(self, obs, goal):
        return gmm_sample(self.nets.forward_train(obs, goal=goal), self._generator)


class BCGaussian(BCGMM):
    """Gaussian BC: a 1-mode GMM whose std settings come from the
    ``gaussian`` section (``init_std`` as the floor with ``fixed_std``)."""

    def _gmm_kwargs(self) -> dict:
        g = self.algo_config.gaussian
        return {"num_modes": 1,
                "min_std": float(g.init_std) if bool(g.fixed_std) else float(g.min_std),
                "std_activation": str(g.std_activation),
                "low_noise_eval": bool(g.low_noise_eval)}


class BCRNNGMM(BCGMM):
    """RNN GMM BC over obs sequences of ``rnn.horizon`` steps."""

    sequence = True

    def _build_net(self):
        rc = self.algo_config.rnn
        return RNNGMMActorNetwork(self.group_specs, self.ac_dim,
                                  hidden_dim=int(rc.hidden_dim), num_layers=int(rc.num_layers),
                                  encoder_cores=self.encoder_cores, **self._gmm_kwargs())


class BCTransformerGMM(BCGMM):
    """Transformer GMM BC over obs sequences of ``transformer.context_length``
    steps."""

    sequence = True

    def _build_net(self):
        tc = self.algo_config.transformer
        return TransformerGMMActorNetwork(
            self.group_specs, self.ac_dim, **self._gmm_kwargs(),
            encoder_cores=self.encoder_cores, embed_dim=int(tc.embed_dim),
            num_layers=int(tc.num_layers), num_heads=int(tc.num_heads),
            context_length=int(tc.context_length), causal=bool(tc.causal),
            emb_dropout=float(tc.emb_dropout), attn_dropout=float(tc.attn_dropout),
            block_output_dropout=float(tc.block_output_dropout),
            sinusoidal_embedding=bool(tc.sinusoidal_embedding),
            nn_parameter_for_timesteps=bool(tc.nn_parameter_for_timesteps),
            activation=str(tc.activation))

    def _loss(self, batch, train: bool, draws=None):
        dists, actions = self._dists(batch, train), batch["actions"]
        if not bool(self.algo_config.transformer.supervise_all_steps):
            dists, actions = GMMParams(*(a[:, -1] for a in dists)), actions[:, -1]
        loss = -torch.mean(gmm_log_prob(dists, actions))
        return loss, {"action_loss": loss, "log_probs": -loss}
