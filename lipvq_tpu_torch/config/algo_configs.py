"""Per-algorithm config classes (copy of ``lipvq_tpu/config/algo_configs.py``).

Every algorithm's config is ported: ``ICLConfig``, ``ICLMambaConfig``,
``BCConfig``, ``MCRConfig``, ``ACTConfig``, ``DiffusionPolicyConfig``, the
offline-RL ``IQLConfig``, ``TD3BCConfig``, ``CQLConfig`` and ``BCQConfig``,
and the hierarchical ``GLConfig``, ``HBCConfig`` and ``IRISConfig``.
Defaults mirror the reference per-algo configs so the reference's JSON
templates apply unchanged (reference: robomimic/config/{icl,bc,mcr,act,
diffusion_policy,iql,td3_bc,cql,bcq,gl,hbc,iris}_config.py).

The four mutually-exclusive action-tokenizer switches live under
``algo.transformer.{vq_vae_enabled,bin_enabled,fast_enabled,ln_act_enabled}``
(``algo.mamba.*`` for ``icl_mamba``; reference icl_config.py:154-157);
all-false selects the spectral-norm MLP + TransformerEncoder raw-action
tokenizer.
"""

from __future__ import annotations

from lipvq_tpu_torch.config.base import BaseConfig


def _policy_optim_defaults(algo):
    algo.optim_params.policy.optimizer_type = "adam"
    algo.optim_params.policy.learning_rate.initial = 1e-4
    algo.optim_params.policy.learning_rate.decay_factor = 0.1
    algo.optim_params.policy.learning_rate.epoch_schedule = []
    algo.optim_params.policy.learning_rate.scheduler_type = "constant_with_warmup"
    algo.optim_params.policy.regularization.L2 = 0.0


def _loss_defaults(algo):
    algo.loss.l2_weight = 1.0
    algo.loss.l1_weight = 0.0
    algo.loss.cos_weight = 0.0


def _gaussian_defaults(algo):
    algo.gaussian.enabled = False
    algo.gaussian.fixed_std = False
    algo.gaussian.init_std = 0.1
    algo.gaussian.min_std = 0.01
    algo.gaussian.std_activation = "softplus"
    algo.gaussian.low_noise_eval = True


def _gmm_defaults(algo):
    algo.gmm.enabled = False
    algo.gmm.num_modes = 5
    algo.gmm.min_std = 1e-4
    algo.gmm.std_activation = "softplus"
    algo.gmm.low_noise_eval = True


def _vae_defaults(algo):
    algo.vae.enabled = False
    algo.vae.latent_dim = 14
    algo.vae.latent_clip = None
    algo.vae.kl_weight = 1.0
    algo.vae.decoder.is_conditioned = True
    algo.vae.decoder.reconstruction_sum_across_elements = False
    algo.vae.prior.learn = False
    algo.vae.prior.is_conditioned = False
    algo.vae.prior.use_gmm = False
    algo.vae.prior.gmm_num_modes = 10
    algo.vae.prior.gmm_learn_weights = False
    algo.vae.prior.use_categorical = False
    algo.vae.prior.categorical_dim = 10
    algo.vae.prior.categorical_gumbel_softmax_hard = False
    algo.vae.prior.categorical_init_temp = 1.0
    algo.vae.prior.categorical_temp_anneal_step = 0.001
    algo.vae.prior.categorical_min_temp = 0.3
    algo.vae.encoder_layer_dims = [300, 400]
    algo.vae.decoder_layer_dims = [300, 400]
    algo.vae.prior_layer_dims = [300, 400]


def _rnn_defaults(algo):
    algo.rnn.enabled = False
    algo.rnn.horizon = 10
    algo.rnn.hidden_dim = 400
    algo.rnn.rnn_type = "LSTM"
    algo.rnn.num_layers = 2
    algo.rnn.open_loop = False
    algo.rnn.kwargs.bidirectional = False
    algo.rnn.kwargs.do_not_lock_keys()


def _seq_backbone_defaults(section):
    """Shared transformer/mamba backbone settings incl. tokenizer switches."""
    section.enabled = False
    section.context_length = 10
    section.embed_dim = 512
    section.num_layers = 6
    section.num_heads = 8
    section.emb_dropout = 0.1
    section.attn_dropout = 0.1
    section.block_output_dropout = 0.1
    section.sinusoidal_embedding = False
    section.activation = "gelu"
    section.fast_enabled = False
    section.bin_enabled = False
    section.vq_vae_enabled = False
    section.ln_act_enabled = True
    section.supervise_all_steps = False
    section.nn_parameter_for_timesteps = True
    section.pred_future_acs = False
    section.causal = True
    section.remat = False  # extension: recompute blocks to save memory
    # extension: backbone matmul precision. "bfloat16" runs the
    # attention/MLP matmuls in bf16 with fp32 params and accumulation;
    # softmax, LayerNorm and the residual stream stay fp32, and the VQ
    # tokenizer always stays fp32 for token-ID parity. Set "float32" for
    # bit-level reference parity runs.
    section.compute_dtype = "bfloat16"
    # extension: backbone residual-stream precision. "bfloat16" keeps the
    # residual stream in bf16 (LayerNorm statistics, attention softmax and
    # the final output stay fp32). The fp32 default preserves reference
    # training dynamics.
    section.activation_dtype = "float32"


class ICLConfig(BaseConfig):
    ALGO_NAME = "icl"

    def train_config(self):
        super().train_config()
        self.train.hdf5_load_next_obs = False

    def algo_config(self):
        algo = self.algo
        _policy_optim_defaults(algo)
        _loss_defaults(algo)
        algo.actor_layer_dims = [1024, 1024]
        _gaussian_defaults(algo)
        _gmm_defaults(algo)
        _vae_defaults(algo)
        _rnn_defaults(algo)
        _seq_backbone_defaults(algo.transformer)
        algo.language_conditioned = False
        # extensions (absent in reference, defaulted off/neutral):
        algo.vq.optimizer_lr = 1e-3       # reference icl.py:885-889 hardcodes
        algo.vq.optimizer_wd = 1e-4       # AdamW(lr=1e-3, weight_decay=1e-4)
        algo.vq.num_codes = 1024          # reference backbone_lfqvae_v5.py:52
        algo.vq.hidden_dim = 128
        algo.vq.ema_codebook = False      # EMA codebook update (extension)
        algo.vq.ema_decay = 0.99


class ICLMambaConfig(BaseConfig):
    ALGO_NAME = "icl_mamba"

    def train_config(self):
        super().train_config()
        self.train.hdf5_load_next_obs = False

    def algo_config(self):
        algo = self.algo
        _policy_optim_defaults(algo)
        _loss_defaults(algo)
        algo.actor_layer_dims = [1024, 1024]
        _gaussian_defaults(algo)
        _gmm_defaults(algo)
        _vae_defaults(algo)
        _rnn_defaults(algo)
        _seq_backbone_defaults(algo.mamba)
        # mamba SSM block dims (reference obs_nets.py:2748-2753)
        algo.mamba.d_state = 8
        algo.mamba.d_conv = 4
        algo.mamba.expand = 2
        algo.language_conditioned = False
        algo.vq.optimizer_lr = 1e-3
        algo.vq.optimizer_wd = 1e-4
        algo.vq.num_codes = 1024
        algo.vq.hidden_dim = 128
        algo.vq.ema_codebook = False
        algo.vq.ema_decay = 0.99


class BCConfig(BaseConfig):
    ALGO_NAME = "bc"

    def algo_config(self):
        algo = self.algo
        _policy_optim_defaults(algo)
        _loss_defaults(algo)
        algo.actor_layer_dims = [1024, 1024]
        _gaussian_defaults(algo)
        _gmm_defaults(algo)
        _vae_defaults(algo)
        _rnn_defaults(algo)
        _seq_backbone_defaults(algo.transformer)
        algo.language_conditioned = False


class MCRConfig(BaseConfig):
    """Reference: robomimic/config/mcr_config.py — transformer GMM BC with
    a pretrained MCR representation."""

    ALGO_NAME = "mcr"

    def algo_config(self):
        algo = self.algo
        _policy_optim_defaults(algo)
        _loss_defaults(algo)
        algo.actor_layer_dims = [1024, 1024]
        _gaussian_defaults(algo)
        _gmm_defaults(algo)
        algo.gmm.enabled = True
        _vae_defaults(algo)
        _rnn_defaults(algo)
        _seq_backbone_defaults(algo.transformer)
        algo.transformer.enabled = True
        algo.mcr.pretrained_ckpt = None
        algo.mcr.freeze_backbone = False
        algo.mcr.embed_dim = 128
        algo.language_conditioned = False


class ACTConfig(BaseConfig):
    """Reference: robomimic/config/act_config.py (+ algo/act.py defaults)."""

    ALGO_NAME = "act"

    def train_config(self):
        super().train_config()
        self.train.seq_length = 10
        self.train.hdf5_load_next_obs = False

    def algo_config(self):
        algo = self.algo
        _policy_optim_defaults(algo)
        algo.optim_params.policy.learning_rate.initial = 5e-5
        algo.optim_params.policy.regularization.L2 = 1e-4
        algo.act.chunk_size = 10
        algo.act.hidden_dim = 512
        algo.act.latent_dim = 32
        algo.act.num_heads = 8
        algo.act.enc_layers = 4
        algo.act.dec_layers = 7
        algo.act.ff_dim = 3200
        algo.act.kl_weight = 20.0


class DiffusionPolicyConfig(BaseConfig):
    """Reference: robomimic/config/diffusion_policy_config.py."""

    ALGO_NAME = "diffusion_policy"

    def train_config(self):
        super().train_config()
        self.train.seq_length = 16
        self.train.frame_stack = 2
        self.train.hdf5_load_next_obs = False

    def algo_config(self):
        algo = self.algo
        _policy_optim_defaults(algo)
        algo.optim_params.policy.learning_rate.initial = 1e-4
        algo.optim_params.policy.learning_rate.scheduler_type = "cosine"
        algo.optim_params.policy.learning_rate.num_warmup_steps = 500
        algo.optim_params.policy.regularization.L2 = 1e-6

        algo.horizon.observation_horizon = 2
        algo.horizon.action_horizon = 8
        algo.horizon.prediction_horizon = 16

        algo.unet.enabled = True
        algo.unet.diffusion_step_embed_dim = 256
        algo.unet.down_dims = [256, 512, 1024]
        algo.unet.kernel_size = 5
        algo.unet.n_groups = 8

        algo.ema.enabled = True
        algo.ema.power = 0.75

        algo.ddpm.enabled = True
        algo.ddpm.num_train_timesteps = 100
        algo.ddpm.num_inference_timesteps = 100
        algo.ddpm.beta_schedule = "squaredcos_cap_v2"
        algo.ddpm.clip_sample = True
        algo.ddpm.prediction_type = "epsilon"

        algo.ddim.enabled = False
        algo.ddim.num_train_timesteps = 100
        algo.ddim.num_inference_timesteps = 10
        algo.ddim.beta_schedule = "squaredcos_cap_v2"
        algo.ddim.clip_sample = True
        algo.ddim.set_alpha_to_one = True
        algo.ddim.steps_offset = 0
        algo.ddim.prediction_type = "epsilon"


def _gl_algo_defaults(section):
    """GL planner algo section (reference gl_config.py)."""
    section.optim_params.goal_network.learning_rate.initial = 1e-4
    section.optim_params.goal_network.learning_rate.decay_factor = 0.1
    section.optim_params.goal_network.learning_rate.epoch_schedule = []
    section.optim_params.goal_network.learning_rate.scheduler_type = "constant"
    section.optim_params.goal_network.regularization.L2 = 0.0
    section.subgoal_horizon = 10
    section.ae.planner_layer_dims = [300, 400]
    _vae_defaults(section)


class GLConfig(BaseConfig):
    """Reference: robomimic/config/gl_config.py."""

    ALGO_NAME = "gl"

    def algo_config(self):
        _gl_algo_defaults(self.algo)


class HBCConfig(BaseConfig):
    """Reference: robomimic/config/hbc_config.py — nested planner (GL) and
    actor (BC) sections."""

    ALGO_NAME = "hbc"

    def algo_config(self):
        algo = self.algo
        algo.subgoal_update_interval = 10
        algo.latent_subgoal.enabled = False
        _gl_algo_defaults(algo.planner)
        a = algo.actor
        _policy_optim_defaults(a)
        _loss_defaults(a)
        a.actor_layer_dims = [1024, 1024]
        _gaussian_defaults(a)
        _gmm_defaults(a)
        a.gmm.enabled = True
        _vae_defaults(a)
        _rnn_defaults(a)
        _seq_backbone_defaults(a.transformer)


class IRISConfig(HBCConfig):
    """Reference: robomimic/config/iris_config.py."""

    ALGO_NAME = "iris"

    def algo_config(self):
        super().algo_config()
        self.algo.planner.vae.enabled = True
        self.algo.discount = 0.99
        self.algo.num_subgoal_samples = 10


def _rl_optim(algo, names, lr=1e-4):
    for n in names:
        algo.optim_params[n].learning_rate.initial = lr
        algo.optim_params[n].learning_rate.decay_factor = 0.1
        algo.optim_params[n].learning_rate.epoch_schedule = []
        algo.optim_params[n].learning_rate.scheduler_type = "constant"
        algo.optim_params[n].regularization.L2 = 0.0


class IQLConfig(BaseConfig):
    """Reference: robomimic/config/iql_config.py."""

    ALGO_NAME = "iql"

    def algo_config(self):
        algo = self.algo
        _rl_optim(algo, ["critic", "vf", "actor"], lr=1e-4)
        algo.discount = 0.99
        algo.target_tau = 0.01
        algo.vf_quantile = 0.9
        algo.actor.net.type = "gaussian"
        algo.actor.net.common.std_activation = "softplus"
        algo.actor.net.common.low_noise_eval = True
        algo.actor.net.common.use_tanh = False
        algo.actor.net.gaussian.init_last_fc_weight = 0.001
        algo.actor.net.gaussian.init_std = 0.3
        algo.actor.net.gaussian.fixed_std = False
        algo.actor.net.gmm.num_modes = 5
        algo.actor.net.gmm.min_std = 1e-4
        algo.actor.layer_dims = [300, 400]
        algo.actor.max_gradient_norm = None
        algo.critic.ensemble.n = 2
        algo.critic.layer_dims = [300, 400]
        algo.critic.use_huber = False
        algo.critic.max_gradient_norm = None
        algo.adv.clip_adv_value = None
        algo.adv.beta = 1.0
        algo.adv.use_final_clip = True


class TD3BCConfig(BaseConfig):
    """Reference: robomimic/config/td3_bc_config.py."""

    ALGO_NAME = "td3_bc"

    def algo_config(self):
        algo = self.algo
        _rl_optim(algo, ["critic", "actor"], lr=3e-4)
        algo.alpha = 2.5
        algo.discount = 0.99
        algo.n_step = 1
        algo.target_tau = 0.005
        algo.infinite_horizon = False
        algo.critic.use_huber = False
        algo.critic.max_gradient_norm = None
        algo.critic.value_bounds = None
        algo.critic.ensemble.n = 2
        algo.critic.ensemble.weight = 1.0
        algo.critic.layer_dims = [256, 256]
        algo.actor.update_freq = 2
        algo.actor.noise_std = 0.2
        algo.actor.noise_clip = 0.5
        algo.actor.layer_dims = [256, 256]


class CQLConfig(BaseConfig):
    """Reference: robomimic/config/cql_config.py."""

    ALGO_NAME = "cql"

    def algo_config(self):
        algo = self.algo
        _rl_optim(algo, ["critic", "actor"], lr=1e-4)
        algo.discount = 0.99
        algo.target_tau = 0.005
        algo.actor.layer_dims = [300, 400]
        algo.critic.ensemble.n = 2
        algo.critic.layer_dims = [300, 400]
        algo.critic.cql_weight = 1.0
        algo.critic.num_random_actions = 10


class BCQConfig(BaseConfig):
    """Reference: robomimic/config/bcq_config.py."""

    ALGO_NAME = "bcq"

    def algo_config(self):
        algo = self.algo
        _rl_optim(algo, ["critic", "actor", "action_sampler"], lr=1e-3)
        algo.discount = 0.99
        algo.n_step = 1
        algo.target_tau = 0.005
        algo.infinite_horizon = False
        algo.critic.use_huber = False
        algo.critic.max_gradient_norm = None
        algo.critic.value_bounds = None
        algo.critic.num_action_samples = 10
        algo.critic.ensemble.n = 2
        algo.critic.ensemble.weight = 0.75
        algo.critic.layer_dims = [300, 400]
        algo.actor.enabled = False
        algo.actor.perturbation_scale = 0.05
        algo.actor.layer_dims = [300, 400]
        algo.action_sampler.vae.latent_dim = 14
        algo.action_sampler.vae.kl_weight = 0.5
