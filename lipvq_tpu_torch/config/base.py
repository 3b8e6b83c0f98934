"""BaseConfig + algorithm config registry (copy of ``lipvq_tpu/config/base.py``).

Capability parity with the reference's metaclass registry
(reference: robomimic/config/base_config.py:24-67): every ``BaseConfig``
subclass declaring ``ALGO_NAME`` is auto-registered, and
``config_factory(algo_name)`` instantiates the matching config, fully
populated with defaults and locked.
"""

from __future__ import annotations

from lipvq_tpu_torch.config.config import Config

# algo_name -> BaseConfig subclass
REGISTERED_CONFIGS: dict[str, type] = {}

def register_config(cls):
    name = getattr(cls, "ALGO_NAME", None)
    if name is not None:
        REGISTERED_CONFIGS[name] = cls
    return cls


def config_factory(algo_name: str, dic: dict | None = None) -> Config:
    """Build a locked config for ``algo_name``; optionally merge overrides.

    Mirrors reference config_factory (base_config.py:49-67) + the JSON
    override flow in train.py:491-497 (unknown keys error).
    """
    if algo_name not in REGISTERED_CONFIGS:
        raise KeyError(
            f"Unknown algo {algo_name!r}; registered: {sorted(REGISTERED_CONFIGS)}"
        )
    cfg = REGISTERED_CONFIGS[algo_name]()
    if dic is not None:
        with cfg.values_unlocked():
            cfg.update_from(dic, strict=True)
    return cfg


def config_from_json(path_or_str: str) -> Config:
    """Load a template/override JSON and merge over registered defaults."""
    raw = Config.from_json(path_or_str)
    algo_name = raw["algo_name"]
    return config_factory(algo_name, raw.to_dict())


class ConfigMeta(type):
    def __init__(cls, name, bases, attrs):
        super().__init__(name, bases, attrs)
        if name != "BaseConfig":
            register_config(cls)


class BaseConfig(Config, metaclass=ConfigMeta):
    """Default experiment/train/observation sections shared by all algos.

    Defaults mirror reference base_config.py:75-260 so JSON templates from
    the reference ecosystem apply cleanly.
    """

    ALGO_NAME: str | None = None

    def __init__(self):
        super().__init__()
        self.algo_name = type(self).ALGO_NAME
        self.experiment_config()
        self.train_config()
        self.algo_config()
        self.observation_config()
        self.meta_config()
        self.lock()

    # -- sections ----------------------------------------------------------
    def experiment_config(self):
        e = self.experiment
        e.name = "test"
        e.validate = False
        e.logging.terminal_output_to_txt = True
        e.logging.log_tb = True
        e.logging.log_wandb = False
        e.logging.wandb_proj_name = "debug"

        e.mse.enabled = False
        e.mse.every_n_epochs = 50
        e.mse.on_save_ckpt = True
        e.mse.num_samples = 20
        e.mse.visualize = True

        e.save.enabled = True
        e.save.every_n_seconds = None
        e.save.every_n_epochs = 50
        e.save.epochs = []
        e.save.on_best_validation = False
        e.save.on_best_rollout_return = False
        e.save.on_best_rollout_success_rate = True

        e.epoch_every_n_steps = 100
        e.validation_epoch_every_n_steps = 10

        e.env = None
        e.additional_envs = None

        e.render = False
        e.render_video = True
        e.keep_all_videos = False
        e.video_skip = 5

        e.rollout.enabled = True
        e.rollout.n = 50
        e.rollout.horizon = 400
        e.rollout.rate = 50
        e.rollout.warmstart = 0
        e.rollout.terminate_on_success = True
        e.rollout.batched = False
        e.rollout.num_batch_envs = 5

        e.env_meta_update_dict = Config()
        e.env_meta_update_dict.do_not_lock_keys()

        e.ckpt_path = None
        # resume entry epoch: with ckpt_path = a latest_full.state payload
        # (params + optimizer + rng), start_epoch = saved_epoch + 1 makes
        # train() continue epoch numbering/saves where the previous
        # process stopped — true preemption-safe resume, which the
        # reference lacks (its dir-mode ckpt_path is follow-along eval
        # only, SURVEY.md §5.3)
        e.start_epoch = 1

    def train_config(self):
        t = self.train
        t.data = None
        t.output_dir = f"../{self.algo_name}_trained_models"
        t.num_data_workers = 0
        # multi-task MetaDataset only: draw every batch from ONE
        # sub-dataset so ICL context/query halving pairs same-task demos
        t.group_task_batches = False
        # multi-task MetaDataset only: weight each sub-dataset's items
        # by 1/len so every TASK gets equal sampling probability
        # (reference MetaDataset normalize_weights_by_ds_size,
        # dataset.py:1069-1078); False = per-item uniform, which lets
        # long-demo tasks dominate the mixture
        t.normalize_weights_by_ds_size = False
        t.hdf5_cache_mode = "all"
        t.hdf5_use_swmr = True
        t.hdf5_load_next_obs = True
        t.hdf5_normalize_obs = False
        t.hdf5_filter_key = None
        t.hdf5_validation_filter_key = None
        t.seq_length = 1
        t.pad_seq_length = True
        t.frame_stack = 1
        t.pad_frame_stack = True
        t.dataset_keys = ["actions", "rewards", "dones"]
        t.action_keys = ["actions"]
        t.action_config = Config()
        t.action_config.do_not_lock_keys()
        t.goal_mode = None
        t.cuda = True  # scripts/train.py runs on CUDA unless this is false
        # data-parallel device count: None = single-device (reference
        # parity), -1 = all visible devices, N = first N devices. When set,
        # train() builds a Mesh and shards every batch (SURVEY.md §2.5).
        t.num_devices = None
        t.batch_size = 100
        t.num_epochs = 2000
        t.seed = 1
        t.max_grad_norm = None
        t.data_format = "robomimic"
        t.shuffled_obs_key_groups = None

    def algo_config(self):
        """Populated by subclasses (reference base_config.py:252)."""

    def observation_config(self):
        o = self.observation
        o.modalities.obs.low_dim = [
            "robot0_eef_pos",
            "robot0_eef_quat",
            "robot0_gripper_qpos",
            "object",
        ]
        o.modalities.obs.rgb = []
        o.modalities.obs.depth = []
        o.modalities.obs.scan = []
        o.modalities.goal.low_dim = []
        o.modalities.goal.rgb = []
        o.modalities.goal.depth = []
        o.modalities.goal.scan = []

        for mod in ("low_dim", "rgb", "depth", "scan"):
            enc = o.encoder[mod]
            enc.core_class = "VisualCore" if mod == "rgb" else None
            enc.core_kwargs = Config()
            enc.core_kwargs.do_not_lock_keys()
            enc.obs_randomizer_class = None
            enc.obs_randomizer_kwargs = Config()
            enc.obs_randomizer_kwargs.do_not_lock_keys()
        if o.encoder.rgb.core_class == "VisualCore":
            o.encoder.rgb.core_kwargs.feature_dimension = 64
            o.encoder.rgb.core_kwargs.backbone_class = "ResNet18Conv"
            o.encoder.rgb.core_kwargs.backbone_kwargs = Config(
                pretrained=False, input_coord_conv=False
            )
            o.encoder.rgb.core_kwargs.pool_class = "SpatialSoftmax"
            o.encoder.rgb.core_kwargs.pool_kwargs = Config(
                num_kp=32, learnable_temperature=False, temperature=1.0, noise_std=0.0
            )

    def meta_config(self):
        m = self.meta
        m.hp_base_config_file = None
        m.hp_keys = []
        m.hp_values = []

    # -- convenience -------------------------------------------------------
    @property
    def all_obs_keys(self):
        keys = set()
        for group in self.observation.modalities.values():
            for mod_keys in group.values():
                keys.update(mod_keys)
        return sorted(keys)

    def use_goals(self):
        return self.train.goal_mode is not None
