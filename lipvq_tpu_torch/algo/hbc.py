"""HBC, hierarchical behavior cloning, and IRIS (counterpart of
``lipvq_tpu/algo/hbc.py``).

- ``HBC``: a GL or GL-VAE planner proposes a subgoal (a future
  observation) every ``subgoal_update_interval`` calls of ``get_action``;
  a goal-conditioned BC-GMM actor (``GoalConditionedBC``) acts toward the
  current one. With ``latent_subgoal`` the actor conditions on the GL-VAE's
  latent instead: posterior means of the target subgoals in training,
  prior normals when acting. The actor trains on the planner's target
  subgoals (their latents encoded after the planner's step).
- ``IRIS``: HBC whose subgoals come from a ``ValuePlanner``: per obs,
  ``num_subgoal_samples`` GL-VAE samples scored by a BCQ value algorithm
  trained alongside (``config_factory("bcq")`` defaults merged with
  ``algo.value``), the best candidate's mixed Q of each sampled subgoal.

``self.nets`` holds the parts' nets (``planner``, ``actor``, IRIS's
``value``), so ``serialize`` carries every weight; ``serialize_full``
carries the planner's and the actor's full states only, which IRIS
inherits: a resumed IRIS restarts its value BCQ from its init, optimizer
state included, as the JAX package does (ROADMAP queue 3, reference fault
(g)). The subgoal and the call counter survive ``RolloutPolicy``'s episode
start (reference fault (a)); ``reset`` clears them.
"""

from __future__ import annotations

from torch import nn

from lipvq_tpu_torch.algo.base import Algo, register_algo_factory_func, resolve_device
from lipvq_tpu_torch.algo.bc import BCGMM
from lipvq_tpu_torch.algo.bcq import BCQ
from lipvq_tpu_torch.algo.gl import GL, GLVAE, ValuePlanner
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.config.config import Config


@register_algo_factory_func("hbc")
def algo_config_to_class(algo_config):
    return HBC, {}


@register_algo_factory_func("iris")
def iris_algo_config_to_class(algo_config):
    return IRIS, {}


def _sub_config(global_config, algo_section, obs_section) -> Config:
    """A standalone config for a part: the run's train and experiment
    sections with the part's algo and observation sections."""
    cfg = Config()
    cfg.algo_name = "sub"
    cfg.train = Config(global_config.train.to_dict())
    cfg.experiment = Config(global_config.experiment.to_dict())
    cfg.algo = Config(algo_section.to_dict())
    cfg.observation = Config(obs_section.to_dict())
    return cfg


class GoalConditionedBC(BCGMM):
    """BC-GMM whose goal group is the planner's subgoal set (or latent)."""

    def __init__(self, *args, subgoal_shapes=None, **kwargs):
        self._subgoal_shapes = subgoal_shapes or {}
        super().__init__(*args, **kwargs)

    def _create_shapes(self, obs_keys, obs_key_shapes):
        super()._create_shapes(obs_keys, obs_key_shapes)
        self.goal_shapes = dict(self._subgoal_shapes)


class HBC(Algo):
    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes, ac_dim,
                 device=None):
        self.algo_config, self.obs_config = algo_config, obs_config
        self.global_config, self.obs_key_shapes, self.ac_dim = global_config, obs_key_shapes, ac_dim
        self.device = resolve_device(device)
        self._subgoal_update_interval = int(algo_config.subgoal_update_interval)
        planner_obs = obs_config.planner if "planner" in obs_config else obs_config
        self.planner = (GLVAE if algo_config.planner.vae.enabled else GL)(
            algo_config=algo_config.planner, obs_config=planner_obs,
            global_config=_sub_config(global_config, algo_config.planner, planner_obs),
            obs_key_shapes=obs_key_shapes, ac_dim=ac_dim, device=self.device)
        self.latent_subgoal = bool(algo_config.get("latent_subgoal", {}).get("enabled", False))
        if self.latent_subgoal:
            if not isinstance(self.planner, GLVAE):
                raise ValueError("latent_subgoal needs a VAE planner (algo.planner.vae.enabled)")
            goal_shapes = {"latent_subgoal": (self.planner.latent_dim,)}
        else:
            goal_shapes = self.planner.subgoal_shapes
        actor_obs = obs_config.actor if "actor" in obs_config else obs_config
        self.actor = GoalConditionedBC(
            algo_config=algo_config.actor, obs_config=actor_obs,
            global_config=_sub_config(global_config, algo_config.actor, actor_obs),
            obs_key_shapes=obs_key_shapes, ac_dim=ac_dim, device=self.device,
            subgoal_shapes=goal_shapes)
        # what get_action asks for subgoals (IRIS: the value planner)
        self.subgoal_planner = self.planner
        self.nets = nn.ModuleDict({"planner": self.planner.nets, "actor": self.actor.nets})
        self._current_subgoal = None
        self._step_counter = 0

    def parts(self) -> dict[str, Algo]:
        return {"planner": self.planner, "actor": self.actor}

    def optimizers(self):
        return {f"{name}.{k}": o for name, part in self.parts().items()
                for k, o in part.optimizers().items()}

    def generators(self):
        return {f"{name}.{k}": g for name, part in self.parts().items()
                for k, g in part.generators().items()}

    def process_batch_for_training(self, batch):
        return {"planner": self.planner.process_batch_for_training(batch),
                "actor": self.actor.process_batch_for_training(batch)}

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """The planner's step, then the actor's on the planner's target
        subgoals. ``draws``: {"planner": the planner's draws}."""
        draws = draws or {}
        p_info = self.planner.train_on_batch(batch["planner"], epoch, validate=validate,
                                             draws=draws.get("planner"))
        actor_batch = dict(batch["actor"])
        targets = batch["planner"]["target_subgoals"]
        if self.latent_subgoal:
            actor_batch["goal_obs"] = {"latent_subgoal": self.planner.encode_latent_subgoals(
                batch["planner"]["obs"], targets)}
        else:
            actor_batch["goal_obs"] = targets
        a_info = self.actor.train_on_batch(actor_batch, epoch, validate=validate)
        actor_loss = a_info["losses"]["action_loss"]
        return {"losses": {"planner_loss": p_info["losses"]["action_loss"],
                           "actor_loss": actor_loss, "action_loss": actor_loss}}

    def log_info(self, info):
        losses = info["losses"]
        return {"Loss": float(losses["action_loss"]),
                "Planner_Loss": float(losses["planner_loss"]),
                "Actor_Loss": float(losses["actor_loss"])}

    @property
    def current_subgoal(self):
        return self._current_subgoal

    def get_action(self, obs_dict, goal_dict=None):
        """A new subgoal at the first call and every
        ``subgoal_update_interval`` calls after it, then the actor's action
        toward the current one [B, A]."""
        if (self._current_subgoal is None
                or self._step_counter % self._subgoal_update_interval == 0):
            if self.latent_subgoal:
                self._current_subgoal = {
                    "latent_subgoal": self.planner.sample_latent_subgoals(obs_dict)}
            else:
                self._current_subgoal = self.subgoal_planner.get_subgoal_predictions(
                    obs_dict, goal_dict)
        self._step_counter += 1
        return self.actor.get_action(obs_dict, goal_dict=self._current_subgoal)

    def reset(self):
        self._current_subgoal = None
        self._step_counter = 0

    def serialize_full(self) -> dict:
        return {"planner": self.planner.serialize_full(), "actor": self.actor.serialize_full()}

    def deserialize_full(self, payload) -> None:
        self.planner.deserialize_full(payload["planner"])
        self.actor.deserialize_full(payload["actor"])


class IRIS(HBC):
    """HBC with a value-guided planner (reference iris.py)."""

    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes, ac_dim,
                 device=None):
        super().__init__(algo_config, obs_config, global_config, obs_key_shapes, ac_dim,
                         device=device)
        if not isinstance(self.planner, GLVAE):
            raise ValueError("IRIS needs a VAE planner (algo.planner.vae.enabled)")
        value_cfg = config_factory("bcq").algo
        if "value" in algo_config:
            value_cfg = Config(value_cfg.to_dict())
            with value_cfg.unlocked():
                value_cfg.update_from(algo_config.value.to_dict(), strict=False)
        self.value_bcq = BCQ(algo_config=value_cfg, obs_config=obs_config,
                             global_config=_sub_config(global_config, value_cfg, obs_config),
                             obs_key_shapes=obs_key_shapes, ac_dim=ac_dim, device=self.device)
        self.nets["value"] = self.value_bcq.nets
        self.subgoal_planner = ValuePlanner(
            self.planner, self.value_bcq.state_values,
            num_samples=int(algo_config.get("num_subgoal_samples", 10)))

    def parts(self) -> dict[str, Algo]:
        return {**super().parts(), "value": self.value_bcq}

    def process_batch_for_training(self, batch):
        return {**super().process_batch_for_training(batch),
                "value": self.value_bcq.process_batch_for_training(batch)}

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """HBC's step, then the value BCQ's. ``draws``: {"planner": ...,
        "value": the BCQ's draws}."""
        draws = draws or {}
        info = super().train_on_batch(batch, epoch, validate=validate, draws=draws)
        v_info = self.value_bcq.train_on_batch(batch["value"], epoch, validate=validate,
                                               draws=draws.get("value"))
        info["losses"]["value_loss"] = v_info["losses"]["critic_loss"]
        return info
