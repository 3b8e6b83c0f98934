"""Environment factory from dataset env metadata (counterpart of
``lipvq_tpu/envs/env_factory.py``; reference
EnvUtils.create_env_from_metadata, driven by the ``env_args`` JSON of the
dataset).

The synthetic env and the first-party MuJoCo kitchen's tasks (single- and
multi-stage) are ported: a ``ROBOSUITE_TYPE`` env_meta whose name is in
``REGISTERED_KITCHEN_ENVS`` builds an ``EnvKitchen``. The robosuite, gym
and iG-MoMart adapters raise ``NotImplementedError`` naming ROADMAP §1
item 15. Without ``mujoco`` a kitchen task raises ``ModuleNotFoundError``.
``scripts/train.py`` prints "Rollout disabled" for any of these, as the
JAX script does for an env it cannot build.

``create_env`` builds an env by name with its seed, layout and style, as
``lipvq_tpu/robocasa/env_utils.py::create_env`` does;
``lipvq_tpu_torch/robocasa/env_utils.py`` re-exports it.
"""

from __future__ import annotations

from lipvq_tpu_torch.envs.env_base import EnvType


def create_env_from_metadata(env_meta: dict, render: bool = False,
                             render_offscreen: bool = False, **kwargs):
    env_name = env_meta["env_name"]
    env_type = env_meta.get("type", None)
    env_kwargs = dict(env_meta.get("env_kwargs", {}))
    env_kwargs.update(kwargs)

    if env_name == "SyntheticKitchen" or env_type == EnvType.SYNTHETIC_TYPE:
        from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv

        return SyntheticKitchenEnv(env_name=env_name, **env_kwargs)

    if env_type == EnvType.ROBOSUITE_TYPE:
        from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS

        if env_name in REGISTERED_KITCHEN_ENVS:
            from lipvq_tpu_torch.envs.env_kitchen import EnvKitchen

            return EnvKitchen(env_name, render=render, render_offscreen=render_offscreen,
                              **env_kwargs)
        raise NotImplementedError(
            f"env {env_name!r}: the robosuite adapter is not ported yet "
            f"(ROADMAP §1 item 15)")
    if env_type == EnvType.GYM_TYPE:
        raise NotImplementedError(
            f"env {env_name!r}: the gym adapter is not ported yet (ROADMAP §1 item 15)")
    if env_type == EnvType.IG_MOMART_TYPE:
        raise NotImplementedError(
            f"env {env_name!r}: the iG-MoMart adapter is not ported yet "
            f"(ROADMAP §1 item 15)")
    raise ValueError(
        f"No environment adapter for env_meta type={env_type!r} "
        f"name={env_name!r}"
    )


def create_env(env_name: str, render: bool = False, render_offscreen: bool = False,
               seed: int | None = None, layout_ids=None, style_ids=None, **kwargs):
    """An env by name (``lipvq_tpu/robocasa/env_utils.py:17-33``): a kitchen
    task (type 1) or ``SyntheticKitchen`` (type 99), with ``layout_ids``,
    ``style_ids`` and ``seed`` added to its kwargs where given."""
    env_meta = {
        "env_name": env_name,
        "type": (EnvType.ROBOSUITE_TYPE if env_name != "SyntheticKitchen"
                 else EnvType.SYNTHETIC_TYPE),
        "env_kwargs": dict(kwargs),
    }
    if layout_ids is not None:
        env_meta["env_kwargs"]["layout_ids"] = layout_ids
    if style_ids is not None:
        env_meta["env_kwargs"]["style_ids"] = style_ids
    if seed is not None:
        env_meta["env_kwargs"]["seed"] = seed
    return create_env_from_metadata(env_meta, render=render,
                                    render_offscreen=render_offscreen)
