"""Environment factory from dataset env metadata (counterpart of
``lipvq_tpu/envs/env_factory.py``; reference
EnvUtils.create_env_from_metadata, driven by the ``env_args`` JSON of the
dataset).

It dispatches as the JAX factory does: the synthetic env by name or type
99; a ``ROBOSUITE_TYPE`` env_meta whose name is in
``REGISTERED_KITCHEN_ENVS`` builds the first-party MuJoCo kitchen's
``EnvKitchen``, any other robosuite name ``EnvRobosuite``; type 2 builds
``EnvGym``, type 3 ``EnvIGMomart``. Each adapter imports its simulator
(``mujoco``, ``robosuite``, ``gymnasium``, ``igibson``) when it is built,
so a missing package raises there, with the JAX package's exception type;
``scripts/train.py`` then prints "Rollout disabled", as the JAX script
does for an env it cannot build.

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
        from lipvq_tpu_torch.envs.env_robosuite import EnvRobosuite

        return EnvRobosuite(env_name, render=render, render_offscreen=render_offscreen,
                            **env_kwargs)
    if env_type == EnvType.GYM_TYPE:
        from lipvq_tpu_torch.envs.env_gym import EnvGym

        return EnvGym(env_name, **env_kwargs)
    if env_type == EnvType.IG_MOMART_TYPE:
        from lipvq_tpu_torch.envs.env_ig_momart import EnvIGMomart

        return EnvIGMomart(env_name, render=render, render_offscreen=render_offscreen,
                           **env_kwargs)
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
