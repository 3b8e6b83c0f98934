"""Environment factory from dataset env metadata (counterpart of
``lipvq_tpu/envs/env_factory.py``; reference
EnvUtils.create_env_from_metadata, driven by the ``env_args`` JSON of the
dataset).

Only the hermetic synthetic env is ported. The first-party MuJoCo kitchen
is ROADMAP §1 item 8; the robosuite, gym and iG-MoMart adapters are
ROADMAP §1 item 15. Each raises ``NotImplementedError`` naming its item, so
``scripts/train.py`` prints "Rollout disabled" for them as the JAX script
does for an env it cannot build.
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
        raise NotImplementedError(
            f"env {env_name!r}: the MuJoCo kitchen (and the robosuite adapter) is not "
            f"ported yet (ROADMAP §1 item 8)")
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
