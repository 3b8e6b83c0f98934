"""Rollout policy wrappers (counterpart of ``lipvq_tpu/algo/rollout_policy.py``):
observation preparation (modality processing, optional obs normalization,
lang-emb injection, batch/time dims), ``get_action``, action
unnormalization + rot_6d -> axis-angle conversion (reference
algo.py:739-805)."""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.utils import obs_utils as ObsUtils
from lipvq_tpu_torch.utils.action_utils import rot_6d_to_axis_angle, vector_to_action_dict
from lipvq_tpu_torch.utils.obs_utils import LANG_EMB_KEY


class RolloutPolicy:
    """Wrap a trained algo for closed-loop env stepping."""

    def __init__(self, policy, obs_normalization_stats=None,
                 action_normalization_stats=None, lang_encoder=None):
        self.policy = policy
        self.obs_normalization_stats = obs_normalization_stats
        self.action_normalization_stats = action_normalization_stats
        self.lang_encoder = lang_encoder
        self._ep_lang_emb = None

    def start_episode(self, lang=None):
        """Cache the episode language embedding. ``lang`` may be a str (one
        episode) or a list of str (one per env -> [N, 768])."""
        if lang is not None and self.lang_encoder is not None:
            self._ep_lang_emb = np.asarray(
                self.lang_encoder.get_lang_emb(lang), np.float32
            )
        else:
            self._ep_lang_emb = None

    def _prepare_observation(self, ob: dict) -> dict:
        """Process + normalize + lang emb + batch dim. Obs leaves arrive
        [T, ...] from a frame-stack wrapper (or [...] unstacked)."""
        ob = ObsUtils.process_obs_dict(ob)
        if self.obs_normalization_stats is not None:
            ob = ObsUtils.normalize_dict(ob, self.obs_normalization_stats)
        if self._ep_lang_emb is not None:
            some = next(iter(ob.values()))
            t = some.shape[0] if some.ndim >= 2 else 1
            ob[LANG_EMB_KEY] = np.tile(self._ep_lang_emb[None], (t, 1))
        return {k: np.asarray(v, np.float32)[None] for k, v in ob.items()}

    def _postprocess_action(self, ac: np.ndarray) -> np.ndarray:
        """Unnormalize + rot_6d conversion (reference algo.py:786-805)."""
        if self.action_normalization_stats is None:
            return ac
        stats = self.action_normalization_stats
        action_keys = list(stats.keys())
        shapes = {
            k: stats[k]["offset"].reshape(-1).shape for k in action_keys
        }
        ac_dict = vector_to_action_dict(ac, shapes, action_keys)
        for k in action_keys:
            off = np.asarray(stats[k]["offset"]).reshape(-1)
            sc = np.asarray(stats[k]["scale"]).reshape(-1)
            ac_dict[k] = ac_dict[k] * sc + off
        parts = []
        for k in action_keys:
            v = ac_dict[k]
            if k.endswith("rot_6d"):
                v = rot_6d_to_axis_angle(v)
            parts.append(v)
        return np.concatenate(parts, axis=-1)

    def __call__(self, ob, goal=None):
        ob = self._prepare_observation(ob)
        goal = self._prepare_observation(goal) if goal is not None else None
        ac = self.policy.get_action(ob, goal_dict=goal)
        return self._postprocess_action(np.asarray(ac)[0])


class ICLRolloutPolicy(RolloutPolicy):
    """ICL variant: threads the context batch through ``get_action``.

    The context batch (with a FAST context's ``ctx_act_feat``) is kept on
    the policy's device per (context, env count), so the env loop does not
    copy the same context to the card, or recompute its features, on every
    step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ctx_cache = (None, None, None)  # (ctx key, n, device ctx)

    def _device_context(self, context_batch, n):
        key = (id(context_batch), self.policy.device)
        cached_key, cached_n, dev = self._ctx_cache
        if cached_key == key and cached_n == n:
            return dev

        def tile(v):
            v = np.asarray(v)
            return np.repeat(v, n, axis=0) if v.shape[0] == 1 and n > 1 else v

        ctx = {
            "obs": {k: tile(v) for k, v in context_batch["obs"].items()},
            "actions": tile(context_batch["actions"]),
        }
        # FAST contexts carry their token features: keep them, or get_action
        # would rerun the host BPE pipeline on every env step
        if context_batch.get("ctx_act_feat") is not None:
            ctx["ctx_act_feat"] = tile(context_batch["ctx_act_feat"])
        dev = self.policy._put_infer(ctx)
        self._ctx_cache = (key, n, dev)
        return dev

    def __call__(self, ob, context_batch, goal=None):
        ob = self._prepare_observation(ob)
        goal = self._prepare_observation(goal) if goal is not None else None
        ctx = self._device_context(context_batch, 1)
        ac = self.policy.get_action(ob, ctx, goal_dict=goal)
        return self._postprocess_action(np.asarray(ac)[0])

    def batched(self, obs, context_batch):
        """Batched path for vector envs: obs leaves [N, T, ...] -> [N, A].
        The context batch is tiled to the env count."""
        obs = {k: np.asarray(v, np.float32) for k, v in obs.items()}
        n = next(iter(obs.values())).shape[0]
        if self.obs_normalization_stats is not None:
            obs = ObsUtils.normalize_dict(obs, self.obs_normalization_stats)
        if self._ep_lang_emb is not None:
            t = next(iter(obs.values())).shape[1]
            if self._ep_lang_emb.ndim == 2:
                # per-env embeddings [N, E] from start_episode(lang=list)
                obs[LANG_EMB_KEY] = np.tile(self._ep_lang_emb[:, None], (1, t, 1))
            else:
                obs[LANG_EMB_KEY] = np.tile(self._ep_lang_emb[None, None], (n, t, 1))
        ctx = self._device_context(context_batch, n)
        acts = np.asarray(self.policy.get_action(obs, ctx))
        return np.stack([self._postprocess_action(a) for a in acts])
