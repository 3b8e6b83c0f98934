"""``closed_loop``: N envs in lock-step, one ``ICLRolloutPolicy.batched``
request per env step (as ``envs/vector_env.py::batched_icl_rollout`` drives
it), every env sharing one context demonstration; a request's latency is
host time from the call to its actions on the host."""

from __future__ import annotations

import functools
import math
import statistics
import time

import numpy as np
import torch

from portbench.harness import driver as base
from portbench.harness import program, weights


class CameraEnv:
    """The port's ``SyntheticKitchenEnv`` with camera frames: frame k of an
    episode is ``frames[k % P]`` of this env's pool (float32 in [0, 1], made
    once in set-up), plus a fixed language embedding and ``frame_id``, the
    pool index, which the loop records and never sends."""

    def __init__(self, horizon: int, seed: int, frames: np.ndarray, cams: list, lang):
        from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv

        self.env = SyntheticKitchenEnv(horizon=horizon, seed=seed)
        self.frames, self.cams, self.lang = frames, cams, lang

    def _obs(self, o: dict) -> dict:
        k = self.env._t % len(self.frames)
        o = dict(o)
        for i, cam in enumerate(self.cams):
            o[cam] = self.frames[k, i]
        o["lang_emb"] = self.lang
        o["frame_id"] = np.int64(k)
        return o

    def reset(self):
        return self._obs(self.env.reset())

    def step(self, action):
        o, r, done, info = self.env.step(action)
        return self._obs(o), r, done, info


def _frames(rng, shape) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8).astype(np.float32) / np.float32(255.0)


class Driver(base.Driver):
    def setup(self) -> None:
        ref = self.ref
        self.specs = ref.param_specs(self.cfg)
        w = weights.make(self.specs, self.seed, self.device, ref.lipvq_encode,
                         codebooks=[ref.TOK])
        self.mark("weights")
        self.weights = {k: v.cpu() for k, v in w.items()}
        self.policy = self.make_policy(w)
        del w
        self.mark("program")
        self.make_inputs()
        self.mark("inputs")
        for _ in range(self.mix["warmup_requests"]):
            self._step(record=False)
        base.sync(self.device)
        self.mark("warmup")
        self.record.clear()
        self.env_s = []
        self.captured["ids"].clear()
        self.captured["head"].clear()

    def make_policy(self, w: dict):
        """The port's rollout policy, with hooks that keep what each request
        produced where it is produced: the context's K1 ids and the GMM
        head's raw outputs."""
        from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy

        self.algo = program.build_policy(self.cfg, w, self.seed, self.device)
        self.captured = {"ids": [], "head": []}
        net = self.algo.nets.net
        net.encoder.action_network.quantizer.register_forward_hook(
            lambda m, i, o: self.captured["ids"].append(o[1]))
        net.decoder.register_forward_hook(lambda m, i, o: self.captured["head"].append(o))
        return ICLRolloutPolicy(self.algo)

    def make_inputs(self) -> None:
        """Frame pools, language embeddings, the shared context and the envs,
        from the seed."""
        from lipvq_tpu_torch.envs.vector_env import VectorEnv

        cfg, mix = self.cfg, self.mix
        n, t = mix["envs"], cfg["context_length"]
        rng = np.random.default_rng([self.seed, 1])
        cams = cfg["rgb_keys"]
        shapes = dict(cfg["obs"])
        frame = shapes[cams[0]] if cams else None
        self.pools = (_frames(rng, (n, mix["frame_pool"], len(cams), *frame)) if cams
                      else np.zeros((n, 1, 0), np.float32))
        lang_dim = math.prod(shapes["lang_emb"])
        self.langs = (rng.standard_normal((n, lang_dim), dtype=np.float32)
                      / np.float32(math.sqrt(lang_dim)))
        ctx_obs = {}
        for k, s in cfg["obs"]:
            if k in cams:
                ctx_obs[k] = _frames(rng, (1, t, *s))
            elif k == "lang_emb":
                lang = rng.standard_normal((1, 1, lang_dim), dtype=np.float32)
                ctx_obs[k] = np.repeat(lang / np.float32(math.sqrt(lang_dim)), t, axis=1)
            else:
                ctx_obs[k] = 0.5 * rng.standard_normal((1, t, *s), dtype=np.float32)
        self.context = {"obs": ctx_obs, "actions": 0.5 * rng.standard_normal(
            (1, t, cfg["ac_dim"]), dtype=np.float32)}
        env_seeds = rng.integers(0, 2**31 - 1, n)
        self.vec = VectorEnv([functools.partial(CameraEnv, mix["horizon"], int(s), self.pools[i],
                                                cams, self.langs[i])
                              for i, s in enumerate(env_seeds)], frame_stack=cfg["frame_stack"])
        self.low_keys = [k for k in cfg["obs_keys"] if k not in cams and k != "lang_emb"]
        self.obs = self.vec.reset()
        self.episode_step = 0
        self.record, self.env_s = [], []

    def _step(self, record: bool) -> float:
        obs = dict(self.obs)
        fid = obs.pop("frame_id")
        tracing = self.tracer is not None
        with base.span(tracing, "bench.request"):
            t0 = time.perf_counter()
            acts = self.policy.batched(obs, self.context)
            dt = time.perf_counter() - t0
        if record:
            self.record.append(({k: obs[k] for k in self.low_keys}, fid, acts, dt))
        with base.span(tracing, "bench.env_step"):
            t1 = time.perf_counter()
            self.obs, _, _, _ = self.vec.step(acts)
            self.episode_step += 1
            if self.episode_step >= self.mix["horizon"]:
                self.obs = self.vec.reset()
                self.episode_step = 0
            if record:
                self.env_s.append(time.perf_counter() - t1)
        return dt

    def host_summary(self) -> dict:
        """Median host ms of a request and of an env step in the window."""
        return {"request_ms_median": 1e3 * statistics.median(r[3] for r in self.record),
                "env_step_ms_median": 1e3 * statistics.median(self.env_s)}

    def window(self, t0: float, seconds: float) -> int:
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._step(record=True)
            n += 1
        return n

    def end_to_end(self) -> dict:
        lat = [r[3] for r in self.record]
        from portbench.harness.common import percentile

        return {"request_p95_ms": percentile(lat, 95) * 1e3,
                "env_steps_per_s": self.mix["envs"] * len(lat) / self.elapsed}

    def flops_per_unit(self) -> float:
        return float(sum(self.counts.policy(self.cfg, self.mix["envs"]).values()))

    def k1_shape(self) -> tuple:
        return (self.mix["envs"] * self.cfg["context_length"], self.cfg["num_codes"],
                self.ref.latent_dim(self.cfg))

    def free(self) -> None:
        head = [{k: v[:, 0].float().cpu() for k, v in h.items()} for h in self.captured["head"]]
        ids = [i.cpu() for i in self.captured["ids"]]
        self.captured = {"ids": ids, "head": head}
        self.algo = self.policy = self.vec = None
        base.empty_cache(self.device)

    def check(self) -> tuple[dict, list]:
        """{number: worst value over the sampled requests}, and each sampled
        request's numbers."""
        cfg, n, ref = self.cfg, len(self.record), self.ref
        if len(self.captured["ids"]) != n or len(self.captured["head"]) != n:
            raise RuntimeError("one forward per request expected: "
                               f"{len(self.captured['head'])} forwards for {n} requests")
        rng = np.random.default_rng([self.seed, 2])
        pick = set(rng.choice(n, min(self.mix["check_requests"], n), replace=False).tolist())
        pick.add(n - 1)
        dev = self.device
        W = {k: v.to(dev) for k, v in self.weights.items()}
        envs, t = self.mix["envs"], cfg["context_length"]
        ctx_obs = {k: torch.as_tensor(np.repeat(v, envs, axis=0), device=dev)
                   for k, v in self.context["obs"].items()}
        ctx_act = torch.as_tensor(np.repeat(self.context["actions"], envs, axis=0), device=dev)
        lang = torch.as_tensor(np.repeat(self.langs[:, None], t, axis=1), device=dev)
        per = []
        for r in sorted(pick):
            low, fid, acts, _ = self.record[r]
            obs = {k: torch.as_tensor(v, device=dev) for k, v in low.items()}
            obs["lang_emb"] = lang
            for c, cam in enumerate(cfg["rgb_keys"]):
                frames = self.pools[np.arange(envs)[:, None], fid, c]
                obs[cam] = torch.as_tensor(frames, device=dev)
            ids = self.captured["ids"][r].to(dev)
            with torch.no_grad():
                mean, _, logits, _, _, z = ref.policy_heads(W, cfg, obs, ctx_obs, ctx_act,
                                                            ctx_ids=ids)
            mr, lr = torch.tanh(mean[:, 0]).cpu(), torch.log_softmax(logits[:, 0], -1).cpu()
            head = self.captured["head"][r]
            mp = torch.tanh(head["mean"])
            lp = torch.log_softmax(head["logits"], -1)
            a = torch.as_tensor(acts, dtype=torch.float32)
            action_gap = (a[:, None] - mr).abs().amax(-1).amin(-1).max()
            per.append({"request": r,
                        "ids_gap": ref.id_gap(z, W[ref.TOK + "quantizer.codebook"], ids),
                        "head_gap": float(max((mp - mr).abs().max(), (lp - lr).abs().max())),
                        "action_gap": float(action_gap)})
        worst = {k: max(p[k] for p in per) for k in ("ids_gap", "head_gap", "action_gap")}
        return worst, per


class ControlPolicy:
    """``ICLRolloutPolicy.batched``'s interface, served by the reference in
    the lower precision; keeps each request's ids and head outputs as the
    program's hooks do."""

    def __init__(self, loop: "Control", w: dict):
        self.loop, self.w, self.ref = loop, w, loop.ref
        self.lower = self.ref.Lower()
        self.gen = torch.Generator(device=loop.device).manual_seed(loop.seed)
        self._ctx = None

    def batched(self, obs: dict, context: dict) -> np.ndarray:
        dev, cfg, ref = self.loop.device, self.loop.cfg, self.ref
        n = next(iter(obs.values())).shape[0]
        if self._ctx is None:
            self._ctx = ({k: torch.as_tensor(np.repeat(v, n, axis=0), device=dev)
                          for k, v in context["obs"].items()},
                         torch.as_tensor(np.repeat(context["actions"], n, axis=0), device=dev))
        ctx_obs, ctx_act = self._ctx
        x = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev) for k, v in obs.items()}
        with torch.no_grad(), self.lower.scope():
            z = ref.lipvq_encode(self.w, ref.TOK, ctx_act.reshape(-1, ctx_act.shape[-1]))
            ids = ref.nearest_fp32(z, self.w[ref.TOK + "quantizer.codebook"])
            mean, scale, logits, _, _, _ = ref.policy_heads(self.w, cfg, x, ctx_obs, ctx_act,
                                                            ctx_ids=ids, lower=self.lower)
        self.loop.captured["ids"].append(ids)
        self.loop.captured["head"].append({"mean": mean, "scale": scale, "logits": logits})
        u = torch.rand(logits[:, 0].shape, generator=self.gen, device=dev).clamp_min(1e-38)
        mode = torch.argmax(logits[:, 0] - torch.log(-torch.log(u)), dim=-1)
        means = torch.tanh(mean[:, 0])[torch.arange(n, device=dev), mode]
        eps = torch.randn(means.shape, generator=self.gen, device=dev)
        return (means + 1e-4 * eps).cpu().numpy()


class Control(Driver):
    """The reference, one precision lower, serving the same loop for a short
    window at the cell's load."""

    def make_policy(self, w: dict):
        self.captured = {"ids": [], "head": []}
        return ControlPolicy(self, w)
