"""``train``: ``utils/train_utils.py::run_epoch`` over a
``DeviceCachedLoader`` of seeded windows; the first steps, through the same
call and loader, are the ones the reference follows."""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from portbench.harness import driver as base
from portbench.harness import program, weights


class Items:
    """Seeded windows of ``2 T - 1`` steps: low-dim observations and actions
    0.5 N(0, 1), the language embedding of one of ``tasks`` tasks, and each
    camera's uint8 frames drawn from a pool of ``frame_pool``."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        rng = np.random.default_rng([seed, 3])
        n, steps = mix["items"], 2 * cfg["context_length"] - 1
        shapes = dict(cfg["obs"])
        lang_dim = math.prod(shapes["lang_emb"])
        self.cams = cfg["rgb_keys"]
        self.pools = {k: rng.integers(0, 256, (mix["frame_pool"], *shapes[k]), dtype=np.uint8)
                      for k in self.cams}
        self.frame_ids = {k: rng.integers(0, mix["frame_pool"], (n, steps)) for k in self.cams}
        self.low = {k: 0.5 * rng.standard_normal((n, steps, *s), dtype=np.float32)
                    for k, s in cfg["obs"] if k != "lang_emb" and k not in self.cams}
        self.langs = (rng.standard_normal((mix["tasks"], lang_dim), dtype=np.float32)
                      / np.float32(math.sqrt(lang_dim)))
        self.task = rng.integers(0, mix["tasks"], n)
        self.actions = 0.5 * rng.standard_normal((n, steps, cfg["ac_dim"]), dtype=np.float32)
        self.steps = steps

    def __len__(self) -> int:
        return len(self.actions)

    def __getitem__(self, i: int) -> dict:
        obs = {k: v[i] for k, v in self.low.items()}
        obs["lang_emb"] = np.repeat(self.langs[self.task[i]][None], self.steps, axis=0)
        for k in self.cams:
            obs[k] = self.pools[k][self.frame_ids[k][i]]
        return {"obs": obs, "actions": self.actions[i]}

    def batch(self, idx, device) -> dict:
        """Items ``idx`` stacked on ``device``, for the reference."""
        obs = {k: torch.as_tensor(v[idx], device=device) for k, v in self.low.items()}
        lang = torch.as_tensor(self.langs[self.task[idx]], device=device)
        obs["lang_emb"] = lang[:, None].expand(-1, self.steps, -1)
        for k in self.cams:
            frames = torch.as_tensor(self.pools[k][self.frame_ids[k][idx]], device=device)
            obs[k] = frames.to(torch.float32) / torch.full((), 255.0, device=device)
        return {"obs": obs, "actions": torch.as_tensor(self.actions[idx], device=device)}


class Driver(base.Driver):
    checks_window = False  # the first steps, taken in set-up, are compared

    def setup(self) -> None:
        from lipvq_tpu_torch.data.loaders import CyclingIterator, DeviceCachedLoader
        from lipvq_tpu_torch.utils.train_utils import run_epoch

        cfg, mix = self.cfg, self.mix
        self.run_epoch = run_epoch
        self.specs = self.ref.param_specs(cfg)
        w = weights.make(self.specs, self.seed, self.device, self.ref.lipvq_encode,
                         codebooks=[self.ref.TOK])
        self.mark("weights")
        self.algo = program.build_policy(cfg, w, self.seed, self.device)
        program.take_up_schedule(self.algo, mix["schedule_step"])
        self.weights = {k: v.cpu() for k, v in w.items()}
        del w
        self.mark("program")
        self.items = Items(cfg, mix, self.seed)
        self.mark("items")
        loader = DeviceCachedLoader(self.items, batch_size=mix["batch_size"], model=self.algo,
                                    seed=self.seed)

        driver = self

        class TimedCycling(CyclingIterator):
            """The loader as ``run_epoch`` cycles it, with the host time of
            each ``next`` summed (the benchmark's data-wait span)."""

            def __next__(self):
                with base.span(driver.tracer is not None, "bench.next_batch"):
                    t0 = time.perf_counter()
                    batch = super().__next__()
                    driver.data_wait_s += time.perf_counter() - t0
                return batch

        self.reset_spans()
        self.it = TimedCycling(loader)
        self.mark("loader")
        # the first steps, through the window's own call and loader
        self.logs, self.grad1, self.state3 = [], None, None
        beta1 = program.betas(self.algo)
        for step in range(mix["check_steps"]):
            self.logs.append(run_epoch(self.algo, self.it, step, num_steps=1))
            if step == 0:
                self.grad1 = {k: (v / (1.0 - beta1[k])).cpu()
                              for k, v in program.exp_avg(self.algo).items()}
        self.state3 = {k: v.cpu() for k, v in program.device_state(self.algo).items()}
        self.mark("first_steps")
        for _ in range(mix["warmup_epochs"]):
            run_epoch(self.algo, self.it, 0, num_steps=mix["epoch_steps"])
        base.sync(self.device)
        self.mark("warmup")

    def reset_spans(self) -> None:
        self.data_wait_s = 0.0

    def spans(self) -> dict:
        return {"data_wait_s": self.data_wait_s}

    def window(self, t0: float, seconds: float) -> int:
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.run_epoch(self.algo, self.it, 1, num_steps=self.mix["epoch_steps"])
            steps += self.mix["epoch_steps"]
        return steps

    def end_to_end(self) -> dict:
        return {"train_samples_per_s": self.units * self.mix["batch_size"] / self.elapsed}

    def flops_per_unit(self) -> float:
        return float(sum(self.counts.policy(self.cfg, self.mix["batch_size"] // 2,
                                       train=True).values()))

    def k1_shape(self) -> tuple:
        return (self.mix["batch_size"] // 2 * self.cfg["context_length"], self.cfg["num_codes"],
                self.ref.latent_dim(self.cfg))

    def free(self) -> None:
        del self.algo, self.it
        base.empty_cache(self.device)

    def check(self) -> tuple[dict, list]:
        """The reference follows the first steps from the same weights on the
        same draws of the loader's seed: each step's losses, the first
        gradient's norm by leaf, the change of each leaf after the steps."""
        dev, mix = self.device, self.mix
        W = {k: v.to(dev) for k, v in self.weights.items()}
        trainer = self.ref.Trainer(W, self.cfg, seed=self.seed, device=dev,
                                   start=mix["schedule_step"])
        rng = np.random.default_rng(self.seed)
        per, grads = [], None
        for step, log in enumerate(self.logs):
            idx = rng.choice(len(self.items), size=mix["batch_size"], replace=True)
            r = trainer.step(self.items.batch(idx, dev))
            if step == 0:
                grads = {k: g.cpu() for k, g in r["grads"].items()}
            per.append({"step": step + 1,
                        "loss_gap": max(abs(log["Loss"] - r["action_loss"])
                                        / abs(r["action_loss"]),
                                        abs(log["VQ_Loss"] - r["vq_loss"]) / abs(r["vq_loss"]))})
        ref_change = {k: (trainer.W[k].cpu() - self.weights[k]) for k in grads}
        prog_change = {k: self.state3[k] - self.weights[k] for k in grads}
        grad_gap, grad_leaf, kept = leaf_gap(self.grad1, grads, grads)
        change_gap, change_leaf, _ = leaf_gap(prog_change, ref_change, grads)
        worst = {"loss_gap": max(p["loss_gap"] for p in per), "grad_gap": grad_gap,
                 "change_gap": change_gap}
        per.append({"grad_gap": grad_gap, "grad_leaf": grad_leaf, "change_gap": change_gap,
                    "change_leaf": change_leaf, "leaves": len(kept),
                    "excluded": sorted(set(grads) - set(kept))})
        return worst, per


def leaf_gap(prog: dict, ref_: dict, grads: dict):
    """Worst leaf of |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm), over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (the others move by round-off alone).
    Returns (gap, its leaf, the leaves compared)."""
    gnorm = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    gmed = statistics.median(gnorm.values())
    kept = [k for k in grads if gnorm[k] >= 1e-3 * gmed]
    rn = {k: float(torch.linalg.vector_norm(ref_[k].double())) for k in kept}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in kept}
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in kept}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, kept


class Control(Driver):
    """The first steps taken by the reference in the lower precision, on the
    loader's draws; no window."""

    def setup(self) -> None:
        self.specs = self.ref.param_specs(self.cfg)
        w = weights.make(self.specs, self.seed, self.device, self.ref.lipvq_encode,
                         codebooks=[self.ref.TOK])
        self.weights = {k: v.cpu() for k, v in w.items()}
        self.items = Items(self.cfg, self.mix, self.seed)
        lower = self.ref.Lower()
        trainer = self.ref.Trainer(w, self.cfg, lower=lower, seed=self.seed, device=self.device,
                                   start=self.mix["schedule_step"])
        rng = np.random.default_rng(self.seed)
        self.logs = []
        with lower.scope():
            for step in range(self.mix["check_steps"]):
                idx = rng.choice(len(self.items), size=self.mix["batch_size"], replace=True)
                r = trainer.step(self.items.batch(idx, self.device))
                self.logs.append({"Loss": r["action_loss"], "VQ_Loss": r["vq_loss"]})
                if step == 0:
                    self.grad1 = {k: g.cpu() for k, g in r["grads"].items()}
        self.state3 = {k: v.cpu() for k, v in trainer.W.items()}

    def free(self) -> None:
        pass
