"""``corpus``: ``parallel/corpus.py::tokenize_array`` called again and again
on host arrays of seeded actions, the ids back on the host."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import driver as base
from portbench.harness import program, weights


class Driver(base.Driver):
    def setup(self) -> None:
        from lipvq_tpu_torch.parallel.corpus import tokenize_array

        tok, mix = self.cfg["corpus_tokenizer"], self.mix
        self.tokenize_array = tokenize_array
        self.specs = self.ref.lipvq_specs("", tok["feature_dim"], tok["latent_dim"],
                                          tok["num_codes"], tok["hidden_dim"])
        w = weights.make(self.specs, self.seed, self.device, self.ref.lipvq_encode,
                         codebooks=[""])
        self.model = program.build_tokenizer(tok, w, self.device)
        self.weights = {k: v.cpu() for k, v in w.items()}
        del w
        self.mark("program")
        rng = np.random.default_rng([self.seed, 4])
        self.arrays = [(mix["action_std"] * rng.standard_normal(
            (mix["rows"], tok["feature_dim"]))).astype(np.float32) for _ in range(mix["arrays"])]
        keep_rng = np.random.default_rng([self.seed, 5])
        self.keep = set(keep_rng.choice(mix["keep_range"], mix["check_calls"],
                                        replace=False).tolist())
        self.kept = {}
        self.mark("inputs")
        # the first call pays the libraries' first use; the second shows a
        # warm call's set-up cost beside it
        for name in ("first_call", "second_call"):
            self._call(self.arrays[0])
            base.sync(self.device)
            self.mark(name)

    def _call(self, x):
        return self.tokenize_array(self.model, x, device=self.device, chunk=self.mix["chunk"],
                                   precision=self.mix["precision"])

    def window(self, t0: float, seconds: float) -> int:
        calls, last = 0, None
        tracing = self.tracer is not None
        while time.perf_counter() - t0 < seconds:
            with base.span(tracing, "bench.call"):
                ids = self._call(self.arrays[calls % len(self.arrays)])
            if calls in self.keep:
                self.kept[calls] = ids
            last = (calls, ids)
            calls += 1
        self.kept[last[0]] = last[1]
        return calls

    def end_to_end(self) -> dict:
        return {"corpus_rows_per_s": self.units * self.mix["rows"] / self.elapsed}

    def flops_per_unit(self) -> float:
        return float(sum(self.counts.corpus_call(self.cfg["corpus_tokenizer"],
                                            self.mix["rows"]).values()))

    def k1_shape(self) -> tuple:
        tok = self.cfg["corpus_tokenizer"]
        return (self.mix["chunk"], tok["num_codes"], tok["latent_dim"])

    def free(self) -> None:
        del self.model
        base.empty_cache(self.device)

    def check(self) -> tuple[dict, list]:
        """Each kept call's ids against the exact nearest codes of the
        reference's latents."""
        dev = self.device
        W = {k: v.to(dev) for k, v in self.weights.items()}
        per = []
        for call, ids in sorted(self.kept.items()):
            x = torch.as_tensor(self.arrays[call % len(self.arrays)], device=dev)
            with torch.no_grad():
                z = torch.cat([self.ref.lipvq_encode(W, "", xb) for xb in x.split(1 << 16)])
            gap = self.ref.id_gap(z, W["quantizer.codebook"], torch.as_tensor(ids, device=dev))
            per.append({"call": call, "ids_gap": gap})
        return {"ids_gap": max(p["ids_gap"] for p in per)}, per


class Control(Driver):
    """As many calls as a run keeps, their ids from the reference in TF32."""

    checks_window = False

    def setup(self) -> None:
        tok, mix, ref = self.cfg["corpus_tokenizer"], self.mix, self.ref
        specs = ref.lipvq_specs("", tok["feature_dim"], tok["latent_dim"], tok["num_codes"],
                                tok["hidden_dim"])
        w = weights.make(specs, self.seed, self.device, ref.lipvq_encode, codebooks=[""])
        self.weights = {k: v.cpu() for k, v in w.items()}
        rng = np.random.default_rng([self.seed, 4])
        self.arrays = [(mix["action_std"] * rng.standard_normal(
            (mix["rows"], tok["feature_dim"]))).astype(np.float32) for _ in range(mix["arrays"])]
        self.kept = {}
        with torch.no_grad(), ref.Lower().scope():
            for call in range(mix["check_calls"] + 1):
                x = torch.as_tensor(self.arrays[call % len(self.arrays)], device=self.device)
                z = torch.cat([ref.lipvq_encode(w, "", xb) for xb in x.split(mix["chunk"])])
                self.kept[call] = ref.nearest_fp32(z, w["quantizer.codebook"]).cpu().numpy()

    def free(self) -> None:
        pass
