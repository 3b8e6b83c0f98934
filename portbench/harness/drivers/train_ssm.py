"""``train_ssm``: ``train``'s run (``run_epoch`` over a ``DeviceCachedLoader``
of seeded windows, the first steps held against the reference) for a policy
whose backbone runs the selective scan.

- Weights: ``harness/weights.py``'s draw, with each mixer's ``A_log`` and
  ``dt_proj.bias`` then set as Mamba initializes them (``published_ssm``):
  A_log = log(1..d_state) on every channel, and the bias the inverse
  softplus of a dt log-uniform in [1e-3, 0.1], the uniform taken from the
  bias's own slice of the draw. A trained mixer keeps such a spread of
  decays; 0.05 N(0, 1) would give every state one decay of ~0.5 a step.
- Check: ``train``'s numbers, and ``grad_err``, the relative L2 distance of
  the program's whole first gradient from the reference's (all leaves as
  one vector). The worst leaf (``grad_gap``) is set by leaves whose
  gradient is a sum that cancels (conv biases, the B norm), in the lower
  precision as in the program's; the whole gradient reads the precision.
  The norms are taken on the card.
- Spans of the first traced half: ``train``'s and the scan's calls on the
  card (``ssm_scan``: its forward and backward calls, the elements (b, t, d,
  n) they scanned, and their counted work, ``counts/<name>.py::scan``), read
  from the port's counters on ``ops/selective_scan.py::selective_scan_cuda``;
  a port without them adds nothing.
- ``bf16_scan_state``: a fault this kind can have, reachable as
  ``control.py --reading fault:bf16_scan_state`` once this module is
  imported (the configuration's reference imports it).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.utils.checkpoint

from portbench import faults
from portbench.harness import weights
from portbench.harness.drivers import train

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


def published_ssm(specs: list, out: dict) -> dict:
    """``out`` (``weights.make``'s) with every ``A_log`` and ``dt_proj.bias``
    of ``specs`` as Mamba initializes them; the bias's slice must be of the
    kind ``small`` (0.05 N(0, 1)), whose normal draw gives the uniform."""
    for name, shape, kind in specs:
        if name.endswith(".A_log"):
            n = torch.arange(1, shape[1] + 1, dtype=torch.float32, device=out[name].device)
            out[name] = torch.log(n).expand(shape).contiguous()
        elif name.endswith(".dt_proj.bias"):
            if kind != "small":
                raise ValueError(f"{name}: the dt draw takes a 'small' slice, got {kind!r}")
            u = torch.special.ndtr(out[name] / 0.05)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
            dt = dt.clamp(min=DT_FLOOR)
            out[name] = dt + torch.log(-torch.expm1(-dt))
    return out


def _published_weights():
    """``weights.make`` returning ``published_ssm``'s weights, for the set-up
    of ``train``'s driver and control."""
    def make(orig):
        def made(specs, *args, **kwargs):
            return published_ssm(specs, orig(specs, *args, **kwargs))
        return made

    return faults._patched(weights, "make", make)


def scan_counts():
    """(calls, elements) of the port's scan on the card so far; None where
    the port has no fused scan."""
    try:
        from lipvq_tpu_torch.ops.selective_scan import selective_scan_cuda
    except ImportError:
        return None
    return selective_scan_cuda.launches, selective_scan_cuda.elems


class _Checked:
    """The set-up on the published mixer weights and the check with
    ``grad_err``, for ``Driver`` and ``Control`` alike."""

    def setup(self) -> None:
        with _published_weights():
            super().setup()

    def check(self) -> tuple[dict, list]:
        """``train.Driver.check``'s numbers, and ``grad_err``; the reference
        follows the first steps from the same weights on the same draws."""
        dev, mix = self.device, self.mix
        trainer = self.ref.Trainer({k: v.to(dev) for k, v in self.weights.items()}, self.cfg,
                                   seed=self.seed, device=dev, start=mix["schedule_step"])
        rng = np.random.default_rng(self.seed)
        per, grads = [], None
        for step, log in enumerate(self.logs):
            idx = rng.choice(len(self.items), size=mix["batch_size"], replace=True)
            r = trainer.step(self.items.batch(idx, dev))
            if step == 0:
                grads = {k: g.detach().clone() for k, g in r["grads"].items()}
            per.append({"step": step + 1,
                        "loss_gap": max(abs(log["Loss"] - r["action_loss"])
                                        / abs(r["action_loss"]),
                                        abs(log["VQ_Loss"] - r["vq_loss"]) / abs(r["vq_loss"]))})
        grad1 = {k: self.grad1[k].to(dev) for k in grads}
        err2 = sum(float(torch.linalg.vector_norm((grad1[k] - grads[k]).double())) ** 2
                   for k in grads)
        ref2 = sum(float(torch.linalg.vector_norm(grads[k].double())) ** 2 for k in grads)
        grad_err = math.sqrt(err2 / ref2)
        grad_gap, grad_leaf, kept = train.leaf_gap(grad1, grads, grads)
        del grad1
        start = {k: self.weights[k].to(dev) for k in grads}
        ref_change = {k: trainer.W[k] - start[k] for k in grads}
        prog_change = {k: self.state3[k].to(dev) - start[k] for k in grads}
        del start, trainer
        change_gap, change_leaf, _ = train.leaf_gap(prog_change, ref_change, grads)
        worst = {"loss_gap": max(p["loss_gap"] for p in per), "grad_gap": grad_gap,
                 "grad_err": grad_err, "change_gap": change_gap}
        per.append({"grad_err": grad_err, "grad_gap": grad_gap, "grad_leaf": grad_leaf,
                    "change_gap": change_gap, "change_leaf": change_leaf, "leaves": len(kept),
                    "excluded": sorted(set(grads) - set(kept))})
        return worst, per


class Driver(_Checked, train.Driver):
    def reset_spans(self) -> None:
        super().reset_spans()
        self.scan_base = scan_counts()

    def scan_shape(self) -> tuple:
        """(b, t, d, n) of one scan call of the backbone: the context-query
        pairs, 3T tokens, the mixer's channels and its states."""
        cfg = self.cfg
        return (self.mix["batch_size"] // 2, 3 * cfg["context_length"],
                cfg["expand"] * cfg["embed_dim"], cfg["d_state"])

    def spans(self) -> dict:
        out = super().spans()
        now = scan_counts()
        if now is None or self.scan_base is None:
            return out
        calls, elems = (a - b for a, b in zip(now, self.scan_base))
        b, t, d, n = self.scan_shape()
        # a forward and its backward per layer and step
        pairs = elems / (2 * b * t * d * n)
        work = self.counts.scan(b, t, d, n)
        out["ssm_scan"] = {"launches": calls, "elems": elems, "ops": pairs * work["ops"],
                           "bytes": pairs * work["bytes"]}
        return out


class Control(_Checked, train.Control):
    pass


def _bf16_state_scan(x, dt, A, B, C, D, rows: int = 48):
    """The recurrence by its definition with the state rounded to bf16 after
    every step, ``rows`` sequences at a time."""
    ys = []
    for r in range(0, x.shape[0], rows):
        xb, dtb, Bb, Cb = (v[r:r + rows].float() for v in (x, dt, B, C))
        h = torch.zeros(xb.shape[0], xb.shape[2], A.shape[1], dtype=torch.bfloat16,
                        device=x.device)
        out = []
        for t in range(xb.shape[1]):
            h = (torch.exp(dtb[:, t, :, None] * A) * h.float()
                 + (dtb[:, t] * xb[:, t])[:, :, None] * Bb[:, t, None]).to(torch.bfloat16)
            out.append((h.float() * Cb[:, t, None]).sum(-1))
        ys.append(torch.stack(out, 1) + xb * D)
    return torch.cat(ys).to(x.dtype)


def bf16_scan_state():
    """The scan's state kept in bf16 where the Mamba mixer calls the scan
    (recomputed in the backward, so that it fits at the cell's size)."""
    from lipvq_tpu_torch.models import mamba

    def scan(*args):
        return torch.utils.checkpoint.checkpoint(_bf16_state_scan, *args, use_reentrant=False)

    return faults._patched(mamba, "selective_scan", lambda orig: scan)


# ``faults.py`` predates the scan: the fault joins its module, where
# ``control.py --reading fault:<name>`` looks a fault up by name
if not hasattr(faults, "bf16_scan_state"):
    faults.bf16_scan_state = bf16_scan_state
