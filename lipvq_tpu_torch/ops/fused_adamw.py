"""Adam and AdamW over many fp32 tensors in two passes, and their plain
versions.

A train step's optimizer block used to pass over the parameters about 24
times: the logged global norm, the clip's norm and scale, then torch's
foreach Adam/AdamW. ``csrc/fused_adamw.cu`` does it in two passes: one read
of the grads for the norms, one pass that reads p, g, m, v and writes p, m, v
(module docstring of the source: kernels, launches, roundings).

- ``sq_norms_reference(grads, group_sizes, max_norms, carry)``: the norm
  pass in plain PyTorch. ``grads`` are the groups' grads one after another,
  group k holding ``group_sizes[k]``; the result is [2 G + 1] fp32: each
  group's sum of squares, the norm of all of them and of the sums of squares
  ``carry`` (one-element tensors from earlier passes), each group's clip
  scale (1 where its ``max_norms`` entry is negative: no clip).
- ``clip_adamw_reference_(params, grads, exp_avgs, exp_avg_sqs, scales,
  hyper_of, hyper_floats, hyper_ints)``: the update pass in plain PyTorch,
  torch's single-tensor Adam op for op. Tensor i takes hyper-parameter set
  j = ``hyper_of[i]``: ``hyper_floats[8 j:8 j + 8]`` = (1 - lr wd, wd,
  1 - beta1, beta2, 1 - beta2, -lr / bc1, sqrt(bc2), eps) and
  ``hyper_ints[2 j:2 j + 2]`` = (index of its scale in ``scales``, -1 for
  none; ``DECAY`` or ``L2`` or 0).
- ``lipvq_tpu_torch::_foreach_sq_norms`` and
  ``lipvq_tpu_torch::_foreach_clip_adamw_``: the two as torch.library ops,
  the kernels on CUDA tensors and the plain versions on CPU tensors. The
  kernels are launched from inside the ops, which call no other op that
  launches a kernel, so a profiler credits their device time to op names
  that hold ``_foreach``, as it credited torch's foreach optimizer. They are
  defined through ``torch.library.Library``: ``custom_op``'s per-call
  checks over a list of a thousand tensors cost several times the dispatch.
- ``engages(optimizer)``: whether ``adam_step_`` can take ``optimizer``:
  a ``torch.optim.Adam`` or ``AdamW`` (not a subclass) without amsgrad,
  maximize, capturable, differentiable, fused, a grad scaler or step hooks,
  with float hyper-parameters, some parameter with a grad, and every
  parameter with a grad a dense, contiguous fp32 CUDA tensor on one device
  with a grad (and moments, once made) of the same kind.
- ``sq_norms(groups, max_norms, carry)`` and ``adam_step_(optimizers,
  scales, scale_index)``: the host side. ``adam_step_`` makes the moments
  lazily and advances ``state["step"]`` on the CPU as torch does, so
  ``state_dict``, ``load_state_dict`` and checkpoints are torch's.
  ``torch_step_(optimizer)``: torch's own step, where the kernels do not
  engage.
- Counters, since the process started: ``adam_step_.steps`` and
  ``.elems``, the optimizer steps the kernels took and the elements they
  updated; ``torch_step_.steps``, the steps on torch's path (the three
  registered with ``utils/profile_utils`` at import as
  ``optimizer_fused_steps``, ``optimizer_fused_elems`` and
  ``optimizer_torch_steps``); ``sq_norms.launches`` and
  ``adam_step_.launches``, the kernels each pass launched on the card, as
  the library reports them.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch
from torch.optim import optimizer as torch_optimizer

from lipvq_tpu_torch.ops import _build
from lipvq_tpu_torch.utils import profile_utils

KERNEL_DEVICE = "cuda"  # the device type the kernels run on
DECAY = 1  # AdamW: p *= 1 - lr wd
L2 = 2     # Adam with weight decay: g += wd p
HYPER_FLOATS = 8
HYPER_INTS = 2


# -- plain versions ------------------------------------------------------------

def sq_norms_reference(grads: Sequence[torch.Tensor], group_sizes: Sequence[int],
                       max_norms: Sequence[float], carry: Sequence[torch.Tensor] = ()
                       ) -> torch.Tensor:
    """[each group's sum of squares, the norm of all and of ``carry``, each
    group's clip scale] in fp32; the scale as ``clip_by_global_norm_``
    computes it."""
    some = [*grads, *carry]
    device = some[0].device if some else torch.device("cpu")
    sums, i = [], 0
    for size in group_sizes:
        s = torch.zeros((), dtype=torch.float32, device=device)
        for g in grads[i:i + size]:
            s = s + g.float().square().sum()
        sums.append(s)
        i += size
    scales = []
    for s, mx in zip(sums, max_norms):
        norm = s.sqrt()
        scales.append(torch.ones_like(norm) if mx < 0 else
                      torch.where(norm < mx, torch.ones_like(norm), mx / norm))
    total = torch.zeros((), dtype=torch.float32, device=device)
    for s in [*sums, *(c.reshape(()) for c in carry)]:  # in order, as the finalize adds
        total = total + s
    return torch.stack(sums + [total.sqrt()] + scales)


def clip_adamw_reference_(params, grads, exp_avgs, exp_avg_sqs, scales, hyper_of,
                          hyper_floats, hyper_ints) -> None:
    """The update pass in place, torch's single-tensor Adam op for op."""
    with torch.no_grad():
        for p, g, m, v, j in zip(params, grads, exp_avgs, exp_avg_sqs, hyper_of):
            decay, l2, w1, b2, omb2, neg_step, bc2s, eps = hyper_floats[
                HYPER_FLOATS * j:HYPER_FLOATS * (j + 1)]
            scale, flags = hyper_ints[HYPER_INTS * j:HYPER_INTS * (j + 1)]
            if scale >= 0:
                g = g * scales[scale]
            if flags & DECAY:
                p.mul_(decay)
            if flags & L2:
                g = g.add(p, alpha=l2)
            m.lerp_(g, w1)
            v.mul_(b2).addcmul_(g, g, value=omb2)
            p.addcdiv_(m, (v.sqrt() / bc2s).add_(eps), value=neg_step)


# -- the kernels ---------------------------------------------------------------

def _declare(name: str, lib: ctypes.CDLL) -> None:
    """``_build.load``'s declaration of ``csrc/fused_adamw.cu``'s entry
    points."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fused_sq_norms_partials.argtypes = [i32, ptr]
    lib.fused_sq_norms_partials.restype = i64
    lib.fused_sq_norms.argtypes = [i32, ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr]
    lib.fused_sq_norms.restype = i32
    lib.fused_clip_adamw.argtypes = [i32] + [ptr] * 6 + [i32, ptr, ptr, ptr, ptr, ptr]
    lib.fused_clip_adamw.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load("fused_adamw", _declare)


def limits() -> dict[str, int]:
    """The library's launch limits: tensors a launch takes in each pass,
    hyper-parameter sets an update launch takes, groups, chunk sizes."""
    out = (ctypes.c_int * 6)()
    _lib().fused_adamw_limits(out)
    return dict(zip(("norm_tensors", "adam_tensors", "hypers", "groups", "norm_chunk",
                     "adam_chunk"), out))


def _dense_fp32(t: torch.Tensor | None, index: int) -> bool:
    """A dense, contiguous fp32 tensor on device ``index`` (``get_device``:
    -1 for the CPU); a device index is cheaper to compare than a device."""
    return (t is not None and t.dtype == torch.float32 and t.layout == torch.strided
            and t.get_device() == index and t.is_contiguous())


def _on_one_card(*lists) -> torch.device:
    """The one CUDA device of dense, contiguous fp32 tensors of equal sizes
    index by index; raises otherwise."""
    first = lists[0][0]
    index, sizes = first.get_device(), [t.numel() for t in lists[0]]
    for ts in lists:
        if not (first.is_cuda and len(ts) == len(sizes) and all(
                _dense_fp32(t, index) and t.numel() == n for t, n in zip(ts, sizes))):
            raise ValueError("the fused optimizer takes lists of dense, contiguous float32 "
                             "tensors of equal sizes index by index on one CUDA device")
    return first.device


def _sq_norms_cuda(grads, group_sizes, max_norms, carry) -> torch.Tensor:
    dev = _on_one_card([*grads, *carry])
    n = len(grads)
    numel = (ctypes.c_int64 * n)(*[g.numel() for g in grads])
    partials = torch.empty(max(_lib().fused_sq_norms_partials(n, numel), 1),
                           dtype=torch.float32, device=dev)
    groups = len(group_sizes)
    out = torch.empty(2 * groups + 1, dtype=torch.float32, device=dev)
    ends, total = [], 0
    for size in group_sizes:
        total += size
        ends.append(total)
    launches = ctypes.c_int(0)  # the kernels the entry point launched
    _build.launch(_lib(), "fused_sq_norms", dev, n, _build.addresses(grads), numel, groups,
                  (ctypes.c_int32 * groups)(*ends), (ctypes.c_float * groups)(*max_norms),
                  len(carry), _build.addresses(carry), partials.data_ptr(), out.data_ptr(),
                  ctypes.byref(launches))
    sq_norms.launches += launches.value
    return out


def _clip_adamw_cuda(params, grads, exp_avgs, exp_avg_sqs, scales, hyper_of, hyper_floats,
                     hyper_ints) -> None:
    dev = _on_one_card(params, grads, exp_avgs, exp_avg_sqs)
    if scales is not None:
        _on_one_card([scales])
        if scales.device != dev:
            raise ValueError(f"the clip scales are on {scales.device}, the tensors on {dev}")
    n, launches = len(params), ctypes.c_int(0)
    lists = [_build.addresses(ts) for ts in (params, grads, exp_avgs, exp_avg_sqs)]
    _build.launch(_lib(), "fused_clip_adamw", dev, n, *lists,
                  (ctypes.c_int64 * n)(*[p.numel() for p in params]),
                  (ctypes.c_int32 * n)(*hyper_of), len(hyper_ints) // HYPER_INTS,
                  (ctypes.c_float * len(hyper_floats))(*hyper_floats),
                  (ctypes.c_int32 * len(hyper_ints))(*hyper_ints),
                  None if scales is None else scales.data_ptr(), ctypes.byref(launches))
    adam_step_.launches += launches.value


_OPS = torch.library.Library("lipvq_tpu_torch", "FRAGMENT")
_OPS.define("_foreach_sq_norms(Tensor[] grads, int[] group_sizes, float[] max_norms, "
            "Tensor[] carry) -> Tensor")
_OPS.define("_foreach_clip_adamw_(Tensor(a!)[] params, Tensor[] grads, Tensor(b!)[] exp_avgs, "
            "Tensor(c!)[] exp_avg_sqs, Tensor? scales, int[] hyper_of, float[] hyper_floats, "
            "int[] hyper_ints) -> ()")
_OPS.impl("_foreach_sq_norms", sq_norms_reference, "CPU")
_OPS.impl("_foreach_sq_norms", _sq_norms_cuda, "CUDA")
_OPS.impl("_foreach_clip_adamw_", clip_adamw_reference_, "CPU")
_OPS.impl("_foreach_clip_adamw_", _clip_adamw_cuda, "CUDA")


# -- the host side -------------------------------------------------------------

def _global_hooks() -> bool:
    return bool(getattr(torch_optimizer, "_global_optimizer_pre_hooks", None)
                or getattr(torch_optimizer, "_global_optimizer_post_hooks", None))


def engages(optimizer: torch.optim.Optimizer) -> bool:
    """Whether the kernels can take ``optimizer``'s step (module docstring);
    where they cannot, torch's own step runs."""
    if type(optimizer) not in (torch.optim.Adam, torch.optim.AdamW):
        return False
    if (getattr(optimizer, "grad_scale", None) is not None
            or getattr(optimizer, "found_inf", None) is not None
            or optimizer._optimizer_step_pre_hooks or optimizer._optimizer_step_post_hooks
            or _global_hooks()):
        return False
    index = None
    for group in optimizer.param_groups:
        if any(group.get(k) for k in ("amsgrad", "maximize", "capturable", "differentiable",
                                      "fused")):
            return False
        if not all(isinstance(x, (float, int)) for x in (group["lr"], group["weight_decay"],
                                                         group["eps"], *group["betas"])):
            return False
        for p in group["params"]:
            if p.grad is None:
                continue
            if index is None:
                if p.device.type != KERNEL_DEVICE:
                    return False
                index = p.get_device()
            if not (_dense_fp32(p, index) and _dense_fp32(p.grad, index)):
                return False
            state = optimizer.state.get(p)
            if state and not (_dense_fp32(state.get("exp_avg"), index)
                              and _dense_fp32(state.get("exp_avg_sq"), index)
                              and isinstance(state.get("step"), torch.Tensor)
                              and state["step"].is_cpu):
                return False
    return index is not None


def sq_norms(groups: Sequence[Sequence[torch.Tensor]], max_norms: Sequence[float | None],
             carry: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The norm pass over each group of grads: [each group's sum of squares,
    the norm of all of them and of the sums of squares ``carry`` (one-element
    tensors), each group's clip scale], on the grads' device, with no host
    sync. A group's ``max_norms`` entry None means no clip (scale 1)."""
    flat = [g for grads in groups for g in grads]
    return torch.ops.lipvq_tpu_torch._foreach_sq_norms(
        flat, [len(g) for g in groups], [-1.0 if m is None else float(m) for m in max_norms],
        list(carry))


sq_norms.launches = 0


def _scalar_dtype() -> torch.dtype:
    get = getattr(torch_optimizer, "_get_scalar_dtype", None)
    return get() if get is not None else torch.float32


def adam_step_(optimizers: Sequence[torch.optim.Optimizer], scales: torch.Tensor | None = None,
               scale_index: Sequence[int | None] | None = None) -> int:
    """One step of each of ``optimizers`` (each ``engages``) in one update
    pass; optimizer k's grads are scaled by ``scales[scale_index[k]]`` (no
    scale where its index is None). Returns the elements updated."""
    params, grads, exp_avgs, exp_avg_sqs, steps, where = [], [], [], [], [], []
    for k, opt in enumerate(optimizers):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = opt.state[p]
                if not state:  # made as torch's Adam makes it, on the first step
                    state["step"] = torch.tensor(0.0, dtype=_scalar_dtype())
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                params.append(p)
                grads.append(p.grad)
                exp_avgs.append(state["exp_avg"])
                exp_avg_sqs.append(state["exp_avg_sq"])
                steps.append(state["step"])
                where.append((k, group))
    if not params:
        return 0
    torch._foreach_add_(steps, torch.tensor(1.0), alpha=1.0)
    sets: dict = {}
    hyper_of, hyper_floats, hyper_ints = [], [], []
    for (k, group), step in zip(where, steps):
        key = (id(group), step.item())
        j = sets.get(key)
        if j is None:
            j = sets[key] = len(sets)
            index = None if scale_index is None else scale_index[k]
            f, i = _hyper(group, optimizers[k], key[1], -1 if index is None else index)
            hyper_floats += f
            hyper_ints += i
        hyper_of.append(j)
    with torch.no_grad():
        torch.ops.lipvq_tpu_torch._foreach_clip_adamw_(
            params, grads, exp_avgs, exp_avg_sqs, scales, hyper_of, hyper_floats, hyper_ints)
    elems = sum(p.numel() for p in params)
    adam_step_.steps += len(optimizers)
    adam_step_.elems += elems
    return elems


adam_step_.steps = adam_step_.elems = adam_step_.launches = 0


def torch_step_(optimizer: torch.optim.Optimizer) -> None:
    """torch's own step of ``optimizer``, where the kernels do not engage."""
    optimizer.step()
    torch_step_.steps += 1


torch_step_.steps = 0
profile_utils.register({"optimizer_fused_steps": lambda: adam_step_.steps,
                        "optimizer_fused_elems": lambda: adam_step_.elems,
                        "optimizer_torch_steps": lambda: torch_step_.steps})


def _hyper(group, optimizer, step: float, scale: int) -> tuple[list[float], list[int]]:
    """A group's hyper-parameters at ``step``, as ``_multi_tensor_adam``
    computes them on its non-capturable path (in double; the kernel rounds
    them to fp32 as torch rounds its scalars)."""
    lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
    beta1, beta2 = group["betas"]
    decoupled = group.get("decoupled_weight_decay", type(optimizer) is torch.optim.AdamW)
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    flags = 0 if wd == 0 else DECAY if decoupled else L2
    return ([1 - lr * wd, wd, 1 - beta1, beta2, 1 - beta2, (lr / bc1) * -1, bc2 ** 0.5, eps],
            [scale, flags])
