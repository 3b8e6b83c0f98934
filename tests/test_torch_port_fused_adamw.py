"""The optimizer's two passes (``ops/fused_adamw.py``) on the CPU.

The ops' CPU kernels are the plain versions of the CUDA kernels, so here
the host side (the moments made lazily, the step counts, the
hyper-parameter sets, the clip's sums carried into ICL's logged norm) runs
whole and is held to ``torch.optim.Adam``/``AdamW`` with
``clip_by_global_norm_``. ``KERNEL_DEVICE`` set to "cpu" lets
``step_optimizers`` take that path here; by default the CPU takes torch's.
The kernels themselves are held to torch in ``test_torch_port_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.base import (
    ScheduledOptimizer,
    clip_by_global_norm_,
    global_norm,
    step_optimizers,
)
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.ops import fused_adamw
from lipvq_tpu_torch.utils import obs_utils, profile_utils, train_utils
from lipvq_tpu_torch.utils.file_utils import get_shape_metadata_from_dataset
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides, make_synthetic_export

torch.set_num_threads(1)

SHAPES = [(3, 5), (7,), (0,), (1,), (33,), (2, 2, 3)]
OPTIMIZERS = {"adamw": (torch.optim.AdamW, {"weight_decay": 0.1}),
              "adam_l2": (torch.optim.Adam, {"weight_decay": 0.1}),
              "adam": (torch.optim.Adam, {})}
# max_grad_norm: engaged (the exact grads' norm is 5/8 to 40), not engaged, no clip
CLIPS = {"engaged": 0.5, "not_engaged": 1e4, "none": None}


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of want's fp32 spacing."""
    spacing = torch.finfo(torch.float32).eps * want.abs() + 1e-12
    return float(((got - want).abs() / spacing).max()) if want.numel() else 0.0


def _params(seed: int = 0, shapes=SHAPES, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g).to(dtype)) for s in shapes]


def _set_grads(params, gen, scale: float = 1.0):
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen).to(p.dtype) * scale


# nonzero grads of each tensor of SHAPES: squares, and 4 + 4 + 1 + 16 = 5^2
EXACT_COUNTS = [4, 4, 0, 1, 16, 0]


def _exact_grads(params, gen):
    """Grads of +-2^e (e drawn per step) on the first EXACT_COUNTS[i]
    elements of tensor i, zeros elsewhere: each tensor's norm and the
    global norm (5 2^e) are exact in fp32 whatever the order, so the clip's
    scale is the same bit for bit on both paths and only the update's
    roundings remain."""
    e = int(torch.randint(-3, 4, (), generator=gen))
    for p, k in zip(params, EXACT_COUNTS):
        g = torch.zeros(p.numel())
        g[:k] = (torch.randint(0, 2, (k,), generator=gen) * 2 - 1) * 2.0 ** e
        p.grad = g.reshape(p.shape).to(p.dtype)


@pytest.fixture
def kernels_here(monkeypatch):
    """``step_optimizers`` takes the two ops' path for CPU tensors."""
    monkeypatch.setattr(fused_adamw, "KERNEL_DEVICE", "cpu")


# -- the plain versions against torch ------------------------------------------

@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_the_two_ops_equal_torch_over_ten_steps(kind, clip):
    cls, kw = OPTIMIZERS[kind]
    max_norm = CLIPS[clip]
    pa, pb = _params(), _params()
    oa = cls(pa, lr=1e-2, eps=1e-8, **kw)
    ob = cls(pb, lr=1e-2, eps=1e-8, **kw)
    gen = torch.Generator().manual_seed(1)
    for _ in range(10):
        _exact_grads(pa, gen)
        for a, b in zip(pa, pb):
            b.grad = a.grad.clone()
        if max_norm is not None:
            clip_by_global_norm_([p.grad for p in pa], max_norm)
        oa.step()
        out = fused_adamw.sq_norms([[p.grad for p in pb]], [max_norm])
        fused_adamw.adam_step_([ob], out, [None if max_norm is None else 2])
    for a, b in zip(pa, pb):
        sa, sb = oa.state[a], ob.state[b]
        assert float(sa["step"]) == float(sb["step"]) == 10
        for got, want in ((b, a), (sb["exp_avg"], sa["exp_avg"]),
                          (sb["exp_avg_sq"], sa["exp_avg_sq"])):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sq_norms_reference_gives_sums_norm_and_scales():
    g = torch.Generator().manual_seed(3)
    first = [torch.randn(5, generator=g) * 10, torch.zeros(0), torch.randn(2, 3, generator=g)]
    second = [torch.randn(4, generator=g)]
    out = fused_adamw.sq_norms([first, second, []], [1.0, None, 5.0])
    assert out.shape == (7,) and out.dtype == torch.float32
    s1 = sum(float(t.double().square().sum()) for t in first)
    s2 = float(second[0].double().square().sum())
    np.testing.assert_allclose(out[:3].numpy(), [s1, s2, 0.0], rtol=1e-6)
    np.testing.assert_allclose(float(out[3]), np.sqrt(s1 + s2), rtol=1e-6)
    np.testing.assert_allclose(float(out[4]), 1.0 / np.sqrt(s1), rtol=1e-6)  # clipped
    assert float(out[5]) == 1.0  # no clip
    assert float(out[6]) == 1.0  # norm 0 below 5


def test_sq_norms_carries_earlier_sums_into_the_norm():
    g = torch.Generator().manual_seed(5)
    first = [torch.randn(6, generator=g) * 3, torch.randn(2, 2, generator=g)]
    second = [torch.randn(9, generator=g)]
    sum_sq = fused_adamw.sq_norms([first], [1.0])[:1]
    out = fused_adamw.sq_norms([second], [None], [sum_sq])
    want = fused_adamw.sq_norms([first, second], [None, None])
    assert out.shape == (3,)
    np.testing.assert_allclose(float(out[1]), float(want[2]), rtol=1e-6)
    assert float(out[0]) == float(want[1]) and float(out[2]) == 1.0
    # no group at all: the norm of the carried sums alone
    alone = fused_adamw.sq_norms([], [], [sum_sq, out[:1]])
    assert alone.shape == (1,)
    np.testing.assert_allclose(float(alone[0]), float(want[2]), rtol=1e-6)


def test_sq_norms_scale_is_clip_by_global_norms():
    g = torch.Generator().manual_seed(4)
    grads = [torch.randn(50, generator=g), torch.randn(7, 3, generator=g)]
    want = [t.clone() for t in grads]
    clip_by_global_norm_(want, 0.5)
    scale = fused_adamw.sq_norms([grads], [0.5])[2]
    for t, w in zip(grads, want):
        assert _ulps(t * scale, w) <= 2


# -- where the kernels engage ----------------------------------------------------

def _adamw(params, **kw):
    return torch.optim.AdamW(params, lr=1e-3, **kw)


def test_engages_not_on_the_cpu_by_default():
    ps = _params()
    opt = _adamw(ps)
    _set_grads(ps, torch.Generator().manual_seed(0))
    assert fused_adamw.KERNEL_DEVICE == "cuda"
    assert not fused_adamw.engages(opt)


class _MyAdamW(torch.optim.AdamW):
    pass


def _noncontiguous_param():
    ps = _params()
    ps[0] = torch.nn.Parameter(torch.randn(5, 3).t())
    return ps


def _hooked(opt):
    opt.register_step_pre_hook(lambda *a: None)
    return opt


def _float64_moments(opt):
    ps = opt.param_groups[0]["params"]
    _set_grads(ps, torch.Generator().manual_seed(1))
    opt.step()  # makes the moments, then one turns float64
    p = ps[0]
    opt.state[p]["exp_avg"] = opt.state[p]["exp_avg"].double()
    return opt


ENGAGEMENT = {
    "adamw": (True, lambda: _adamw(_params())),
    "adam": (True, lambda: torch.optim.Adam(_params(), lr=1e-3, weight_decay=0.1)),
    "adam_after_a_step": (True, lambda: _stepped(torch.optim.Adam(_params(), lr=1e-3))),
    "fp16_params": (False, lambda: _adamw(_params(dtype=torch.float16))),
    "bf16_params": (False, lambda: _adamw(_params(dtype=torch.bfloat16))),
    "amsgrad": (False, lambda: _adamw(_params(), amsgrad=True)),
    "maximize": (False, lambda: _adamw(_params(), maximize=True)),
    "capturable": (False, lambda: _adamw(_params(), capturable=True)),
    "differentiable": (False, lambda: _adamw(_params(), differentiable=True)),
    "noncontiguous_param": (False, lambda: _adamw(_noncontiguous_param())),
    "tensor_lr": (False, lambda: torch.optim.AdamW(_params(), lr=torch.tensor(1e-3))),
    "sgd": (False, lambda: torch.optim.SGD(_params(), lr=1e-3)),
    "a_subclass": (False, lambda: _MyAdamW(_params(), lr=1e-3)),
    "a_step_hook": (False, lambda: _hooked(_adamw(_params()))),
    "float64_moments": (False, lambda: _float64_moments(_adamw(_params()))),
}


def _stepped(opt):
    _set_grads(opt.param_groups[0]["params"], torch.Generator().manual_seed(1))
    opt.step()
    return opt


@pytest.mark.parametrize("case", ENGAGEMENT)
def test_engagement_predicate(kernels_here, case):
    want, make = ENGAGEMENT[case]
    opt = make()
    _set_grads([p for g in opt.param_groups for p in g["params"]],
               torch.Generator().manual_seed(2))
    assert fused_adamw.engages(opt) is want


def test_engages_not_without_grads_nor_with_a_noncontiguous_grad(kernels_here):
    ps = _params()
    opt = _adamw(ps)
    assert not fused_adamw.engages(opt)  # no grad at all
    _set_grads(ps, torch.Generator().manual_seed(0))
    assert fused_adamw.engages(opt)
    ps[0].grad = torch.randn(5, 3).t()
    assert not fused_adamw.engages(opt)


# -- step_optimizers: the kernels' path against torch's -----------------------

def _scheduled(kind: str, clip, seed: int = 0):
    cls, kw = OPTIMIZERS[kind]
    return ScheduledOptimizer(_params(seed), cls, lambda step: 1e-2 / (1 + step),
                              max_grad_norm=clip, eps=1e-8, **kw)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_step_optimizers_kernels_path_equals_torch_path(monkeypatch, kind, clip):
    a, b = _scheduled(kind, CLIPS[clip]), _scheduled(kind, CLIPS[clip])
    before = (fused_adamw.adam_step_.steps, fused_adamw.torch_step_.steps,
              fused_adamw.adam_step_.elems)

    gen = torch.Generator().manual_seed(5)
    for _ in range(10):
        _exact_grads(a.params, gen)
        for pa, pb in zip(a.params, b.params):
            pb.grad = pa.grad.clone()
        want = step_optimizers([a])
        with monkeypatch.context() as m:
            m.setattr(fused_adamw, "KERNEL_DEVICE", "cpu")
            got = step_optimizers([b])
        assert float(got) == float(want)
    assert a.steps == b.steps == 10
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"] == 1e-2 / 11
    for pa, pb in zip(a.params, b.params):
        torch.testing.assert_close(pb, pa, rtol=0, atol=0)
    assert fused_adamw.adam_step_.steps - before[0] == 10
    assert fused_adamw.torch_step_.steps - before[1] == 10
    assert fused_adamw.adam_step_.elems - before[2] == 10 * sum(p.numel() for p in a.params)


def test_the_logged_norm_is_taken_before_the_clip(kernels_here):
    o = _scheduled("adamw", 0.5)
    _set_grads(o.params, torch.Generator().manual_seed(6), 2.0)
    want = float(global_norm([p.grad for p in o.params]))
    got = float(step_optimizers([o]))
    assert want > 10 * 0.5
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clips", [(0.5, None), (None, None), (0.5, 2.0), (None, 1e4)],
                         ids=["clip_none", "none_none", "clip_clip", "none_clip"])
def test_two_optimizers_log_the_norm_of_both(kernels_here, clips):
    """Each clipping step's sum of squares is carried into one pass over the
    other optimizer's grads: the norm of both, before any clip."""
    opts = [ScheduledOptimizer(_params(seed), torch.optim.AdamW, lambda step: 1e-2,
                               max_grad_norm=clip) for seed, clip in zip((0, 1), clips)]
    gen = torch.Generator().manual_seed(10)
    for o in opts:
        _set_grads(o.params, gen, 2.0)
    want = float(global_norm([p.grad for o in opts for p in o.params]))
    got = float(step_optimizers(opts))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert all(o.steps == 1 for o in opts)


def test_a_clipping_step_returns_its_sum_of_squares(kernels_here):
    clipped, plain = _scheduled("adamw", 0.5), _scheduled("adam", None, seed=1)
    gen = torch.Generator().manual_seed(11)
    _set_grads(clipped.params, gen)
    _set_grads(plain.params, gen)
    want = float(global_norm([p.grad for p in clipped.params])) ** 2
    got = clipped.step()
    assert got.shape == (1,)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert plain.step() is None


def test_state_dict_is_torchs_after_a_round_trip(kernels_here):
    a, b = _scheduled("adamw", 1e4), _scheduled("adamw", 1e4)
    gen = torch.Generator().manual_seed(7)
    for _ in range(3):
        _set_grads(b.params, gen)
        for pa, pb in zip(a.params, b.params):
            pa.grad = pb.grad.clone()
        step_optimizers([b])
        a.optimizer.step()  # torch's step straight
        a._advance()
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["steps"] == sb["steps"] == 3
    assert sa["optimizer"]["param_groups"] == sb["optimizer"]["param_groups"]
    assert sa["optimizer"]["state"].keys() == sb["optimizer"]["state"].keys()
    for k, st in sa["optimizer"]["state"].items():
        assert st.keys() == sb["optimizer"]["state"][k].keys()
        for name, t in st.items():
            got = sb["optimizer"]["state"][k][name]
            assert got.dtype == t.dtype and got.device == t.device
            torch.testing.assert_close(got, t, rtol=0, atol=0)
    # a fresh optimizer loaded from the kernels' state goes on as torch's
    c = _scheduled("adamw", 1e4)
    with torch.no_grad():
        for pc, pb in zip(c.params, b.params):
            pc.copy_(pb)
    c.load_state_dict(copy.deepcopy(sb))
    _set_grads(c.params, gen)
    for pa, pc in zip(a.params, c.params):
        pa.grad = pc.grad.clone()
    step_optimizers([c])
    a.optimizer.step()
    for pa, pc in zip(a.params, c.params):
        torch.testing.assert_close(pc, pa, rtol=0, atol=0)
    assert float(c.optimizer.state[c.params[0]]["step"]) == 4


def test_counters_say_the_cpu_takes_torchs_path():
    o = _scheduled("adamw", 1.0)
    profile_utils.reset()
    _set_grads(o.params, torch.Generator().manual_seed(8))
    step_optimizers([o])
    o.step()
    got = profile_utils.totals()["counters"]
    assert got["optimizer_torch_steps"] == 2
    assert got["optimizer_fused_steps"] == got["optimizer_fused_elems"] == 0
    profile_utils.reset()


def test_counters_reach_the_totals_on_the_kernels_path(kernels_here):
    o = _scheduled("adam", None)
    profile_utils.reset()
    _set_grads(o.params, torch.Generator().manual_seed(9))
    o.step()
    got = profile_utils.totals()["counters"]
    assert got["optimizer_fused_steps"] == 1 and got["optimizer_torch_steps"] == 0
    assert got["optimizer_fused_elems"] == sum(p.numel() for p in o.params)
    profile_utils.reset()


# -- ICL's two optimizers, one norm pass ----------------------------------------

@pytest.fixture(scope="module")
def icl_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused_adamw")
    export = make_synthetic_export(str(root / "export"), n_demos=3, demo_len=20)
    d = icl_test_config_overrides()
    d["train"].update({"data": export, "output_dir": str(root)})
    cfg = config_factory("icl", d)
    obs_utils.initialize_obs_utils_with_config(cfg)
    sm = get_shape_metadata_from_dataset(export, all_obs_keys=cfg.all_obs_keys)
    train_ds, _ = train_utils.load_data_for_training(cfg, obs_keys=sm["all_obs_keys"])
    loader, _, _ = train_utils.make_loaders(cfg, train_ds, None)
    return cfg, sm, loader


def _icl(icl_setup, max_grad_norm: float):
    cfg, sm, _ = icl_setup
    model = algo_factory("icl", cfg, sm["all_shapes"], ac_dim=sm["ac_dim"], device="cpu")
    for o in model.optimizers().values():  # past the warm-up: a real learning rate
        o.steps = 20000
        for group in o.optimizer.param_groups:
            group["lr"] = o.schedule(o.steps)
    model.policy_optimizer.max_grad_norm = max_grad_norm
    return model


@pytest.mark.parametrize("max_grad_norm", [1e-3, 1e4], ids=["clip_engaged", "clip_not_engaged"])
def test_icl_train_on_batch_on_the_kernels_path(monkeypatch, icl_setup, max_grad_norm):
    _, _, loader = icl_setup
    a, b = _icl(icl_setup, max_grad_norm), _icl(icl_setup, max_grad_norm)
    assert b.vq_optimizer is not None
    it = iter(loader)
    fused = fused_adamw.adam_step_.steps
    for _ in range(3):
        batch = a.process_batch_for_training(next(it))
        want = a.train_on_batch(copy.deepcopy(batch), epoch=1)["losses"]
        with monkeypatch.context() as m:
            m.setattr(fused_adamw, "KERNEL_DEVICE", "cpu")
            got = b.train_on_batch(batch, epoch=1)["losses"]
        np.testing.assert_allclose(float(got["action_loss"]), float(want["action_loss"]),
                                   rtol=1e-5)
        # the norm of both optimizers' grads, before the policy's clip
        np.testing.assert_allclose(float(got["policy_grad_norms"]),
                                   float(want["policy_grad_norms"]), rtol=1e-5)
        if max_grad_norm < 1:
            assert float(got["policy_grad_norms"]) > 10 * max_grad_norm
        # bit for bit without the clip; with it, the clip's scale differs in
        # its last bits and Adam's step (the size of lr wherever a grad is
        # near 0) carries that on: within a hundredth of one step
        lr = a.policy_optimizer.optimizer.param_groups[0]["lr"]
        atol = 0.0 if max_grad_norm > 1 else 1e-2 * lr
        for (name, pa), pb in zip(a.nets.named_parameters(), b.nets.parameters()):
            torch.testing.assert_close(pb, pa, rtol=0, atol=atol, msg=name)
    assert fused_adamw.adam_step_.steps - fused == 6  # policy and tokenizer, 3 steps
    for o in b.optimizers().values():
        assert all(p.grad is None for p in o.params)
        assert o.steps == 20003


def test_icl_steps_each_optimizer_through_its_step(monkeypatch, kernels_here, icl_setup):
    """Each update goes through ``ScheduledOptimizer.step``: a step made a
    no-op changes nothing, and the logged norm is still both optimizers'."""
    calls = []
    step = ScheduledOptimizer.step
    monkeypatch.setattr(ScheduledOptimizer, "step", lambda self: calls.append(self) or step(self))
    model = _icl(icl_setup, 1e-3)
    batch = model.process_batch_for_training(next(iter(icl_setup[2])))
    model.train_on_batch(batch, epoch=1)
    assert calls == [model.policy_optimizer, model.vq_optimizer]
    seen = []  # the grads each no-op step was given
    monkeypatch.setattr(ScheduledOptimizer, "step",
                        lambda self: seen.extend(p.grad.clone() for p in self.params))
    before = [p.detach().clone() for p in model.nets.parameters()]
    logged = model.train_on_batch(batch, epoch=1)["losses"]["policy_grad_norms"]
    for b, p in zip(before, model.nets.parameters()):
        assert torch.equal(b, p)
    np.testing.assert_allclose(float(logged), float(global_norm(seen)), rtol=1e-5)
