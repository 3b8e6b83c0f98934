"""Port parity of the visual stack (``lipvq_tpu_torch/models/obs_core.py``
and the BatchNorm / FiLM / conv blocks of ``models/base_nets.py``): each
module run by the JAX package and by the port on the same weights (bridged
from flax, BatchNorm statistics included) and the same numpy inputs, in eval
mode (running statistics) and in train mode (batch statistics, which both
then advance).

Tolerances: fp32 convolutions on the CPU (XLA against oneDNN) sum in other
orders, so outputs are held to rtol 1e-4 / atol 1e-5 and the updated
BatchNorm statistics to rtol 1e-5 / atol 1e-6; crops, grids and frame
processing are held bit for bit."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.models import obs_core as jax_core
from lipvq_tpu.utils import obs_utils as jax_obs_utils
from lipvq_tpu_torch.algo.base import frames_to_float
from lipvq_tpu_torch.models import obs_core
from lipvq_tpu_torch.models import base_nets
from lipvq_tpu_torch.models.base_nets import BatchNorm, Conv, seeded_init
from lipvq_tpu_torch.utils import obs_utils
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

OUT_TOL = {"rtol": 1e-4, "atol": 1e-5}
STATS_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(variables, rng):
    """Move BatchNorm statistics, scales and biases off their init (mean 0,
    var 1, scale 1, bias 0), so running-statistics normalization and the
    affine part are exercised. FiLM's Dense gets multiples of 2^-10 (gamma
    near 1): with a condition of small integers its products and sums are
    exact in fp32, which the JAX package's Dense computes in even under
    float64."""
    variables = _np(variables)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif path[-1] == "TorchLinear_0" and path[-2].startswith("film"):
                grid = rng.integers(-32, 33, v.shape) / 1024.0
                if k == "bias":
                    grid[: v.shape[0] // 2] += 1.0  # gamma
                out[k] = grid.astype(np.float32)
            elif k == "mean" or (k == "bias" and "bn" in path[-1]):
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k in ("var", "scale"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(variables, ("",))


def _load(port, variables):
    state = state_dict_from_jax_params(variables["params"], port)
    state.update(state_dict_from_jax_params(variables.get("batch_stats", {})))
    port.load_state_dict(state, strict=True)


def _nchw(x):
    """NHWC numpy -> the [B, C, H, W] tensor the port's trunk takes."""
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _check_stats(port, updates, tol=STATS_TOL):
    want = {k: np.asarray(v) for k, v in _flat(_np(updates["batch_stats"])).items()}
    got = {k: v for k, v in port.state_dict().items() if k in want}
    assert got.keys() == want.keys() and want
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **tol)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = v
    return out


def _hold_trunk(jax_mod, port, x, train, rng, fp64=False, tol=None, stats_tol=None, **kw):
    """JAX module (NHWC) against the port module (channels-first) on the
    same bridged, perturbed weights; in train mode the updated statistics
    too. ``kw`` passes extra call arguments to both (numpy arrays). With
    ``fp64`` both sides run in float64, held to rtol 1e-8 / atol 1e-9;
    ``tol`` and ``stats_tol`` replace the outputs' and the statistics'
    tolerances."""
    variables = _perturbed(jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x), **{
        k: jnp.asarray(v) for k, v in kw.items()}), rng)
    _load(port, variables)
    out_tol, held_tol = OUT_TOL, STATS_TOL
    if fp64:
        x, kw = x.astype(np.float64), {k: v.astype(np.float64) for k, v in kw.items()}
        variables = jax.tree.map(lambda a: a.astype(np.float64), variables)
        port.double()
        out_tol = held_tol = {"rtol": 1e-8, "atol": 1e-9}
    out_tol, held_tol = tol or out_tol, stats_tol or held_tol
    with jax.enable_x64(fp64):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        if train:
            want, updates = jax_mod.apply(variables, jnp.asarray(x), train=True,
                                          mutable=["batch_stats"], **jkw)
        else:
            want = jax_mod.apply(variables, jnp.asarray(x), **jkw)
        want, updates = np.asarray(want), _np(updates) if train else None
    with torch.no_grad():
        got = port(_nchw(x), train, **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **out_tol)
    if train:
        _check_stats(port, updates, held_tol)
    return got


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("in_f,feats,stride", [(16, 32, 2), (32, 32, 1)])
def test_basic_block_matches_jax(train, in_f, feats, stride):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 10, 10, in_f), dtype=np.float32)
    port = obs_core._BasicBlock(in_f, feats, stride)
    assert hasattr(port, "downsample_conv") == (in_f != feats or stride != 1)
    _hold_trunk(jax_core._BasicBlock(feats, stride), port, x, train, rng)


@pytest.mark.parametrize("train", [False, True])
def test_bottleneck_matches_jax(train):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, 9, 16), dtype=np.float32)
    _hold_trunk(jax_core._Bottleneck(8, 2), obs_core._Bottleneck(16, 8, 2), x, train, rng)


@pytest.mark.parametrize("film,train,size,fp64", [
    (False, False, 32, False), (True, False, 32, False), (False, True, 32, True),
    (True, True, 32, True), (True, True, 64, False)])
def test_resnet18_matches_jax(film, train, size, fp64):
    """At 32x32 and batch 2, layer4 is 1x1: its BatchNorms see n = 2 values
    per channel, where the biased and unbiased variances differ by 2x. At
    init those two values lie ~1e-4 of their spread apart from their mean
    (var / mean^2 down to 2e-8), so fp32 keeps few digits of the variance
    on either side: that case runs in fp64 on both sides (rtol 1e-8, the two
    agree to ~1e-13 of the output's scale). In fp32 at 64x64 (n = 8 at
    layer4, var / mean^2 >= 0.05) train mode amplifies the two packages'
    rounding ~30x over eval mode (2.8e-5 of the output's scale against
    1.1e-6): held to atol 5e-4 (6e-5 of the scale) there, the statistics
    to atol 5e-6."""
    rng = np.random.default_rng(2)
    x = rng.random((2, size, size, 3), dtype=np.float32)
    kw = {"film_cond": rng.integers(-1, 2, (2, 16)).astype(np.float32)} if film else {}
    port = obs_core.ResNet18Conv(3, 16 if film else None)
    loose = train and not fp64
    got = _hold_trunk(jax_core.ResNet18Conv(), port, x, train, rng, fp64=fp64,
                      tol={"rtol": 1e-4, "atol": 5e-4} if loose else None,
                      stats_tol={"rtol": 1e-5, "atol": 5e-6} if loose else None, **kw)
    assert got.shape == (2, 512, size // 32, size // 32)
    assert hasattr(port, "film4") == film


@pytest.mark.parametrize("kernel,stride,bias", [((3, 3), 1, True), ((7, 7), 2, False),
                                                ((1, 1), 1, True), ((3,), 2, True)],
                         ids=["3x3", "7x7-stride2-nobias", "1x1", "1d-stride2"])
def test_conv_runs_forward_and_backward_with_cudnn_tf32_off(monkeypatch, kernel, stride, bias):
    """``Conv`` computes what ``F.conv1d`` / ``F.conv2d`` of its padded input
    compute, gradients too, bit for bit on the CPU; its forward and its
    backward each run inside ``cudnn_fp32`` (cuDNN's TF32 off), and the
    process's setting is back afterwards."""
    seen = []
    scope = base_nets.cudnn_fp32

    @contextlib.contextmanager
    def observed():
        with scope():
            seen.append(torch.backends.cudnn.allow_tf32)
            yield

    monkeypatch.setattr(base_nets, "cudnn_fp32", observed)
    gen = torch.Generator().manual_seed(0)
    conv = seeded_init(Conv(3, 5, kernel, stride=stride, bias=bias), gen)
    if bias:
        torch.nn.init.normal_(conv.bias, generator=gen)
    x = torch.randn((2, 3) + (9,) * len(kernel), generator=gen, requires_grad=True)
    ref_x = x.detach().clone().requires_grad_()
    pads = [p for lo_hi in reversed(conv._pads(x.shape[2:])) for p in lo_hi]
    fn = torch.nn.functional.conv1d if len(kernel) == 1 else torch.nn.functional.conv2d
    ref_w = conv.weight.detach().clone().requires_grad_()
    ref_b = None if conv.bias is None else conv.bias.detach().clone().requires_grad_()
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = conv(x)
        y.square().sum().backward()
        assert seen == [False, False] and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    want = fn(torch.nn.functional.pad(ref_x, pads), ref_w, ref_b, stride)
    want.square().sum().backward()
    assert torch.equal(y, want)
    assert torch.equal(x.grad, ref_x.grad) and torch.equal(conv.weight.grad, ref_w.grad)
    if bias:
        assert torch.equal(conv.bias.grad, ref_b.grad)


def test_batchnorm_running_variance_is_biased():
    """n = 2 values per channel: flax's update (and the port's) takes the
    biased variance, torch's BatchNorm2d the unbiased one, twice as large."""
    x = torch.tensor([[[[1.0]], [[0.0]]], [[[3.0]], [[4.0]]]])  # [2, 2, 1, 1]
    bn = seeded_init(BatchNorm(2), torch.Generator().manual_seed(0))
    bn(x, train=True)
    biased = torch.tensor([1.0, 4.0])  # ((1 - 2)^2 + (3 - 2)^2) / 2, ((0-2)^2+(4-2)^2)/2
    torch.testing.assert_close(bn.var, 0.9 * torch.ones(2) + 0.1 * biased, rtol=1e-6, atol=0)
    torch.testing.assert_close(bn.mean, 0.1 * torch.tensor([2.0, 2.0]), rtol=1e-6, atol=0)
    ref = torch.nn.BatchNorm2d(2, momentum=0.1)
    ref(x)
    assert float((ref.running_var - bn.var).abs().min()) > 0.05
    jbn = jax.numpy.asarray(x.permute(0, 2, 3, 1).numpy())
    from flax import linen as nn

    mod = nn.BatchNorm(use_running_average=False, momentum=0.9)
    _, upd = mod.apply(mod.init(jax.random.PRNGKey(0), jbn), jbn, mutable=["batch_stats"])
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)


def test_batchnorm_one_value_per_channel_matches_flax():
    """One frame at a 1x1 map in train mode: x - mean is 0, so flax's output
    is the bias (torch's batch_norm would raise); the statistics move as
    flax's do."""
    from flax import linen as nn

    x = np.asarray([[[[2.0, -1.0, 0.5]]]], np.float32)  # NHWC [1, 1, 1, 3]
    mod = nn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = _np(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["params"]["bias"] = np.asarray([0.3, -0.2, 0.1], np.float32)
    want, upd = mod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(3)
    _load(bn, variables)
    xt = _nchw(x).requires_grad_(True)
    got = bn(xt, train=True)
    np.testing.assert_array_equal(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want))
    _check_stats(bn, upd, {"rtol": 1e-6, "atol": 0})
    got.sum().backward()
    assert torch.equal(xt.grad, torch.zeros_like(xt))


def test_batchnorm_stats_follow_train_flag_only():
    """Buffers move only with train=True; nn.Module.training plays no part."""
    bn = seeded_init(BatchNorm(3), torch.Generator().manual_seed(0))
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(1))
    bn.train()
    bn(x)
    assert torch.equal(bn.mean, torch.zeros(3)) and torch.equal(bn.var, torch.ones(3))
    bn.eval()
    bn(x, train=True)
    assert not torch.equal(bn.mean, torch.zeros(3))


@pytest.mark.parametrize("num_kp,learnable", [(6, False), (16, False), (6, True)])
def test_spatial_softmax_matches_jax(num_kp, learnable):
    """kp_conv where num_kp differs from the 16 input channels; none at 16."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 7, 16), dtype=np.float32)
    jax_mod = jax_core.SpatialSoftmax(num_kp=num_kp, temperature=0.7,
                                      learnable_temperature=learnable)
    variables = _np(jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = seeded_init(obs_core.SpatialSoftmax(16, num_kp, 0.7, learnable),
                       torch.Generator().manual_seed(0))
    assert (port.kp_conv is None) == (num_kp == 16)
    if learnable:  # the port's init equals flax's
        np.testing.assert_allclose(port.log_temperature.detach().numpy(),
                                   variables["params"]["log_temperature"], rtol=1e-7)
        variables["params"]["log_temperature"] = np.asarray([0.3], np.float32)
    if variables:
        _load(port, variables)
    want = jax_mod.apply(variables, jnp.asarray(x))
    got = port(_nchw(x))
    assert got.shape == (3, 2 * num_kp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OUT_TOL)


def test_spatial_mean_pool_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 4, 6, 8), dtype=np.float32)
    want = jax_core.SpatialMeanPool().apply({}, jnp.asarray(x))
    np.testing.assert_allclose(obs_core.SpatialMeanPool()(_nchw(x)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-7)


def test_cross_attention_matches_jax():
    """512-d patches query one 768-d language token, 8 heads."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, 3, 512), dtype=np.float32)
    lang = rng.standard_normal((2, 768), dtype=np.float32)
    jax_mod = jax_core.CrossAttentionConditioner()
    variables = _np(jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lang)))
    port = obs_core.CrossAttentionConditioner(512, 768)
    _load(port, variables)
    want = jax_mod.apply(variables, jnp.asarray(x), jnp.asarray(lang))
    got = port(_nchw(x), torch.from_numpy(lang))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               **OUT_TOL)


def test_shallow_conv_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.random((2, 24, 20, 3), dtype=np.float32)
    port = obs_core.ShallowConv(3)
    got = _hold_trunk(jax_core.ShallowConv(), port, x, False, rng)
    assert got.shape == (2, 256, 2, 2)


@pytest.mark.parametrize("shape", [(50,), (37, 2)])
def test_conv1d_base_and_scan_core_match_jax(shape):
    """flax's SAME padding (uneven at L = 37 and 50) and its [B, L', C']
    flattening; ScanCore's projection on top."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3,) + shape, dtype=np.float32)
    for jax_mod, port in ((jax_core.Conv1dBase(), obs_core.Conv1dBase(
            shape[1] if len(shape) > 1 else 1)),
            (jax_core.ScanCore(feature_dimension=24), obs_core.ScanCore(shape, 24))):
        variables = _np(jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        _load(port, variables)
        want = jax_mod.apply(variables, jnp.asarray(x))
        got = port(torch.from_numpy(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("depth", [34, 50])
def test_deep_resnet_trees_load_strictly(depth):
    """ResNet-34 and -50: flax's parameter and statistics trees (shapes from
    ``jax.eval_shape``) map onto the port's modules under a strict load."""
    jax_mod = {34: jax_core.ResNet34Conv, 50: jax_core.ResNet50Conv}[depth]()
    shapes = jax.eval_shape(jax_mod.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = {34: obs_core.ResNet34Conv, 50: obs_core.ResNet50Conv}[depth](3)
    _load(port, zeros)
    assert port.out_channels == (2048 if depth == 50 else 512)


def _visual_variables(jax_mod, x, lang, rng):
    variables = jax_mod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                             jnp.asarray(x), lang_emb=jnp.asarray(lang))
    return _perturbed(variables, rng)


@pytest.mark.parametrize("train,film,crop,num_crops", [
    (False, True, 24, 1), (True, True, 28, 1), (True, False, 28, 2)])
def test_visual_core_matches_jax(train, film, crop, num_crops):
    """ResNet-18 (FiLM on ``lang_emb`` or not) + SpatialSoftmax + proj.
    Eval (fp32): the center crop of 24 x 24 from 28 x 28. Train: the crop
    at its identity setting (the full frame: every offset 0), with 2 crops
    folded into the batch and averaged out where FiLM is off, so the
    randomness of either package plays no part; in fp64 as the 1x1 layer4
    of ``test_resnet18_matches_jax``, to rtol 1e-6 / atol 1e-7 (the JAX
    package's ``proj`` Dense rounds to fp32 even under float64) and the
    statistics to rtol 1e-8."""
    rng = np.random.default_rng(8)
    x = rng.random((2, 28, 28, 3), dtype=np.float32)
    lang = rng.integers(-1, 2, (2, 768)).astype(np.float32)
    kw = dict(feature_dimension=20, num_kp=6, crop_height=crop, crop_width=crop,
              num_crops=num_crops, film=film)
    jax_mod = jax_core.VisualCore(**kw)
    variables = _visual_variables(jax_mod, x, lang, rng)
    port = obs_core.VisualCore((28, 28, 3), lang_dim=768, **kw)
    _load(port, variables)
    out_tol, stats_tol = OUT_TOL, STATS_TOL
    if train:
        x, lang = x.astype(np.float64), lang.astype(np.float64)
        variables = jax.tree.map(lambda a: a.astype(np.float64), variables)
        port.double()
        out_tol, stats_tol = {"rtol": 1e-6, "atol": 1e-7}, {"rtol": 1e-8, "atol": 1e-9}
    with jax.enable_x64(train):
        if train:
            want, updates = jax_mod.apply(variables, jnp.asarray(x), train=True,
                                          lang_emb=jnp.asarray(lang), mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(2)})
            updates = _np(updates)
        else:
            want = jax_mod.apply(variables, jnp.asarray(x), lang_emb=jnp.asarray(lang))
        want = np.asarray(want)
    with torch.no_grad():
        got = port(torch.from_numpy(x), train, torch.Generator().manual_seed(0),
                   lang_emb=torch.from_numpy(lang))
    assert got.shape == (2, 20)
    np.testing.assert_allclose(got.numpy(), want, **out_tol)
    if train:
        _check_stats(port, updates, stats_tol)


def test_film_with_several_crops_fails_in_both_packages():
    """A reference fault, mirrored: FiLM's condition keeps the batch of
    images while the crops are folded into it, so FiLM with num_crops > 1
    cannot broadcast, in the JAX package as in the port."""
    x = np.random.default_rng(11).random((2, 40, 40, 3), dtype=np.float32)
    lang = np.zeros((2, 768), np.float32)
    kw = dict(feature_dimension=8, num_kp=4, crop_height=36, crop_width=36, num_crops=2,
              film=True)
    jax_mod = jax_core.VisualCore(**kw)
    variables = jax_mod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                             lang_emb=jnp.asarray(lang))
    with pytest.raises(TypeError, match="broadcast"):
        jax_mod.apply(variables, jnp.asarray(x), train=True, lang_emb=jnp.asarray(lang),
                      mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
    port = seeded_init(obs_core.VisualCore((40, 40, 3), lang_dim=768, **kw),
                       torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="size of tensor"):
        port(torch.from_numpy(x), True, torch.Generator().manual_seed(0),
             lang_emb=torch.from_numpy(lang))


def test_visual_core_cross_attention_matches_jax():
    """The cross-attention backbone with mean pooling, eval."""
    rng = np.random.default_rng(9)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    lang = rng.standard_normal((2, 768), dtype=np.float32)
    kw = dict(feature_dimension=16, backbone="ResNet18ConvCrossAttention",
              pool="SpatialMeanPool")
    jax_mod = jax_core.VisualCore(**kw)
    variables = _visual_variables(jax_mod, x, lang, rng)
    port = obs_core.VisualCore((32, 32, 3), lang_dim=768, **kw)
    assert port.xattn is not None and not port.backbone.film
    _load(port, variables)
    want = jax_mod.apply(variables, jnp.asarray(x), lang_emb=jnp.asarray(lang))
    got = port(torch.from_numpy(x), lang_emb=torch.from_numpy(lang))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OUT_TOL)


def test_crop_randomizer_eval_train_and_folding():
    x = torch.arange(2 * 32 * 32 * 3, dtype=torch.float32).reshape(2, 32, 32, 3)
    crop = obs_core.CropRandomizer(24, 20, num_crops=3)
    # eval: the center crop, bit-equal to slicing (JAX's rule)
    out = crop.forward_in(x, train=False)
    assert torch.equal(out, x[:, 4:28, 6:26])
    want = jax_core.CropRandomizer(24, 20, 3).forward_in(jnp.asarray(x.numpy()), train=False)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # train: 3 crops per image, image-major, each a window at an in-range offset
    out = crop.forward_in(x, train=True, generator=torch.Generator().manual_seed(0))
    assert out.shape == (6, 24, 20, 3)
    offsets = set()
    for i in range(6):
        img = x[i // 3]
        y0 = int(out[i, 0, 0, 0] - img[0, 0, 0]) // (32 * 3)
        x0 = int(out[i, 0, 0, 0] - img[0, 0, 0]) % (32 * 3) // 3
        assert 0 <= y0 <= 8 and 0 <= x0 <= 12
        assert torch.equal(out[i], img[y0:y0 + 24, x0:x0 + 20])
        offsets.add((y0, x0))
    assert len(offsets) > 1
    feats = torch.arange(6 * 5, dtype=torch.float32).reshape(6, 5)
    pooled = crop.forward_out(feats, train=True)
    torch.testing.assert_close(pooled, feats.reshape(2, 3, 5).mean(1))
    assert crop.forward_out(feats, train=False) is feats
    with pytest.raises(ValueError, match="Generator"):
        crop.forward_in(x, train=True)


def test_color_and_noise_randomizers():
    """The identity at eval; at zero magnitude (train) the JAX package's
    arithmetic on the same frame: brightness, contrast and saturation each
    1, noise 0."""
    rng = np.random.default_rng(10)
    x = rng.random((2, 6, 5, 3), dtype=np.float32)
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    color, noise = obs_core.ColorRandomizer(), obs_core.GaussianNoiseRandomizer()
    assert color(xt, train=False) is xt and noise(xt, train=False) is xt
    still = obs_core.ColorRandomizer(0.0, 0.0, 0.0)(xt, True, gen)
    want = jax_core.ColorRandomizer(0.0, 0.0, 0.0)(jnp.asarray(x), True, jax.random.PRNGKey(0))
    np.testing.assert_allclose(still.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(still.numpy(), x, rtol=0, atol=1e-6)
    assert torch.equal(obs_core.GaussianNoiseRandomizer(0.0, 0.0)(xt, True, gen), xt)
    jittered = color(xt, True, gen)
    assert jittered.shape == xt.shape and not torch.equal(jittered, xt)
    assert 0.0 <= float(jittered.min()) and float(jittered.max()) <= 1.0
    noisy = noise(xt, True, gen)
    assert not torch.equal(noisy, xt) and float(noisy.min()) >= 0.0


def test_visual_core_randomizers_draw_from_the_generator():
    """Train-mode randomness comes from the generator passed in: the same
    seed gives the same features, another seed other ones."""
    core = seeded_init(obs_core.VisualCore((72, 72, 3), feature_dimension=8, num_kp=4,
                                           crop_height=64, crop_width=64,
                                           color_jitter=True, gaussian_noise=True),
                       torch.Generator().manual_seed(0))
    x = torch.rand(2, 72, 72, 3, generator=torch.Generator().manual_seed(1))

    def run(seed):
        with torch.no_grad():
            return core(x, True, torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    with torch.no_grad():
        assert torch.equal(core(x), core(x))


def test_build_core_parses_spec_strings():
    core = obs_core.build_core(
        "VisualCoreLanguageConditioned:feature_dimension=48,num_kp=16,"
        "backbone=ResNet18ConvFiLM,crop_height=20,crop_width=20,num_crops=2",
        (24, 24, 3), lang_dim=768)
    assert core.backbone.film and core.proj.weight.shape == (48, 32)
    assert (core.crop.crop_height, core.crop.num_crops) == (20, 2)
    plain = obs_core.build_core("VisualCore:backbone=ShallowConv,num_kp=8", (24, 24, 3))
    assert isinstance(plain.backbone, obs_core.ShallowConv) and plain.crop is None
    scan = obs_core.build_core("ScanCore:feature_dimension=12,num_kp=3,crop_height=4",
                               (40,))
    assert isinstance(scan, obs_core.ScanCore) and scan.proj.weight.shape[0] == 12
    with pytest.raises(KeyError):
        obs_core.build_core("NoSuchCore", (4,))


def test_pretrained_repr_conv():
    """Random init only: a checkpoint path raises, naming its ROADMAP item;
    frozen, the trunk passes no gradient and keeps its statistics."""
    with pytest.raises(NotImplementedError, match="item 14"):
        obs_core.R3MConv(ckpt_path="weights.msgpack")
    core = seeded_init(obs_core.MVPConv(), torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, 32, 32, requires_grad=True)
    out = core(x, train=True)
    assert out.shape == (2, 512, 1, 1) and not out.requires_grad
    assert torch.equal(core.backbone.stem_bn.mean, torch.zeros(64))


def test_uint8_frames_process_bit_equal_to_jax():
    """Every uint8 value: the host ``process_obs`` equals JAX's bit for bit,
    and so does the division on the device the algo does
    (``frames_to_float``) after a uint8 copy."""
    frames = np.arange(256, dtype=np.uint8).reshape(4, 4, 4, 4).repeat(3, -1)
    jax_obs_utils.register_obs_keys({"cam": "rgb"})
    obs_utils.register_obs_keys({"cam": "rgb"})
    want = jax_obs_utils.process_obs(frames, obs_key="cam")
    host = obs_utils.process_obs(frames, obs_key="cam")
    kept = obs_utils.process_obs_for_device(frames, obs_key="cam")
    device = frames_to_float(torch.from_numpy(kept)).numpy()
    assert want.dtype == host.dtype == device.dtype == np.float32 and kept.dtype == np.uint8
    np.testing.assert_array_equal(host.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(device.view(np.int32), want.view(np.int32))
    low = np.arange(6, dtype=np.float64)
    assert obs_utils.process_obs_for_device(low, obs_key="other").dtype == np.float32
