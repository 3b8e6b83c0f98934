"""The library names the port had left out, each against its JAX twin on the
CPU: ``CoordConv2d`` and ``FeatureAggregator`` (``models/base_nets.py``) on
weights carried by ``utils/jax_weights.py``, ``TanhWrapped`` with
``tanh_log_prob`` and ``tanh_sample`` (``models/distributions.py``, JAX's
draws replayed), and the nested-container helpers of
``utils/tensor_utils.py`` on the same numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.models import base_nets as jax_base_nets
from lipvq_tpu.models import distributions as jax_dist
from lipvq_tpu.utils import tensor_utils as jax_tu

from lipvq_tpu_torch.models import base_nets, distributions
from lipvq_tpu_torch.utils import tensor_utils as tu
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape,features,kernel,stride", [
    ((2, 9, 7, 3), 8, (3, 3), 1),
    ((1, 16, 16, 4), 5, (5, 5), 2),
    ((3, 6, 10, 1), 4, (1, 3), 1),
])
def test_coord_conv2d_on_carried_weights(shape, features, kernel, stride):
    """JAX's NHWC module against the port's channels-first one, the coordinate
    channels appended after the input's in both."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jmod = jax_base_nets.CoordConv2d(features=features, kernel_size=kernel,
                                     strides=(stride, stride))
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.1, params)  # a non-zero bias
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    mod = base_nets.CoordConv2d(shape[-1], features, kernel, stride=stride)
    mod.load_state_dict(state_dict_from_jax_params(_np_tree(params), mod), strict=True)
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("dim", [0, 1, 2, -1])
def test_feature_aggregator(dim):
    x = np.random.default_rng(dim + 5).standard_normal((3, 4, 5)).astype(np.float32)
    jmod = jax_base_nets.FeatureAggregator(dim=dim)
    want = np.asarray(jmod.apply({}, jnp.asarray(x)))
    got = base_nets.FeatureAggregator(dim=dim)(torch.from_numpy(x)).numpy()
    assert not list(base_nets.FeatureAggregator(dim=dim).parameters())
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _gmm(seed: int, lead=(6,), modes=5, dim=4):
    rng = np.random.default_rng(seed)
    means = np.tanh(rng.standard_normal((*lead, modes, dim))).astype(np.float32)
    scales = (0.05 + rng.random((*lead, modes, dim))).astype(np.float32)
    logits = rng.standard_normal((*lead, modes)).astype(np.float32)
    return means, scales, logits


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_tanh_log_prob(scale):
    means, scales, logits = _gmm(3)
    value = (np.random.default_rng(4).uniform(-0.99, 0.99, (6, 4)) * scale).astype(np.float32)
    value[0, 0] = scale  # clipped to 1 - eps in both
    jd = jax_dist.TanhWrapped(jax_dist.GMMParams(*map(jnp.asarray, (means, scales, logits))),
                              scale)
    want = np.asarray(jax_dist.tanh_log_prob(jd, jnp.asarray(value)))
    d = distributions.TanhWrapped(distributions.GMMParams(
        *map(torch.from_numpy, (means, scales, logits))), scale)
    got = distributions.tanh_log_prob(d, torch.from_numpy(value)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tanh_sample_with_replayed_draws(seed):
    """JAX's ``gmm_sample`` draws (split key: Gumbel uniforms for the mode,
    normals for the component) given to the port as ``draws``: the same
    samples; the port's own generator gives samples inside (-scale, scale)."""
    means, scales, logits = _gmm(seed, lead=(3, 2))
    key = jax.random.PRNGKey(seed)
    jd = jax_dist.TanhWrapped(jax_dist.GMMParams(*map(jnp.asarray, (means, scales, logits))),
                              1.5)
    want = np.asarray(jax_dist.tanh_sample(jd, key))
    k_mode, k_normal = jax.random.split(key)
    u = jax.random.uniform(k_mode, logits.shape, jnp.float32,
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    eps = jax.random.normal(k_normal, means.shape[:-2] + means.shape[-1:], jnp.float32)
    d = distributions.TanhWrapped(distributions.GMMParams(
        *map(torch.from_numpy, (means, scales, logits))), 1.5)
    got = distributions.tanh_sample(d, None, draws=(torch.from_numpy(np.array(u)),
                                                    torch.from_numpy(np.array(eps))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    own = distributions.tanh_sample(d, torch.Generator().manual_seed(seed))
    assert own.shape == want.shape and bool((own.abs() < 1.5).all())


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"obs": {"a": rng.standard_normal((2, 3, 4)).astype(np.float32),
                    "b": rng.standard_normal((2, 3, 5, 6)).astype(np.float32)},
            "actions": [rng.standard_normal((2, 3, 7)).astype(np.float32)],
            "ids": (rng.integers(0, 9, (2, 3)).astype(np.int32),),
            "none": None}


# (name, JAX call, port call) on the same tree
TENSOR_CASES = [
    ("map_tensor", lambda m, x: m.map_tensor(x, lambda a: a * 2)),
    ("to_float32", lambda m, x: m.to_float32(m.map_tensor(
        x, lambda a: (a.half() if a.is_floating_point() else a) if isinstance(a, torch.Tensor)
        else a.astype(
            jnp.float16 if jnp.issubdtype(a.dtype, jnp.floating) else a.dtype)))),
    ("to_numpy", lambda m, x: m.to_numpy(x)),
    ("detach", lambda m, x: m.detach(x)),
    ("index_at_time", lambda m, x: m.index_at_time(x, 1)),
    ("slice_time", lambda m, x: m.slice_time(x, 1, 3)),
    ("join_dimensions", lambda m, x: m.join_dimensions(x, 0, 1)),
    ("reshape_dimensions", lambda m, x: m.reshape_dimensions(
        m.join_dimensions(x, 0, 1), 0, 0, (3, 2))),
    ("unsqueeze_expand_at", lambda m, x: m.unsqueeze_expand_at(x, 4, 1)),
    ("unsqueeze_expand_at_last", lambda m, x: m.unsqueeze_expand_at(x, 3, -1)),
    ("flatten_leading", lambda m, x: m.flatten_leading(x)),
    ("unflatten_leading", lambda m, x: m.unflatten_leading(m.flatten_leading(x), 2, 3)),
]


@pytest.mark.parametrize("name,call", TENSOR_CASES, ids=[c[0] for c in TENSOR_CASES])
def test_tensor_utils(name, call):
    x = _tree(0)
    want = call(jax_tu, jax.tree.map(jnp.asarray, x))
    got = call(tu, tu.map_tensor(x, torch.from_numpy))
    if name == "to_numpy":
        assert all(isinstance(a, np.ndarray) for a in jax.tree.leaves(got))
    want_leaves, want_def = jax.tree.flatten(want)
    got_leaves, got_def = jax.tree.flatten(
        tu.map_tensor(got, lambda a: a.numpy() if isinstance(a, torch.Tensor) else a))
    assert got_def == want_def and got["none"] is None
    for w, g in zip(want_leaves, got_leaves):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape, g.dtype)
        np.testing.assert_array_equal(g, w)


def test_assert_size_at_dim():
    x = _tree(1)
    del x["ids"]
    for m, tree in ((jax_tu, jax.tree.map(jnp.asarray, x)),
                    (tu, tu.map_tensor(x, torch.from_numpy))):
        m.assert_size_at_dim(tree, 3, 1)
        with pytest.raises(ValueError, match="window"):
            m.assert_size_at_dim(tree, 4, 1, msg="window")
