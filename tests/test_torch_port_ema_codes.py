"""One EMA-codebook train step of the port's ``LipVQVAE`` against the JAX
module at 65536 codes, more than one shared histogram of K2's row sort
holds (49152 codes, so on the card the sort runs over two code ranges), on
the CPU with bridged weights. JAX's EMA path takes ``vq_nearest`` plus the
one-hot ``vq_cluster_stats`` with no bound on N; the port's takes
``vq_nearest_with_stats``, whose CPU path is K2's plain version.

The step: the training forward (which updates ``ema_cluster_size`` and
``ema_embed_sum``), the gradient of its loss, one SGD update of every
parameter, then the EMA codebook written into the codebook, in the order of
the JAX train step. Tolerances are those of ``test_torch_port_train.py``:
the two packages run the same fp32 arithmetic in other orders, so the loss
agrees to rtol 1e-5 and buffers and parameters to atol 2e-5 + rtol 1e-5.

The Lipschitz bound is raised to 30 and the codebook set to the latents of
random actions, with each batch row's latent moved by N(0, 1e-3) in a
random slot: every row's nearest code then lies far closer than any other,
so the ids are exact in both packages and spread over both code ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu.models.tokenizers.lipvq import apply_ema_codebook as jax_apply_ema
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_with_stats_cuda
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

A, LATENT, CODES, B = 12, 8, 65536, 64
HIST_CODES = 49152  # the codes one shared histogram of K2's sort holds
LR = 0.5
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5


def _setup():
    """(JAX model, params, vq_stats, the port's model, the batch, the slots
    of the batch's codes), with the same weights."""
    rng = np.random.default_rng(0)
    model = JaxLipVQVAE(feature_dim=A, latent_dim=LATENT, num_codes=CODES, ema_codebook=True)
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3), jnp.zeros((8, A))))
    params, stats = variables["params"], variables["vq_stats"]
    params["to_latent"]["ci"] = np.full_like(params["to_latent"]["ci"], 30.0)
    x = rng.uniform(-1, 1, (B, A)).astype(np.float32)
    actions = rng.uniform(-1, 1, (CODES, A)).astype(np.float32)
    variables = {"params": params, "vq_stats": stats}
    codebook = np.array(model.apply(variables, jnp.asarray(actions), method=JaxLipVQVAE.encode))
    latents = np.asarray(model.apply(variables, jnp.asarray(x), method=JaxLipVQVAE.encode))
    slots = rng.permutation(CODES)[:B]
    codebook[slots] = latents + rng.normal(0.0, 1e-3, latents.shape).astype(np.float32)
    params["quantizer"]["codebook"] = codebook
    port = LipVQVAE(A, LATENT, num_codes=CODES, ema_codebook=True)
    state = state_dict_from_jax_params(params)
    state.update(state_dict_from_jax_params(stats))
    port.load_state_dict(state, strict=True)
    return model, params, stats, port, x, slots


def _jax_step(model, params, stats, x):
    def loss_fn(p):
        (_, loss, ids), new_vars = model.apply({"params": p, "vq_stats": stats},
                                               jnp.asarray(x), mutable=["vq_stats"])
        return loss, (ids, new_vars["vq_stats"])

    (loss, (ids, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    new_params = jax.tree.map(lambda p, g: p - LR * g, params, grads)
    new_params["quantizer"]["codebook"] = jax_apply_ema(
        new_params["quantizer"]["codebook"], new_stats["ema_cluster_size"],
        new_stats["ema_embed_sum"])
    return float(loss), np.asarray(ids), new_params, new_stats


def test_ema_step_beyond_one_histogram_range_matches_jax():
    model, params, stats, port, x, slots = _setup()
    loss_want, ids_want, params_want, stats_want = _jax_step(model, params, stats, x)

    before = vq_nearest_with_stats_cuda.launches
    _, loss, ids = port(torch.from_numpy(x), train=True)
    loss_value = float(loss.detach())
    port.zero_grad()
    loss.backward()
    with torch.no_grad():
        for p in port.parameters():
            p -= LR * p.grad
    port.apply_ema_codebook()
    assert vq_nearest_with_stats_cuda.launches == before  # the CPU path: the plain version

    np.testing.assert_allclose(loss_value, loss_want, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(ids.numpy(), ids_want)
    np.testing.assert_array_equal(np.sort(ids.numpy()), np.sort(slots))
    assert int((ids >= HIST_CODES).sum()) > 0 and int((ids < HIST_CODES).sum()) > 0

    want = state_dict_from_jax_params(jax.tree.map(np.asarray, params_want))
    want.update(state_dict_from_jax_params(jax.tree.map(np.asarray, stats_want)))
    got = port.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)
    # the EMA moved exactly the assigned codes: the counts are one per row
    cluster = got["ema_cluster_size"]
    np.testing.assert_allclose(float(cluster.sum()), 0.01 * B, rtol=1e-5)
    assert int((cluster > 0).sum()) == B
    codebook = got["quantizer.codebook"]
    before = torch.from_numpy(params["quantizer"]["codebook"])
    assert not torch.equal(codebook[slots], before[slots])
