"""Port parity of the image ICL policy of ``test_torch_port_visual_algo.py``
with the EMA codebook: one and three fp32 train steps against the JAX
algo (metrics, every parameter, the BatchNorm statistics and the EMA
buffers, at that file's tolerances), then the weight bridge's strictness
about the image algo's trees and a checkpoint round trip."""

import jax
import numpy as np
import pytest
import torch
from test_torch_port_visual_algo import (
    BATCH,
    CAM,
    LOSS_RTOL,
    hold_state,
    image_items,
    image_pair,
    jax_state_dict,
)

from lipvq_tpu_torch.utils.jax_weights import load_jax_params
from lipvq_tpu_torch.utils.tensor_utils import stack_collate

torch.set_num_threads(1)

CORE = "net.encoder.group_encoder.enc_obs.core_" + CAM


@pytest.fixture(scope="module")
def ema_trained():
    jax_algo, port = image_pair(ema=True)
    start = {k: v.clone() for k, v in port.nets.state_dict().items()}
    rng = np.random.default_rng(11)
    snaps = {}
    for step in (1, 2, 3):
        raw = stack_collate(image_items(rng, BATCH))
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)
        got = port.train_on_batch(port.process_batch_for_training(raw), 0)
        if step in (1, 3):
            snaps[step] = ({k: float(v) for k, v in want["losses"].items()},
                           {k: float(v) for k, v in got["losses"].items()},
                           jax_state_dict(jax_algo, port),
                           {k: v.clone() for k, v in port.nets.state_dict().items()})
    return jax_algo, port, start, snaps


@pytest.mark.parametrize("step", [1, 3])
def test_ema_train_steps_match_jax(ema_trained, step):
    _, _, start, snaps = ema_trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, err_msg=k)
    hold_state(got_sd, want_sd)
    moved = {k for k in want_sd if not torch.equal(got_sd[k], start[k])}
    assert "net.encoder.action_network.quantizer.codebook" in moved
    assert (got_sd["net.encoder.action_network.ema_cluster_size"] > 0).sum() >= 2
    assert f"{CORE}.backbone.stem_bn.mean" in moved


def test_bridge_maps_every_leaf_and_is_strict(ema_trained):
    """Every flax leaf of the image algo (params, batch_stats, vq_stats) has
    its place in the port; a missing or an extra BatchNorm statistic, and a
    collection the port does not know, raise."""
    jax_algo, port, _, _ = ema_trained
    params = jax.tree.map(np.asarray, jax_algo.state.params)
    extra = jax.tree.map(np.asarray, jax_algo.state.extra_vars)
    assert set(extra) == {"batch_stats", "vq_stats"}
    assert len(jax_state_dict(jax_algo, port)) == len(port.nets.state_dict())
    load_jax_params(port, params, extra)

    def stats_of(extra, edit):
        tree = jax.tree.map(lambda a: a, extra)  # a copy of the containers
        bn = tree["batch_stats"]["net"]["encoder"]["group_encoder"]["enc_obs"][
            "core_" + CAM]["backbone"]["stem_bn"]
        edit(bn)
        return tree

    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(port, params, stats_of(extra, lambda bn: bn.pop("var")))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_params(port, params, stats_of(extra, lambda bn: bn.update(
            extra=np.zeros(64, np.float32))))
    with pytest.raises(KeyError, match="no counterpart"):
        load_jax_params(port, params, {**extra, "cache": {}})


def test_checkpoint_round_trip_keeps_batchnorm_state(ema_trained):
    """serialize / deserialize into a fresh algo: every parameter and buffer
    bit-equal, the BatchNorm statistics among them, and the same eval
    forward."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory
    from test_torch_port_visual_algo import AC_DIM, OBS_SHAPES, image_config

    _, port, _, _ = ema_trained
    fresh = algo_factory("icl", image_config(config_factory, True), OBS_SHAPES, ac_dim=AC_DIM,
                         device="cpu")
    fresh.deserialize(port.serialize())
    for (k, a), b in zip(port.nets.state_dict().items(), fresh.nets.state_dict().values()):
        assert torch.equal(a, b), k
    assert not torch.equal(fresh.nets.get_buffer(f"{CORE}.backbone.layer1_0.bn1.var"),
                           torch.ones(64))
    raw = stack_collate(image_items(np.random.default_rng(5), BATCH))
    obs = port.process_batch_for_training(raw)["obs"]
    with torch.inference_mode():
        a = port.nets.forward_train(*(port._put_infer(x) for x in (
            obs, obs, raw["actions"][:, :10])))[0]
        b = fresh.nets.forward_train(*(fresh._put_infer(x) for x in (
            obs, obs, raw["actions"][:, :10])))[0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
