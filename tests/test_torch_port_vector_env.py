"""The subprocess vector env and inference placement of the port
(``envs/vector_env.py::SubprocVectorEnv``, ``algo/base.py::Algo.
set_inference_device``) against the in-process ``VectorEnv`` and the JAX
package's ``SubprocVectorEnv``: the same seeded synthetic envs stepped in
lock-step with the same actions give bit-equal observations, rewards, dones
and success flags."""

import functools

import numpy as np
import pytest
import torch

from lipvq_tpu.envs.env_synthetic import SyntheticKitchenEnv as JaxEnv
from lipvq_tpu.envs.vector_env import SubprocVectorEnv as JaxSubproc
from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
from lipvq_tpu_torch.envs.vector_env import SubprocVectorEnv, VectorEnv
from test_torch_port_checkpoint import AC_DIM, T, _algo, _batches, _spread_codebook
from test_torch_port_export import _inputs

torch.set_num_threads(1)

N_ENVS, STEPS = 3, 12


def _assert_equal_trees(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("frame_stack", [None, 3])
def test_subproc_vector_env_in_lockstep_with_vector_env_and_jax(frame_stack):
    fns = [functools.partial(SyntheticKitchenEnv, seed=s, horizon=8) for s in range(N_ENVS)]
    jax_fns = [functools.partial(JaxEnv, seed=s, horizon=8) for s in range(N_ENVS)]
    envs = [SubprocVectorEnv(fns, frame_stack=frame_stack),
            VectorEnv(fns, frame_stack=frame_stack),
            JaxSubproc(jax_fns, frame_stack=frame_stack)]
    try:
        first = [e.reset() for e in envs]
        for other in first[1:]:
            _assert_equal_trees(first[0], other)
        assert envs[0].ep_lang_strs == envs[1].ep_lang_strs == envs[2].ep_lang_strs
        actions = np.random.default_rng(0).uniform(-1, 1, (STEPS, N_ENVS, AC_DIM))
        for a in actions.astype(np.float32):
            out = [e.step(a) for e in envs]
            for other in out[1:]:
                _assert_equal_trees(out[0][0], other[0])
                np.testing.assert_array_equal(out[0][1], other[1])
                np.testing.assert_array_equal(out[0][2], other[2])
                assert list(out[0][3]) == list(other[3])
            assert envs[0].is_success() == envs[1].is_success() == envs[2].is_success()
    finally:
        envs[0].close()
        envs[2].close()
    assert not any(p.is_alive() for p in envs[0].procs)


def test_set_inference_device_serves_the_same_actions():
    """Serving after ``set_inference_device`` (to the device the algo is
    on: the CPU here; the card-to-CPU move runs in the CUDA tests) gives
    ``get_action``'s actions at the same generator state, and the
    optimizer and generators follow."""
    algo = _algo(ema=False, warmup=False)
    _spread_codebook(algo, np.random.default_rng(1))
    for b in _batches(algo, 2):
        algo.train_on_batch(b, 0)
    obs, ctx = _inputs(4)
    state = algo._generator.get_state()
    want = algo.get_action(obs, ctx)
    algo._generator.set_state(state)
    algo.set_inference_device("cpu")
    assert algo.device == torch.device("cpu")
    np.testing.assert_array_equal(algo.get_action(obs, ctx), want)
    assert want.shape == (4, AC_DIM) and T == algo.context_length


@pytest.mark.parametrize("name", ["hbc", "iris"])
def test_set_inference_device_reaches_the_sub_algos(name):
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory
    from test_torch_port_hbc import OBS_SHAPES, VARIANTS, hier_config
    from test_torch_port_hbc import AC_DIM as HBC_AC_DIM

    algo_name, over = VARIANTS[name]
    algo = algo_factory(algo_name, hier_config(config_factory, algo_name, over), OBS_SHAPES,
                        ac_dim=HBC_AC_DIM, device="cpu")
    algo.set_inference_device("cpu")
    subs = algo.sub_algos()
    assert len(subs) == (3 if name == "iris" else 2)
    assert all(sub.device == torch.device("cpu") for sub in subs)
