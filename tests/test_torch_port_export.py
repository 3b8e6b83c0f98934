"""Policy export in the port (``scripts/export_policy.py``) and the lookup
kernels as registered ops (``ops/vq_lookup.py``).

The exported program of a trained ICL checkpoint must hold the registered
K1 op as one node, reload with nothing but torch and the op registration,
and give ``get_action``'s actions bit for bit on the CPU when its draws come
from the same sample-generator state. The ops' fake implementations give
the plain versions' shapes and dtypes, and their FLOP formulas count
2 B N D (K2: + B D)."""

import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from lipvq_tpu_torch.ops import vq_lookup
from lipvq_tpu_torch.scripts import export_policy as EP
from lipvq_tpu_torch.utils import file_utils
from test_torch_port_checkpoint import (
    AC_DIM,
    OBS_SHAPES,
    SHAPE_META,
    T,
    _algo,
    _batches,
    _spread_codebook,
)

torch.set_num_threads(1)


def _checkpoint(tmp_path, compute_dtype: str) -> str:
    algo = _algo(ema=False, compute_dtype=compute_dtype, warmup=False)
    _spread_codebook(algo, np.random.default_rng(1))
    algo.train_on_batch(_batches(algo, 1)[0], 0)
    path = str(tmp_path / "model.ckpt")
    file_utils.save_checkpoint(path, algo, algo.global_config,
                               env_meta={"env_name": "SyntheticKitchen", "type": 1,
                                         "env_kwargs": {}},
                               shape_meta=SHAPE_META, obs_normalization_stats=None,
                               action_normalization_stats=None, lang_backend="hash")
    return path


def _inputs(batch: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    obs, ctx = ({k: rng.standard_normal((batch, T, *s), dtype=np.float32)
                 for k, s in OBS_SHAPES.items()} for _ in range(2))
    return obs, {"obs": ctx, "actions": rng.uniform(-1, 1, (batch, T, AC_DIM))
                 .astype(np.float32)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_reloaded_program_equals_get_action(tmp_path, compute_dtype, batch):
    ckpt = _checkpoint(tmp_path, compute_dtype)
    out = str(tmp_path / "policy.pt2")
    EP.main(["--ckpt", ckpt, "--output", out, "--batch", str(batch), "--device", "cpu"])
    program = torch.export.load(out)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(EP.LOOKUP_OP) == 1

    model, _ = file_utils.policy_from_checkpoint(ckpt, device="cpu")
    obs, ctx = _inputs(batch)
    state = model._generator.get_state()
    want = model.get_action(obs, ctx)
    after = model._generator.get_state()
    model._generator.set_state(state)
    got = EP.load_and_run(out, model, *(
        model._put_infer(x) for x in (obs, ctx["obs"], ctx["actions"])))
    assert torch.equal(model._generator.get_state(), after)
    np.testing.assert_array_equal(got.numpy(), want)
    # the zero inputs of the JAX round trip
    assert EP.load_and_run(out, model).shape == (batch, AC_DIM)


def test_reload_needs_only_torch_and_the_op_registration(tmp_path):
    """A fresh process that imports the op registration and nothing else
    of the port runs the program; the lookup runs through the registered
    op (its CPU implementation)."""
    ckpt = _checkpoint(tmp_path, "float32")
    out = str(tmp_path / "policy.pt2")
    EP.export_policy(ckpt, out, batch=2, device="cpu")
    model, _ = file_utils.policy_from_checkpoint(ckpt, device="cpu")
    obs, ctx = _inputs(2)
    args = [model._put_infer(x) for x in (obs, ctx["obs"], ctx["actions"])]
    *_, u_like, eps_like = EP.user_inputs(torch.export.load(out))
    args += list(EP.draw_like(model, u_like, eps_like))
    torch.save(args, str(tmp_path / "args.pt"))
    with torch.no_grad():
        want = torch.export.load(out).module()(*args)
    script = (
        "import sys, torch\n"
        "import lipvq_tpu_torch.ops.vq_lookup\n"
        "torch.set_num_threads(1)\n"
        f"args = torch.load({str(tmp_path / 'args.pt')!r}, weights_only=True)\n"
        f"with torch.no_grad():\n"
        f"    out = torch.export.load({out!r}).module()(*args)\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "loaded = [m for m in sys.modules if m.startswith('lipvq_tpu_torch.')]\n"
        "assert not any(m.startswith(('lipvq_tpu_torch.algo', 'lipvq_tpu_torch.models'))\n"
        "               for m in loaded), loaded\n")
    subprocess.run([sys.executable, "-c", script], check=True, timeout=300)
    assert torch.equal(torch.load(str(tmp_path / "out.pt"), weights_only=True), want)


@pytest.mark.parametrize("name", ["vq_nearest", "vq_nearest_fast", "vq_nearest_with_stats"])
def test_registered_ops_fake_shapes_and_flops(name):
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((37, 9), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((21, 9), dtype=np.float32))
    op = getattr(torch.ops.lipvq_tpu_torch, name)
    plain = {"vq_nearest": vq_lookup.vq_nearest_reference,
             "vq_nearest_fast": vq_lookup.vq_nearest_fast_reference,
             "vq_nearest_with_stats": vq_lookup.vq_nearest_with_stats_reference}[name]
    with FlopCounterMode(display=False) as counter:
        got = op(z, c)
    want = plain(z, c)
    got, want = ((got,), (want,)) if name != "vq_nearest_with_stats" else (got, want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert counter.get_total_flops() == 2 * 37 * 21 * 9 + (37 * 9 if "stats" in name else 0)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = op(mode.from_tensor(z), mode.from_tensor(c))
    fake = (fake,) if name != "vq_nearest_with_stats" else fake
    assert [(f.shape, f.dtype) for f in fake] == [(w.shape, w.dtype) for w in want]
    torch.library.opcheck(op, (z, c))
