"""Reference-checkpoint import in the port (``lipvq_tpu_torch/utils/
torch_import.py``, ``scripts/import_torch_ckpt.py``) against the JAX
package's.

Each seeded reference-layout state_dict goes two ways: the JAX package's
import followed by the port's weight bridge (``utils/jax_weights.py``), and
the port's own import. The two must give the same keys and bit-equal tensors,
and the module loaded either way bit-equal forwards on the CPU. The
reference-layout torch builders are those of ``tests/test_torch_import.py``.
"""

import numpy as np
import pytest
import torch

from lipvq_tpu.scripts import import_torch_ckpt as jax_ckpt
from lipvq_tpu.utils import torch_import as jax_ti
from lipvq_tpu_torch.models import obs_core
from lipvq_tpu_torch.models.obs_core import ResNet18Conv
from lipvq_tpu_torch.models.tokenizers.bin_action import AdaptiveBinActionEmbedding
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.models.tokenizers.vqvae import LFQVAE, VQVAE
from lipvq_tpu_torch.models.transformer import GPTBackbone
from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_reference
from lipvq_tpu_torch.scripts import import_torch_ckpt as port_ckpt
from lipvq_tpu_torch.utils import torch_import as port_ti
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params
from test_torch_import import (
    _build_torch_gpt,
    _build_torch_icl_policy,
    _build_torch_lipvq,
    _build_torch_resnet18,
)

torch.set_num_threads(1)


def _np_sd(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _assert_same(port: dict, via_jax: dict) -> None:
    assert sorted(port) == sorted(via_jax)
    for k, v in port.items():
        assert v.dtype == via_jax[k].dtype and torch.equal(v, via_jax[k]), k


def _seeded_reference(module, rename) -> dict:
    """A seeded reference-layout state_dict for a module with no reference
    builder: the port module's shapes under the reference's keys."""
    rng = np.random.default_rng(3)
    return {rename(k): rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in module.state_dict().items()}


def _vae_key(k: str) -> str:
    """The reference VQ-VAEs' key of a port key: ``enc_1.weight`` ->
    ``encoder.2.weight``, ``embedding`` -> ``embedding.weight``."""
    if k == "embedding":
        return "embedding.weight"
    layer, leaf = k.split(".")
    part, i = layer.split("_")
    return f"{part}oder.{2 * int(i)}.{leaf}"


def _case(name):
    """(port state_dict, JAX route's state_dict, port module, forward input)
    of one import function."""
    rng = np.random.default_rng(0)
    if name == "lipvq":
        sd = _np_sd(_build_torch_lipvq(feature_dim=12, latent_dim=24, num_codes=32))
        return (port_ti.import_lipvq_state_dict(sd),
                state_dict_from_jax_params(jax_ti.import_lipvq_state_dict(sd)),
                LipVQVAE(12, 24, num_codes=32),
                rng.standard_normal((50, 12)).astype(np.float32))
    if name in ("vqvae", "lfqvae"):
        module = VQVAE(12, 8, num_embeddings=16) if name == "vqvae" else LFQVAE(12, 8)
        sd = _seeded_reference(module, _vae_key)
        fn = getattr(port_ti, f"import_{name}_state_dict")
        jfn = getattr(jax_ti, f"import_{name}_state_dict")
        return (fn(sd), state_dict_from_jax_params(jfn(sd)), module,
                rng.standard_normal((20, 12)).astype(np.float32))
    if name == "bin":
        module = AdaptiveBinActionEmbedding(4, 8, num_bins=5, embedding_dim=6)
        sd = {f"embedding_layers.{i}.weight": rng.standard_normal((5, 6)).astype(np.float32)
              for i in range(4)}
        shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        sd.update({f"output_layer.{j}.{leaf}": rng.standard_normal(shapes[f"{mod}.{leaf}"])
                   .astype(np.float32) for j, mod in ((0, "out1"), (2, "out2"))
                   for leaf in ("weight", "bias")})
        sd["running_min"] = -np.abs(rng.standard_normal(4)).astype(np.float32)
        sd["running_max"] = np.abs(rng.standard_normal(4)).astype(np.float32)
        p, s = port_ti.import_bin_state_dict(sd, 4)
        jp, js = jax_ti.import_bin_state_dict(sd, 4)
        return ({**p, **s}, {**state_dict_from_jax_params(jp), **state_dict_from_jax_params(js)},
                module, rng.standard_normal((20, 4)).astype(np.float32))
    if name == "gpt":
        sd = _np_sd(_build_torch_gpt(embed_dim=32, context_length=6, num_layers=2, num_heads=4))
        return (port_ti.import_gpt_backbone_state_dict(sd, 2),
                state_dict_from_jax_params(jax_ti.import_gpt_backbone_state_dict(sd, 2)),
                GPTBackbone(embed_dim=32, context_length=6, causal=False, attn_dropout=0.0,
                            block_output_dropout=0.0, num_layers=2, num_heads=4),
                rng.standard_normal((3, 6, 32)).astype(np.float32))
    raise KeyError(name)


def _forward(module, x):
    with torch.no_grad():
        if isinstance(module, AdaptiveBinActionEmbedding):
            return module(torch.from_numpy(x), update_stats=False)
        return module(torch.from_numpy(x))


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("name", ["lipvq", "vqvae", "lfqvae", "bin", "gpt"])
def test_import_bit_equal_to_the_jax_route(name):
    port, via_jax, module, x = _case(name)
    _assert_same(port, via_jax)
    outs = []
    for sd in (port, via_jax):
        module.load_state_dict(sd, strict=True)
        outs.append(_flat(_forward(module, x)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_icl_policy_import_bit_equal_to_the_jax_route():
    from lipvq_tpu_torch.models.obs_nets import obs_spec
    from lipvq_tpu_torch.models.policy_nets import ICLGMMActorNetwork

    tm = _build_torch_icl_policy(17, 12, 32, 4, 2, 4, num_codes=16)
    sd = _np_sd(tm)
    port = port_ti.import_icl_policy_state_dict(sd, num_layers=2)
    _assert_same(port, state_dict_from_jax_params(jax_ti.import_icl_policy_state_dict(sd, 2)))
    net = ICLGMMActorNetwork(
        group_specs=(("obs", obs_spec({"object": (17,)})),), ac_dim=12, embed_dim=32,
        num_layers=2, num_heads=4, context_length=4, causal=False, emb_dropout=0.0,
        attn_dropout=0.0, block_output_dropout=0.0, vq_vae_enabled=True, vq_num_codes=16,
        num_modes=5, min_std=1e-4)
    net.net.load_state_dict(port, strict=True)
    rng = np.random.default_rng(1)
    obs, ctx = (rng.standard_normal((3, 4, 17)).astype(np.float32) for _ in range(2))
    act = (0.4 * rng.standard_normal((3, 4, 12))).astype(np.float32)
    with torch.no_grad():
        dists, _ = net.forward_train({"object": torch.from_numpy(obs)},
                                     {"object": torch.from_numpy(ctx)}, torch.from_numpy(act),
                                     low_noise_eval=False)
        mean_t, scale_t, logits_t = tm(*(torch.from_numpy(a) for a in (obs, ctx, act)))
    # the reference module's forward math: the tolerance of tests/test_torch_import.py
    for got, want in zip((dists.means, dists.scales, dists.logits), (mean_t, scale_t, logits_t)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("prefix", ["module.convnet.", "convnet.", "backbone.", ""])
def test_resnet18_convert_bit_equal_to_the_jax_route(prefix, tmp_path):
    """Every trunk layout ``convert`` tries, in both packages; the converted
    file loads through ``PretrainedReprConv.load_pretrained`` and gives the
    reference trunk's outputs."""
    tm = _build_torch_resnet18()
    sd = {prefix + k: v for k, v in _np_sd(tm).items()}
    sd[prefix + "fc.weight"] = np.zeros((10, 512), np.float32)  # ignored
    port = port_ckpt.convert(sd, "resnet18")
    jax_out = jax_ckpt.convert(sd, "resnet18")
    trunk = ResNet18Conv()
    _assert_same(port["params"], state_dict_from_jax_params(jax_out["params"], trunk))
    _assert_same(port["batch_stats"], state_dict_from_jax_params(jax_out["batch_stats"]))
    path = str(tmp_path / "r3m.pt")
    port_ckpt.save_converted(port, path)
    core = obs_core.R3MConv()
    obs_core.apply_pretrained(core, path)
    x = np.random.default_rng(2).random((2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = core(torch.from_numpy(x))
        want = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-4)


def test_cli_round_trip_gives_the_reference_ids(tmp_path):
    """A reference payload ({"model": state_dict, ...}) through the port's
    CLI: the file loads into ``LipVQVAE`` with ``weights_only=True`` and its
    ids are the reference module's."""
    tm = _build_torch_lipvq(feature_dim=12, latent_dim=24, num_codes=32)
    src, dst = str(tmp_path / "model.pth"), str(tmp_path / "params.pt")
    torch.save({"model": tm.state_dict(), "config": {"algo": "icl"}}, src)
    port_ckpt.main(["--torch_ckpt", src, "--output", dst])
    model = LipVQVAE(12, 24, num_codes=32)
    model.load_state_dict(torch.load(dst, weights_only=True)["params"], strict=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((200, 12)).astype(np.float32))
    with torch.no_grad():
        _, ids_t, _ = tm(x)
        ids = model.tokenize(x)
        assert torch.equal(ids, vq_nearest_reference(model.encode(x), model.quantizer.codebook))
    assert torch.equal(ids.long(), ids_t)


def test_cli_rejects_the_resnet18_component_in_both_packages(tmp_path, monkeypatch, capsys):
    """Reference fault (r), mirrored: ``--component`` offers ``lipvq`` and
    ``icl_policy`` only, though ``convert`` takes ``resnet18`` and the
    ``PretrainedReprConv`` docstring names it."""
    src = str(tmp_path / "trunk.pth")
    torch.save(_build_torch_resnet18().state_dict(), src)
    argv = ["--torch_ckpt", src, "--output", str(tmp_path / "o"), "--component", "resnet18"]
    monkeypatch.setattr("sys.argv", ["import_torch_ckpt", *argv])
    for main in (jax_ckpt.main, lambda: port_ckpt.main(argv)):
        with pytest.raises(SystemExit):
            main()
        assert "invalid choice: 'resnet18'" in capsys.readouterr().err
    sd = port_ckpt.load_torch_state_dict(src)
    assert set(port_ckpt.convert(sd, "resnet18")) == set(jax_ckpt.convert(sd, "resnet18"))
