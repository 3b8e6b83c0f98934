"""The port's corpus tokenization against the JAX package: ``tokenize_array``
ids exactly equal to JAX's on one CPU device, ``tokenize_export_corpus`` on
the export of an HDF5 file writing per-demo tokens exactly equal to what
``tokenize_hdf5_corpus`` writes into that file, the same stats keys, a dry
run that writes nothing, the CLI on the CPU with a state_dict bridged from
the JAX tokenizer's params, and the export's atomic array writer.

The tokenizer's Lipschitz bound is raised to 30 and its codebook set to the
latents of random actions: at the init's bound every latent lies within
fp32 rounding of sigmoid(0), so the nearest code would be decided by the
last bits of each package's arithmetic; spread out, the ids are exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu.parallel.corpus import tokenize_array as jax_tokenize_array
from lipvq_tpu.parallel.corpus import tokenize_hdf5_corpus
from lipvq_tpu.parallel.mesh import make_mesh
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.data.export import Export, ExportWriter, add_arrays, hdf5_to_export
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_fast_reference
from lipvq_tpu_torch.parallel.corpus import tokenize_array, tokenize_export_corpus
from lipvq_tpu_torch.scripts import tokenize_corpus
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

A, LATENT, CODES = 12, 32, 64
STATS_KEYS = {"files", "demos", "chunks", "seconds", "chunks_per_sec"}


@pytest.fixture(scope="module")
def tokenizer():
    """(JAX model, its variables, the port's model) with the same weights."""
    model = JaxLipVQVAE(feature_dim=A, latent_dim=LATENT, num_codes=CODES)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(7),
                                                 jnp.zeros((8, A)))["params"])
    params["to_latent"]["ci"] = np.full_like(params["to_latent"]["ci"], 30.0)
    actions = np.random.default_rng(0).uniform(-1, 1, (CODES, A)).astype(np.float32)
    params["quantizer"]["codebook"] = np.asarray(model.apply(
        {"params": params}, jnp.asarray(actions), method=JaxLipVQVAE.encode))
    port = LipVQVAE(A, LATENT, num_codes=CODES)
    port.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model, {"params": params}, port


def test_tokenize_array_matches_jax(tokenizer):
    model, variables, port = tokenizer
    x = np.random.default_rng(1).uniform(-1, 1, (700, A)).astype(np.float32)
    want = jax_tokenize_array(model, variables, x, mesh=make_mesh(1), chunk=512)
    got = tokenize_array(port, x, device="cpu", chunk=256)  # 3 lookups of <= 256 rows
    assert got.dtype == np.int32 and got.shape == (700,)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 16
    fast = tokenize_array(port, x, device="cpu", precision="fast")
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(fast, vq_nearest_fast_reference(z, port.quantizer.codebook))
    assert tokenize_array(port, x[:0], device="cpu").shape == (0,)


@pytest.fixture
def corpus(tmp_path):
    """The same demonstrations as an HDF5 file and as its export."""
    h5 = make_synthetic_dataset(str(tmp_path / "d.hdf5"), n_demos=6, demo_len=25)
    return h5, hdf5_to_export(h5, str(tmp_path / "export"))


def test_tokenize_export_corpus_matches_hdf5_corpus(tokenizer, corpus):
    import h5py

    model, variables, port = tokenizer
    h5, export = corpus
    want_stats = tokenize_hdf5_corpus(model, variables, [h5], mesh=make_mesh(1), write=True)
    got_stats = tokenize_export_corpus(port, [export], device="cpu", write=True)
    assert set(got_stats) == set(want_stats) == STATS_KEYS
    for k in ("files", "demos", "chunks"):
        assert got_stats[k] == want_stats[k], k
    assert got_stats["chunks"] == 150
    reader = Export(export)
    with h5py.File(h5, "r") as f:
        for demo in reader.demos:
            want = np.asarray(f[f"data/{demo}/tokens/lipvq_tokens"])
            got = reader.load(demo, "tokens/lipvq_tokens")
            assert got.dtype == np.int32 and got.shape == (25,)
            np.testing.assert_array_equal(got, want, err_msg=demo)


def test_dry_run_writes_nothing(tokenizer, corpus):
    _, export = corpus
    before = {(d, k) for d in Export(export).demos for k in Export(export).keys(d, "tokens")}
    files = sorted(os.walk(export))
    stats = tokenize_export_corpus(tokenizer[2], [export], device="cpu", write=False)
    assert stats["chunks"] == 150 and not before
    assert sorted(os.walk(export)) == files
    assert not any(Export(export).keys(d, "tokens") for d in Export(export).demos)


def test_cli_on_the_cpu_with_jax_weights(tokenizer, corpus, tmp_path, capsys):
    """A state_dict converted from the JAX tokenizer's params, read with
    weights_only, gives the JAX ids; without --ckpt a seeded init runs."""
    model, variables, _ = tokenizer
    h5, export = corpus
    ckpt = str(tmp_path / "tokenizer.pt")
    torch.save(state_dict_from_jax_params(variables["params"]), ckpt)
    common = ["--datasets", export, "--action_dim", str(A), "--latent_dim", str(LATENT),
              "--num_codes", str(CODES), "--device", "cpu"]
    stats = tokenize_corpus.main(common + ["--ckpt", ckpt, "--output_key", "cli"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu") and json.loads(out[out.index("{"):]) == stats
    reader = Export(export)
    x = np.concatenate([reader.load(d, "actions") for d in reader.demos])
    want = jax_tokenize_array(model, variables, x, mesh=make_mesh(1), chunk=256)
    got = np.concatenate([reader.load(d, "tokens/cli") for d in reader.demos])
    np.testing.assert_array_equal(got, want)
    tokenize_corpus.main(common + ["--dry_run", "--output_key", "seeded"])
    assert not Export(export).has(reader.demos[0], "tokens/seeded")
    tokenize_corpus.main(common + ["--precision", "fast", "--output_key", "seeded"])
    assert Export(export).load(reader.demos[0], "tokens/seeded").shape == (25,)


def test_add_arrays_is_seen_by_a_new_reader(tmp_path):
    root = str(tmp_path / "e")
    writer = ExportWriter(root)
    for i in range(3):
        writer.add_demo(f"demo_{i}", {"num_samples": 4}, {"actions": np.zeros((4, 2))})
    writer.finish({"total": 12}, {"train": ["demo_0"]})
    old = Export(root)
    add_arrays(root, {"demo_1": {"tokens/t": np.arange(4, dtype=np.int32)}})
    new = Export(root)
    assert new.has("demo_1", "tokens/t") and not new.has("demo_0", "tokens/t")
    np.testing.assert_array_equal(new.load("demo_1", "tokens/t"), np.arange(4))
    assert new.shape("demo_1", "tokens/t") == (4,) and new.keys("demo_1", "tokens") == ["t"]
    assert not old.has("demo_1", "tokens/t")  # a reader opened before keeps its meta
    assert new.mask("train") == ["demo_0"] and new.data_attrs == {"total": 12}
    add_arrays(root, {"demo_1": {"tokens/t": np.ones(4, np.int32)}})  # replaced in place
    np.testing.assert_array_equal(Export(root).load("demo_1", "tokens/t"), np.ones(4))
    assert not [f for _, _, fs in os.walk(root) for f in fs if f.endswith(".tmp")]
    with pytest.raises(KeyError, match="demo_9"):
        add_arrays(root, {"demo_9": {"tokens/t": np.zeros(1)}})
