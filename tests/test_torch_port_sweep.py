"""The port's offline tokenizer sweep (``scripts/tokenizer_sweep.py``)
against the JAX script: the corpus read from an export equals the JAX
script's read of the HDF5 file it mirrors, and 3 training steps at 8 and 16
codes, with the loss and with the EMA codebook, from bridged identical
weights and the same batch draws, give the JAX result's values.

Tolerances: ``final_train_loss`` and ``recon_mse`` rtol 1e-4 (three AdamW
steps of fp32 GEMMs in other orders, torch's and optax's AdamW arithmetic);
``codebook_utilization`` exactly equal (the ids of the eval rows are equal);
``tokenize_chunks_per_sec`` is a time and is not compared.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu.scripts import tokenizer_sweep as jax_sweep
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.scripts import tokenizer_sweep
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params
from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

torch.set_num_threads(1)

LATENT, STEPS, BATCH, SEED = 16, 3, 64, 0
KEYS = {"num_codes", "codebook_update", "final_train_loss", "recon_mse",
        "codebook_utilization", "tokenize_chunks_per_sec"}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same 12 demos (demo_10 and demo_11 sort after demo_9) as an HDF5
    file for JAX and as an export for the port."""
    root = tmp_path_factory.mktemp("sweep")
    h5 = make_synthetic_dataset(str(root / "demos.hdf5"), n_demos=12, demo_len=50, seed=3)
    export = make_synthetic_export(str(root / "export"), n_demos=12, demo_len=50, seed=3)
    return h5, export


def test_load_corpus_matches_jax(corpora):
    h5, export = corpora
    got, want = tokenizer_sweep.load_corpus(export), jax_sweep.load_corpus(h5)
    assert got.dtype == np.float32 and got.shape == (600, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_codes", [8, 16])
@pytest.mark.parametrize("ema", [False, True], ids=["loss", "ema"])
def test_sweep_setting_matches_jax(corpora, num_codes, ema):
    # scaled: at the init's Lipschitz bound the latents of actions in
    # [-1, 1] all fall on one code; these spread over 3 to 8 codes
    corpus = 200.0 * jax_sweep.load_corpus(corpora[0])
    want = jax_sweep.train_tokenizer(corpus, num_codes, ema, LATENT, STEPS, BATCH, seed=SEED)
    # the JAX script's init, bridged into the port
    model = JaxLipVQVAE(feature_dim=corpus.shape[1], latent_dim=LATENT, num_codes=num_codes,
                        ema_codebook=ema)
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(SEED),
                                                    jnp.zeros((8, corpus.shape[1]))))
    port = LipVQVAE(corpus.shape[1], LATENT, num_codes=num_codes, ema_codebook=ema)
    state = state_dict_from_jax_params(variables["params"])
    for name in ("vq_stats",) if ema else ():
        state.update(state_dict_from_jax_params(variables[name]))
    port.load_state_dict(state, strict=True)
    got = tokenizer_sweep.run_setting(port, corpus, STEPS, BATCH, SEED, "cpu")
    assert set(got) | {"num_codes", "codebook_update"} == set(want) == KEYS
    for k in ("final_train_loss", "recon_mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["codebook_utilization"] == want["codebook_utilization"] > 1 / num_codes
    assert got["tokenize_chunks_per_sec"] > 0
    if ema:  # the EMA buffers moved and the codebook took their means
        assert float(port.ema_cluster_size.sum()) > 0


def test_train_step_on_the_cpu():
    """One step of each codebook: the EMA buffers advance only with the EMA
    codebook, and its touched codes become the EMA means."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (32, 12)).astype(np.float32))
    for ema in (False, True):
        model = LipVQVAE(12, LATENT, num_codes=8, ema_codebook=ema)
        tokenizer_sweep.seeded_init(model, torch.Generator().manual_seed(1))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
        before = model.quantizer.codebook.detach().clone()
        loss = tokenizer_sweep.train_step(model, opt, x)
        assert torch.isfinite(loss) and not loss.requires_grad
        assert not torch.equal(model.quantizer.codebook, before)
        if ema:
            assert float(model.ema_cluster_size.sum()) == pytest.approx(0.01 * 32)


def test_main_on_the_cpu(corpora, capsys):
    results = tokenizer_sweep.main(["--dataset", corpora[1], "--codebook_sizes", "8",
                                    "--latent_dim", "8", "--steps", "2", "--batch", "16",
                                    "--device", "cpu"])
    assert [(r["num_codes"], r["codebook_update"]) for r in results] == [(8, "loss"),
                                                                         (8, "ema")]
    assert all(set(r) == KEYS for r in results)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "corpus: 600 chunks x 12 dims"
    assert [json.loads(line) for line in lines[1:]] == results
