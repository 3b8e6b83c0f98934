"""The FAST arm of the port against the JAX package: its BPE library, the
FAST tokenizer, the CLIP text tower, the ICL composite with ``fast_enabled``
and its training, checkpoints and serving.

Tolerances:
- the BPE library and the FAST tokenizer are exact: the same serialized
  bytes, vocabulary size, token ids, decodings, quantile bounds, and
  ``features_for_policy`` bit-equal (host numpy and the same C++ source);
- the CLIP text tower at random init: rtol 1e-5 / atol 1e-6 (the same fp32
  GEMMs, softmax and LayerNorms in other orders);
- the ICL composite with ``fast_enabled``: rtol 1e-4 / atol 1e-5, as the
  other arms' composite (``test_torch_port_arms.py``);
- train steps 1 and 3: the features bit-equal, losses and the gradient norm
  rtol 1e-5, parameters atol 2e-5 + rtol 1e-5 (``test_torch_port_train.py``);
- checkpoints: a reload bit-equal, a resume bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.models import clip_text as jax_clip
from lipvq_tpu.models.obs_nets import ICLMIMOTransformer as JaxICL
from lipvq_tpu.models.tokenizers.fast import FastActionTokenizer as JaxFast
from lipvq_tpu.models.tokenizers.prise import PriseTokenizer as JaxPrise
from lipvq_tpu.utils.lang_utils import LangEncoder as JaxLangEncoder
from lipvq_tpu_torch import native
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.models import clip_text
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.obs_nets import FAST_FEAT_DIM, ICLMIMOTransformer, obs_spec
from lipvq_tpu_torch.models.tokenizers.fast import FastActionTokenizer
from lipvq_tpu_torch.models.tokenizers.prise import PriseTokenizer, byte_level_alphabet
from lipvq_tpu_torch.utils import file_utils
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params
from lipvq_tpu_torch.utils.lang_utils import LangEncoder
from lipvq_tpu_torch.utils.tensor_utils import stack_collate

torch.set_num_threads(1)

SEQ_TOL = {"rtol": 1e-4, "atol": 1e-5}
CLIP_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# -- the BPE library ---------------------------------------------------------

def _corpus(seed, n_words=200, hi=32, longest=12):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, hi, rng.integers(3, longest))]
            for _ in range(n_words)]


def _jax_bytes(tok, tmp_path) -> bytes:
    path = tmp_path / "jax.bpe"
    tok.save(str(path))
    return path.read_bytes()


# the last four: two- and three-symbol alphabets with long words (many
# tied counts, merged strings that another pair already made, runs of one
# symbol), short token limits, and a FAST-sized fit
@pytest.mark.parametrize("seed,vocab,min_frequency,max_len,hi,longest,n_words", [
    (0, 128, 2, 8, 32, 12, 200), (1, 96, 2, 16, 32, 12, 200), (2, 300, 3, 100, 32, 12, 200),
    (3, 1024, 2, 100, 32, 12, 200), (5, 400, 1, 3, 2, 30, 300), (6, 300, 1, 100, 3, 25, 300),
    (7, 200, 2, 2, 5, 20, 300), (8, 1024, 2, 100, 40, 120, 400)])
def test_bpe_library_matches_jax(tmp_path, seed, vocab, min_frequency, max_len, hi, longest,
                                 n_words):
    corpus = _corpus(seed, n_words, hi, longest)
    got, want = PriseTokenizer("bpe", vocab), JaxPrise("bpe", vocab)
    got.train(corpus, min_frequency=min_frequency, max_token_length=max_len)
    want.train(corpus, min_frequency=min_frequency, max_token_length=max_len)
    assert got.vocab_size == want.vocab_size > hi + 1  # [UNK], the alphabet, merges
    assert got.to_bytes() == _jax_bytes(want, tmp_path)
    for word in corpus[:30] + [corpus[0] + corpus[1]]:
        ids = got.encode(word)
        assert ids == want.encode(word)
        assert got.decode(ids) == want.decode(ids) == word
        assert [got.token_str(i) for i in ids] == [want.token_str(i) for i in ids]


def test_bpe_checkpoint_loads_into_either_package(tmp_path):
    corpus = _corpus(4)
    port, jax_tok = PriseTokenizer("bpe", 160), JaxPrise("bpe", 160)
    port.train(corpus)
    jax_tok.train(corpus)
    into_port, into_jax = PriseTokenizer("bpe", 8), JaxPrise("bpe", 8)
    assert _jax_bytes(jax_tok, tmp_path) == port.to_bytes()  # writes jax.bpe
    into_port.load(str(tmp_path / "jax.bpe"))
    port.save(str(tmp_path / "port.bpe"))
    into_jax.load(str(tmp_path / "port.bpe"))
    assert into_port.vocab_size == into_jax.vocab_size == port.vocab_size
    assert into_port.to_bytes() == port.to_bytes()
    for word in corpus[:20]:
        assert into_port.encode(word) == into_jax.encode(word) == port.encode(word)


def test_bpe_library_is_the_ports_own():
    """The port builds its copy of bpe.cpp into its own git-ignored
    directory, named by a digest of the source and flags."""
    lib = native.load_bpe_lib()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert path.name.startswith("libbpe-") and lib._name == str(path)
    assert "lipvq_tpu_torch" in str(path) and "lipvq_tpu/" not in str(path)
    assert native.SRC.read_bytes().count(b"bpe_serialize") >= 1
    assert native.load_bpe_lib() is lib  # loaded once per process


def test_bpe_build_raises_without_gpp_or_on_a_failed_compile(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    monkeypatch.undo()
    broken = tmp_path / "bpe.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_byte_level_alphabet_and_text_mapping_match_jax():
    from lipvq_tpu.models.tokenizers.prise import byte_level_alphabet as jax_alphabet

    assert byte_level_alphabet() == jax_alphabet()
    tok, ref = PriseTokenizer("bpe", 64), JaxPrise("bpe", 64)
    raw = [[5, 17, 200, 3, 99], [0, 255]]
    assert tok.textualize(raw) == ref.textualize(raw)
    assert tok.detextualize(tok.textualize(raw[0])) == raw[0]


@pytest.mark.parametrize("algo", ["wordpiece", "unigram"])
def test_hf_backed_algorithms_match_jax(algo):
    pytest.importorskip("tokenizers")
    rng = np.random.default_rng(5)
    corpus = [[int(x) for x in rng.integers(0, 24, rng.integers(3, 10))] for _ in range(150)]
    got, want = PriseTokenizer(algo, 96), JaxPrise(algo, 96)
    got.train(corpus, min_frequency=2, max_token_length=8)
    want.train(corpus, min_frequency=2, max_token_length=8)
    # HF's trainers number their vocabularies in hash-map order, so ids are
    # compared through the round trip, as the JAX package's own test does
    assert got.vocab_size == want.vocab_size
    for word in corpus[:10]:
        assert got.decode(got.encode(word)) == want.decode(want.encode(word)) == word


# -- the FAST tokenizer ------------------------------------------------------

def _chunks(seed, n, t=10, d=12, smooth=True):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.uniform(-1, 1, (n, t, d)).astype(np.float32)
    ts = np.arange(t, dtype=np.float32)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, (n, 1, d)).astype(np.float32)
    freq = rng.uniform(0.02, 0.3, (n, 1, d)).astype(np.float32)
    return (0.7 * np.sin(freq * ts + phase)).astype(np.float32)


@pytest.mark.parametrize("smooth,vocab,seq_len", [(True, 512, 10), (False, 1024, 10),
                                                  (True, 256, 4)])
def test_fast_tokenizer_matches_jax_bit_for_bit(tmp_path, smooth, vocab, seq_len):
    chunks = _chunks(6, 48, smooth=smooth)
    got, want = FastActionTokenizer(vocab_size=vocab), JaxFast(vocab_size=vocab)
    got.fit(chunks)
    want.fit(chunks)
    np.testing.assert_array_equal(got.lo, want.lo)
    np.testing.assert_array_equal(got.hi, want.hi)
    assert got.bpe.to_bytes() == _jax_bytes(want.bpe, tmp_path)
    assert got.batch_encode(chunks) == want.batch_encode(chunks)
    ids = got.encode(chunks[0])
    np.testing.assert_array_equal(got.decode(ids, 10, 12), want.decode(ids, 10, 12))
    fresh = _chunks(7, 9, smooth=smooth)
    feats = got.features_for_policy(fresh, LangEncoder(), seq_len=seq_len)
    ref = want.features_for_policy(fresh, JaxLangEncoder(), seq_len=seq_len)
    assert feats.dtype == np.float32 and feats.shape == (9, seq_len, FAST_FEAT_DIM)
    np.testing.assert_array_equal(feats, ref)


def test_fast_tokenizer_encode_before_fit_raises():
    with pytest.raises(RuntimeError, match="fit"):
        FastActionTokenizer().encode(np.zeros((10, 12), np.float32))


# -- the CLIP text tower -----------------------------------------------------

TINY = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_positions=16, projection_dim=24, eos_token_id=119)


def _ids(rng, rows, length, eos, vocab):
    """Rows of seeded ids whose first EOS falls at different places, pad
    after it (the tokenizer's padding is EOS)."""
    ids = rng.integers(1, vocab - 1, (rows, length))
    for r in range(rows):
        ids[r, rng.integers(1, length):] = eos
    return ids


@pytest.mark.parametrize("length", [16, 7])
def test_clip_tower_matches_jax_at_random_init(length):
    jcfg, cfg = jax_clip.CLIPTextConfig(**TINY), clip_text.CLIPTextConfig(**TINY)
    ids = _ids(np.random.default_rng(8), 5, length, cfg.eos_token_id, cfg.vocab_size)
    jt = jax_clip.CLIPTextTower(jcfg)
    variables = jt.init(jax.random.PRNGKey(3), jnp.asarray(ids, jnp.int32))
    tower = clip_text.CLIPTextTower(cfg)
    tower.load_state_dict(state_dict_from_jax_params(_np(variables["params"])), strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(ids))
    want = jt.apply(variables, jnp.asarray(ids, jnp.int32))
    assert got.shape == (5, cfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLIP_TOL)


def test_clip_tower_imports_hf_weights():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=16, projection_dim=24,
        hidden_act="quick_gelu", eos_token_id=119)
    torch.manual_seed(0)
    hf = transformers.CLIPTextModelWithProjection(hf_cfg).eval()
    cfg = clip_text.CLIPTextConfig(**TINY)
    tower = clip_text.CLIPTextTower(cfg)
    tower.load_state_dict(clip_text.import_clip_text_state_dict(hf.state_dict(), cfg),
                          strict=True)
    ids = torch.from_numpy(_ids(np.random.default_rng(9), 4, 12, 119, 120))
    with torch.no_grad():
        np.testing.assert_allclose(tower(ids).numpy(), hf(input_ids=ids).text_embeds.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_clip_tower_seeded_init_is_deterministic():
    cfg = clip_text.CLIPTextConfig(**TINY)
    a = seeded_init(clip_text.CLIPTextTower(cfg), torch.Generator().manual_seed(1))
    b = seeded_init(clip_text.CLIPTextTower(cfg), torch.Generator().manual_seed(1))
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(v, w) and torch.isfinite(v).all(), k


# -- the ICL composite -------------------------------------------------------

@pytest.mark.parametrize("backbone", ["transformer", "mamba"])
def test_icl_composite_with_fast_matches_jax(backbone):
    t, b = 10, 2
    spec = obs_spec({"eef": (3,), "object": (5,)})
    kw = dict(output_spec=obs_spec({"action": (12,)}), backbone=backbone, embed_dim=32,
              num_layers=2, num_heads=4, context_length=t, causal=False, emb_dropout=0.0,
              attn_dropout=0.0, block_output_dropout=0.0, action_input_shape=12,
              fast_enabled=True, vq_vae_enabled=True, bin_enabled=True)
    rng = np.random.default_rng(10)
    obs, ctx = ({k: rng.standard_normal((b, t, *s), dtype=np.float32) for k, s in spec}
                for _ in range(2))
    feat = rng.standard_normal((b, t, FAST_FEAT_DIM), dtype=np.float32)
    jm = JaxICL(group_specs=(("obs", spec),), **kw)
    jin = (jax.tree.map(jnp.asarray, obs), jax.tree.map(jnp.asarray, ctx), jnp.asarray(feat))
    variables = jm.init(jax.random.PRNGKey(11), *jin)
    port = ICLMIMOTransformer(group_specs=(("obs", spec),), **kw)
    assert port.encoder.arm == "fast"  # FAST takes precedence over bin and vq
    port.load_state_dict(state_dict_from_jax_params(_np(variables["params"])), strict=True)
    assert port.encoder.fast_proj_0.weight.shape == (64, FAST_FEAT_DIM)
    tin = ({k: _t(v) for k, v in obs.items()}, {k: _t(v) for k, v in ctx.items()}, _t(feat))
    want, want_aux = jm.apply(variables, *jin)
    got, got_aux = port(*tin)
    np.testing.assert_allclose(got["action"].detach().numpy(), np.asarray(want["action"]),
                               **SEQ_TOL)
    assert float(got_aux) == float(want_aux) == 0.0


# -- training, checkpoints and serving ---------------------------------------

OBS_SHAPES = {"robot0_eef_pos": [3], "object": [14]}
AC_DIM, T, BATCH = 12, 10, 4
STEPS = 2 * T - 1
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5
SHAPE_META = {"ac_dim": AC_DIM, "all_shapes": OBS_SHAPES, "all_obs_keys": list(OBS_SHAPES),
              "use_images": False}


def _config(factory, dropout=0.0, warmup=2, backbone="transformer"):
    section = "mamba" if backbone == "mamba" else "transformer"
    cfg = factory("icl_mamba" if backbone == "mamba" else "icl", {
        "train": {"max_grad_norm": 100.0, "seed": 1},
        "algo": {
            "optim_params": {"policy": {
                "optimizer_type": "adamw",
                "learning_rate": {"initial": 1e-3, "scheduler_type": "constant_with_warmup"},
                "regularization": {"L2": 0.01}}},
            "gmm": {"enabled": True},
            section: {"enabled": True, "supervise_all_steps": True, "pred_future_acs": True,
                      "causal": False, "embed_dim": 32, "num_layers": 2, "num_heads": 4,
                      "vq_vae_enabled": False, "ln_act_enabled": False, "fast_enabled": True,
                      "compute_dtype": "float32", "emb_dropout": dropout,
                      "attn_dropout": dropout, "block_output_dropout": dropout},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        if warmup is not None:
            cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = warmup
    return cfg


def _raw_batches(n, seed=11, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [stack_collate([
        {"obs": {k: rng.standard_normal((STEPS, *s), dtype=np.float32)
                 for k, s in OBS_SHAPES.items()},
         "actions": rng.uniform(-1, 1, (STEPS, AC_DIM)).astype(np.float32)}
        for _ in range(batch)]) for _ in range(n)]


def _jax_state_dict(jax_algo):
    return state_dict_from_jax_params(_np(jax_algo.state.params))


@pytest.fixture(scope="module")
def trained():
    """Both packages from one set of weights through the same sequence of
    processed batches: train steps 1 and 2 (the fit refits on each), six
    context batches (refits 3-8: the fit freezes on the 8th), train step 3
    on the frozen vocabulary."""
    jax_algo = jax_algo_factory("icl", _config(jax_config_factory), OBS_SHAPES, ac_dim=AC_DIM)
    port = algo_factory("icl", _config(config_factory), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")
    load_jax_params(port, _np(jax_algo.state.params))
    raw = _raw_batches(9)
    feats, snaps, frozen = [], {}, []

    def process(batch):
        want = jax_algo.process_batch_for_training(batch)
        got = port.process_batch_for_training(batch)
        feats.append((got["ctx_act_feat"], want["ctx_act_feat"]))
        frozen.append((port._fast_frozen, jax_algo._fast_frozen))
        return got, want

    def step(i, batch):
        got, want = process(batch)
        w = jax_algo.train_on_batch(want, 0)["losses"]
        g = port.train_on_batch(got, 0)["losses"]
        snaps[i] = ({k: float(v) for k, v in w.items()}, {k: float(v) for k, v in g.items()},
                    _jax_state_dict(jax_algo),
                    {k: v.clone() for k, v in port.nets.state_dict().items()})

    step(1, raw[0])
    step(2, raw[1])
    for batch in raw[2:8]:
        process(batch)
    step(3, raw[8])
    return jax_algo, port, feats, snaps, frozen


def test_fast_features_match_jax_across_refits_and_freeze(trained, tmp_path):
    jax_algo, port, feats, _, frozen = trained
    assert len(feats) == 9
    for got, want in feats:
        assert got.shape == (BATCH, T, FAST_FEAT_DIM)
        np.testing.assert_array_equal(got, want)
    # refit on every call until the 8th, frozen from then on
    assert frozen == [(False, False)] * 7 + [(True, True)] * 2
    assert port._fast_fit_buf == [] and jax_algo._fast_fit_buf == []
    assert port._fast_tok.bpe.to_bytes() == _jax_bytes(jax_algo._fast_tok.bpe, tmp_path)
    np.testing.assert_array_equal(port._fast_tok.lo, jax_algo._fast_tok.lo)


@pytest.mark.parametrize("step", [1, 3])
def test_fast_train_step_matches_jax(trained, step):
    _, port, _, snaps, _ = trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert set(got_sd) == set(want_sd)
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
    assert port.vq_optimizer is None


def test_fast_payload_equals_jax_checkpoint(trained):
    jax_algo, port, _, _, _ = trained
    fast = msgpack_restore(bytes(jax_algo.serialize()[8:]))["fast"]
    payload = port.serialize()
    np.testing.assert_array_equal(payload["fast_tokenizer.lo"].numpy(), fast["lo"])
    np.testing.assert_array_equal(payload["fast_tokenizer.hi"].numpy(), fast["hi"])
    assert payload["fast_tokenizer.vocab_size"].dtype == torch.int64
    assert int(payload["fast_tokenizer.vocab_size"]) == fast["vocab_size"]
    assert payload["fast_tokenizer.bpe"].dtype == torch.uint8
    assert payload["fast_tokenizer.bpe"].numpy().tobytes() == fast["bpe"]


def _fast_algo(**kw):
    return algo_factory("icl", _config(config_factory, **kw), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")


def test_fast_checkpoint_reloads_bit_equal(tmp_path):
    writer = _fast_algo(dropout=0.1, warmup=None)
    for batch in _raw_batches(2, seed=21):
        writer.train_on_batch(writer.process_batch_for_training(batch), 0)
    path = str(tmp_path / "model.ckpt")
    file_utils.save_checkpoint(path, writer, _config(config_factory, dropout=0.1, warmup=None),
                               shape_meta=SHAPE_META)
    reloaded, _ = file_utils.policy_from_checkpoint(path, device="cpu")
    assert reloaded._fast_frozen and reloaded._fast_tok is not None
    for (k, v), (k2, v2) in zip(writer.nets.state_dict().items(),
                                reloaded.nets.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    probe = _raw_batches(1, seed=22)[0]
    writer._fast_frozen = True  # the reloaded vocabulary is the saved one, frozen
    feat = writer._fast_features(probe["actions"][:, :T])
    np.testing.assert_array_equal(reloaded._fast_features(probe["actions"][:, :T]), feat)
    obs = {k: _t(v[:, :T]) for k, v in probe["obs"].items()}
    with torch.no_grad():
        want = writer.nets.forward_train(obs, obs, _t(feat), low_noise_eval=True)[0]
        got = reloaded.nets.forward_train(obs, obs, _t(feat), low_noise_eval=True)[0]
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_fast_full_state_resume_is_bit_identical(tmp_path):
    """Dropout 0.1, the schedule's warmup: a run resumed from
    ``serialize_full`` after 2 steps (fit not frozen yet: the resumed
    tokenizer is the writer's, frozen) takes steps 3 and 4 bit for bit."""
    writer = _fast_algo(dropout=0.1, warmup=None)
    raw = _raw_batches(4, seed=23)
    for batch in raw[:2]:
        writer.train_on_batch(writer.process_batch_for_training(batch), 0)
    state = str(tmp_path / "latest_full.state")
    torch.save(writer.serialize_full(), state)
    resumed = _fast_algo(dropout=0.1, warmup=None)
    resumed.deserialize_full(torch.load(state, map_location="cpu", weights_only=True))
    writer._fast_frozen = True  # the resumed run's vocabulary is the saved one, frozen
    for batch in raw[2:]:
        want = writer.train_on_batch(writer.process_batch_for_training(batch), 1)["losses"]
        got = resumed.train_on_batch(resumed.process_batch_for_training(batch), 1)["losses"]
        assert all(torch.equal(got[k], want[k]) for k in want)
    for (k, v), (_, v2) in zip(writer.nets.state_dict().items(),
                               resumed.nets.state_dict().items()):
        assert torch.equal(v, v2), k


def test_fast_checkpoint_without_payload_raises(tmp_path):
    """A FAST algo that never fitted saves no tokenizer; loading that
    checkpoint into a FAST algo must raise rather than fit a vocabulary
    unrelated to training (JAX algo/icl.py:274-281)."""
    unfitted = _fast_algo()
    payload = unfitted.serialize()
    assert not any(k.startswith("fast_tokenizer.") for k in payload)
    loaded = _fast_algo()
    loaded.deserialize(payload)
    with pytest.raises(RuntimeError, match="no FAST tokenizer"):
        loaded.process_batch_for_training(_raw_batches(1)[0])
    # an incomplete payload is refused outright
    fitted = _fast_algo()
    fitted.process_batch_for_training(_raw_batches(1)[0])
    broken = fitted.serialize()
    del broken["fast_tokenizer.bpe"]
    with pytest.raises(KeyError, match="incomplete"):
        _fast_algo().deserialize(broken)


def test_fast_algo_serves_with_and_without_features(monkeypatch):
    algo = _fast_algo()
    raw = _raw_batches(1, seed=31, batch=2)[0]
    ctx = algo.process_batch_for_training(raw)
    calls = []
    features = algo._fast_features

    def counted(actions):
        calls.append(np.asarray(actions).shape)
        return features(actions)

    monkeypatch.setattr(algo, "_fast_features", counted)
    policy = ICLRolloutPolicy(algo)
    obs = {k: np.asarray(v[:1, :T]) for k, v in raw["obs"].items()}
    one_ctx = {"obs": {k: v[:1] for k, v in ctx["obs"].items()},
               "actions": ctx["actions"][:1], "ctx_act_feat": ctx["ctx_act_feat"][:1]}
    batched = {k: np.repeat(v, 3, 0) for k, v in obs.items()}
    acts = policy.batched(batched, one_ctx)
    assert acts.shape == (3, AC_DIM) and np.isfinite(acts).all()
    assert calls == []  # the context carried its features: no host BPE per request
    assert policy._ctx_cache[2]["ctx_act_feat"].shape == (3, T, FAST_FEAT_DIM)
    raw_ctx = {"obs": one_ctx["obs"], "actions": one_ctx["actions"]}
    policy.batched(batched, raw_ctx)
    policy.batched(batched, raw_ctx)
    assert calls == [(3, T, AC_DIM)] * 2  # a raw context reruns the pipeline per request
    # the fit is not frozen yet, so each of those refit over every window
    # seen (JAX algo/icl.py:282-306): the processed batch and both requests
    assert [len(b) for b in algo._fast_fit_buf] == [2, 3, 3]


@pytest.mark.parametrize("backbone", ["transformer", "mamba"])
def test_fast_algo_builds_on_both_backbones(backbone):
    algo = algo_factory("icl_mamba" if backbone == "mamba" else "icl",
                        _config(config_factory, backbone=backbone), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")
    assert algo.fast_enabled and algo.nets.net.encoder.arm == "fast"
    batch = algo.process_batch_for_training(_raw_batches(1, seed=41)[0])
    losses = algo.train_on_batch(batch, 0)["losses"]
    assert all(torch.isfinite(v) for v in losses.values())


def test_lang_encoder_embeds_each_fast_string_once(monkeypatch):
    """The FAST features embed every token string once, across refits: the
    LangEncoder's per-string cache is their only cache."""
    enc = LangEncoder()
    seen, embed = [], enc._hash_embed
    monkeypatch.setattr(enc, "_hash_embed", lambda t: seen.append(t) or embed(t))
    a = enc.get_lang_emb(["1", "2", "2"])
    b = enc.get_lang_emb(["2", "3", "1"])
    assert seen == ["1", "2", "3"]
    np.testing.assert_array_equal(a[0], b[2])
    np.testing.assert_array_equal(a[1], a[2])
