"""The plain version of K1's tensor-core path (``vq_nearest_certified``):
split-precision scores, the bound E, the per-row certificate over the
kernel's lists and K1's own fp32 chain where it cannot settle a row. Its ids
must equal the exact lookup wherever K1's do, exact ties included, and E
must cover every error measured in fp64."""

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.ops.vq_lookup import (
    k1_chain_distances,
    k1_code_norms,
    tc_bound,
    tc_norms,
    tc_scores,
    tc_split,
    vq_nearest_certified,
    vq_nearest_expand,
    vq_nearest_reference,
)

torch.set_num_threads(1)


def _dyadic(rng, shape):
    """k/8 with |k| < 256: every product and sum exact in fp32."""
    return (np.round(np.clip(rng.standard_normal(shape) * 8, -255, 255)) / 8).astype(np.float32)


def _latents(seed: int, rows: int, codes: int, d: int = 208):
    """LipVQ latents of 0.5 N(0, 1) actions under seeded encoder weights (two
    GELU layers, the Lipschitz-bounded sigmoid layer with its bounds near 3),
    the codebook the latents of other actions: sigmoid outputs close
    together, as the lowdim corpus cell's."""
    gen = torch.Generator().manual_seed(seed)
    w1, w2 = torch.randn(64, 12, generator=gen) / 12 ** 0.5, torch.randn(128, 64, generator=gen) / 8
    w = torch.randn(d, 128, generator=gen)
    ci = 3.0 + 0.3 * torch.randn(d, generator=gen)
    w = w * torch.clamp(torch.nn.functional.softplus(ci)[:, None] / w.abs().sum(1, keepdim=True),
                        max=1.0)
    gelu = torch.nn.functional.gelu

    def encode(x):
        return torch.sigmoid(gelu(gelu(x @ w1.T) @ w2.T) @ w.T)

    return (encode(0.5 * torch.randn(rows, 12, generator=gen)).contiguous(),
            encode(0.5 * torch.randn(codes, 12, generator=gen)).contiguous())


def _fixture(name):
    rng = np.random.default_rng(0)
    if name.startswith("gauss"):
        b, n, d = (int(v) for v in name[5:].split("x"))
        return rng.standard_normal((b, d), dtype=np.float32), \
            rng.standard_normal((n, d), dtype=np.float32)
    if name == "sigmoid400x256x32":
        sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
        return (sig(10.0 * rng.standard_normal((400, 32))).astype(np.float32),
                sig(10.0 * rng.standard_normal((256, 32))).astype(np.float32))
    return (np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32),
            np.asarray([[5, 5], [1, 0], [1, 0], [0, 1], [0, 1]], np.float32))


@pytest.mark.parametrize("name", ["gauss80x128x12", "gauss300x1024x208", "gauss512x256x64",
                                  "sigmoid400x256x32", "ties"])
def test_certified_equals_the_exact_lookup_on_the_fixtures(name):
    z, c = (torch.from_numpy(a) for a in _fixture(name))
    got = vq_nearest_certified(z, c)
    assert got.dtype == torch.int32
    assert torch.equal(got, vq_nearest_reference(z, c))
    assert torch.equal(got, vq_nearest_expand(z, c))
    if name == "ties":
        assert got.tolist() == [1, 3]


@pytest.mark.parametrize("copies", [2, 40])
def test_certified_duplicated_codes_take_the_lowest_index(copies):
    """Exact ties (dyadic values: K1's sums are exact): pairs of codes stay
    within the lists and are re-scored over the candidates; 40 copies of one
    code overflow every list, so those rows are re-scored over every code."""
    rng = np.random.default_rng(copies)
    c = _dyadic(rng, (96, 16))
    if copies == 2:
        c[1::2] = c[0::2]
    else:
        c[50:50 + copies - 1] = c[49]
    z = np.concatenate([c[::3] + _dyadic(rng, (32, 16)) / 64, _dyadic(rng, (32, 16))])
    z[:4] = c[49]
    zt, ct = torch.from_numpy(z), torch.from_numpy(c)
    got, (rescored, every) = vq_nearest_certified(zt, ct, counts=True)
    assert torch.equal(got, vq_nearest_reference(zt, ct))
    assert got[:4].tolist() == [48 if copies == 2 else 49] * 4
    assert rescored >= 4
    if copies == 40:
        assert every >= 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_certified_equidistant_rows_take_the_lowest_index(seed):
    """Rows at the exact midpoint of two codes (dyadic: the tie is exact in
    fp32) get the lower of the two."""
    rng = np.random.default_rng(seed)
    c = _dyadic(rng, (64, 8)) * 2
    i, j = rng.choice(64, size=(2, 16), replace=True)
    keep = i != j
    i, j = i[keep], j[keep]
    z = (c[i] + c[j]) / 2
    zt, ct = torch.from_numpy(z), torch.from_numpy(c)
    got = vq_nearest_certified(zt, ct)
    assert torch.equal(got, vq_nearest_reference(zt, ct))


def _planted(gap_in_e: float, rows: int = 48):
    """Rows whose two nearest codes are i and j, their distance gap set to
    ``gap_in_e`` times the row's bound at code i; every other code is far."""
    rng = np.random.default_rng(7)
    c = torch.from_numpy(rng.uniform(0.0, 1.0, (64, 208)).astype(np.float32))
    i = torch.arange(rows) % 32
    j = i + 32
    delta = (c[i] - c[j]).double()
    mu = c.mean(0)
    mid = ((c[i].double() + c[j].double()) / 2).float()
    e = tc_bound(tc_norms(mid, mu, rows=True), tc_norms(c, mu, rows=False), 208)
    gap = gap_in_e * e[torch.arange(rows), i]
    t = gap / (2.0 * (delta ** 2).sum(1))
    z = (mid.double() + t[:, None] * delta).float()
    return z, c, i


@pytest.mark.parametrize("gap_in_e,rescored", [(0.5, True), (1.0, True), (1.5, True),
                                               (4.0, False), (16.0, False)])
def test_certified_gaps_just_inside_and_outside_the_bound(gap_in_e, rescored):
    """A gap inside E + E leaves both codes candidates (re-scored by K1's
    chain); one well outside is certified with no fp32 work. Either way the
    id is the exact nearest (K1's own error here is far below E)."""
    z, c, i = _planted(gap_in_e)
    got, (n_rescored, every) = vq_nearest_certified(z, c, counts=True)
    assert torch.equal(got, vq_nearest_reference(z, c))
    assert torch.equal(got.long(), i)
    assert every == 0
    assert n_rescored == (z.shape[0] if rescored else 0)


def test_certified_saturated_sigmoid_latents():
    """Latents pinned at exactly 0 and 1 (sigmoid of large arguments)."""
    gen = torch.Generator().manual_seed(3)
    z = torch.sigmoid(200.0 * torch.randn(300, 64, generator=gen))
    c = torch.sigmoid(200.0 * torch.randn(128, 64, generator=gen))
    c[5] = 1.0
    z[:3] = 1.0
    assert bool(((z == 0) | (z == 1)).float().mean() > 0.5)
    got = vq_nearest_certified(z, c)
    assert torch.equal(got, vq_nearest_reference(z, c))
    assert got[:3].tolist() == [5, 5, 5]


@pytest.mark.parametrize("kind", ["latents", "gauss"])
@pytest.mark.parametrize("seed", list(range(6)))
def test_bound_covers_every_measured_error(kind, seed):
    """In fp64, for every (row, code): K1's chain distance less the split
    score less the row's constant (||zb||^2 - ||z||^2) lies within E, and
    so does K1's chain against the exact distance less ||z||^2."""
    if kind == "latents":
        z, c = _latents(seed, 48, 128)
    else:
        gen = torch.Generator().manual_seed(seed)
        z, c = torch.randn(48, 208, generator=gen), torch.randn(128, 208, generator=gen)
    scores, mu = tc_scores(z, c)
    codes = torch.arange(c.shape[0]).expand(z.shape[0], -1)
    d_k1 = k1_chain_distances(z, c, codes).double()
    zb = tc_split(z, mu)[0].double()
    z64 = z.double()
    shift = (zb ** 2).sum(1) - (z64 ** 2).sum(1)
    e = tc_bound(tc_norms(z, mu, rows=True), tc_norms(c, mu, rows=False), z.shape[1])
    err = (d_k1 - scores.double() - shift[:, None]).abs()
    assert bool((err <= e).all()), float((err / e).max())
    exact = ((z64[:, None] - c.double()[None]) ** 2).sum(-1) - (z64 ** 2).sum(1)[:, None]
    assert bool(((d_k1 - exact).abs() <= e).all())


def test_k1_code_norms_follow_the_kernels_chain():
    """cn as code_norms_kernel adds it: lane chains, then a butterfly; on
    dyadic values every sum is exact, so it equals the plain sum."""
    c = torch.from_numpy(_dyadic(np.random.default_rng(5), (40, 70)))
    assert torch.equal(k1_code_norms(c), (c.double() ** 2).sum(1).float())


@pytest.mark.parametrize("seed", [11, 12])
def test_certified_on_corpus_latents_equals_k1s_chain_everywhere(seed):
    """At the corpus cell's kind of latents most rows are certified or
    re-scored over a few candidates; every id is the one K1's chain picks
    over all codes."""
    z, c = _latents(seed, 256, 256)
    got, (rescored, every) = vq_nearest_certified(z, c, counts=True)
    codes = torch.arange(c.shape[0]).expand(z.shape[0], -1)
    d = k1_chain_distances(z, c, codes)
    best = d.min(1, keepdim=True).values
    want = torch.where(d == best, codes, c.shape[0]).min(1).values
    assert torch.equal(got.long(), want)
    assert 0 < rescored < z.shape[0]
    assert every <= rescored
