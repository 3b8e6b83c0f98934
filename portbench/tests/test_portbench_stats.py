"""The end-to-end metrics are taken over the whole window: the 95th
percentile over every request, each rate as all the window's work over all
its time, so a stall anywhere in the window moves them."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import common
from portbench.harness import driver as base
from portbench.tests.tiny import MIXES, config


def test_percentile_interpolates_over_every_value():
    rng = np.random.default_rng(0)
    xs = rng.random(357).tolist()
    assert common.percentile(xs, 95) == pytest.approx(float(np.percentile(xs, 95)))
    assert common.percentile([1.0], 95) == 1.0
    with pytest.raises(ValueError):
        common.percentile([], 95)


def _loop(latencies, elapsed):
    d = base.load("closed_loop").Driver(config("icl_lipvq_image"), MIXES["closed_loop"], 0, "cpu")
    d.record = [({}, None, None, x) for x in latencies]
    d.elapsed = elapsed
    return d.end_to_end()


def test_tail_and_rate_cover_the_whole_window():
    lat = [0.060] * 400
    base = _loop(lat, 40.0)
    assert base["request_p95_ms"] == pytest.approx(60.0)
    assert base["env_steps_per_s"] == pytest.approx(3 * 400 / 40.0)
    # 30 stalled requests at the end of the window: the tail and the rate move
    stalled = _loop(lat[:370] + [0.5] * 30, 40.0 + 30 * 0.44)
    assert stalled["request_p95_ms"] > 400
    assert stalled["env_steps_per_s"] < base["env_steps_per_s"]


@pytest.mark.parametrize("kind,key,per_unit", [("train", "train_samples_per_s", "batch_size"),
                                               ("corpus", "corpus_rows_per_s", "rows")])
def test_rates_are_work_over_time(kind, key, per_unit):
    d = base.load(kind).Driver(config("icl_lipvq_lowdim"), MIXES[kind], 0, "cpu")
    d.units, d.elapsed = 50, 10.0
    fast = d.end_to_end()[key]
    assert fast == pytest.approx(50 * MIXES[kind][per_unit] / 10.0)
    d.elapsed = 12.5  # the same work with a stall
    assert d.end_to_end()[key] < fast
