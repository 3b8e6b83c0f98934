"""The launch plan of the lookup kernels (``plan_lookup``), on the CPU: which
tile configuration, how many CTAs, and which codes each split covers."""

import pytest

from lipvq_tpu_torch.ops.vq_lookup import (
    LARGE,
    MEDIUM,
    SMALL,
    TC,
    TC_MAX_D,
    TC_MAX_N,
    TC_TILE,
    TILE_SHAPES,
    plan_lookup,
)

H100_SMS = 132
SHAPES = [(160, 1024), (500, 1024), (1 << 20, 1024), (1, 1), (63, 65), (65, 1024),
          (4097, 1), (4097, 1024), (33792, 1024), (33793, 65), (1 << 20, 1)]


@pytest.mark.parametrize("b,n", SHAPES)
def test_plan_covers_every_code_once(b, n):
    plan = plan_lookup(b, n, H100_SMS)
    rows, codes = TILE_SHAPES[plan.config]
    assert plan.codes_per_split % codes == 0
    assert plan.row_tiles * rows >= b > (plan.row_tiles - 1) * rows
    seen = []
    for s in range(plan.splits):
        split = range(s * plan.codes_per_split, min(n, (s + 1) * plan.codes_per_split))
        assert len(split) > 0, f"split {s} is empty"
        seen.extend(split)
    assert seen == list(range(n))


@pytest.mark.parametrize("b,n,config", [(1 << 20, 1024, LARGE), (160, 1024, SMALL),
                                        (256, 1024, SMALL), (257, 1024, MEDIUM),
                                        (500, 1024, MEDIUM), (33664, 1024, MEDIUM),
                                        (33665, 1024, LARGE), (4097, 65, MEDIUM)])
def test_plan_picks_the_configuration_by_grid_size(b, n, config):
    plan = plan_lookup(b, n, H100_SMS)
    assert plan.config == config
    if config == LARGE:
        assert plan.splits == 1 and plan.ctas >= 2 * H100_SMS


@pytest.mark.parametrize("b", [160, 500])
def test_plan_gives_every_sm_a_cta_at_served_and_train_rows(b):
    assert plan_lookup(b, 1024, H100_SMS).ctas >= H100_SMS


def test_plan_follows_the_sm_count():
    """With one SM, two 128-row tiles already fill it and one MEDIUM tile
    gives it a CTA; the CUDA tests use that to run LARGE and MEDIUM at small
    B."""
    assert plan_lookup(129, 1024, 1).config == LARGE
    assert plan_lookup(128, 1024, 1).config == MEDIUM
    assert plan_lookup(1, 1, 1) == (MEDIUM, 1, 1, 64)


@pytest.mark.parametrize("b,n,d,config", [
    (1 << 16, 1024, 208, TC),     # a corpus chunk: the tensor-core path
    (1 << 20, 1024, 208, TC),     # a whole corpus array in one lookup
    (33665, 1024, 208, TC),       # the least B whose LARGE tiles give 132 SMs two CTAs
    (33664, 1024, 208, MEDIUM),
    (1 << 16, 1024, TC_MAX_D, TC),
    (1 << 16, 1024, TC_MAX_D + 1, LARGE),  # past the tensor-core tile's z limit
    (1 << 16, 1024, 791, LARGE),
    (1 << 16, TC_MAX_N, 208, TC),
    (1 << 16, TC_MAX_N + 1, 208, LARGE),  # past the codes its keys can name
    (8000, 1024, 791, MEDIUM),    # the profiler's train batch
    (8000, 1024, 208, MEDIUM),
    (160, 1024, 791, SMALL),      # the served request
    (160, 1024, 208, SMALL),
])
def test_plan_takes_the_tensor_core_path_where_large_runs_within_its_width(b, n, d, config):
    """K1 passes its width: the tensor-core path replaces LARGE (one code
    split, its codes covering N) for D <= TC_MAX_D and N <= TC_MAX_N; MEDIUM
    and SMALL are untouched, and so is every plan made without a width
    (K2's)."""
    plan = plan_lookup(b, n, H100_SMS, d)
    assert plan.config == config
    if config == TC:
        rows, codes = TC_TILE
        assert plan.splits == 1 and plan.codes_per_split >= n
        assert plan.row_tiles == -(-b // rows) and plan.codes_per_split % codes == 0
        assert plan_lookup(b, n, H100_SMS).config == LARGE
    else:
        assert plan == plan_lookup(b, n, H100_SMS)
