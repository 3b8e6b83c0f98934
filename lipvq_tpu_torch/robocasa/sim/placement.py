"""Collision-aware object placement samplers.

The port's copy of ``lipvq_tpu/robocasa/sim/placement.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

Counterpart of reference robocasa/utils/placement_samplers.py:19-622
(UniformRandomSampler / SequentialCompositeSampler): rejection-sample
object poses inside a fixture's sampling region, keeping horizontal
separation from already-placed objects.

The reference threads ``pos``/``offset``/``size``/``rotation`` through
each task's object cfg (kitchen.py:684-878); this module keeps those
knob names and semantics:

- ``size``: requested (x, y) extent of the inner sampling window,
  clipped to the fixture region (kitchen.py:733-744);
- ``pos``: per-axis placement of the inner window WITHIN the region's
  free space, in [-1, 1] — e.g. ``pos=(1, -0.3)`` shifts the window to
  the +x extreme and 30% toward -y; the draw is then uniform inside
  the window (kitchen.py:747-775 intra_offset semantics). None centers
  the window; "ref" means "aligned with the reference fixture" (region
  centering near a reference fixture is resolved by
  Fixture.sample_region, so "ref" also centers here);
- ``offset``: additive (x, y) local offset;
- ``margin``: shrink of the outer region before windowing
  (kitchen.py:728-730, default 0.04);
- ``rotation``: scalar/range/list-of-ranges for the yaw draw
  (reference placement_samplers.py:234-268); defaults to the
  reference's (-pi/4, pi/4) (kitchen.py:792).
"""

from __future__ import annotations

import numpy as np


class RandomizationError(RuntimeError):
    pass


def _draw_rotation(rng, rotation):
    if rotation is None:
        # reference default rotation window (kitchen.py:792)
        return float(rng.uniform(-np.pi / 4, np.pi / 4))
    if isinstance(rotation, (int, float)):
        return float(rotation)
    rotation = list(rotation)
    if rotation and isinstance(rotation[0], (list, tuple)):
        lo, hi = rotation[rng.integers(len(rotation))]
    else:
        lo, hi = rotation
    return float(rng.uniform(lo, hi))


def _axis_window(outer_half, inner_half, bias, offset):
    """-> (window_center, window_half) for one local axis.

    The inner window sits at ``bias`` in [-1, 1] of the outer region's
    free space (reference kitchen.py:770-775 ``intra_offset``);
    None/"ref" center it.
    """
    if bias is None or bias == "ref":
        bias = 0.0
    bias = float(np.clip(float(bias), -1.0, 1.0))
    return (outer_half - inner_half) * bias + offset, inner_half


def sample_object_placement(
    rng,
    fixture,
    obj,
    placed,
    size=(0.3, 0.3),
    pos=(None, None),
    offset=(0.0, 0.0),
    rotation=None,
    margin=0.04,
    ensure_object_boundary_in_range=True,
    ensure_valid_placement=True,
    sample_region_kwargs=None,
    max_attempts=200,
):
    """Rejection-sample a world pose for ``obj`` on/in ``fixture``.

    Returns (world_pos, yaw). Raises RandomizationError after
    ``max_attempts`` failed draws (reference
    placement_samplers.py:270-414; window math kitchen.py:723-792).
    """
    region_c, region_half = fixture.sample_region(**(sample_region_kwargs or {}))
    # outer region shrunk by margin, inner window clipped into it
    outer_x = max(region_half[0] - margin / 2, 0.0)
    outer_y = max(region_half[1] - margin / 2, 0.0)
    inner_x = min(size[0] / 2, outer_x) if size is not None else outer_x
    inner_y = min(size[1] / 2, outer_y) if size is not None else outer_y

    if pos is None:
        pos = (None, None)
    cx, half_x = _axis_window(outer_x, inner_x, pos[0], offset[0])
    cy, half_y = _axis_window(outer_y, inner_y, pos[1], offset[1])
    if ensure_object_boundary_in_range:
        half_x = max(half_x - obj.horizontal_radius, 0.0)
        half_y = max(half_y - obj.horizontal_radius, 0.0)

    for _ in range(max_attempts):
        lx = region_c[0] + cx + float(rng.uniform(-half_x, half_x))
        ly = region_c[1] + cy + float(rng.uniform(-half_y, half_y))
        yaw = _draw_rotation(rng, rotation)
        world = fixture.to_world([lx, ly, region_c[2] + 0.002])
        if not ensure_valid_placement:
            return world, yaw
        ok = True
        for other_pos, other_r in placed:
            dist = np.linalg.norm(world[:2] - np.asarray(other_pos)[:2])
            if dist < obj.horizontal_radius + other_r + 0.01:
                ok = False
                break
        if ok:
            return world, yaw
    raise RandomizationError(
        f"could not place {obj.name} on {fixture.name} after {max_attempts} tries"
    )


class SequentialCompositeSampler:
    """Places a list of object cfgs in order, accumulating collision
    state (reference placement_samplers.py:416-568)."""

    def __init__(self, rng):
        self.rng = rng
        self.placed = []  # [(world_pos, radius)]

    def place(self, fixture, obj, placement):
        kwargs = {
            k: placement[k]
            for k in (
                "size",
                "pos",
                "offset",
                "rotation",
                "margin",
                "ensure_object_boundary_in_range",
                "ensure_valid_placement",
                "sample_region_kwargs",
            )
            if k in placement
        }
        world, yaw = sample_object_placement(
            self.rng, fixture, obj, self.placed, **kwargs
        )
        self.placed.append((world, obj.horizontal_radius))
        return world, yaw
