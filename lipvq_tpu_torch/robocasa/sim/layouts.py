"""Procedural kitchen layouts and styles.

The port's copy of ``lipvq_tpu/robocasa/sim/layouts.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

Counterpart of reference robocasa/models/scenes/scene_registry.py
(LayoutType/StyleType enums, layout groups) + the 46 layout/style YAML
blueprints + scene_builder.py. The blueprints' *content* (mesh fixtures,
textures) is asset-bound and unavailable, so each layout here is a
procedural template over the primitive fixtures in
:mod:`lipvq_tpu_torch.robocasa.sim.fixtures`: wall runs of counters with
appliances inserted, top rows of cabinets, and an island for the
island-group layouts.

Layout ids and group semantics match reference scene_registry.py:9-36;
style ids match reference scene_registry.py:38-63 (palettes instead of
texture swaps — reference utils/texture_swap.py is asset-bound).
"""

from __future__ import annotations

import math

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import (
    CoffeeMachine,
    Counter,
    Dishwasher,
    Drawer,
    Floor,
    Fridge,
    HingeCabinet,
    Hood,
    Microwave,
    OpenCabinet,
    SingleCabinet,
    Sink,
    Stool,
    Stove,
    Toaster,
    Wall,
    rot_z,
)

# ---- layout registry (reference scene_registry.py:9-36) -------------
LAYOUT_NAMES = {
    0: "one_wall_small",
    1: "one_wall_large",
    2: "l_shaped_small",
    3: "l_shaped_large",
    4: "galley",
    5: "u_shaped_small",
    6: "u_shaped_large",
    7: "g_shaped_small",
    8: "g_shaped_large",
    9: "wraparound",
}

LAYOUT_GROUPS_TO_IDS = {
    -1: list(range(10)),  # all
    -2: [0, 2, 4, 5, 7],  # no island
    -3: [1, 3, 6, 8, 9],  # island
    -4: [1, 3, 6, 7, 8, 9],  # dining
}

# ---- style registry (reference scene_registry.py:38-63) -------------
STYLE_NAMES = {
    0: "industrial",
    1: "scandanavian",
    2: "coastal",
    3: "modern_1",
    4: "modern_2",
    5: "traditional_1",
    6: "traditional_2",
    7: "farmhouse",
    8: "rustic",
    9: "mediterranean",
    10: "transitional_1",
    11: "transitional_2",
}

STYLE_GROUPS_TO_IDS = {-1: list(range(12))}


def _palette(counter, cabinet, door, floor, wall, appliance, handle, handle_type):
    return dict(
        counter=counter,
        cabinet=cabinet,
        door=door,
        floor=floor,
        wall=wall,
        appliance=appliance,
        handle=handle,
        handle_type=handle_type,
    )


STYLES = {
    0: _palette([0.35, 0.35, 0.37, 1], [0.25, 0.25, 0.27, 1], [0.3, 0.3, 0.32, 1],
                [0.45, 0.42, 0.38, 1], [0.55, 0.52, 0.5, 1], [0.5, 0.5, 0.52, 1],
                [0.15, 0.15, 0.15, 1], "bar"),
    1: _palette([0.92, 0.92, 0.9, 1], [0.96, 0.96, 0.95, 1], [0.98, 0.98, 0.97, 1],
                [0.8, 0.72, 0.6, 1], [0.95, 0.95, 0.93, 1], [0.75, 0.75, 0.77, 1],
                [0.2, 0.2, 0.2, 1], "bar"),
    2: _palette([0.9, 0.9, 0.88, 1], [0.65, 0.78, 0.85, 1], [0.7, 0.82, 0.88, 1],
                [0.85, 0.8, 0.7, 1], [0.93, 0.96, 0.97, 1], [0.8, 0.8, 0.82, 1],
                [0.9, 0.9, 0.92, 1], "knob"),
    3: _palette([0.2, 0.2, 0.22, 1], [0.85, 0.85, 0.87, 1], [0.88, 0.88, 0.9, 1],
                [0.55, 0.55, 0.57, 1], [0.9, 0.9, 0.9, 1], [0.6, 0.6, 0.62, 1],
                [0.1, 0.1, 0.1, 1], "bar"),
    4: _palette([0.95, 0.95, 0.97, 1], [0.3, 0.32, 0.35, 1], [0.32, 0.35, 0.38, 1],
                [0.7, 0.7, 0.72, 1], [0.88, 0.89, 0.9, 1], [0.55, 0.55, 0.58, 1],
                [0.85, 0.85, 0.88, 1], "bar"),
    5: _palette([0.75, 0.68, 0.55, 1], [0.6, 0.45, 0.3, 1], [0.63, 0.48, 0.33, 1],
                [0.65, 0.55, 0.42, 1], [0.9, 0.87, 0.8, 1], [0.5, 0.5, 0.52, 1],
                [0.35, 0.25, 0.15, 1], "knob"),
    6: _palette([0.8, 0.75, 0.65, 1], [0.5, 0.35, 0.22, 1], [0.53, 0.38, 0.25, 1],
                [0.6, 0.5, 0.38, 1], [0.88, 0.85, 0.78, 1], [0.45, 0.45, 0.48, 1],
                [0.7, 0.6, 0.3, 1], "knob"),
    7: _palette([0.88, 0.86, 0.8, 1], [0.93, 0.93, 0.9, 1], [0.95, 0.95, 0.93, 1],
                [0.75, 0.65, 0.5, 1], [0.92, 0.92, 0.88, 1], [0.35, 0.35, 0.37, 1],
                [0.25, 0.25, 0.25, 1], "bar"),
    8: _palette([0.65, 0.55, 0.4, 1], [0.55, 0.42, 0.28, 1], [0.58, 0.45, 0.3, 1],
                [0.55, 0.45, 0.33, 1], [0.82, 0.78, 0.7, 1], [0.42, 0.42, 0.45, 1],
                [0.3, 0.22, 0.12, 1], "knob"),
    9: _palette([0.85, 0.82, 0.75, 1], [0.35, 0.5, 0.65, 1], [0.38, 0.53, 0.68, 1],
                [0.78, 0.68, 0.5, 1], [0.94, 0.92, 0.86, 1], [0.6, 0.6, 0.63, 1],
                [0.75, 0.55, 0.3, 1], "knob"),
    10: _palette([0.82, 0.82, 0.84, 1], [0.55, 0.55, 0.57, 1], [0.58, 0.58, 0.6, 1],
                 [0.68, 0.66, 0.62, 1], [0.9, 0.9, 0.9, 1], [0.58, 0.58, 0.6, 1],
                 [0.4, 0.4, 0.42, 1], "bar"),
    11: _palette([0.9, 0.88, 0.85, 1], [0.7, 0.7, 0.72, 1], [0.73, 0.73, 0.75, 1],
                 [0.72, 0.68, 0.62, 1], [0.92, 0.92, 0.9, 1], [0.62, 0.62, 0.64, 1],
                 [0.3, 0.3, 0.32, 1], "bar"),
}


CTR_H = 0.92  # counter height
CTR_D = 0.65  # counter depth
TOP_Z = 1.45  # bottom of the wall-cabinet row
TOP_D = 0.40  # wall-cabinet depth


class _WallRun:
    """Sequentially lays fixtures along a wall.

    origin = world position of the run's left end (facing the wall);
    yaw = wall orientation (fixture backs point along R(yaw)@[0,1,0]).
    """

    def __init__(self, fixtures, origin, yaw, prefix):
        self.fixtures = fixtures
        self.origin = np.asarray(origin, dtype=float)
        self.yaw = float(yaw)
        self.prefix = prefix
        self.cursor = 0.0
        self.top_cursor = 0.0
        self._n = 0

    def _place(self, cls, width, depth, z, cursor, **kwargs):
        local = np.array([cursor + width / 2, -depth / 2, z])
        pos = self.origin + rot_z(self.yaw) @ local
        self._n += 1
        name = kwargs.pop("name", f"{self.prefix}_{cls.__name__.lower()}_{self._n}")
        fx = cls(name, pos, yaw=self.yaw, **kwargs)
        # the run dictates the footprint; keep the class default height
        fx.size = np.array([width, depth, fx.size[2]])
        self.fixtures.append(fx)
        return fx

    def add(self, cls, width, depth=CTR_D, **kwargs):
        fx = self._place(cls, width, depth, 0.0, self.cursor, **kwargs)
        self.cursor += width
        return fx

    def add_top(self, cls, width, depth=TOP_D, z=TOP_Z, **kwargs):
        fx = self._place(cls, width, depth, z, self.top_cursor, **kwargs)
        fx.pos[2] = z
        self.top_cursor += width
        return fx

    def skip_top(self, width):
        self.top_cursor += width


def _bottom_standard(run, sink_first=True, with_dishwasher=True, with_fridge=True):
    """A standard bottom row: counters + sink + drawer + stove (+fridge)."""
    run.add(Counter, 0.7)
    if sink_first:
        sink = run.add(Sink, 0.7)
        run.add(Drawer, 0.6)
    else:
        run.add(Drawer, 0.6)
        sink = run.add(Sink, 0.7)
    run.add(Counter, 0.6)
    stove = run.add(Stove, 0.72)
    run.add(Counter, 0.7)
    if with_dishwasher:
        run.add(Dishwasher, 0.6)
    if with_fridge:
        run.add(Fridge, 0.8, depth=0.7)
    return sink, stove


def _top_standard(run, stove, micro=True):
    """Wall cabinets over the bottom row; hood over the stove; the
    microwave slots into the top row (reference one_wall_small.yaml
    top_row)."""
    # corner cabinet hinges AWAY from the corner (orientation="right"):
    # hinged into the corner, the open panel's outer face points at the
    # side wall and no manipulator vantage exists to push it shut
    run.add_top(SingleCabinet, 0.5, orientation="right")
    run.add_top(HingeCabinet, 1.0)
    if micro:
        # the microwave sits 0.10 proud of the cabinet row; leave
        # door-swing clearance so flush-hinged neighbor doors don't
        # clip its front corners
        run.skip_top(0.07)
        mw = run.add_top(Microwave, 0.55, depth=0.45)
        run.skip_top(0.07)
    else:
        mw = None
    run.add_top(HingeCabinet, 0.9)
    # hood above the stove: same x as the stove, pushed onto the wall line
    hood = Hood(f"{run.prefix}_hood", np.array(stove.pos, dtype=float), yaw=run.yaw)
    hood.pos[2] = TOP_Z + 0.40
    hood.pos = hood.pos + rot_z(run.yaw) @ np.array([0, CTR_D / 2 - 0.45 / 2, 0])
    hood.size = np.array([0.72, 0.45, 0.35])
    run.fixtures.append(hood)
    run.add_top(OpenCabinet, 0.7, num_shelves=2)
    return mw


def _coffee_machine(fixtures, counters, rng_like=None):
    """Place the coffee machine on the widest counter's top."""
    counter = max(counters, key=lambda c: c.width)
    pos = counter.to_world([counter.width / 2 - 0.25, 0.08, counter.height])
    cm = CoffeeMachine("coffee_machine", pos, yaw=counter.yaw)
    fixtures.append(cm)
    return cm


def _room(fixtures, width, depth, style_unused=None):
    fixtures.append(Wall("wall_main", [width / 2, 0.06, 0], (width, 0.12, 2.6), yaw=0.0))
    fixtures.append(Wall("wall_left", [-0.06, -depth / 2, 0], (depth, 0.12, 2.6), yaw=math.pi / 2))
    fixtures.append(Wall("wall_right", [width + 0.06, -depth / 2, 0], (depth, 0.12, 2.6), yaw=math.pi / 2))
    fixtures.append(Floor("floor", [width / 2, -depth / 2, 0], (width, depth, 0.02)))


def _island(fixtures, x, y, w=1.6, d=0.9):
    isl = Counter("island", [x, y, 0], (w, d, CTR_H), yaw=math.pi)
    isl.is_island = True
    fixtures.append(isl)
    _stools(fixtures, isl)
    return isl


def _stools(fixtures, counter, n=2):
    """Two stools on the counter's front (seating) side — dining
    layouts put seating at islands/peninsulas (reference layout YAMLs
    with stool fixtures; tasks reference them via FixtureType.STOOL)."""
    for i in range(n):
        dx = (i - (n - 1) / 2) * 0.55
        pos = counter.to_world([dx, -counter.depth / 2 - 0.28, 0.0])
        pos[2] = 0.0
        fixtures.append(
            Stool(f"{counter.name}_stool_{i + 1}", pos, yaw=counter.yaw)
        )


def _toaster(fixtures, counters):
    """Toaster on the second-widest counter, off-center (reference
    layouts place it as a counter accessory)."""
    ranked = sorted(counters, key=lambda c: -c.width)
    counter = ranked[1] if len(ranked) > 1 else ranked[0]
    pos = counter.to_world([-counter.width / 2 + 0.22, 0.12, counter.height])
    fixtures.append(Toaster("toaster", pos, yaw=counter.yaw))


def _one_wall(length, island):
    fixtures = []
    room_d = 3.2 if island else 2.8
    _room(fixtures, length, room_d)
    run = _WallRun(fixtures, [0.0, 0.0, 0.0], 0.0, "main")
    sink, stove = _bottom_standard(run)
    _top_standard(run, stove)
    counters = [f for f in fixtures if type(f) is Counter]
    _coffee_machine(fixtures, counters)
    _toaster(fixtures, counters)
    if island:
        _island(fixtures, length / 2, -1.9)
    return fixtures


CORNER = 1.0  # corner clearance so side-wall fixtures don't collide
# with the main run's standing zone (reference layouts leave corners
# to blind cabinets for the same reason)


def _l_shaped(length, island):
    fixtures = []
    room_d = 4.4 if island else 3.8
    _room(fixtures, length, room_d)
    run = _WallRun(fixtures, [0.0, 0.0, 0.0], 0.0, "main")
    sink, stove = _bottom_standard(run, with_fridge=False)
    _top_standard(run, stove)
    # left wall run (fronts face +x), far end toward the corner,
    # stopping CORNER short of the main wall
    run2 = _WallRun(fixtures, [0.0, -room_d + 0.4, 0.0], math.pi / 2, "left")
    run2.add(Fridge, 0.8, depth=0.7)
    run2.add(Counter, 0.9)
    run2.add(Drawer, 0.6)
    # top row clears the full-height fridge plus door-swing clearance
    # (a flush top cabinet's door sweeps a plane that clips the deeper
    # fridge front — and the cabinet body would sit inside the fridge)
    run2.skip_top(0.8 + 0.08)
    run2.add_top(HingeCabinet, 1.0)
    run2.add_top(SingleCabinet, 0.5)
    counters = [f for f in fixtures if type(f) is Counter]
    _coffee_machine(fixtures, counters)
    _toaster(fixtures, counters)
    if island:
        _island(fixtures, length / 2 + 0.6, -2.4)
    return fixtures


def _galley(length):
    fixtures = []
    room_d = 2.6
    _room(fixtures, length, room_d)
    run = _WallRun(fixtures, [0.0, 0.0, 0.0], 0.0, "main")
    sink, stove = _bottom_standard(run, with_fridge=False)
    _top_standard(run, stove)
    # opposite wall (yaw=pi), runs right-to-left in world x
    run2 = _WallRun(fixtures, [length, -room_d, 0.0], math.pi, "opp")
    run2.add(Fridge, 0.8, depth=0.7)
    run2.add(Counter, 1.2)
    run2.add(Drawer, 0.6)
    run2.add(Counter, 0.9)
    run2.skip_top(0.8 + 0.08)  # clear the full-height fridge (see _l_shaped)
    run2.add_top(HingeCabinet, 1.0)
    run2.add_top(OpenCabinet, 0.7, num_shelves=2)
    counters = [f for f in fixtures if type(f) is Counter]
    _coffee_machine(fixtures, counters)
    _toaster(fixtures, counters)
    return fixtures


def _u_shaped(length, island):
    fixtures = _l_shaped(length, island=False)
    # right wall run (fronts face -x), starting CORNER below the main
    # wall so the corner standing zones stay clear
    run3 = _WallRun(fixtures, [length, -CORNER, 0.0], -math.pi / 2, "right")
    run3.add(Counter, 1.0)
    run3.add(Drawer, 0.6)
    run3.add(Counter, 0.8)
    run3.add_top(HingeCabinet, 0.9)
    if island:
        _island(fixtures, length / 2, -2.6)
    return fixtures


def _g_shaped(length, island):
    fixtures = _u_shaped(length, island=False)
    # peninsula off the right wall
    pen = Counter("peninsula", [length - 1.9, -2.8, 0], (1.4, 0.65, CTR_H), yaw=math.pi)
    pen.is_island = True
    fixtures.append(pen)
    _stools(fixtures, pen)
    if island:
        _island(fixtures, length / 2 - 0.6, -2.2, w=1.4)
    return fixtures


def _wraparound(length):
    fixtures = _u_shaped(length, island=True)
    return fixtures


def build_layout(layout_id):
    """-> list[Fixture] for the given layout id."""
    if layout_id == 0:
        return _one_wall(5.6, island=False)
    if layout_id == 1:
        return _one_wall(6.4, island=True)
    if layout_id == 2:
        return _l_shaped(5.0, island=False)
    if layout_id == 3:
        return _l_shaped(5.8, island=True)
    if layout_id == 4:
        return _galley(5.2)
    if layout_id == 5:
        return _u_shaped(5.0, island=False)
    if layout_id == 6:
        return _u_shaped(6.0, island=True)
    if layout_id == 7:
        return _g_shaped(5.2, island=False)
    if layout_id == 8:
        return _g_shaped(6.0, island=True)
    if layout_id == 9:
        return _wraparound(6.2)
    raise ValueError(f"unknown layout id {layout_id}")


def unpack_layout_ids(layout_ids):
    """Resolve ids/groups to concrete layout ids (reference
    scene_registry.unpack_layout_ids)."""
    if layout_ids is None:
        layout_ids = -1
    if isinstance(layout_ids, int):
        layout_ids = [layout_ids]
    out = []
    for lid in layout_ids:
        if lid < 0:
            out.extend(LAYOUT_GROUPS_TO_IDS[lid])
        else:
            out.append(lid)
    return sorted(set(out))


def unpack_style_ids(style_ids):
    if style_ids is None:
        style_ids = -1
    if isinstance(style_ids, int):
        style_ids = [style_ids]
    out = []
    for sid in style_ids:
        if sid < 0:
            out.extend(STYLE_GROUPS_TO_IDS[sid])
        else:
            out.append(sid)
    return sorted(set(out))
