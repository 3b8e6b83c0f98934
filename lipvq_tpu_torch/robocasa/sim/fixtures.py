"""Parametric kitchen fixtures built on mujoco.MjSpec.

The port's copy of ``lipvq_tpu/robocasa/sim/fixtures.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

Counterpart of reference robocasa/models/fixtures/ (cabinets.py,
counter.py, microwave.py, sink.py, stove.py, others.py — ~8.4k LoC of
XML-asset-driven fixture classes). Here each fixture is a procedural
primitive-geom builder: ``build(spec, style)`` adds a MuJoCo body tree,
and the state APIs (set/get door state, knobs, handles, buttons) match
the reference's joint-fraction semantics:

- door fractions:      reference cabinets.py:208-217,334-390,523-590
- drawer slide:        reference cabinets.py:679-884
- microwave door/btns: reference microwave.py:29-147
- sink handle/spout:   reference sink.py:43-110
- stove knobs:         reference stove.py:76-160

Local fixture frame: origin at the footprint center with z=0 at the
fixture bottom; +x spans the width, +y points into the fixture (the
front face is at y=-d/2), yaw rotates local->world about +z.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

try:  # mujoco is available in the image; keep importable without it
    import mujoco
except ImportError:  # importable without mujoco
    mujoco = None


class FixtureType:
    """Fixture id enum (reference fixture.py:38-66)."""

    SINK = 1
    STOVE = 2
    MICROWAVE = 3
    COUNTER = 4
    CABINET = 5
    CABINET_TOP = 6
    DOOR_TOP_HINGE = 7
    DOOR_TOP_HINGE_SINGLE = 8
    DOOR_TOP_HINGE_DOUBLE = 9
    TOP_DRAWER = 10
    COFFEE_MACHINE = 11
    FRIDGE = 12
    DISHWASHER = 13
    HOOD = 14
    OVEN = 15
    TOASTER = 16
    STOOL = 17
    ISLAND = 18
    COUNTER_NON_CORNER = 19
    DINING_COUNTER = 20


def rot_z(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def yaw_quat(yaw: float) -> list:
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


class Fixture:
    """Base fixture (reference fixture.py:67-437).

    Args:
        name: unique scene name; all bodies/geoms/joints are prefixed.
        pos: world (x, y, z) of the local origin (footprint center,
            z at fixture bottom).
        size: full extents (w, d, h).
        yaw: rotation about +z; front face points along local -y.
    """

    nat_lang = "fixture"

    def __init__(self, name, pos, size, yaw=0.0):
        self.name = name
        self.pos = np.asarray(pos, dtype=float)
        self.size = np.asarray(size, dtype=float)
        self.yaw = float(yaw)

    # ---- frames -----------------------------------------------------
    def to_world(self, local) -> np.ndarray:
        return self.pos + rot_z(self.yaw) @ np.asarray(local, dtype=float)

    def to_local(self, world) -> np.ndarray:
        return rot_z(-self.yaw) @ (np.asarray(world, dtype=float) - self.pos)

    @property
    def width(self):
        return float(self.size[0])

    @property
    def depth(self):
        return float(self.size[1])

    @property
    def height(self):
        return float(self.size[2])

    @property
    def center(self) -> np.ndarray:
        """World center of the bounding box."""
        return self.to_world([0, 0, self.height / 2])

    def get_ext_sites(self, all_points=False, relative=False):
        """Exterior bbox corner points (reference fixture.py get_ext_sites)."""
        w, d, h = self.size / np.array([2, 2, 1])
        pts = [
            [sx * w, sy * d, sz * h]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (0, 1)
        ]
        if not all_points:
            pts = pts[:4]
        if relative:
            return [np.asarray(p) for p in pts]
        return [self.to_world(p) for p in pts]

    # interior box for obj_inside_of checks; override per class
    def interior_box(self):
        """-> (local_center, local_halfsize) of the usable interior."""
        w, d, h = self.size
        return np.array([0, 0, h / 2]), np.array([w / 2, d / 2, h / 2])

    def point_inside(self, world_point, margin=0.0) -> bool:
        """Point-in-interior test (reference object_utils.py:12-60)."""
        c, half = self.interior_box()
        p = self.to_local(world_point) - c
        return bool(np.all(np.abs(p) <= half + margin))

    # placement region: rectangle where objects may be sampled
    def sample_region(self, env=None, **kwargs):
        """-> (world_center_xyz_at_surface, (half_x, half_y)) in the
        fixture frame; consumers sample local offsets and call
        :meth:`to_world`."""
        c, half = self.interior_box()
        surface = np.array([c[0], c[1], c[2] - half[2]])
        return surface, (half[0], half[1])

    def build(self, spec, style):  # pragma: no cover - abstract
        raise NotImplementedError

    def update_state(self, env):
        """Per-step hook (reference fixture.py:245)."""

    # ---- mjspec helpers ---------------------------------------------
    def _root(self, spec):
        body = spec.worldbody.add_body(name=self.name, pos=list(self.pos))
        body.quat = yaw_quat(self.yaw)
        return body

    # Contact filtering: static fixture shells must not burn contacts
    # against each other (procedural fixtures may share faces), while
    # dynamic parts (doors, drawers, robot, objects) collide with
    # everything. collide(a,b) = (contype_a & conaffinity_b) |
    # (contype_b & conaffinity_a):
    #   static : contype=1, conaffinity=2   (never static-static)
    #   dynamic: contype=2, conaffinity=3
    @staticmethod
    def _mark(g, dynamic):
        g.contype = 2 if dynamic else 1
        g.conaffinity = 3 if dynamic else 2
        return g

    @staticmethod
    def _box(body, name, size, pos, rgba, group=0, density=400.0, dynamic=False):
        g = body.add_geom(
            name=name,
            type=mujoco.mjtGeom.mjGEOM_BOX,
            size=[max(s, 0.004) for s in size],
            pos=list(pos),
            rgba=list(rgba),
        )
        g.density = density
        g.group = group
        return Fixture._mark(g, dynamic)

    @staticmethod
    def _cyl(body, name, radius, halfheight, pos, rgba, euler=None, dynamic=False):
        g = body.add_geom(
            name=name,
            type=mujoco.mjtGeom.mjGEOM_CYLINDER,
            size=[radius, halfheight, 0],
            pos=list(pos),
            rgba=list(rgba),
        )
        if euler is not None:
            # assigning g.alt.euler does NOT persist through MjSpec
            # compilation (same binding trap as scalar joint attrs);
            # set the quaternion explicitly (XYZ euler order)
            cx, cy, cz = [math.cos(a / 2) for a in euler]
            sx, sy, sz = [math.sin(a / 2) for a in euler]
            g.quat = [
                cx * cy * cz + sx * sy * sz,
                sx * cy * cz - cx * sy * sz,
                cx * sy * cz + sx * cy * sz,
                cx * cy * sz - sx * sy * cz,
            ]
        return Fixture._mark(g, dynamic)


THICK = 0.018  # panel thickness used across fixtures


class Counter(Fixture):
    """Solid counter slab + base (reference counter.py).

    Placement region is the counter top (reference counter.py
    get_sample_region / Kitchen._get_placement_initializer usage).
    """

    nat_lang = "counter"

    def __init__(self, name, pos, size=(1.0, 0.65, 0.92), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        top_t = 0.02
        self._box(
            body,
            f"{self.name}_top",
            [w / 2, d / 2, top_t],
            [0, 0, h - top_t],
            style["counter"],
        )
        self._box(
            body,
            f"{self.name}_base",
            [w / 2 - 0.01, d / 2 - 0.02, (h - 2 * top_t) / 2],
            [0, 0, (h - 2 * top_t) / 2],
            style["cabinet"],
        )
        return body

    def interior_box(self):
        # "interior" of a counter = the volume above the top surface
        w, d, h = self.size
        return np.array([0, 0, h + 0.25]), np.array([w / 2, d / 2, 0.25])

    def sample_region(self, env=None, ref=None, loc=None, top_size=None, locs=None):
        """Counter-top region, optionally localized near ``ref``
        (reference counter.py get_sample_region + kitchen.py:684-878
        sample_region_kwargs threading)."""
        w, d, h = self.size
        cx = 0.0
        half_x = w / 2 - 0.03
        if ref is not None:
            # restrict to a window of the counter nearest to the ref fixture
            ref_local = self.to_local(ref.center)
            win = max((top_size[0] / 2 if top_size else 0.3), 0.3)
            cx = float(np.clip(ref_local[0], -w / 2 + win, w / 2 - win))
            half_x = win
            if loc == "left_right":
                # offset the window to one side of the ref fixture
                side = 1.0 if cx <= 0 else -1.0
                shift = win + getattr(ref, "width", 0.3) / 2
                cx = float(np.clip(cx + side * shift, -w / 2 + win, w / 2 - win))
        return np.array([cx, 0.0, h]), (half_x, d / 2 - 0.05)


class _DooredBox(Fixture):
    """Shared shell logic for cabinets/microwave: an open-front box."""

    def _shell(self, body, style, interior_rgba=None):
        w, d, h = self.size
        t = THICK
        col = style["cabinet"]
        inner = interior_rgba or col
        self._box(body, f"{self.name}_bottom", [w / 2, d / 2, t / 2], [0, 0, t / 2], inner)
        self._box(body, f"{self.name}_topp", [w / 2, d / 2, t / 2], [0, 0, h - t / 2], col)
        self._box(body, f"{self.name}_left", [t / 2, d / 2, h / 2], [-w / 2 + t / 2, 0, h / 2], col)
        self._box(body, f"{self.name}_right", [t / 2, d / 2, h / 2], [w / 2 - t / 2, 0, h / 2], col)
        self._box(body, f"{self.name}_back", [w / 2, t / 2, h / 2], [0, d / 2 - t / 2, h / 2], col)

    def interior_box(self):
        w, d, h = self.size
        t = THICK
        return (
            np.array([0, 0, h / 2]),
            np.array([w / 2 - t, d / 2 - t, h / 2 - t]),
        )

    def sample_region(self, env=None, **kwargs):
        w, d, h = self.size
        t = THICK
        return np.array([0.0, 0.0, t]), (w / 2 - 2 * t, d / 2 - 2 * t)


def _add_handle(body, name, kind, pos, rgba, vertical=True):
    """Door/drawer handle: bar or knob (reference handles.py)."""
    if kind == "knob":
        g = body.add_geom(
            name=name,
            type=mujoco.mjtGeom.mjGEOM_SPHERE,
            size=[0.015, 0, 0],
            pos=list(pos),
            rgba=list(rgba),
        )
    else:
        # bars are thicker than the gripper's minimum finger gap so a
        # full-force close clamps the bar instead of squeezing past it
        # vertical bars are short (6cm) so a top-grasping palm clears
        # the bar top while the fingers still span it
        size = [0.012, 0.012, 0.03] if vertical else [0.065, 0.012, 0.012]
        g = body.add_geom(
            name=name,
            type=mujoco.mjtGeom.mjGEOM_BOX,
            size=size,
            pos=list(pos),
            rgba=list(rgba),
        )
    return Fixture._mark(g, dynamic=True)


# hinge cabinets open to an 85deg door stop (real cabinet hinges stop
# short of 90: a panel shoved past the soft joint limit at 90deg digs
# into the adjacent fixture's front plane and friction-wedges there —
# observed as a door pinned at q=1.581 that no closing push could move)
DOOR_RANGE = (0.0, math.radians(85.0))


class SingleCabinet(_DooredBox):
    """One hinged door (reference cabinets.py:219-390).

    ``orientation``: "left" or "right" — which edge carries the hinge.
    """

    nat_lang = "cabinet"

    def __init__(self, name, pos, size=(0.5, 0.4, 0.92), yaw=0.0, orientation="right"):
        super().__init__(name, pos, size, yaw)
        self.orientation = orientation

    def door_joints(self):
        return [f"{self.name}_doorjoint"]

    def build(self, spec, style):
        body = self._root(spec)
        self._shell(body, style)
        w, d, h = self.size
        hx = (w / 2 - 0.005) * (1 if self.orientation == "right" else -1)
        # hinge on the panel FRONT plane: swinging never drives the
        # panel edge into the carcass (a hinge inside the wall jams)
        door = body.add_body(
            name=f"{self.name}_door", pos=[hx, -d / 2 - THICK - 0.007, 0]
        )
        # positive rotation swings the panel outward for either hinge side
        axis = [0, 0, 1] if self.orientation == "right" else [0, 0, -1]
        j = door.add_joint(
            name=f"{self.name}_doorjoint",
            type=mujoco.mjtJoint.mjJNT_HINGE,
            axis=axis,
            range=list(DOOR_RANGE),
            damping=2.0,
        )
        panel_cx = -hx  # panel spans the front face back from the hinge
        self._box(
            door,
            f"{self.name}_doorpanel",
            [w / 2 - 0.004, THICK / 2, h / 2 - 0.004],
            [panel_cx, THICK / 2, h / 2],
            style["door"],
            dynamic=True,
        )
        _add_handle(
            door,
            f"{self.name}_handle",
            style["handle_type"],
            [panel_cx * 1.8, -0.075, h / 2],
            style["handle"],
        )
        return body

    def set_door_state(self, min, max, env, rng):
        """Reference cabinets.py:334-362 — fraction of joint range."""
        lo, hi = DOOR_RANGE
        frac = rng.uniform(min, max)
        env.set_joint_qpos(f"{self.name}_doorjoint", lo + frac * (hi - lo))

    def get_door_state(self, env):
        lo, hi = DOOR_RANGE
        q = env.get_joint_qpos(f"{self.name}_doorjoint")
        return {"door": float(np.clip((q - lo) / (hi - lo), 0, 1))}

    @property
    def handle_name(self):
        return f"{self.name}_handle"


class HingeCabinet(_DooredBox):
    """Two hinged doors (reference cabinets.py:392-590)."""

    nat_lang = "cabinet"

    def __init__(self, name, pos, size=(1.0, 0.4, 0.92), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    def door_joints(self):
        return [f"{self.name}_leftdoorjoint", f"{self.name}_rightdoorjoint"]

    def build(self, spec, style):
        body = self._root(spec)
        self._shell(body, style)
        w, d, h = self.size
        for side, sign in (("left", -1), ("right", 1)):
            door = body.add_body(
                name=f"{self.name}_{side}door",
                pos=[sign * (w / 2 - 0.005), -d / 2 - THICK - 0.007, 0],
            )
            j = door.add_joint(
                name=f"{self.name}_{side}doorjoint",
                type=mujoco.mjtJoint.mjJNT_HINGE,
                axis=[0, 0, sign],
                range=list(DOOR_RANGE),
                damping=2.0,
            )
            panel_cx = -sign * (w / 4 - 0.005)
            self._box(
                door,
                f"{self.name}_{side}doorpanel",
                [w / 4 - 0.006, THICK / 2, h / 2 - 0.004],
                [panel_cx, THICK / 2, h / 2],
                style["door"],
                dynamic=True,
            )
            _add_handle(
                door,
                f"{self.name}_{side}handle",
                style["handle_type"],
                [panel_cx * 1.7, -0.075, h / 2],
                style["handle"],
            )
        return body

    def set_door_state(self, min, max, env, rng):
        """Reference cabinets.py:523-552 — each door gets its own draw."""
        lo, hi = DOOR_RANGE
        for jn in self.door_joints():
            frac = rng.uniform(min, max)
            env.set_joint_qpos(jn, lo + frac * (hi - lo))

    def get_door_state(self, env):
        lo, hi = DOOR_RANGE
        out = {}
        for side in ("left", "right"):
            q = env.get_joint_qpos(f"{self.name}_{side}doorjoint")
            out[f"{side}_door"] = float(np.clip((q - lo) / (hi - lo), 0, 1))
        return out

    @property
    def handle_name(self):
        return f"{self.name}_righthandle"


class OpenCabinet(Fixture):
    """Open shelves (reference cabinets.py:591-678)."""

    nat_lang = "shelves"

    def __init__(self, name, pos, size=(0.7, 0.4, 0.92), yaw=0.0, num_shelves=2):
        super().__init__(name, pos, size, yaw)
        self.num_shelves = num_shelves

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        col = style["cabinet"]
        t = THICK
        self._box(body, f"{self.name}_left", [t / 2, d / 2, h / 2], [-w / 2 + t / 2, 0, h / 2], col)
        self._box(body, f"{self.name}_right", [t / 2, d / 2, h / 2], [w / 2 - t / 2, 0, h / 2], col)
        self._box(body, f"{self.name}_back", [w / 2, t / 2, h / 2], [0, d / 2 - t / 2, h / 2], col)
        for i in range(self.num_shelves + 1):
            z = i * (h - t) / self.num_shelves + t / 2
            self._box(body, f"{self.name}_shelf{i}", [w / 2, d / 2, t / 2], [0, 0, z], col)
        return body

    def interior_box(self):
        w, d, h = self.size
        return np.array([0, 0, h / 2]), np.array([w / 2 - THICK, d / 2, h / 2])

    def sample_region(self, env=None, **kwargs):
        w, d, _ = self.size
        return np.array([0.0, 0.0, THICK]), (w / 2 - 2 * THICK, d / 2 - THICK)


class Drawer(Fixture):
    """Counter-height drawer unit (reference cabinets.py:679-884).

    The sliding box occupies the top of the unit (reference
    FixtureType.TOP_DRAWER) and slides out along local -y; state is the
    slide fraction of the travel range (reference cabinets.py:829-884).
    """

    nat_lang = "drawer"

    def __init__(self, name, pos, size=(0.6, 0.65, 0.92), yaw=0.0):
        super().__init__(name, pos, size, yaw)
        self.box_h = 0.20
        self.travel = 0.60 * self.depth

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        t = THICK
        col = style["cabinet"]
        bh = self.box_h
        z0 = h - bh  # bottom of the drawer cavity
        # solid base below the cavity + thin top slab above it
        self._box(body, f"{self.name}_base", [w / 2, d / 2, (z0 - t) / 2], [0, 0, (z0 - t) / 2], col)
        self._box(body, f"{self.name}_housetop", [w / 2, d / 2, t / 2], [0, 0, h - t / 2], style["counter"])
        self._box(body, f"{self.name}_houseleft", [t / 2, d / 2, bh / 2], [-w / 2 + t / 2, 0, z0 + bh / 2 - t], col)
        self._box(body, f"{self.name}_houseright", [t / 2, d / 2, bh / 2], [w / 2 - t / 2, 0, z0 + bh / 2 - t], col)
        self._box(body, f"{self.name}_houseback", [w / 2, t / 2, bh / 2], [0, d / 2 - t / 2, z0 + bh / 2 - t], col)
        self._box(body, f"{self.name}_housebot", [w / 2, d / 2, t / 2], [0, 0, z0 - t / 2], col)
        # sliding box inside the cavity
        box = body.add_body(name=f"{self.name}_box", pos=[0, 0, z0])
        j = box.add_joint(
            name=f"{self.name}_slidejoint",
            type=mujoco.mjtJoint.mjJNT_SLIDE,
            axis=[0, -1, 0],
            range=[0.0, self.travel],
            damping=3.0,
        )
        bw, bd = w / 2 - 2 * t, d / 2 - 1.5 * t
        ih = bh - 2.5 * t  # inner wall height
        # drawers ride on rollers: low-friction glides + light panels,
        # else dragging the slide needs ~60N and no gripper can pull it
        panels = [
            self._box(box, f"{self.name}_boxbot", [bw, bd, t / 2], [0, 0, t / 2], style["door"], dynamic=True),
            self._box(box, f"{self.name}_boxfront", [bw, t / 2, ih / 2], [0, -bd, t + ih / 2], style["door"], dynamic=True),
            self._box(box, f"{self.name}_boxback", [bw, t / 2, ih / 2], [0, bd, t + ih / 2], style["door"], dynamic=True),
            self._box(box, f"{self.name}_boxleft", [t / 2, bd, ih / 2], [-bw, 0, t + ih / 2], style["door"], dynamic=True),
            self._box(box, f"{self.name}_boxright", [t / 2, bd, ih / 2], [bw, 0, t + ih / 2], style["door"], dynamic=True),
        ]
        for g in panels:
            g.density = 120.0
            g.friction = [0.03, 0.002, 0.0001]
        # deep D-handle: 0.10 standoff puts the whole grasp volume in
        # free air (a straddling gripper's inner finger needs ~5cm of
        # clearance behind the bar), and low on the front so the palm
        # clears the countertop slab
        _add_handle(
            box,
            f"{self.name}_handle",
            style["handle_type"],
            [0, -bd - 0.10, t + ih / 5],
            style["handle"],
            vertical=False,
        )
        # handle struts connecting the bar to the drawer front
        for sx in (-0.05, 0.05):
            self._box(box, f"{self.name}_handlestrut{int(sx*100)}",
                      [0.006, 0.05, 0.006], [sx, -bd - 0.05, t + ih / 5],
                      style["handle"], dynamic=True)
        return body

    def set_door_state(self, min, max, env, rng):
        """Reference cabinets.py:829-857 (drawer reuses the door API)."""
        frac = rng.uniform(min, max)
        env.set_joint_qpos(f"{self.name}_slidejoint", frac * self.travel)

    def get_door_state(self, env):
        q = env.get_joint_qpos(f"{self.name}_slidejoint")
        return {"drawer": float(np.clip(q / self.travel, 0, 1))}

    def interior_box(self):
        w, d, h = self.size
        return (
            np.array([0, 0, h - self.box_h / 2]),
            np.array([w / 2 - 2 * THICK, d / 2 - 2 * THICK, self.box_h / 2]),
        )

    def sample_region(self, env=None, **kwargs):
        w, d, h = self.size
        return (
            np.array([0.0, 0.0, h - self.box_h + 2 * THICK]),
            (w / 2 - 3 * THICK, d / 2 - 3 * THICK),
        )

    @property
    def handle_name(self):
        return f"{self.name}_handle"



MICRO_DOOR_RANGE = (0.0, math.pi / 2)


class Microwave(_DooredBox):
    """Microwave with hinged door + start/stop buttons
    (reference microwave.py:7-160)."""

    nat_lang = "microwave"

    def __init__(self, name, pos, size=(0.55, 0.45, 0.35), yaw=0.0):
        super().__init__(name, pos, size, yaw)
        self._turned_on = False

    def build(self, spec, style):
        body = self._root(spec)
        metal = style["appliance"]
        self._shell(body, {**style, "cabinet": metal}, interior_rgba=[0.2, 0.2, 0.2, 1])
        w, d, h = self.size
        # control panel strip on the right of the front face
        panel_w = 0.10
        self._box(
            body,
            f"{self.name}_panel",
            [panel_w / 2, THICK / 2, h / 2],
            [w / 2 - panel_w / 2, -d / 2 - THICK / 2, h / 2],
            metal,
        )
        for bname, z in (("start_button", 0.60), ("stop_button", 0.40)):
            self._box(
                body,
                f"{self.name}_{bname}",
                [0.018, 0.008, 0.012],
                [w / 2 - panel_w / 2, -d / 2 - THICK - 0.006, z * h],
                [0.8, 0.2, 0.2, 1] if bname == "stop_button" else [0.2, 0.8, 0.2, 1],
            )
        # door hinged on the left edge, covering the opening left of the panel
        door = body.add_body(
            name=f"{self.name}_door", pos=[-w / 2, -d / 2 - THICK - 0.007, 0]
        )
        j = door.add_joint(
            name=f"{self.name}_microjoint",
            type=mujoco.mjtJoint.mjJNT_HINGE,
            axis=[0, 0, -1],
            range=list(MICRO_DOOR_RANGE),
            damping=2.0,
        )
        dw = (w - panel_w) / 2
        self._box(
            door,
            f"{self.name}_doorpanel",
            [dw - 0.004, THICK / 2, h / 2 - 0.004],
            [dw, THICK / 2, h / 2],
            [0.25, 0.25, 0.28, 1],
            dynamic=True,
        )
        _add_handle(
            door,
            f"{self.name}_door_handle",
            "bar",
            [2 * dw - 0.03, -0.05, h / 2],
            style["handle"],
        )
        # turntable tray
        self._cyl(body, f"{self.name}_tray", min(w, d) / 2 - 2 * THICK, 0.008,
                  [0, 0, THICK + 0.008], [0.9, 0.9, 0.92, 1])
        return body

    def set_door_state(self, min, max, env, rng):
        """Reference microwave.py:29-57 (hinge opens positive here)."""
        lo, hi = MICRO_DOOR_RANGE
        frac = rng.uniform(min, max)
        env.set_joint_qpos(f"{self.name}_microjoint", lo + frac * (hi - lo))

    def get_door_state(self, env):
        lo, hi = MICRO_DOOR_RANGE
        q = env.get_joint_qpos(f"{self.name}_microjoint")
        return {"door": float(np.clip((q - lo) / (hi - lo), 0, 1))}

    def get_state(self):
        return {"turned_on": self._turned_on}

    def update_state(self, env):
        """Button edge logic (reference microwave.py:96-130)."""
        start = env.check_gripper_contact(f"{self.name}_start_button")
        stop = env.check_gripper_contact(f"{self.name}_stop_button")
        door_open = self.get_door_state(env)["door"] > 0.005
        if door_open:
            self._turned_on = False
        else:
            if self._turned_on and stop:
                self._turned_on = False
            elif not self._turned_on and start:
                self._turned_on = True

    def gripper_button_far(self, env, button="start_button", th=0.15):
        """Reference microwave.py:132-147."""
        bpos = env.geom_xpos(f"{self.name}_{button}")
        return bool(np.linalg.norm(env.eef_pos() - bpos) > th)

    def sample_region(self, env=None, **kwargs):
        w, d, _ = self.size
        r = min(w, d) / 2 - 2 * THICK
        return np.array([0.0, 0.0, THICK + 0.016]), (r * 0.6, r * 0.6)

    @property
    def handle_name(self):
        return f"{self.name}_door_handle"


class Sink(Fixture):
    """Sink basin + faucet (reference sink.py:8-160).

    ``handle_joint`` (water on/off) and ``spout_joint`` (left/right)
    semantics match reference sink.py:43-110.
    """

    nat_lang = "sink"

    def __init__(self, name, pos, size=(0.65, 0.65, 0.92), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    @property
    def basin_depth(self):
        return 0.16

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        t = THICK
        bd = self.basin_depth
        col = style["appliance"]
        base = style["cabinet"]
        # cabinet base below the basin
        self._box(body, f"{self.name}_base", [w / 2, d / 2, (h - bd) / 2], [0, 0, (h - bd) / 2], base)
        # basin: bottom + 4 walls, open top flush with counter height
        bw, bdep = w / 2 - 0.05, d / 2 - 0.08
        z0 = h - bd
        self._box(body, f"{self.name}_basinbot", [bw, bdep, t / 2], [0, 0, z0 + t / 2], col)
        self._box(body, f"{self.name}_basinfront", [bw, t / 2, bd / 2], [0, -bdep, z0 + bd / 2], col)
        self._box(body, f"{self.name}_basinback", [bw, t / 2, bd / 2], [0, bdep, z0 + bd / 2], col)
        self._box(body, f"{self.name}_basinleft", [t / 2, bdep, bd / 2], [-bw, 0, z0 + bd / 2], col)
        self._box(body, f"{self.name}_basinright", [t / 2, bdep, bd / 2], [bw, 0, z0 + bd / 2], col)
        # spout tower on the back rim, swivels about z
        spout = body.add_body(name=f"{self.name}_spout", pos=[0, bdep + 0.03, h])
        sj = spout.add_joint(
            name=f"{self.name}_spout_joint",
            type=mujoco.mjtJoint.mjJNT_HINGE,
            axis=[0, 0, 1],
            range=[-math.pi, math.pi],
            damping=1.0,
        )
        self._cyl(spout, f"{self.name}_spout_up", 0.02, 0.12, [0, 0, 0.12], col, dynamic=True)
        self._cyl(
            spout,
            f"{self.name}_spout_arm",
            0.015,
            0.10,
            [0, -0.10, 0.24],
            col,
            euler=[math.pi / 2, 0, 0],
            dynamic=True,
        )
        spout.add_site(
            name=f"{self.name}_water",
            pos=[0, -0.20, 0.20],
            size=[0.012, 0.012, 0.012],
            rgba=[0.4, 0.6, 1.0, 0.0],
        )
        # handle lever beside the spout, rotates about z; raised well
        # above the basin rim so a gripper can straddle the lever bar
        handle = body.add_body(name=f"{self.name}_handle", pos=[0.12, bdep + 0.03, h + 0.08])
        hj = handle.add_joint(
            name=f"{self.name}_handle_joint",
            type=mujoco.mjtJoint.mjJNT_HINGE,
            axis=[0, 0, 1],
            range=[-math.pi, math.pi],
            damping=0.4,
        )
        self._box(handle, f"{self.name}_handlebar", [0.008, 0.09, 0.008], [0, -0.09, 0], style["handle"], dynamic=True)
        return body

    def set_handle_state(self, env, rng, mode="on"):
        """Reference sink.py:43-66."""
        assert mode in ("on", "off", "random")
        if mode == "random":
            mode = "on" if rng.uniform() < 0.5 else "off"
        val = 0.0 if mode == "off" else float(rng.uniform(0.40, 0.50))
        env.set_joint_qpos(f"{self.name}_handle_joint", val)

    def get_handle_state(self, env):
        """Reference sink.py:67-110 (mod-2pi windows)."""
        out = {}
        q = env.get_joint_qpos(f"{self.name}_handle_joint") % (2 * math.pi)
        if q < 0:
            q += 2 * math.pi
        out["handle_joint"] = q
        out["water_on"] = bool(0.40 < q < math.pi)
        sq = env.get_joint_qpos(f"{self.name}_spout_joint") % (2 * math.pi)
        if sq < 0:
            sq += 2 * math.pi
        out["spout_joint"] = sq
        if math.pi <= sq <= 2 * math.pi - math.pi / 6:
            out["spout_ori"] = "left"
        elif math.pi / 6 <= sq <= math.pi:
            out["spout_ori"] = "right"
        else:
            out["spout_ori"] = "center"
        return out

    def update_state(self, env):
        """Water site visibility (reference sink.py:26-41)."""
        on = self.get_handle_state(env)["water_on"]
        env.set_site_alpha(f"{self.name}_water", 0.5 if on else 0.0)

    def interior_box(self):
        w, d, h = self.size
        bd = self.basin_depth
        return (
            np.array([0, 0, h - bd / 2]),
            np.array([w / 2 - 0.06, d / 2 - 0.09, bd / 2 + 0.10]),
        )

    def sample_region(self, env=None, **kwargs):
        w, d, h = self.size
        return (
            np.array([0.0, 0.0, h - self.basin_depth + THICK]),
            (w / 2 - 0.10, d / 2 - 0.13),
        )


STOVE_LOCATIONS = ("front_left", "front_right", "rear_left", "rear_right")


class Stove(Fixture):
    """Range: 4 burners + 4 front knobs (reference stove.py:18-204)."""

    nat_lang = "stove"

    def __init__(self, name, pos, size=(0.72, 0.66, 0.92), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    @property
    def knob_joints(self):
        return {loc: f"{self.name}_knob_{loc}_joint" for loc in STOVE_LOCATIONS}

    def _burner_local(self, loc):
        w, d, h = self.size
        dx = w / 4 * (-1 if "left" in loc else 1)
        dy = d / 4 * (-0.8 if "front" in loc else 0.8)
        return np.array([dx, dy, h])

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        metal = style["appliance"]
        self._box(body, f"{self.name}_body", [w / 2, d / 2, h / 2], [0, 0, h / 2], metal)
        for loc in STOVE_LOCATIONS:
            bp = self._burner_local(loc)
            self._cyl(body, f"{self.name}_burner_{loc}", 0.09, 0.005, [bp[0], bp[1], h + 0.005], [0.1, 0.1, 0.1, 1])
            body.add_site(
                name=f"{self.name}_burner_on_{loc}",
                pos=[bp[0], bp[1], h + 0.013],
                size=[0.07, 0.004, 0.004],
                rgba=[1.0, 0.45, 0.1, 0.0],
            )
            # knob on the front face
            knob = body.add_body(
                name=f"{self.name}_knob_{loc}",
                pos=[bp[0] + (0.06 if "rear" in loc else -0.06), -d / 2, h - 0.10],
            )
            kj = knob.add_joint(
                name=f"{self.name}_knob_{loc}_joint",
                type=mujoco.mjtJoint.mjJNT_HINGE,
                axis=[0, 1, 0],
                range=[-2 * math.pi, 2 * math.pi],
                damping=0.3,
            )
            self._cyl(knob, f"{self.name}_knobcyl_{loc}", 0.022, 0.015, [0, -0.015, 0], style["handle"], euler=[math.pi / 2, 0, 0], dynamic=True)
            # radial tab (real knobs have a grip ridge): gives the
            # scripted expert a push surface to rotate the knob
            self._box(knob, f"{self.name}_knobtab_{loc}",
                      [0.007, 0.008, 0.04], [0, -0.02, -0.06],
                      style["handle"], dynamic=True)
        return body

    def set_knob_state(self, env, rng, knob, mode="on"):
        """Reference stove.py:109-134."""
        assert mode in ("on", "off")
        if mode == "off":
            val = 0.0
        elif rng.uniform() < 0.5:
            val = float(rng.uniform(0.50, math.pi / 2))
        else:
            val = float(rng.uniform(2 * math.pi - math.pi / 2, 2 * math.pi - 0.50))
        env.set_joint_qpos(f"{self.name}_knob_{knob}_joint", val)

    def get_knobs_state(self, env):
        """Reference stove.py:135-160."""
        out = {}
        for loc in STOVE_LOCATIONS:
            q = env.get_joint_qpos(f"{self.name}_knob_{loc}_joint") % (2 * math.pi)
            if q < 0:
                q += 2 * math.pi
            out[loc] = q
        return out

    def update_state(self, env):
        """Flame site visibility (reference stove.py:76-108)."""
        knobs = self.get_knobs_state(env)
        for loc, q in knobs.items():
            on = 0.35 <= abs(q) <= 2 * math.pi - 0.35
            env.set_site_alpha(f"{self.name}_burner_on_{loc}", 0.5 if on else 0.0)

    def sample_region(self, env=None, locs=None, **kwargs):
        w, d, h = self.size
        if locs:
            bp = self._burner_local(locs[0])
            return np.array([bp[0], bp[1], h + 0.01]), (0.05, 0.05)
        return np.array([0.0, 0.0, h + 0.01]), (w / 2 - 0.1, d / 2 - 0.1)

    def interior_box(self):
        w, d, h = self.size
        return np.array([0, 0, h + 0.15]), np.array([w / 2, d / 2, 0.15])


class CoffeeMachine(Fixture):
    """Coffee machine with dispenser + start button
    (reference others.py CoffeeMachine; check_receptacle_placement_for_pouring
    and gripper_button_far per reference)."""

    nat_lang = "coffee machine"

    def __init__(self, name, pos, size=(0.30, 0.35, 0.42), yaw=0.0):
        super().__init__(name, pos, size, yaw)
        self._turned_on = False

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        col = style["appliance"]
        # back tower
        self._box(body, f"{self.name}_tower", [w / 2, d / 4, h / 2], [0, d / 4, h / 2], col)
        # base platform (the receptacle rest)
        self._box(body, f"{self.name}_platform", [w / 2, d / 2, 0.01], [0, 0, 0.01], col)
        # dispenser head overhanging the platform
        self._box(body, f"{self.name}_head", [0.05, 0.09, 0.04], [0, -d / 8, h - 0.04], col)
        body.add_site(
            name=f"{self.name}_dispenser",
            pos=[0, -d / 8, h - 0.09],
            size=[0.01, 0.01, 0.01],
            rgba=[0.5, 0.3, 0.1, 0.0],
        )
        self._box(
            body,
            f"{self.name}_start_button",
            [0.015, 0.008, 0.01],
            [w / 2 - 0.05, -d / 2 + 0.18, h - 0.05],
            [0.2, 0.8, 0.2, 1],
        )
        return body

    def get_state(self):
        return {"turned_on": self._turned_on}

    def update_state(self, env):
        if env.check_gripper_contact(f"{self.name}_start_button"):
            self._turned_on = True

    def gripper_button_far(self, env, th=0.15):
        bpos = env.geom_xpos(f"{self.name}_start_button")
        return bool(np.linalg.norm(env.eef_pos() - bpos) > th)

    def check_receptacle_placement_for_pouring(self, env, obj_name, xy_thresh=0.06):
        """Object under the dispenser site (reference coffee_machine
        fixture: xy-distance + contact with the machine platform)."""
        site = env.site_xpos(f"{self.name}_dispenser")
        opos = env.object_pos(obj_name)
        xy_ok = np.linalg.norm(site[:2] - opos[:2]) < xy_thresh
        below_ok = opos[2] < site[2]
        return bool(xy_ok and below_ok)

    def sample_region(self, env=None, **kwargs):
        _, d, _ = self.size
        return np.array([0.0, -d / 8, 0.02]), (0.02, 0.02)

    def interior_box(self):
        w, d, h = self.size
        return np.array([0, -d / 8, h / 2]), np.array([w / 2, d / 4, h / 2])


class Fridge(_DooredBox):
    """Tall fridge with one hinged door (reference fridge.py, simplified)."""

    nat_lang = "fridge"

    def __init__(self, name, pos, size=(0.8, 0.7, 1.75), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    def door_joints(self):
        return [f"{self.name}_doorjoint"]

    def build(self, spec, style):
        body = self._root(spec)
        self._shell(body, {**style, "cabinet": style["appliance"]})
        w, d, h = self.size
        door = body.add_body(
            name=f"{self.name}_door", pos=[w / 2 - 0.005, -d / 2 - THICK - 0.007, 0]
        )
        j = door.add_joint(
            name=f"{self.name}_doorjoint",
            type=mujoco.mjtJoint.mjJNT_HINGE,
            axis=[0, 0, 1],
            range=list(DOOR_RANGE),
            damping=4.0,
        )
        self._box(
            door,
            f"{self.name}_doorpanel",
            [w / 2 - 0.006, THICK / 2, h / 2 - 0.004],
            [-(w / 2 - 0.006), THICK / 2, h / 2],
            style["appliance"],
            dynamic=True,
        )
        _add_handle(door, f"{self.name}_handle", "bar", [-(w - 0.09), -0.05, h * 0.55], style["handle"])
        return body

    set_door_state = SingleCabinet.set_door_state
    get_door_state = SingleCabinet.get_door_state


class Dishwasher(Fixture):
    """Front-panel appliance (nav target; reference dishwasher.py)."""

    nat_lang = "dishwasher"

    def __init__(self, name, pos, size=(0.6, 0.65, 0.92), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        self._box(body, f"{self.name}_body", [w / 2, d / 2, h / 2], [0, 0, h / 2], style["appliance"])
        _add_handle(body, f"{self.name}_handle", "bar", [0, -d / 2 - 0.03, h - 0.06], style["handle"], vertical=False)
        return body


class Hood(Fixture):
    """Vent hood above the stove (reference hood.py)."""

    nat_lang = "hood"

    def __init__(self, name, pos, size=(0.72, 0.45, 0.35), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        self._box(body, f"{self.name}_duct", [0.1, 0.1, h / 2], [0, d / 4, h / 2], style["appliance"])
        self._box(body, f"{self.name}_canopy", [w / 2, d / 2, 0.04], [0, 0, 0.04], style["appliance"])
        return body


class Stool(Fixture):
    """Seating stool beside an island / dining counter (reference
    models/fixtures/accessories.py Stool; used by multi-stage tasks
    only as a spatial reference, e.g. serve_steak.py:29)."""

    nat_lang = "stool"

    def __init__(self, name, pos, size=(0.38, 0.38, 0.62), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        wood = style["cabinet"]
        self._cyl(body, f"{self.name}_leg", 0.035, (h - 0.04) / 2, [0, 0, (h - 0.04) / 2], wood)
        self._cyl(body, f"{self.name}_seat", w / 2, 0.02, [0, 0, h - 0.02], style["counter"])
        return body

    def sample_region(self, env=None, **kwargs):
        w, d, h = self.size
        return np.array([0.0, 0.0, h + 0.005]), (w / 2 - 0.02, d / 2 - 0.02)


class Toaster(Fixture):
    """Counter-top toaster (reference models/fixtures/accessories.py
    Toaster; multi-stage tasks use it as a spatial reference,
    prepare_toast.py:21)."""

    nat_lang = "toaster"

    def __init__(self, name, pos, size=(0.28, 0.2, 0.2), yaw=0.0):
        super().__init__(name, pos, size, yaw)

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        col = style["appliance"]
        self._box(body, f"{self.name}_body", [w / 2, d / 2, h / 2], [0, 0, h / 2], col)
        # two slot lips on top
        for i, dx in enumerate((-w / 6, w / 6)):
            self._box(body, f"{self.name}_slot{i}", [w / 2 - 0.03, 0.004, 0.008],
                      [dx * 0 + 0, dx, h + 0.004], [0.12, 0.12, 0.13, 1])
        # side lever
        self._box(body, f"{self.name}_lever", [0.008, 0.02, 0.012],
                  [w / 2 + 0.008, 0, h * 0.6], style["handle"])
        return body

    def sample_region(self, env=None, **kwargs):
        w, d, h = self.size
        return np.array([0.0, 0.0, h + 0.005]), (0.03, 0.03)


class Wall(Fixture):
    nat_lang = "wall"

    def build(self, spec, style):
        body = self._root(spec)
        w, d, h = self.size
        self._box(body, f"{self.name}_geom", [w / 2, d / 2, h / 2], [0, 0, h / 2], style["wall"])
        return body


class Floor(Fixture):
    nat_lang = "floor"

    def build(self, spec, style):
        body = self._root(spec)
        w, d, _ = self.size
        self._box(body, f"{self.name}_geom", [w / 2, d / 2, 0.01], [0, 0, -0.01], style["floor"])
        return body


# FixtureType -> predicate over fixture instances
# (reference fixture.py fixture_is_type)
def fixture_is_type(fxtr: Fixture, fixture_id) -> bool:
    if isinstance(fixture_id, str):
        return fxtr.name == fixture_id or fixture_id in fxtr.name
    table = {
        FixtureType.SINK: (Sink,),
        FixtureType.STOVE: (Stove,),
        FixtureType.MICROWAVE: (Microwave,),
        FixtureType.COUNTER: (Counter,),
        FixtureType.CABINET: (SingleCabinet, HingeCabinet),
        FixtureType.CABINET_TOP: (SingleCabinet, HingeCabinet),
        FixtureType.DOOR_TOP_HINGE: (SingleCabinet, HingeCabinet, Microwave),
        FixtureType.DOOR_TOP_HINGE_SINGLE: (SingleCabinet,),
        FixtureType.DOOR_TOP_HINGE_DOUBLE: (HingeCabinet,),
        FixtureType.TOP_DRAWER: (Drawer,),
        FixtureType.COFFEE_MACHINE: (CoffeeMachine,),
        FixtureType.FRIDGE: (Fridge,),
        FixtureType.DISHWASHER: (Dishwasher,),
        FixtureType.HOOD: (Hood,),
        FixtureType.STOOL: (Stool,),
        FixtureType.TOASTER: (Toaster,),
        FixtureType.ISLAND: (Counter,),
        FixtureType.COUNTER_NON_CORNER: (Counter,),
        FixtureType.DINING_COUNTER: (Counter,),
    }
    classes = table.get(fixture_id)
    if classes is None:
        return False
    if not isinstance(fxtr, classes):
        return False
    if fixture_id == FixtureType.CABINET_TOP:
        # top cabinets sit above counter height (reference fixture.py)
        return fxtr.pos[2] > 1.2
    if fixture_id in (FixtureType.ISLAND, FixtureType.DINING_COUNTER):
        # free-standing counters (island / peninsula) double as dining
        # counters (reference fixture.py island/dining semantics)
        return getattr(fxtr, "is_island", False)
    if fixture_id == FixtureType.COUNTER:
        # plain COUNTER excludes islands only when wall counters exist;
        # reference tasks that want the island ask for ISLAND explicitly
        return True
    return True
