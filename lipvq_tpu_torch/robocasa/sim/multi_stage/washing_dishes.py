"""Washing Dishes activity tasks (reference
robocasa/environments/kitchen/multi_stage/washing_dishes/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/washing_dishes.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

import math

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_fixture_contact,
    check_obj_in_receptacle,
    gripper_obj_far,
    obj_inside_of,
)


class DryDishes(Kitchen):
    """Reference washing_dishes/dry_dishes.py:4-96."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the cup and bowl from the sink and place them on the "
            "counter for drying."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        cup_pos = tuple(self.rng.choice([(1.0, 1.0), (-1.0, 1.0)]))
        return [
            dict(
                name="obj1", obj_groups="cup", graspable=True, washable=True,
                placement=dict(fixture=self.sink, size=(0.1, 0.1), pos=cup_pos),
            ),
            dict(
                name="obj2", obj_groups="bowl", graspable=True, washable=True,
                placement=dict(
                    fixture=self.sink, size=(0.05, 0.05),
                    ensure_object_boundary_in_range=False,
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.30, 0.30), pos=("ref", -1.0), offset=(0.0, 0.30),
                ),
            ),
        ]

    def _check_success(self):
        """Reference dry_dishes.py:88-96."""
        on_counter = check_obj_fixture_contact(
            self, "obj1", self.counter
        ) and check_obj_fixture_contact(self, "obj2", self.counter)
        far = gripper_obj_far(self, "obj1") and gripper_obj_far(self, "obj2")
        return on_counter and far


class DryDrinkware(Kitchen):
    """Reference washing_dishes/dry_drinkware.py:5-146."""

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab, size=(0.6, 0.5))
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "A wet mug is on the counter and needs to be dried. "
            "Pick it up and place it upside down in the open cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.9, max=1, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        x_positions = [-1, 1]
        self.rng.shuffle(x_positions)
        return [
            dict(
                name="mug", obj_groups="mug",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.3, 0.3), pos=(x_positions[0], -1.0),
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.20), pos=(0.0, 1.0),
                ),
            ),
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    @staticmethod
    def _euler_from_quaternion(x, y, z, w):
        """Reference dry_drinkware.py:116-130."""
        t0 = 2.0 * (w * x + y * z)
        t1 = 1.0 - 2.0 * (x * x + y * y)
        roll_x = math.atan2(t0, t1)
        t2 = max(-1.0, min(1.0, 2.0 * (w * y - z * x)))
        pitch_y = math.asin(t2)
        t3 = 2.0 * (w * z + x * y)
        t4 = 1.0 - 2.0 * (y * y + z * z)
        yaw_z = math.atan2(t3, t4)
        return roll_x, pitch_y, yaw_z

    def _check_success(self):
        """Reference dry_drinkware.py:132-146: mug upside down
        (|yaw-about-x| > 3 in the reference's euler convention) and in
        contact with the cabinet."""
        w, x, y, z = self.object_quat("mug")
        mug_rot = self._euler_from_quaternion(x, y, z, w)
        return (
            gripper_obj_far(self, obj_name="mug")
            and np.abs(mug_rot[2]) > 3
            and check_obj_fixture_contact(self, "mug", self.cab)
        )


class PreSoakPan(Kitchen):
    """Reference washing_dishes/pre_soak_pan.py:4-87."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink, size=(0.6, 0.4))
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the pan and sponge and place them into the sink. "
            "Then turn on the water."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.sink.set_handle_state(mode="off", env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj1", obj_groups="pan", graspable=True, washable=True,
                max_size=(0.35, 0.45, None),
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.6, 0.4)
                    ),
                    size=(0.35, 0.55), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="obj2", obj_groups="sponge",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.3, 0.3), pos=("ref", -1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference pre_soak_pan.py:77-87."""
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        pan_in = obj_inside_of(self, "obj1", self.sink)
        sponge_in = obj_inside_of(self, "obj2", self.sink)
        return water_on and pan_in and sponge_in and gripper_obj_far(self, "obj1")


class SortingCleanup(Kitchen):
    """Reference washing_dishes/sorting_cleanup.py:4-134."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.sink)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the mug and place it in the sink. "
            "Pick the bowl and place it in the cabinet and then close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        # not fully open since it may come in contact with eef
        self.cab.set_door_state(min=0.5, max=0.6, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="mug", obj_groups="mug", graspable=True, washable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.4, 0.4), pos=("ref", -1),
                ),
            ),
            dict(
                name="bowl", obj_groups="bowl", graspable=True, washable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.5, 0.5)
                    ),
                    size=(0.7, 0.7), pos=("ref", -1),
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.30, 0.30), pos=(0, 1.0),
                ),
            ),
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference sorting_cleanup.py:119-134."""
        mug_in_sink = obj_inside_of(self, "mug", self.sink)
        bowl_in_cab = obj_inside_of(self, "bowl", self.cab)
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return mug_in_sink and bowl_in_cab and closed and gripper_obj_far(self, "mug")


class StackBowlsInSink(Kitchen):
    """Reference washing_dishes/stack_bowls.py:4-90."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Stack the bowls in the sink."
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.sink.set_handle_state(mode="off", env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name=f"receptacle{i}", obj_groups="bowl",
                graspable=True, washable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.50, 0.65), pos=("ref", -1.0),
                ),
            )
            for i in (1, 2)
        ]

    def _check_success(self):
        """Reference stack_bowls.py:68-90."""
        in1 = obj_inside_of(self, "receptacle1", self.sink)
        in2 = obj_inside_of(self, "receptacle2", self.sink)
        stacked = check_obj_in_receptacle(
            self, "receptacle2", "receptacle1"
        ) or check_obj_in_receptacle(self, "receptacle1", "receptacle2")
        far = gripper_obj_far(self, obj_name="receptacle1") and gripper_obj_far(
            self, obj_name="receptacle2"
        )
        return in1 and in2 and stacked and far
