"""Baking activity tasks (reference
robocasa/environments/kitchen/multi_stage/baking/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files; the engine underneath is the first-party
MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/baking.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_fixture_contact,
    check_obj_in_receptacle,
    gripper_obj_far,
    obj_inside_of,
)


class CupcakeCleanup(Kitchen):
    """Reference baking/cupcake_cleanup.py:6-85."""

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
            "Move the fresh-baked cupcake off the tray onto the counter, "
            "and place the bowl used for mixing into the sink."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="cupcake",
                obj_groups="cupcake",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.6, 0.4)
                    ),
                    size=(0.3, 0.5),
                    pos=("ref", -1.0),
                    try_to_place_in="tray",
                ),
            ),
            dict(
                name="bowl",
                obj_groups="bowl",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.3, 0.5),
                    pos=("ref", -1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference cupcake_cleanup.py:78-85."""
        gripper_far = gripper_obj_far(self, "cupcake") and gripper_obj_far(self, "bowl")
        bowl_in_sink = obj_inside_of(self, "bowl", self.sink)
        cupcake_on_counter = check_obj_fixture_contact(self, "cupcake", self.counter)
        return gripper_far and bowl_in_sink and cupcake_on_counter


class OrganizeBakingIngredients(Kitchen):
    """Reference baking/organize_baking_ingredients.py:6-125."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Place the eggs and milk next to the bowl."
        return ep_meta

    def _get_obj_cfgs(self):
        region = dict(ref=self.sink, loc="left_right")
        return [
            dict(
                name="bowl", obj_groups="bowl", graspable=True,
                placement=dict(
                    fixture=self.counter, sample_region_kwargs=dict(region),
                    size=(0.40, 0.40), pos=(0.0, -1.0),
                ),
            ),
            dict(
                name="egg1", obj_groups="egg", graspable=True,
                placement=dict(
                    fixture=self.counter, sample_region_kwargs=dict(region),
                    size=(0.3, 0.3), pos=(-1.0, -0.4),
                ),
            ),
            dict(
                name="egg2", obj_groups="egg", graspable=True,
                placement=dict(
                    fixture=self.counter, sample_region_kwargs=dict(region),
                    size=(0.3, 0.3), pos=(-1.0, -0.4), offset=(0.2, 0.0),
                ),
            ),
            dict(
                name="milk", obj_groups="milk", graspable=True,
                placement=dict(
                    fixture=self.counter, sample_region_kwargs=dict(region),
                    size=(0.5, 0.5), pos=(1.0, -1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference organize_baking_ingredients.py:111-125."""
        th = 0.2
        bowl = self.object_pos("bowl")
        return (
            np.linalg.norm(bowl - self.object_pos("egg1")) < th
            and np.linalg.norm(bowl - self.object_pos("egg2")) < th
            and np.linalg.norm(bowl - self.object_pos("milk")) < th
        )


class PastryDisplay(Kitchen):
    """Reference baking/pastry_display.py:6-131."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Place the pastries on the plates."
        return ep_meta

    def _get_obj_cfgs(self):
        region = dict(ref=self.sink, loc="left_right")
        cfgs = []
        for i in (1, 2):
            cfgs.append(
                dict(
                    name=f"receptacle{i}", obj_groups="plate",
                    graspable=False, washable=True,
                    placement=dict(
                        fixture=self.counter, sample_region_kwargs=dict(region),
                        size=(0.40, 0.40), pos=("ref", -1.0),
                    ),
                )
            )
        for i, dx in ((1, 0.1), (2, -0.1)):
            cfgs.append(
                dict(
                    name=f"pastry{i}", obj_groups="pastry", graspable=True,
                    placement=dict(
                        fixture=self.counter, sample_region_kwargs=dict(region),
                        size=(0.30, 0.30), pos=("ref", -0.2), offset=(dx, 0.0),
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference pastry_display.py:112-131."""
        far = gripper_obj_far(self, "pastry1") and gripper_obj_far(self, "pastry2")
        p1r1 = check_obj_in_receptacle(self, "pastry1", "receptacle1")
        p1r2 = check_obj_in_receptacle(self, "pastry1", "receptacle2")
        p2r1 = check_obj_in_receptacle(self, "pastry2", "receptacle1")
        p2r2 = check_obj_in_receptacle(self, "pastry2", "receptacle2")
        return far and ((p1r1 and p2r2) or (p1r2 and p2r1))
