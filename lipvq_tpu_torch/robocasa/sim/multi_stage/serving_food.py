"""Serving Food activity tasks (reference
robocasa/environments/kitchen/multi_stage/serving_food/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/serving_food.py``,
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
)


class DessertUpgrade(Kitchen):
    """Reference serving_food/dessert_upgrade.py:4-79."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER_NON_CORNER, size=(1.0, 0.4))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Move the dessert items from the plate to the tray."
        return ep_meta

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name="receptacle", obj_groups="tray", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(1.0, 0.4)),
                    size=(1, 0.4), pos=(0, -1),
                ),
            )
        ]
        for i in (1, 2):
            cfgs.append(
                dict(
                    name=f"dessert{i}", obj_groups="sweets", graspable=True,
                    placement=dict(
                        fixture=self.counter, size=(1, 0.4), pos=(0, -1),
                        try_to_place_in="plate",
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference dessert_upgrade.py:72-79."""
        sweets_on_tray = check_obj_in_receptacle(
            self, "dessert1", "receptacle"
        ) and check_obj_in_receptacle(self, "dessert2", "receptacle")
        return sweets_on_tray and gripper_obj_far(self, "receptacle")


class PanTransfer(Kitchen):
    """Reference serving_food/pan_transfer.py:4-120."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.init_robot_base_pos = self.stove
        self.dining_table = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.stove, size=(0.5, 0.5))
        )

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick up the pan and dump the vegetables in it onto the plate. "
            "Then return the pan to the stove."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="vegetable", obj_groups="vegetable",
                placement=dict(
                    fixture=self.stove, size=(0.05, 0.05),
                    ensure_object_boundary_in_range=False,
                    try_to_place_in="pan",
                    container_kwargs=dict(
                        rotation=[
                            (-3 * np.pi / 8, -np.pi / 4),
                            (np.pi / 4, 3 * np.pi / 8),
                        ],
                    ),
                ),
            ),
            dict(
                name="plate", obj_groups="plate", graspable=False,
                placement=dict(
                    fixture=self.dining_table,
                    sample_region_kwargs=dict(ref=FixtureType.STOOL),
                    size=(0.50, 0.50), pos=("ref", 1.0),
                ),
            ),
            dict(
                name="dstr_dining", obj_groups="all",
                exclude_obj_groups=["plate", "pan", "vegetable"],
                placement=dict(
                    fixture=self.dining_table, size=(0.30, 0.20), pos=(0.5, 0.5)
                ),
            ),
        ]

    def _check_success(self):
        """Reference pan_transfer.py:111-120."""
        veg_on_plate = check_obj_in_receptacle(self, "vegetable", "plate")
        pan_on_stove = check_obj_fixture_contact(
            self, "vegetable_container", self.stove
        )
        far = gripper_obj_far(self, "vegetable_container") and gripper_obj_far(
            self, "vegetable"
        )
        return veg_on_plate and pan_on_stove and far


class PlaceFoodInBowls(Kitchen):
    """Reference serving_food/place_food_in_bowls.py:4-168."""

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        food1 = self.get_obj_lang("food1")
        food2 = self.get_obj_lang("food2")
        ep_meta["lang"] = (
            "Pick both bowls and place them on the counter. "
            f"Then pick the {food1} and place it in one bowl and pick the "
            f"{food2} and place it in the other bowl."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="receptacle1", obj_groups="bowl", graspable=True,
                placement=dict(fixture=self.cab, size=(0.4, 0.4), pos=(-1.0, -1.0)),
            ),
            dict(
                name="receptacle2", obj_groups="bowl", graspable=True,
                placement=dict(fixture=self.cab, size=(0.4, 0.4), pos=(1.0, -1.0)),
            ),
            dict(
                name="food1", obj_groups="food_set1", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.50, 0.50), pos=("ref", -0.5),
                ),
            ),
            dict(
                name="food2", obj_groups="food_set1", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.50, 0.50), pos=("ref", -0.5), offset=(0.07, 0),
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.50, 0.20), pos=("ref", 1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference place_food_in_bowls.py:146-168."""
        far = gripper_obj_far(self, obj_name="food1") and gripper_obj_far(
            self, obj_name="food2"
        )
        f1r1 = check_obj_in_receptacle(self, "food1", "receptacle1")
        f1r2 = check_obj_in_receptacle(self, "food1", "receptacle2")
        f2r1 = check_obj_in_receptacle(self, "food2", "receptacle1")
        f2r2 = check_obj_in_receptacle(self, "food2", "receptacle2")
        bowls_on_counter = check_obj_fixture_contact(
            self, "receptacle1", self.counter
        ) and check_obj_fixture_contact(self, "receptacle2", self.counter)
        food_in_bowls = (f1r1 and f2r2) or (f1r2 and f2r1)
        return far and food_in_bowls and bowls_on_counter


class PrepareSoupServing(Kitchen):
    """Reference serving_food/prepare_soup_serving.py:4-108."""

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.cabinet = self.register_fixture_ref(
            "cab", dict(id=self.cab_id, ref=self.stove)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.stove)
        )
        self.init_robot_base_pos = self.cabinet

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Open the cabinet and move the ladle to the pot. Then close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cabinet.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="ladle", obj_groups="ladle", graspable=True,
                placement=dict(
                    fixture=self.cabinet, size=(0.50, 0.20), pos=(0, -1.0),
                    rotation=(np.pi / 2 - np.pi / 8, np.pi / 2 + np.pi / 8),
                ),
            ),
            dict(
                name="pot", obj_groups="pot",
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    size=(0.02, 0.02),
                    rotation=[(-3 * np.pi / 8, -np.pi / 4), (np.pi / 4, 3 * np.pi / 8)],
                ),
            ),
            dict(
                name="bowl1", obj_groups="bowl",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.stove),
                    size=(0.4, 0.4), pos=("ref", -1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference prepare_soup_serving.py:98-108."""
        ladle_in_pot = check_obj_in_receptacle(self, "ladle", "pot")
        closed = all(
            p <= 0.05 for p in self.cabinet.get_door_state(env=self).values()
        )
        return ladle_in_pot and closed


class ServeSteak(Kitchen):
    """Reference serving_food/serve_steak.py:4-91."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.init_robot_base_pos = self.stove
        self.dining_table = self.register_fixture_ref(
            "dining_table",
            dict(id=FixtureType.COUNTER, ref=FixtureType.STOOL, size=(0.75, 0.2)),
        )

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick up the pan with the steak in it and place it on the dining "
            "table. Then place the steak on the plate."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="steak",
                placement=dict(
                    fixture=self.stove, size=(0.05, 0.05),
                    ensure_object_boundary_in_range=False,
                    try_to_place_in="pan",
                ),
            ),
            dict(
                name="plate", obj_groups="plate", graspable=False,
                placement=dict(
                    fixture=self.dining_table,
                    sample_region_kwargs=dict(ref=FixtureType.STOOL),
                    size=(0.50, 0.50), pos=("ref", 1.0),
                ),
            ),
            dict(
                name="dstr_dining", obj_groups=("mug", "cup"),
                placement=dict(
                    fixture=self.dining_table, size=(0.30, 0.20), pos=(0.5, 0.5)
                ),
            ),
        ]

    def _check_success(self):
        """Reference serve_steak.py:84-91."""
        steak_on_plate = check_obj_in_receptacle(self, "obj", "plate")
        pan_on_table = check_obj_fixture_contact(
            self, "obj_container", self.dining_table
        )
        return steak_on_plate and pan_on_table and gripper_obj_far(self)


class WineServingPrep(Kitchen):
    """Reference serving_food/wine_serving_prep.py:4-156."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.dining_table = self.register_fixture_ref(
            "dining_table",
            dict(id=FixtureType.COUNTER, ref=FixtureType.STOOL, size=(0.75, 0.2)),
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        alcohol_name = self.get_obj_lang("alcohol")
        cup_name = self.get_obj_lang("cup")
        decoration_name = self.get_obj_lang("decoration")
        ep_meta["lang"] = (
            "Open the cabinet directly in front. "
            f"Then move the {alcohol_name} and the {cup_name} to the counter "
            f"with the {decoration_name} on it."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="alcohol", obj_groups="alcohol", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(-0.6, -1.0)),
            ),
            dict(
                name="cup", obj_groups=["cup", "mug"], graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0.6, -1.0)),
            ),
            dict(
                name="decoration", obj_groups="decoration",
                placement=dict(
                    fixture=self.dining_table, size=(0.30, 0.30), pos=(0.0, 0.0)
                ),
            ),
            dict(
                name="distr_counter",
                obj_groups=["vegetable", "fruit", "sweets", "dairy"],
                placement=dict(
                    fixture=self.dining_table, size=(0.30, 0.30), pos=(-1.0, -1.0)
                ),
            ),
            dict(
                name="distr_sink", obj_groups="all", washable=True,
                placement=dict(fixture=self.sink, size=(0.25, 0.25), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference wine_serving_prep.py:140-156."""
        return (
            gripper_obj_far(self, obj_name="alcohol")
            and gripper_obj_far(self, obj_name="cup")
            and check_obj_fixture_contact(self, "alcohol", self.dining_table)
            and check_obj_fixture_contact(self, "cup", self.dining_table)
        )
