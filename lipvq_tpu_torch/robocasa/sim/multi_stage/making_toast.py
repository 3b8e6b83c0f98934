"""Making Toast activity tasks (reference
robocasa/environments/kitchen/multi_stage/making_toast/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/making_toast.py``,
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


class BreadSelection(Kitchen):
    """Reference making_toast/bread_selection.py:4-123."""

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab, size=(0.6, 0.6))
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "From the different types of pastries on the counter, select a "
            "croissant and place it on the cutting board. Then retrieve a jar "
            "of jam from the cabinet and place it alongside the croissant on "
            "the cutting board."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="cutting_board", obj_groups="cutting_board",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.3, 0.5), pos=(1, -1.0), rot=np.pi / 2,
                ),
            ),
            dict(
                name="distr_pastry",
                obj_groups=str(self.rng.choice(["baguette", "cupcake"])),
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.7, 0.5), pos=(-1, -1.0),
                    try_to_place_in="plate",
                ),
            ),
            dict(
                name="croissant", obj_groups="croissant",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.7, 0.5), pos=(-1, -1.0),
                    try_to_place_in="plate",
                ),
            ),
            dict(
                name="jam", obj_groups="jam",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0, -1.0)),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.20), pos=(0, 1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference bread_selection.py:116-123."""
        return (
            check_obj_in_receptacle(self, "croissant", "cutting_board")
            and gripper_obj_far(self, obj_name="croissant")
            and check_obj_in_receptacle(self, "jam", "cutting_board")
        )


class CheesyBread(Kitchen):
    """Reference making_toast/cheesy_bread.py:4-82."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER_NON_CORNER, size=(0.6, 0.6))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick up the wedge of cheese and place it on the slice of bread "
            "to prepare a simple cheese on bread dish."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="bread", obj_groups="bread",
                placement=dict(
                    fixture=self.counter, size=(0.5, 0.7), pos=(0, -1.0),
                    try_to_place_in="cutting_board",
                ),
            ),
            dict(
                name="cheese", obj_groups="cheese",
                placement=dict(fixture=self.counter, size=(1.0, 0.3), pos=(0, -1.0)),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(fixture=self.counter, size=(1.0, 0.20), pos=(0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference cheesy_bread.py:74-82."""
        return (
            check_obj_in_receptacle(self, "bread", "bread_container")
            and gripper_obj_far(self, obj_name="cheese")
            and self.check_contact("cheese_", "bread_")
        )


class PrepareToast(Kitchen):
    """Reference making_toast/prepare_toast.py:4-137."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=FixtureType.TOASTER)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the bread, place it on the cutting board, "
            "pick the jam, place it on the counter, and close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.9, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="bread", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.30), pos=(0, -0.1)),
            ),
            dict(
                name="container", obj_groups="cutting_board",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.5, 0.5), pos=(0.0, -1.0),
                ),
            ),
            dict(
                name="obj2", obj_groups="jam",
                placement=dict(
                    fixture=self.cab, size=(0.3, 0.15), pos=(0.0, -1.0),
                    offset=(-0.05, 0.0),
                ),
            ),
            dict(
                name="obj3", obj_groups="knife",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.3, 0.3), pos=(0.0, 0.0),
                    ensure_object_boundary_in_range=False,
                    offset=(-0.05, 0.05),
                ),
            ),
        ]

    def _check_success(self):
        """Reference prepare_toast.py:119-137."""
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return (
            check_obj_fixture_contact(self, "obj2", self.counter)
            and gripper_obj_far(self)
            and check_obj_in_receptacle(self, "obj", "container")
            and check_obj_fixture_contact(self, "container", self.counter)
            and closed
        )


class SweetSavoryToastSetup(Kitchen):
    """Reference making_toast/sweet_savory_toast_setup.py:4-160."""

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab, size=(0.6, 0.6))
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the avocado and bread from the counter and place them on "
            "the plate. Then pick the jam from the cabinet and place it next "
            "to the plate. Lastly, close the cabinet door."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="plate", obj_groups="plate",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.5), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="avocado", obj_groups="avocado",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.6, 0.6), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="bread", obj_groups="bread",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.6, 0.6), pos=(0, -1.0),
                ),
            ),
            dict(
                name="jam", obj_groups="jam", graspable=True,
                placement=dict(fixture=self.cab, size=(0.4, 0.4), pos=(0, -1.0)),
            ),
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference sweet_savory_toast_setup.py:143-160."""
        far = gripper_obj_far(self, "plate")
        jam_on_counter = check_obj_fixture_contact(self, "jam", self.counter)
        food_on_plate = check_obj_in_receptacle(
            self, "bread", "plate"
        ) and check_obj_in_receptacle(self, "avocado", "plate")
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return far and food_on_plate and jam_on_counter and closed
