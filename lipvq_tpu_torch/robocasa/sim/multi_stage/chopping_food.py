"""Chopping Food activity tasks (reference
robocasa/environments/kitchen/multi_stage/chopping_food/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/chopping_food.py``,
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


class ArrangeVegetables(Kitchen):
    """Reference chopping_food/arrange_vegetables.py:4-110."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink, size=(0.45, 0.55))
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the vegetables from the sink and place them on the cutting board."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="cutting_board", obj_groups="cutting_board", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.45, 0.55)
                    ),
                    size=(0.35, 0.45), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="knife", obj_groups="knife", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.45, 0.55)
                    ),
                    size=(0.45, 0.45), pos=("ref", -1.0), offset=(0.0, 0.05),
                ),
            ),
            dict(
                name="vegetable1", obj_groups="vegetable", graspable=True,
                placement=dict(fixture=self.sink, size=(0.30, 0.20), pos=(-1.0, 1.0)),
            ),
            dict(
                name="vegetable2", obj_groups="vegetable", graspable=True,
                placement=dict(fixture=self.sink, size=(0.30, 0.20), pos=(1.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference arrange_vegetables.py:96-110."""
        v1 = check_obj_in_receptacle(self, "vegetable1", "cutting_board")
        v2 = check_obj_in_receptacle(self, "vegetable2", "cutting_board")
        return v1 and v2 and gripper_obj_far(self, obj_name="cutting_board")


class BreadSetupSlicing(Kitchen):
    """Reference chopping_food/bread_setup_slicing.py:4-77."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(1.0, 0.4))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Place all breads on the cutting board."
        return ep_meta

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name="receptacle", obj_groups="cutting_board", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(1.0, 0.4)),
                    size=(1, 0.4), pos=(-0.6, -0.5),
                ),
            )
        ]
        self.num_bread = int(self.rng.choice([1, 2, 3]))
        for i in range(self.num_bread):
            cfgs.append(
                dict(
                    name=f"obj_{i}", obj_groups="bread",
                    graspable=True, heatable=True,
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(top_size=(1.0, 0.4)),
                        size=(1, 0.4), pos=(0, -1.0), offset=(i * 0.07, 0),
                        try_to_place_in="container",
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference bread_setup_slicing.py:69-77."""
        bread_on_board = all(
            check_obj_in_receptacle(self, f"obj_{i}", "receptacle")
            for i in range(self.num_bread)
        )
        return bread_on_board and gripper_obj_far(self, "obj_0")


class ClearingTheCuttingBoard(Kitchen):
    """Reference chopping_food/clearing_the_cutting_board.py:4-99."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(0.5, 0.5))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Clear the non-vegetable object off the cutting board and place "
            "the vegetables onto it."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="non_vegetable", graspable=True, obj_groups="food",
                exclude_obj_groups="vegetable",
                placement=dict(
                    fixture=self.counter, size=(0.1, 0.1),
                    ensure_object_boundary_in_range=False, pos=(0, -0.3),
                    try_to_place_in="cutting_board",
                ),
            ),
            dict(
                name="vegetable1", obj_groups="vegetable", graspable=True,
                placement=dict(fixture=self.counter, size=(0.5, 0.40), pos=(0, -1.0)),
            ),
            dict(
                name="vegetable2", obj_groups="vegetable", graspable=True,
                placement=dict(fixture=self.counter, size=(0.50, 0.40), pos=(0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference clearing_the_cutting_board.py:80-99."""
        v1 = check_obj_in_receptacle(self, "vegetable1", "non_vegetable_container")
        v2 = check_obj_in_receptacle(self, "vegetable2", "non_vegetable_container")
        cleared = not check_obj_in_receptacle(
            self, "non_vegetable", "non_vegetable_container"
        )
        far = gripper_obj_far(self, obj_name="non_vegetable_container")
        return v1 and v2 and far and cleared


class MeatTransfer(Kitchen):
    """Reference chopping_food/meat_transfer.py:4-106."""

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab, size=(0.5, 0.5))
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        cont_name = self.get_obj_lang("container")
        ep_meta["lang"] = (
            f"Retrieve the {cont_name} from the cabinet, then place the raw "
            f"meat into the {cont_name} to avoid contamination."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        if self.rng.random() < 0.5:
            container = dict(
                name="container", obj_groups="pan", graspable=True,
                placement=dict(
                    fixture=self.cab,
                    ensure_object_boundary_in_range=False,
                    size=(0.05, 0.02), pos=(0, 0),
                    rotation=(2 * np.pi / 8, 3 * np.pi / 8),
                ),
            )
        else:
            container = dict(
                name="container", obj_groups="bowl", graspable=True,
                placement=dict(
                    fixture=self.cab,
                    ensure_object_boundary_in_range=False,
                    size=(0.02, 0.02), pos=(0, 0),
                ),
            )
        return [
            container,
            dict(
                name="meat", obj_groups="meat",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.5, 0.4), pos=(0.0, -1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference meat_transfer.py:100-106."""
        return (
            check_obj_fixture_contact(self, "container", self.counter)
            and gripper_obj_far(self, obj_name="meat")
            and check_obj_in_receptacle(self, "meat", "container")
        )


class OrganizeVegetables(Kitchen):
    """Reference chopping_food/organize_vegetables.py:4-123."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(1.0, 0.4))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj_name_1 = self.get_obj_lang("vegetable1")
        obj_name_2 = self.get_obj_lang("vegetable2")
        ep_meta["lang"] = (
            f"Place the {obj_name_1} and the {obj_name_2} on separate "
            "cutting boards."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        cfgs = []
        for name, rot, pos in (
            ("cutting_board1", np.pi / 2, (-0.6, -0.5)),
            ("cutting_board2", 0, (0.5, -0.4)),
        ):
            cfgs.append(
                dict(
                    name=name, obj_groups="cutting_board", graspable=False,
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(top_size=(1.0, 0.4)),
                        size=(0.05, 0.05), rotation=rot, pos=pos,
                        ensure_object_boundary_in_range=False,
                    ),
                )
            )
        for name, py in (("vegetable1", -1), ("vegetable2", -0.5)):
            cfgs.append(
                dict(
                    name=name, obj_groups=["vegetable", "fruit"],
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(top_size=(1.0, 0.4)),
                        size=(0.40, 0.40), pos=(0, py),
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference organize_vegetables.py:102-123."""
        v1b1 = check_obj_in_receptacle(self, "vegetable1", "cutting_board1")
        v2b1 = check_obj_in_receptacle(self, "vegetable2", "cutting_board1")
        v1b2 = check_obj_in_receptacle(self, "vegetable1", "cutting_board2")
        v2b2 = check_obj_in_receptacle(self, "vegetable2", "cutting_board2")
        return (v1b1 and v2b2) or (v2b1 and v1b2)
