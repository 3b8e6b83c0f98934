"""Meat Preparation activity tasks (reference
robocasa/environments/kitchen/multi_stage/meat_preparation/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/meat_preparation.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_fixture_contact,
    check_obj_in_receptacle,
    gripper_obj_far,
)


class PrepForTenderizing(Kitchen):
    """Reference meat_preparation/prep_for_tenderizing.py:4-86."""

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
        ep_meta["lang"] = (
            "Retrieve a rolling pin from the cabinet and place it next to the "
            "meat on the cutting board to prepare for tenderizing."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="meat", graspable=True, obj_groups="meat",
                placement=dict(
                    fixture=self.counter, size=(0.1, 0.1),
                    ensure_object_boundary_in_range=False, pos=(0, -0.3),
                    try_to_place_in="cutting_board",
                ),
            ),
            dict(
                name="rolling_pin", obj_groups="rolling_pin", graspable=True,
                placement=dict(
                    fixture=self.cab,
                    ensure_object_boundary_in_range=False,
                    size=(0.05, 0.02), pos=(0, 0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference prep_for_tenderizing.py:80-86."""
        return (
            check_obj_in_receptacle(self, "rolling_pin", "meat_container")
            and gripper_obj_far(self, obj_name="meat_container")
            and check_obj_in_receptacle(self, "meat", "meat_container")
        )


class PrepMarinatingMeat(Kitchen):
    """Reference meat_preparation/prep_marinating_meat.py:4-137."""

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
        cond_name = self.get_obj_lang("condiment")
        meat_name = self.get_obj_lang("meat")
        cont_name = self.get_obj_lang("meat_container")
        ep_meta["lang"] = (
            f"Pick the {meat_name} from the {cont_name} and place it on the "
            f"cutting board. Then pick the {cond_name} from the cabinet and "
            "place it next to the cutting board."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="cutting_board", obj_groups="cutting_board",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.5), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="meat", obj_groups="meat",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.30, 0.30), pos=("ref", -1.0),
                    try_to_place_in="container",
                ),
            ),
            dict(
                name="condiment", obj_groups="condiment_bottle", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.1), pos=(0, -1.0)),
            ),
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference prep_marinating_meat.py:117-137."""
        far = gripper_obj_far(self, "condiment") and gripper_obj_far(self, "meat")
        condiment_on_counter = check_obj_fixture_contact(self, "condiment", self.counter)
        meat_on_board = check_obj_in_receptacle(self, "meat", "cutting_board")
        board_on_counter = check_obj_fixture_contact(self, "cutting_board", self.counter)
        return far and meat_on_board and board_on_counter and condiment_on_counter
