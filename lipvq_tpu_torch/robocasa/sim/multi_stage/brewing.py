"""Brewing activity tasks (reference
robocasa/environments/kitchen/multi_stage/brewing/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/brewing.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_in_receptacle,
    gripper_obj_far,
    obj_location_on_stove,
)


class ArrangeTea(Kitchen):
    """Reference brewing/arrange_tea.py:4-110."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.DOOR_TOP_HINGE_DOUBLE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab, size=(0.6, 0.4))
        )
        self.init_robot_base_pos = self.cab

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.9, max=1.0, env=self, rng=self.rng)

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the kettle from the counter and place it on the tray. "
            "Then pick the mug from the cabinet and place it on the tray. "
            "Then close the cabinet doors."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="mug", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0, -1.0)),
            ),
            dict(
                name="obj2", obj_groups="kettle", graspable=True,
                placement=dict(
                    fixture=self.counter, size=(0.5, 0.5), pos=("ref", -1.0),
                    sample_region_kwargs=dict(ref=self.cab, top_size=(0.6, 0.4)),
                    offset=(0.1, 0.0),
                ),
            ),
            dict(
                name="container", obj_groups="tray",
                placement=dict(
                    fixture=self.counter, size=(0.7, 0.7), pos=("ref", -0.6),
                    offset=(-0.1, 0.0),
                    sample_region_kwargs=dict(ref=self.cab, top_size=(0.6, 0.4)),
                ),
            ),
        ]

    def _check_door_closed(self):
        """Reference arrange_tea.py:87-96."""
        door_state = self.cab.get_door_state(env=self)
        return all(joint_p <= 0.05 for joint_p in door_state.values())

    def _check_success(self):
        """Reference arrange_tea.py:98-110."""
        obj1_on_tray = check_obj_in_receptacle(self, "obj", "container")
        obj2_on_tray = check_obj_in_receptacle(self, "obj2", "container")
        return (
            obj1_on_tray and obj2_on_tray
            and gripper_obj_far(self) and self._check_door_closed()
        )


class KettleBoiling(Kitchen):
    """Reference brewing/kettle_boiling.py:4-130."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.init_robot_base_pos = self.stove
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.stove, size=(0.2, 0.2))
        )

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the kettle from the counter and place it on a stove burner. "
            "Then turn the burner on."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        for knob in self.stove.get_knobs_state(env=self):
            self.stove.set_knob_state(mode="off", knob=knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="kettle_non_electric",
                graspable=True, heatable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.stove),
                    size=(0.35, 0.35), pos=("ref", -1),
                ),
            ),
            dict(
                name="stove_distr", obj_groups=("pan", "pot"),
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    size=(0.02, 0.02),
                    rotation=[(-3 * np.pi / 8, -np.pi / 4), (np.pi / 4, 3 * np.pi / 8)],
                ),
            ),
        ]

    def _check_success(self):
        """Reference kettle_boiling.py:101-130: kettle on a lit burner,
        gripper away."""
        loc = obj_location_on_stove(self, "obj", self.stove, threshold=0.15)
        return loc is not None and gripper_obj_far(self)


class PrepareCoffee(Kitchen):
    """Reference brewing/prepare_coffee.py:4-120."""

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.coffee_machine = self.register_fixture_ref(
            "coffee_machine", dict(id="coffee_machine")
        )
        self.cab = self.register_fixture_ref(
            "cab", dict(id=self.cab_id, ref=self.coffee_machine)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            f"Pick the {self.get_obj_lang()} from the cabinet, place it "
            "under the coffee machine dispenser, and press the start button."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj",
                obj_groups="mug",
                placement=dict(fixture=self.cab, size=(0.30, 0.20), pos=(0, -1.0)),
            ),
            dict(
                name="distr_cab",
                obj_groups="all",
                placement=dict(
                    fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0), offset=(0.0, 0.0)
                ),
            ),
        ]

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _check_success(self):
        """Reference prepare_coffee.py:109-120."""
        far = gripper_obj_far(self)
        contact = self.coffee_machine.check_receptacle_placement_for_pouring(self, "obj")
        button_far = self.coffee_machine.gripper_button_far(self)
        return contact and far and self.coffee_machine._turned_on and button_far
