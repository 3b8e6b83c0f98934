"""Frying activity tasks (reference
robocasa/environments/kitchen/multi_stage/frying/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/frying.py``,
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
    obj_location_on_stove,
)


class AssembleCookingArray(Kitchen):
    """Reference frying/assemble_cooking_array.py:4-131."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.stove, size=[0.30, 0.40])
        )
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.counter)
        )
        self.init_robot_base_pos = self.stove

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        meat_name = self.get_obj_lang("meat")
        condiment_name = self.get_obj_lang("condiment")
        vegetable_name = self.get_obj_lang("vegetable")
        ep_meta["lang"] = (
            f"Move the {meat_name} onto the pan on the stove. "
            f"Then move the {condiment_name} and {vegetable_name} from the "
            "cabinet to the counter where the plate is."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="pan", obj_groups="pan",
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    size=(0.05, 0.05),
                ),
            ),
            dict(
                name="meat", obj_groups="meat", graspable=True, heatable=True,
                placement=dict(
                    fixture=self.counter, loc="nn",
                    sample_region_kwargs=dict(ref=self.stove),
                    size=(0.30, 0.30), pos=("ref", -1.0),
                    try_to_place_in="container",
                ),
            ),
            dict(
                name="condiment", obj_groups="condiment", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(-1.0, -1.0)),
            ),
            dict(
                name="vegetable", obj_groups="vegetable", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(1.0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference assemble_cooking_array.py:112-131."""
        return (
            check_obj_in_receptacle(self, "meat", "pan", th=0.07)
            and gripper_obj_far(self, obj_name="vegetable")
            and gripper_obj_far(self, obj_name="condiment")
            and gripper_obj_far(self, obj_name="meat")
            and check_obj_fixture_contact(self, "vegetable", self.counter)
            and check_obj_fixture_contact(self, "condiment", self.counter)
        )


class FryingPanAdjustment(Kitchen):
    """Reference frying/frying_pan_adjustment.py:4-106."""

    def __init__(self, *args, **kwargs):
        self.start_loc = None
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.init_robot_base_pos = self.stove

    def _reset_internal(self):
        # place first (super), then light the burner the pan landed on
        # (reference frying_pan_adjustment.py:26-41)
        super()._reset_internal()
        pan_loc = obj_location_on_stove(self, "obj", self.stove, require_on=False)
        self.start_loc = None
        for knob in self.stove.get_knobs_state(env=self):
            if pan_loc == knob:
                self.start_loc = pan_loc
                self.stove.set_knob_state(mode="on", knob=knob, env=self, rng=self.rng)
            else:
                self.stove.set_knob_state(mode="off", knob=knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="pan",
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    size=(0.05, 0.05),
                ),
            )
        ]

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick and place the pan from the current burner to another "
            "burner and turn the burner on."
        )
        return ep_meta

    def _check_success(self):
        """Reference frying_pan_adjustment.py:95-106."""
        curr_loc = obj_location_on_stove(self, "obj", self.stove, require_on=False)
        knobs_state = self.stove.get_knobs_state(env=self)
        knob_on_loc = False
        if curr_loc is not None and curr_loc in knobs_state:
            knob_on_loc = 0.35 <= np.abs(knobs_state[curr_loc]) <= 2 * np.pi - 0.35
        return gripper_obj_far(self) and knob_on_loc and curr_loc != self.start_loc


class MealPrepStaging(Kitchen):
    """Reference frying/meal_prep_staging.py:4-166."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.stove, size=(0.3, 0.2))
        )
        self.init_robot_base_pos = self.stove

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj_name_1 = self.get_obj_lang("vegetable")
        obj_name_2 = self.get_obj_lang("meat")
        ep_meta["lang"] = (
            "Place both pans onto different burners. "
            f"Then place the {obj_name_1} and the {obj_name_2} on different pans."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        cfgs = []
        for name, py in (("pan1", 0.2), ("pan2", -0.3)):
            cfgs.append(
                dict(
                    name=name, obj_groups="pan",
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.stove, loc="left_right"),
                        size=(0.5, 0.05), pos=("ref", py), offset=(-0.13, 0.0),
                        rotation=0, ensure_object_boundary_in_range=False,
                    ),
                )
            )
        cfgs.append(
            dict(
                name="vegetable", obj_groups="vegetable",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.stove, loc="left_right"),
                    size=(0.4, 0.4), pos=("ref", 0.0),
                ),
            )
        )
        cfgs.append(
            dict(
                name="meat", obj_groups="meat",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.stove, loc="left_right"),
                    size=(0.5, 0.5), pos=("ref", -1.0),
                ),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference meal_prep_staging.py:146-166."""
        v1 = check_obj_in_receptacle(self, "vegetable", "pan1")
        v2 = check_obj_in_receptacle(self, "vegetable", "pan2")
        m1 = check_obj_in_receptacle(self, "meat", "pan1")
        m2 = check_obj_in_receptacle(self, "meat", "pan2")
        food_on_pans = (v1 and m2) or (v2 and m1)
        pan1_loc = obj_location_on_stove(self, "pan1", self.stove, require_on=False)
        pan2_loc = obj_location_on_stove(self, "pan2", self.stove, require_on=False)
        pans_on_stove = pan1_loc is not None and pan2_loc is not None
        return pans_on_stove and pan1_loc != pan2_loc and food_on_pans


class SearingMeat(Kitchen):
    """Reference frying/searing_meat.py:4-137."""

    def __init__(self, knob_id="random", *args, **kwargs):
        self.knob_id = knob_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.stove, size=[0.30, 0.40])
        )
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.stove)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        meat_name = self.get_obj_lang("meat")
        ep_meta["lang"] = (
            f"Grab the pan from the cabinet and place it on the "
            f"{self.knob.replace('_', ' ')} burner on the stove. "
            f"Then place the {meat_name} on the stove and turn the burner on."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        valid_knobs = sorted(self.stove.get_knobs_state(env=self).keys())
        if self.knob_id == "random":
            self.knob = str(self.rng.choice(valid_knobs))
        else:
            assert self.knob_id in valid_knobs
            self.knob = self.knob_id
        self.stove.set_knob_state(mode="off", knob=self.knob, env=self, rng=self.rng)
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="pan", obj_groups="pan",
                placement=dict(
                    fixture=self.cab,
                    ensure_object_boundary_in_range=False,
                    pos=(0.0, -0.3), size=(0.4, 0.02),
                    rotation=np.pi / 2,
                ),
            ),
            dict(
                name="meat", obj_groups="meat", graspable=True, heatable=True,
                placement=dict(
                    fixture=self.counter, loc="nn",
                    sample_region_kwargs=dict(ref=self.stove),
                    size=(0.30, 0.30), pos=("ref", -1.0),
                    try_to_place_in="container",
                ),
            ),
        ]

    def _check_success(self):
        """Reference searing_meat.py:131-137."""
        far = gripper_obj_far(self, obj_name="meat")
        pan_on_knob = (
            obj_location_on_stove(self, "pan", self.stove, threshold=0.15)
            == self.knob
        )
        meat_in_pan = check_obj_in_receptacle(self, "meat", "pan", th=0.07)
        return far and pan_on_knob and meat_in_pan


class SetupFrying(Kitchen):
    """Reference frying/setup_frying.py:4-131."""

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id, ref=self.stove))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the pan from the cabinet and place it on the stove. "
            "Then turn on the stove burner for the pan."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0, max=0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name="pan", obj_groups="pan", graspable=True,
                placement=dict(
                    fixture=self.cab,
                    ensure_object_boundary_in_range=False,
                    size=(0.05, 0.02), pos=(0, 0),
                    rotation=(2 * np.pi / 8, 3 * np.pi / 8),
                ),
            )
        ]
        for i in range(2):
            cfgs.append(
                dict(
                    name=f"distr_counter_{i}", obj_groups="all",
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.cab),
                        size=(0.50, 0.50), pos=(0.0, -1.0),
                    ),
                )
            )
        cfgs.append(
            dict(
                name="distr_stove", obj_groups="kettle_non_electric",
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    size=(0.02, 0.02),
                ),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference setup_frying.py:106-131."""
        loc = obj_location_on_stove(self, "pan", self.stove, threshold=0.15)
        return loc is not None and gripper_obj_far(self, "pan")
