"""Reheating Food activity tasks (reference
robocasa/environments/kitchen/multi_stage/reheating_food/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/reheating_food.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_in_receptacle,
    gripper_obj_far,
    obj_inside_of,
    obj_location_on_stove,
)


class HeatMug(Kitchen):
    """Reference reheating_food/heat_mug.py:4-79."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.microwave = self.register_fixture_ref(
            "microwave", dict(id=FixtureType.MICROWAVE)
        )
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.microwave)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the mug from the cabinet and place it inside the microwave. "
            "Then close the microwave."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        self.microwave.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="mug", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0, -1.0)),
            ),
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference heat_mug.py:71-79."""
        obj_in = obj_inside_of(self, "obj", self.microwave)
        door_closed = self.microwave.get_door_state(self)["door"] <= 0.005
        return obj_in and gripper_obj_far(self) and door_closed


class MakeLoadedPotato(Kitchen):
    """Reference reheating_food/make_loaded_potato.py:4-115."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.microwave = self.register_fixture_ref(
            "microwave", dict(id=FixtureType.MICROWAVE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(0.6, 0.6), ref=self.microwave)
        )
        self.init_robot_base_pos = self.microwave

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Retrieve the reheated potato from the microwave, then place it "
            "on the cutting board along with cheese and a bottle of condiment."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="potato", obj_groups="potato",
                placement=dict(
                    fixture=self.microwave, size=(0.05, 0.05),
                    ensure_object_boundary_in_range=False,
                    try_to_place_in="bowl",
                ),
            ),
            dict(
                name="cutting_board", obj_groups="cutting_board",
                placement=dict(
                    fixture=self.counter, size=(0.05, 0.05),
                    ensure_object_boundary_in_range=False, pos=(0, 0),
                    rotation=np.pi / 2,
                ),
            ),
            dict(
                name="condiment", obj_groups="condiment",
                placement=dict(fixture=self.counter, size=(0.6, 0.5), pos=(0, -1)),
            ),
            dict(
                name="cheese", obj_groups="cheese",
                placement=dict(fixture=self.counter, size=(0.6, 0.5), pos=(0, -1)),
            ),
        ]

    def _check_success(self):
        """Reference make_loaded_potato.py:102-115."""
        far = (
            gripper_obj_far(self, "potato")
            and gripper_obj_far(self, "condiment")
            and gripper_obj_far(self, "cheese")
        )
        in_place = (
            check_obj_in_receptacle(self, "potato", "cutting_board")
            and check_obj_in_receptacle(self, "condiment", "cutting_board")
            and check_obj_in_receptacle(self, "cheese", "cutting_board")
        )
        return far and in_place


class SimmeringSauce(Kitchen):
    """Reference reheating_food/simmering_sauce.py:4-152."""

    def __init__(self, knob_id="random", *args, **kwargs):
        self.knob_id = knob_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.stove, size=(0.5, 0.4))
        )
        self.init_robot_base_pos = self.stove
        if "knob" in self._ep_meta:
            self.knob = self._ep_meta["knob"]
        else:
            valid_knobs = sorted(
                k for k, v in self.stove.knob_joints.items() if v is not None
            )
            if self.knob_id == "random":
                self.knob = str(self.rng.choice(valid_knobs))
            else:
                assert self.knob_id in valid_knobs
                self.knob = self.knob_id

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        knob_lang = self.knob.replace("_", " ")
        ep_meta["lang"] = (
            f"Place the pan on the {knob_lang} burner on the stove. "
            f"Then place the tomato and the onion in the pan and turn on the "
            f"{knob_lang} burner."
        )
        ep_meta["knob"] = self.knob
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="pan", obj_groups="pan",
                placement=dict(
                    fixture=self.counter,
                    ensure_object_boundary_in_range=False,
                    sample_region_kwargs=dict(ref=self.stove, top_size=(0.50, 0.40)),
                    size=(0.25, 0.05), pos=("ref", 0.0),
                ),
            ),
            dict(
                name="tomato", obj_groups="tomato",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.stove),
                    size=(0.35, 0.2), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="onion", obj_groups="onion",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.stove),
                    size=(0.35, 0.2), pos=("ref", 0.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference simmering_sauce.py:141-152."""
        pan_on_knob = (
            obj_location_on_stove(self, "pan", self.stove, require_on=False)
            == self.knob
        )
        tomato_in = check_obj_in_receptacle(self, "tomato", "pan")
        onion_in = check_obj_in_receptacle(self, "onion", "pan")
        knob_value = self.stove.get_knobs_state(env=self)[self.knob]
        knob_on = 0.35 <= np.abs(knob_value) <= 2 * np.pi - 0.35
        return pan_on_knob and tomato_in and onion_in and knob_on


class WaffleReheat(Kitchen):
    """Reference reheating_food/waffle_reheat.py:4-72."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.microwave = self.register_fixture_ref(
            "microwave", dict(id=FixtureType.MICROWAVE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(0.6, 0.6), ref=self.microwave)
        )
        self.init_robot_base_pos = self.microwave

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Open the microwave, place the bowl with waffle inside the "
            "microwave, then close the microwave door and turn it on."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="waffle", obj_groups="waffle",
                placement=dict(
                    fixture=self.counter, size=(0.3, 0.3), pos=(-1.0, -1.0),
                    try_to_place_in="bowl",
                ),
            )
        ]

    def _check_success(self):
        """Reference waffle_reheat.py:64-72."""
        far = gripper_obj_far(self, "waffle")
        waffle_in_bowl = check_obj_in_receptacle(self, "waffle", "waffle_container")
        bowl_in_microwave = obj_inside_of(self, "waffle_container", self.microwave)
        microwave_on = self.microwave.get_state()["turned_on"]
        return waffle_in_bowl and bowl_in_microwave and microwave_on and far


class WarmCroissant(Kitchen):
    """Reference reheating_food/warm_croissant.py:4-100."""

    def __init__(self, knob_id="random", *args, **kwargs):
        self.knob_id = knob_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        valid_knobs = sorted(
            k for k, v in self.stove.knob_joints.items() if v is not None
        )
        if self.knob_id == "random":
            self.knob = str(self.rng.choice(valid_knobs))
        else:
            assert self.knob_id in valid_knobs
            self.knob = self.knob_id
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=FixtureType.STOVE)
        )
        self.init_robot_base_pos = self.stove

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the croissant and place it on the pan. Then turn on the "
            "stove to warm the croissant."
        )
        ep_meta["knob"] = self.knob
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.stove.set_knob_state(mode="off", knob=self.knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="croissant", obj_groups="croissant",
                placement=dict(
                    fixture=self.counter, size=(0.30, 0.30),
                    sample_region_kwargs=dict(ref=self.stove),
                    pos=("ref", -1.0),
                    try_to_place_in_container=True,
                    container_group="plate",
                ),
            ),
            dict(
                name="pan", obj_groups="pan",
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    sample_region_kwargs=dict(locs=[self.knob]),
                    rotation=[(-3 * np.pi / 8, -np.pi / 4), (np.pi / 4, 3 * np.pi / 8)],
                    size=(0.02, 0.02),
                ),
            ),
        ]

    def _check_success(self):
        """Reference warm_croissant.py:89-100."""
        knob_value = self.stove.get_knobs_state(env=self)[self.knob]
        knob_on = 0.35 <= np.abs(knob_value) <= 2 * np.pi - 0.35
        return (
            knob_on
            and check_obj_in_receptacle(self, "croissant", "pan")
            and gripper_obj_far(self, obj_name="croissant")
        )
