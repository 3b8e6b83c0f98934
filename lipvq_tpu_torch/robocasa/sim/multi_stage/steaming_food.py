"""Steaming Food activity tasks (reference
robocasa/environments/kitchen/multi_stage/steaming_food/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/steaming_food.py``,
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
    obj_location_on_stove,
)


class MultistepSteaming(Kitchen):
    """Reference steaming_food/multistep_steaming.py:4-161."""

    def __init__(self, knob_id="random", *args, **kwargs):
        self.knob_id = knob_id
        self.water_was_turned_on = False
        self.vegetable_was_in_sink = False
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.stove_counter = self.register_fixture_ref(
            "stove_counter", dict(id=FixtureType.COUNTER, ref=self.stove)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        vegetable_name = self.get_obj_lang("vegetable1")
        ep_meta["lang"] = (
            "Turn on the sink faucet. "
            f"Then move the {vegetable_name} from the counter to the sink. "
            "Turn off the sink. Move the vegetable from the sink to the pot "
            "next to the stove. "
            f"Finally, move the pot to the {self.knob.replace('_', ' ')} burner."
        )
        return ep_meta

    def _reset_internal(self):
        self.water_was_turned_on = False
        self.vegetable_was_in_sink = False
        super()._reset_internal()
        self.sink.set_handle_state(mode="off", env=self, rng=self.rng)
        valid_knobs = sorted(self.stove.get_knobs_state(env=self).keys())
        if self.knob_id == "random":
            self.knob = str(self.rng.choice(valid_knobs))
        else:
            assert self.knob_id in valid_knobs
            self.knob = self.knob_id
        self.stove.set_knob_state(mode="off", knob=self.knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="pot", obj_groups="pot",
                placement=dict(
                    fixture=self.stove_counter,
                    sample_region_kwargs=dict(ref=self.stove),
                    size=(0.05, 0.05), pos=("ref", -0.7),
                    rotation=np.pi / 2,
                    ensure_object_boundary_in_range=False,
                ),
            ),
            dict(
                name="vegetable1", obj_groups="vegetable",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.5, 0.5), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="obj", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.4, 0.4), pos=(-1.0, 0.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference multistep_steaming.py:138-161: staged predicate
        with latched progress flags."""
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        if water_on:
            self.water_was_turned_on = True
        pot_on_burner = (
            obj_location_on_stove(self, "pot", self.stove, require_on=False)
            == self.knob
        )
        veg_in_sink = obj_inside_of(self, "vegetable1", self.sink)
        if veg_in_sink and water_on:
            self.vegetable_was_in_sink = True
        veg_in_pot = check_obj_in_receptacle(self, "vegetable1", "pot")
        return (
            self.water_was_turned_on
            and self.vegetable_was_in_sink
            and (not water_on)
            and pot_on_burner
            and veg_in_pot
        )


class SteamInMicrowave(Kitchen):
    """Reference steaming_food/steam_in_microwave.py:4-139."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.microwave = self.register_fixture_ref(
            "microwave", dict(id=FixtureType.MICROWAVE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        vegetable_name = self.get_obj_lang("vegetable")
        ep_meta["lang"] = (
            f"Pick the {vegetable_name} from the sink and place it in the "
            "bowl. Then pick the bowl and place it in the microwave. "
            "Then close the microwave door and press the start button."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.sink.set_handle_state(mode="off", env=self, rng=self.rng)
        self.microwave.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="bowl", obj_groups="bowl",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.35, 0.40), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="vegetable", obj_groups="vegetable",
                graspable=True, washable=True,
                placement=dict(fixture=self.sink, size=(0.3, 0.2), pos=(0.0, 1.0)),
            ),
            dict(
                name="distr_counter_0", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.microwave),
                    size=(0.50, 0.50), pos=("ref", -1.0), offset=(0.0, 0.40),
                ),
            ),
            dict(
                name="distr_counter_1", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.50, 0.50), pos=("ref", -1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference steam_in_microwave.py:124-139."""
        veg_in_bowl = check_obj_in_receptacle(self, "vegetable", "bowl")
        bowl_in_micro = obj_inside_of(self, "bowl", self.microwave)
        closed = all(
            p <= 0.05 for p in self.microwave.get_door_state(env=self).values()
        )
        button = self.microwave.get_state()["turned_on"]
        return veg_in_bowl and bowl_in_micro and closed and button


class SteamVegetables(Kitchen):
    """Reference steaming_food/steam_vegetables.py:4-155."""

    def __init__(self, knob_id="random", *args, **kwargs):
        self.knob_id = knob_id
        # wrong placement order latches failure
        self.task_failed = False
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
            "Place vegetables into the pot based on the amount of time it "
            "would take to steam each, e.g. potatoes and carrots would take "
            "the longest. Then turn off the burner beneath the pot."
        )
        ep_meta["knob"] = self.knob
        return ep_meta

    def _reset_internal(self):
        self.task_failed = False
        super()._reset_internal()
        self.stove.set_knob_state(mode="on", knob=self.knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="vegetable_hard", obj_groups=["potato", "carrot"],
                placement=dict(
                    fixture=self.counter, size=(0.30, 0.50),
                    sample_region_kwargs=dict(ref=self.stove),
                    pos=("ref", -1.0),
                ),
            ),
            dict(
                name="vegetable_easy", obj_groups="vegetable",
                exclude_obj_groups=["potato", "carrot"],
                placement=dict(
                    fixture=self.counter, size=(0.30, 0.50),
                    sample_region_kwargs=dict(ref=self.stove),
                    pos=("ref", -1.0),
                ),
            ),
            dict(
                name="pot", obj_groups="pot",
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
        """Reference steam_vegetables.py:126-155: hard vegetables must
        enter the pot before easy ones; finish with the burner off."""
        if self.task_failed:
            return False
        hard_in_pot = check_obj_in_receptacle(self, "vegetable_hard", "pot")
        easy_in_pot = check_obj_in_receptacle(self, "vegetable_easy", "pot")
        if easy_in_pot and not hard_in_pot:
            self.task_failed = True
            return False
        knob_value = self.stove.get_knobs_state(env=self)[self.knob]
        knob_off = not (0.35 <= np.abs(knob_value) <= 2 * np.pi - 0.35)
        far = (
            gripper_obj_far(self, "vegetable_hard")
            and gripper_obj_far(self, "vegetable_easy")
            and gripper_obj_far(self, "pot")
        )
        pot_on_stove = check_obj_fixture_contact(self, "pot", self.stove)
        return knob_off and far and pot_on_stove and hard_in_pot and easy_in_pot
