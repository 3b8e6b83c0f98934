"""Defrosting Food activity tasks (reference
robocasa/environments/kitchen/multi_stage/defrosting_food/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/defrosting_food.py``,
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
)


class DefrostByCategory(Kitchen):
    """Reference defrosting_food/defrost_by_category.py:5-103."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink, size=(0.5, 0.5))
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "There is a mixed pile of frozen fruits and vegetables on the "
            "counter. Locate all the frozen vegetables and place the items in "
            "a bowl on the counter. Take all the frozen fruits and defrost "
            "them in a running sink."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        placements = [
            dict(
                fixture=self.counter,
                sample_region_kwargs=dict(
                    ref=self.sink, loc="left_right", top_size=(0.5, 0.5)
                ),
                size=(0.3, 0.4), pos=("ref", -1),
            )
            for _ in range(4)
        ]
        self.rng.shuffle(placements)
        cfgs = [
            dict(
                name=f"obj{i}",
                obj_groups="fruit" if i <= 1 else "vegetable",
                graspable=True,
                placement=placements[i],
            )
            for i in range(4)
        ]
        cfgs.append(
            dict(
                name="container", obj_groups="bowl",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.5, 0.5)
                    ),
                    size=(0.3, 0.4), pos=("ref", -1),
                ),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference defrost_by_category.py:89-103."""
        fruits_in_sink = obj_inside_of(self, "obj0", self.sink) and obj_inside_of(
            self, "obj1", self.sink
        )
        veg_in_bowl = check_obj_in_receptacle(
            self, "obj2", "container"
        ) and check_obj_in_receptacle(self, "obj3", "container")
        far = all(gripper_obj_far(self, obj_name=f"obj{i}") for i in range(4))
        return fruits_in_sink and veg_in_bowl and far


class MicrowaveThawing(Kitchen):
    """Reference defrosting_food/microwave_thawing.py:4-110."""

    # exclude layout 8 because the microwave is far from counters
    EXCLUDE_LAYOUTS = [8]

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.microwave = self.register_fixture_ref(
            "microwave", dict(id=FixtureType.MICROWAVE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.microwave)
        )
        self.distr_counter = self.register_fixture_ref(
            "distractor_counter", dict(id=FixtureType.COUNTER, ref=self.microwave)
        )
        self.init_robot_base_pos = self.microwave

    def _reset_internal(self):
        super()._reset_internal()
        self.microwave.set_door_state(min=0, max=0, env=self, rng=self.rng)

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            f"Pick the {self.get_obj_lang()} from the counter and place it "
            "in the microwave. Then turn on the microwave."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="food",
                graspable=True, microwavable=True, freezable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.microwave),
                    size=(0.30, 0.30), pos=("ref", -1.0),
                    try_to_place_in="container",
                ),
            ),
            dict(
                name="container", obj_groups="plate",
                placement=dict(
                    fixture=self.microwave, size=(0.05, 0.05),
                    ensure_object_boundary_in_range=False,
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.distr_counter,
                    sample_region_kwargs=dict(ref=self.microwave),
                    size=(0.50, 0.20), pos=(0, 1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference microwave_thawing.py:103-110."""
        obj_in = obj_inside_of(self, "obj", self.microwave)
        button = self.microwave.get_state()["turned_on"]
        return obj_in and button and gripper_obj_far(self)


class QuickThaw(Kitchen):
    """Reference defrosting_food/quick_thaw.py:4-112."""

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
            "Frozen meat rests on a plate on the counter. Retrieve the meat "
            "and place it in a pot on a burner. Then turn the burner on."
        )
        ep_meta["knob"] = self.knob
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.stove.set_knob_state(mode="off", knob=self.knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="meat", obj_groups="meat",
                placement=dict(
                    fixture=self.counter, size=(0.50, 0.30),
                    sample_region_kwargs=dict(ref=self.stove),
                    pos=("ref", -1.0),
                    try_to_place_in="plate",
                ),
            ),
            dict(
                name="container", obj_groups="pot",
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    sample_region_kwargs=dict(locs=[self.knob]),
                    size=(0.02, 0.02),
                    rotation=[(-3 * np.pi / 8, -np.pi / 4), (np.pi / 4, 3 * np.pi / 8)],
                ),
            ),
        ]

    def _check_success(self):
        """Reference quick_thaw.py:102-112."""
        knob_value = self.stove.get_knobs_state(env=self)[self.knob]
        knob_on = 0.35 <= np.abs(knob_value) <= 2 * np.pi - 0.35
        return (
            knob_on
            and check_obj_in_receptacle(self, "meat", "container")
            and gripper_obj_far(self, obj_name="meat")
        )


class ThawInSink(Kitchen):
    """Reference defrosting_food/thaw_in_sink.py:4-103."""

    def __init__(self, obj_groups="all", *args, **kwargs):
        self.obj_groups = obj_groups
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink, size=(0.4, 0.4))
        )
        self.init_robot_base_pos = self.sink

    def _reset_internal(self):
        super()._reset_internal()
        self.sink.set_handle_state(mode="off", env=self, rng=self.rng)

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            f"Pick the {self.get_obj_lang()} from the counter and place it "
            "in the sink. Then turn on the sink faucet."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups=self.obj_groups,
                graspable=True, washable=True, freezable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.4, 0.4)
                    ),
                    try_to_place_in="container",
                    size=(0.30, 0.40), pos=("ref", -1.0),
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
        """Reference thaw_in_sink.py:96-103."""
        obj_in_sink = obj_inside_of(self, "obj", self.sink)
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        return obj_in_sink and water_on
