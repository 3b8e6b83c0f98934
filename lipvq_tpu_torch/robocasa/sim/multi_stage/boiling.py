"""Boiling activity tasks (reference
robocasa/environments/kitchen/multi_stage/boiling/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/boiling.py``,
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


class FillKettle(Kitchen):
    """Reference boiling/fill_kettle.py:4-77."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.sink)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Open the cabinet, pick the kettle from the cabinet, "
            "and place it in the sink."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0, max=0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="kettle", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.30), pos=(0, -1.0)),
            ),
            dict(
                name="distr_sink", obj_groups="all", washable=True,
                placement=dict(fixture=self.sink, size=(0.25, 0.25), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference fill_kettle.py:73-77."""
        return obj_inside_of(self, "obj", self.sink) and gripper_obj_far(self)


class HeatMultipleWater(Kitchen):
    """Reference boiling/heat_multiple_water.py:4-147."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.ref_cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.stove)
        )
        self.ref_counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.ref_cab, size=(0.2, 0.2))
        )
        self.init_robot_base_pos = self.ref_cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the kettle from the cabinet and place it on a stove burner. "
            "Then pick the pot from the counter and place it on another stove "
            "burner. Finally, turn both burners on."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.ref_cab.set_door_state(min=0.9, max=1.0, env=self, rng=self.rng)
        for knob in self.stove.get_knobs_state(env=self):
            self.stove.set_knob_state(mode="off", knob=knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="pot", graspable=True, heatable=True,
                placement=dict(
                    fixture=self.ref_counter,
                    sample_region_kwargs=dict(ref=self.ref_cab),
                    size=(0.35, 0.35), pos=("ref", 0),
                    ensure_object_boundary_in_range=False,
                ),
            ),
            dict(
                name="obj2", obj_groups="kettle_non_electric", graspable=True,
                placement=dict(fixture=self.ref_cab, size=(0.50, 0.30), pos=(0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference heat_multiple_water.py:127-147."""
        pot_loc = obj_location_on_stove(self, "obj", self.stove, threshold=0.15)
        kettle_loc = obj_location_on_stove(self, "obj2", self.stove)
        placed = (
            pot_loc is not None and kettle_loc is not None and pot_loc != kettle_loc
        )
        return placed and gripper_obj_far(self) and gripper_obj_far(self, "obj2")


class VeggieBoil(Kitchen):
    """Reference boiling/veggie_boil.py:4-186."""

    def __init__(self, *args, **kwargs):
        self.pot_filled = False
        self.filled_time = 0
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter_sink = self.register_fixture_ref(
            "counter_sink", dict(id=FixtureType.COUNTER, ref=self.sink, size=(0.5, 0.5))
        )
        self.stove = self.register_fixture_ref("stove", dict(id=FixtureType.STOVE))
        self.counter_stove = self.register_fixture_ref(
            "counter_stove", dict(id=FixtureType.COUNTER, ref=self.stove)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        food_name = self.get_obj_lang("food")
        ep_meta["lang"] = (
            "Pick up the pot and place it in the sink. "
            "Then turn on the sink faucet and let the pot fill up with water. "
            "Then turn the sink faucet off and move the pot to the stove. "
            f"Lastly, turn on the stove and place the {food_name} in the pot "
            "for boiling."
        )
        return ep_meta

    def _reset_internal(self):
        self.pot_filled = False
        self.filled_time = 0
        super()._reset_internal()
        self.sink.set_handle_state(mode="off", env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name="pot", obj_groups="pot",
                placement=dict(
                    fixture=self.counter_sink,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.5, 0.5)
                    ),
                    size=(0.05, 0.05), pos=("ref", -0.55),
                    ensure_object_boundary_in_range=False,
                ),
            ),
            dict(
                name="food", obj_groups="vegetable",
                placement=dict(
                    fixture=self.counter_stove,
                    sample_region_kwargs=dict(ref=self.stove, loc="nn"),
                    size=(0.5, 0.5), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter_stove,
                    sample_region_kwargs=dict(ref=self.stove, loc="nn"),
                    size=(0.30, 0.30), pos=(0, 1.0),
                ),
            ),
        ]
        if self.counter_sink is not self.counter_stove:
            cfgs.append(
                dict(
                    name="distr_counter2", obj_groups="all",
                    placement=dict(
                        fixture=self.counter_sink,
                        sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                        size=(0.30, 0.30), pos=(0, 1.0),
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference veggie_boil.py:168-186: pot filled in the sink for
        >10 steps, then moved to a lit burner with the food inside and
        the faucet off."""
        pot_in_sink = obj_inside_of(self, "pot", self.sink)
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        if pot_in_sink and water_on:
            self.filled_time += 1
            self.pot_filled = self.filled_time > 10
        else:
            self.filled_time = 0
        veg_in_pot = check_obj_in_receptacle(self, "food", "pot")
        pot_on_stove = obj_location_on_stove(self, "pot", self.stove) is not None
        return self.pot_filled and veg_in_pot and not water_on and pot_on_stove
