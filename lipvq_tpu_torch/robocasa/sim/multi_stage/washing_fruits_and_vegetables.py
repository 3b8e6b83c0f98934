"""Washing Fruits And Vegetables activity tasks (reference
robocasa/environments/kitchen/multi_stage/washing_fruits_and_vegetables/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/washing_fruits_and_vegetables.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_in_receptacle,
    gripper_obj_far,
    obj_inside_of,
)
from lipvq_tpu_torch.robocasa.sim.objects import get_cats_by_type


class AfterwashSorting(Kitchen):
    """Reference washing_fruits_and_vegetables/afterwash_sorting.py:6-144."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        food12_name = self.get_obj_lang("food1")
        food3_name = self.get_obj_lang("food3")
        ep_meta["lang"] = (
            f"Pick the {food12_name}s from the sink and place them in one "
            f"bowl. Place the {food3_name} in the other bowl. Then turn off "
            "the sink faucet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.sink.set_handle_state(mode="on", env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        food_items = get_cats_by_type(
            types=["vegetable", "fruit"], obj_registries=self.obj_registries
        )
        picks = self.rng.choice(sorted(food_items), size=2, replace=False)
        food1, food2 = str(picks[0]), str(picks[1])
        cfgs = [
            dict(
                name="food1", obj_groups=food1, graspable=True, washable=True,
                placement=dict(fixture=self.sink, size=(0.2, 0.2), pos=(-1.0, -1.0)),
            ),
            dict(
                name="food2", obj_groups=food1, graspable=True, washable=True,
                placement=dict(fixture=self.sink, size=(0.2, 0.2), pos=(1.0, 1.0)),
            ),
            dict(
                name="food3", obj_groups=food2, graspable=True, washable=True,
                placement=dict(fixture=self.sink, size=(0.2, 0.2), pos=(-1.0, 1.0)),
            ),
        ]
        for i in (1, 2):
            cfgs.append(
                dict(
                    name=f"bowl{i}", obj_groups="bowl",
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                        size=(0.50, 0.50), pos=("ref", -1.0),
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference afterwash_sorting.py:124-144."""
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        f1b1 = check_obj_in_receptacle(self, "food1", "bowl1")
        f1b2 = check_obj_in_receptacle(self, "food1", "bowl2")
        f2b1 = check_obj_in_receptacle(self, "food2", "bowl1")
        f2b2 = check_obj_in_receptacle(self, "food2", "bowl2")
        f3b1 = check_obj_in_receptacle(self, "food3", "bowl1")
        f3b2 = check_obj_in_receptacle(self, "food3", "bowl2")
        pair_in_1 = f1b1 and f2b1
        pair_in_2 = f1b2 and f2b2
        return (not water_on) and (
            (pair_in_1 and f3b2) or (pair_in_2 and f3b1)
        )


class ClearClutter(Kitchen):
    """Reference washing_fruits_and_vegetables/clear_clutter.py:4-160."""

    def __init__(self, *args, **kwargs):
        self.food_washed = False
        self.washed_time = 0
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink, size=(0.6, 0.6))
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick up the fruits and vegetables and place them in the sink. "
            "Turn on the sink faucet to wash them. Then turn the sink off "
            "and put them in the tray."
        )
        return ep_meta

    def _reset_internal(self):
        self.food_washed = False
        self.washed_time = 0
        super()._reset_internal()

    def _get_obj_cfgs(self):
        cfgs = []
        self.num_food = int(self.rng.choice([1, 2]))
        self.num_unwashable = int(self.rng.choice([1, 2]))
        for i in range(self.num_food):
            cfgs.append(
                dict(
                    name=f"obj_{i}", obj_groups=["vegetable", "fruit"],
                    graspable=True, washable=True,
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                        size=(0.40, 0.40), pos=("ref", -1.0),
                    ),
                )
            )
        for i in range(self.num_unwashable):
            cfgs.append(
                dict(
                    name=f"unwashable_obj_{i}", obj_groups="all",
                    exclude_obj_groups=["food", "tray"],
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                        size=(0.40, 0.40), pos=("ref", -1.0),
                    ),
                )
            )
        cfgs.append(
            dict(
                name="receptacle", obj_groups="tray",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.6, 0.6)
                    ),
                    size=(0.6, 0.8), pos=("ref", -1.0),
                ),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference clear_clutter.py:118-160: wash >10 steps with only
        washable food in the sink, then transfer to the tray with the
        water off."""
        food_in_sink = all(
            obj_inside_of(self, f"obj_{i}", self.sink) for i in range(self.num_food)
        )
        unwashables_out = all(
            not obj_inside_of(self, f"unwashable_obj_{i}", self.sink)
            for i in range(self.num_unwashable)
        )
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        if food_in_sink and unwashables_out and water_on:
            self.washed_time += 1
            self.food_washed = self.washed_time > 10
        else:
            self.washed_time = 0
        food_in_tray = all(
            check_obj_in_receptacle(self, f"obj_{i}", "receptacle")
            for i in range(self.num_food)
        )
        unwashables_not_in_tray = all(
            not check_obj_in_receptacle(self, f"unwashable_obj_{i}", "receptacle")
            for i in range(self.num_unwashable)
        )
        return (
            self.food_washed
            and food_in_tray
            and unwashables_not_in_tray
            and not water_on
        )


class DrainVeggies(Kitchen):
    """Reference washing_fruits_and_vegetables/drain_veggies.py:4-103."""

    def __init__(self, *args, **kwargs):
        self.vegetables_washed = False
        self.washed_time = 0
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink, size=(0.6, 0.6))
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        food_name = self.get_obj_lang("obj")
        ep_meta["lang"] = (
            f"Dump the {food_name} from the pot into the sink. Then turn on "
            f"the water and wash the {food_name}. Then turn off the water "
            f"and put the {food_name} back in the pot."
        )
        return ep_meta

    def _reset_internal(self):
        self.vegetables_washed = False
        self.washed_time = 0
        super()._reset_internal()

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="vegetable",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(
                        ref=self.sink, loc="left_right", top_size=(0.6, 0.6)
                    ),
                    try_to_place_in="pot",
                    size=(0.6, 0.4), pos=("ref", -1.0),
                ),
            )
        ]

    def _check_success(self):
        """Reference drain_veggies.py:85-103."""
        veg_in_sink = obj_inside_of(self, "obj", self.sink)
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        if veg_in_sink and water_on:
            self.washed_time += 1
            self.vegetables_washed = self.washed_time > 10
        else:
            self.washed_time = 0
        veg_in_pot = check_obj_in_receptacle(self, "obj", "obj_container")
        return self.vegetables_washed and veg_in_pot and not water_on


class PrewashFoodAssembly(Kitchen):
    """Reference washing_fruits_and_vegetables/prewash_food_assembly.py:4-123."""

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter_cab = self.register_fixture_ref(
            "counter_cab", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.counter_sink = self.register_fixture_ref(
            "counter_sink", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        food_name = self.get_obj_lang("food")
        ep_meta["lang"] = (
            f"Pick the {food_name} from the cabinet and place it in the "
            "bowl. Then pick the bowl and place it in the sink. Then turn on "
            "the sink facuet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="food", obj_groups=["vegetable", "fruit"], graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0, -1.0)),
            ),
            dict(
                name="bowl", obj_groups="bowl", graspable=True,
                placement=dict(
                    fixture=self.counter_cab,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.50, 0.40), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference prewash_food_assembly.py:113-123."""
        return (
            gripper_obj_far(self, obj_name="bowl")
            and check_obj_in_receptacle(self, "food", "bowl")
            and obj_inside_of(self, "bowl", self.sink)
            and self.sink.get_handle_state(env=self)["water_on"]
        )
