"""Clearing Table activity tasks (reference
robocasa/environments/kitchen/multi_stage/clearing_table/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/clearing_table.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import Counter, FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_fixture_contact,
    check_obj_in_receptacle,
    gripper_obj_far,
    obj_inside_of,
)


def _doors_closed(cab, env, th=0.05):
    """Shared door-closed predicate (reference pattern, e.g.
    candle_cleanup.py:136-142)."""
    return all(p <= th for p in cab.get_door_state(env=env).values())


class BowlAndCup(Kitchen):
    """Reference clearing_table/bowl_and_cup.py:4-77."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5, 7, 8, 9]

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.island = self.register_fixture_ref("island", dict(id=FixtureType.ISLAND))
        self.init_robot_base_pos = self.island

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Place the cup inside the bowl on the island and move the bowl "
            "to any counter."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="cup", obj_groups=["cup"], graspable=True, washable=True,
                placement=dict(fixture=self.island, size=(0.30, 0.40), pos=(0, -1.0)),
            ),
            dict(
                name="bowl", obj_groups=["bowl"], graspable=True, washable=True,
                placement=dict(fixture=self.island, size=(0.30, 0.40), pos=(0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference bowl_and_cup.py:66-77."""
        cup_in_bowl = check_obj_in_receptacle(self, "cup", "bowl")
        bowl_on_counter = any(
            check_obj_fixture_contact(self, "bowl", fxtr)
            for fxtr in self.fixtures.values()
            if isinstance(fxtr, Counter) and fxtr is not self.island
        )
        return cup_in_bowl and bowl_on_counter and gripper_obj_far(self, "bowl")


class CandleCleanup(Kitchen):
    """Reference clearing_table/candle_cleanup.py:4-147."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.dining_table = self.register_fixture_ref(
            "dining_table",
            dict(id=FixtureType.COUNTER, ref=FixtureType.STOOL, size=(0.75, 0.2)),
        )
        self.init_robot_base_pos = self.dining_table

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj_name_1 = self.get_obj_lang("obj1")
        obj_name_2 = self.get_obj_lang("obj2")
        ep_meta["lang"] = (
            f"Pick the {obj_name_1} and {obj_name_2} from the dining table "
            "and place them in the open cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.9, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = []
        for name, dx in (("obj1", -0.05), ("obj2", 0.05)):
            cfgs.append(
                dict(
                    name=name, obj_groups="decoration", graspable=True,
                    placement=dict(
                        fixture=self.dining_table, size=(0.60, 0.30),
                        sample_region_kwargs=dict(ref=self.cab),
                        pos=(0, -1), offset=(dx, 0),
                    ),
                )
            )
        cfgs.append(
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.dining_table, size=(1.0, 0.30), pos=(0.0, 0.0)
                ),
            )
        )
        cfgs.append(
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference candle_cleanup.py:131-147."""
        return (
            _doors_closed(self.cab, self)
            and obj_inside_of(self, "obj1", self.cab)
            and obj_inside_of(self, "obj2", self.cab)
        )


class ClearingCleaningReceptacles(Kitchen):
    """Reference clearing_table/clearing_cleaning_receptacles.py:4-111."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.dining_table = self.register_fixture_ref(
            "dining_table",
            dict(id=FixtureType.COUNTER, ref=FixtureType.STOOL, size=(0.75, 0.2)),
        )
        self.init_robot_base_pos = self.dining_table

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj_name_1 = self.get_obj_lang("receptacle1")
        obj_name_2 = self.get_obj_lang("receptacle2")
        ep_meta["lang"] = (
            f"Pick the {obj_name_1} and {obj_name_2} and place them in the "
            "sink. Then turn on the water."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.sink.set_handle_state(mode="off", env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = []
        for i in (1, 2):
            cfgs.append(
                dict(
                    name=f"receptacle{i}", obj_groups="receptacle",
                    graspable=True, washable=True,
                    placement=dict(
                        fixture=self.dining_table,
                        sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                        size=(0.8, 0.4), pos=("ref", -1.0),
                    ),
                )
            )
        cfgs.append(
            dict(
                name="distr_sink", obj_groups="all", washable=True,
                placement=dict(fixture=self.sink, size=(0.25, 0.25), pos=(0.0, 1.0)),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference clearing_cleaning_receptacles.py:103-111."""
        in1 = obj_inside_of(self, "receptacle1", self.sink)
        in2 = obj_inside_of(self, "receptacle2", self.sink)
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        return in1 and in2 and water_on


class CondimentCollection(Kitchen):
    """Reference clearing_table/condiment_collection.py:4-138."""

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj_name_1 = self.get_obj_lang("condiment1")
        obj_name_2 = self.get_obj_lang("condiment2")
        ep_meta["lang"] = (
            f"Pick the {obj_name_1} and {obj_name_2} from the counter and "
            "place them in the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = []
        for name, px, dx in (("condiment1", 0.60, 0.05), ("condiment2", -0.60, -0.05)):
            cfgs.append(
                dict(
                    name=name, obj_groups="condiment", graspable=True,
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.cab),
                        size=(0.30, 0.30), pos=(px, -1.0), offset=(dx, 0.0),
                    ),
                )
            )
        cfgs.append(
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.30), pos=(0.0, 1.0), offset=(0.0, -0.05),
                ),
            )
        )
        cfgs.append(
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference condiment_collection.py:126-138."""
        return (
            obj_inside_of(self, "condiment1", self.cab)
            and obj_inside_of(self, "condiment2", self.cab)
            and gripper_obj_far(self, obj_name="condiment1")
            and gripper_obj_far(self, obj_name="condiment2")
        )


class DessertAssembly(Kitchen):
    """Reference clearing_table/dessert_assembly.py:4-96."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER_NON_CORNER, size=(1.0, 0.4))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        dessert1 = self.get_obj_lang("dessert1")
        container = self.get_obj_lang("dessert1_container")
        ep_meta["lang"] = (
            f"Pick up the {container} with {dessert1} and place it on the "
            "tray. Pick up the cupcake and place it on the tray."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="receptacle", obj_groups="tray", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(1.0, 0.4)),
                    size=(1, 0.4), pos=(0, -1),
                ),
            ),
            dict(
                name="dessert1", obj_groups=["donut", "cake"], graspable=True,
                placement=dict(
                    fixture=self.counter, size=(1, 0.4), pos=(0, -1),
                    try_to_place_in="bowl",
                ),
            ),
            dict(
                name="dessert2", obj_groups="cupcake", graspable=True,
                placement=dict(fixture=self.counter, size=(1, 0.4), pos=(0, -1)),
            ),
        ]

    def _check_success(self):
        """Reference dessert_assembly.py:88-96."""
        sweets_on_tray = (
            check_obj_in_receptacle(self, "dessert1", "dessert1_container")
            and check_obj_in_receptacle(self, "dessert2", "receptacle")
            and check_obj_in_receptacle(self, "dessert1_container", "receptacle")
        )
        return sweets_on_tray and gripper_obj_far(self, "receptacle")


class DrinkwareConsolidation(Kitchen):
    """Reference clearing_table/drinkware_consolidation.py:4-80."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5, 7, 8, 9]

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.island = self.register_fixture_ref("island", dict(id=FixtureType.ISLAND))
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.island)
        )
        self.init_robot_base_pos = self.island

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        objs_lang = self.get_obj_lang("obj_0")
        for i in range(1, self.num_drinkware):
            objs_lang += f", {self.get_obj_lang(f'obj_{i}')}"
        them = "them" if self.num_drinkware > 1 else "it"
        ep_meta["lang"] = (
            f"Pick the {objs_lang} from the island and place {them} in the "
            "open cabinet."
        )
        return ep_meta

    def reset(self, seed=None):
        obs = super().reset(seed=seed)
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        return obs

    def _get_obj_cfgs(self):
        cfgs = []
        self.num_drinkware = int(self.rng.choice([1, 2, 3]))
        for i in range(self.num_drinkware):
            cfgs.append(
                dict(
                    name=f"obj_{i}", obj_groups=["drink"],
                    graspable=True, washable=True,
                    placement=dict(
                        fixture=self.island,
                        sample_region_kwargs=dict(ref=self.cab),
                        size=(0.30, 0.40), pos=("ref", -1.0),
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference drinkware_consolidation.py:68-80."""
        objs_in_cab = all(
            obj_inside_of(self, f"obj_{i}", self.cab)
            for i in range(self.num_drinkware)
        )
        far = all(
            gripper_obj_far(self, f"obj_{i}") for i in range(self.num_drinkware)
        )
        return objs_in_cab and far


class FoodCleanup(Kitchen):
    """Reference clearing_table/food_cleanup.py:4-98."""

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        items = self.get_obj_lang("food0")
        for i in range(1, self.num_food):
            items += f", {self.get_obj_lang(f'food{i}')}"
        them = "them" if self.num_food > 1 else "it"
        ep_meta["lang"] = (
            f"Pick the {items} from the counter and place {them} in the "
            "cabinet. Then close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = []
        self.num_food = int(self.rng.choice([1, 2, 3]))
        for i in range(self.num_food):
            cfgs.append(
                dict(
                    name=f"food{i}",
                    obj_groups=["fruit", "vegetable", "boxed_food"],
                    graspable=True,
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.cab),
                        size=(0.30, 0.30), pos=("ref", -1.0), offset=(0.05, 0.0),
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference food_cleanup.py:87-98."""
        food_inside = all(
            obj_inside_of(self, f"food{i}", self.cab) for i in range(self.num_food)
        )
        return _doors_closed(self.cab, self) and food_inside
