"""Snack Preparation activity tasks (reference
robocasa/environments/kitchen/multi_stage/snack_preparation/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/snack_preparation.py``,
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


class BreadAndCheese(Kitchen):
    """Reference snack_preparation/bread_and_cheese.py:4-81."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER_NON_CORNER, size=(0.6, 0.6))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Place the bread and cheese on the cutting board."
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="bread", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(0.6, 0.6)),
                    size=(0.50, 0.30), pos=(0, -1),
                ),
            ),
            dict(
                name="container", obj_groups="cutting_board",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(0.6, 0.6)),
                    size=(0.5, 0.5), pos=(0.0, -1.0),
                ),
            ),
            dict(
                name="obj2", obj_groups="cheese",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(0.6, 0.6)),
                    size=(0.3, 0.15), pos=(0.0, -1.0), offset=(-0.05, 0.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference bread_and_cheese.py:74-81."""
        food_on_board = check_obj_in_receptacle(
            self, "obj", "container"
        ) and check_obj_in_receptacle(self, "obj2", "container")
        return food_on_board and gripper_obj_far(self)


class CerealAndBowl(Kitchen):
    """Reference snack_preparation/cereal_and_bowl.py:4-128."""

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
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
        ep_meta["lang"] = (
            "Open the cabinet. Pick the cereal and bowl from the cabinet and "
            "place them on the counter. Then close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        direction = float(self.rng.choice([1.0, -1.0]))
        return [
            dict(
                name="cereal", obj_groups="boxed_food", graspable=True,
                placement=dict(
                    fixture=self.cab, size=(0.30, 0.30), pos=(1.0 * direction, -1.0)
                ),
            ),
            dict(
                name="bowl", obj_groups="bowl", graspable=True,
                placement=dict(
                    fixture=self.cab, size=(0.50, 0.50), pos=(-1.0 * direction, -1.0)
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.30), pos=(0.0, 1.0),
                ),
            ),
            dict(
                name="milk", obj_groups="milk",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.5, 0.30), pos=(0.0, 0.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference cereal_and_bowl.py:117-128."""
        box_on = check_obj_fixture_contact(self, "cereal", self.counter)
        bowl_on = check_obj_fixture_contact(self, "bowl", self.counter)
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return box_on and bowl_on and closed


class MakeFruitBowl(Kitchen):
    """Reference snack_preparation/make_fruit_bowl.py:4-122."""

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab, size=(0.6, 0.4))
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        fruit1_name = self.get_obj_lang("fruit1")
        fruit2_name = self.get_obj_lang("fruit2")
        ep_meta["lang"] = (
            "Open the cabinet. "
            f"Pick the {fruit1_name} and {fruit2_name} from the cabinet and "
            "place them into the bowl. Then close the cabinet."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="bowl", obj_groups="bowl", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab, top_size=(0.6, 0.4)),
                    size=(1, 0.40), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="fruit1", obj_groups="fruit", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(-0.5, -1.0)),
            ),
            dict(
                name="fruit2", obj_groups="fruit", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0.5, -1.0)),
            ),
            dict(
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference make_fruit_bowl.py:111-122."""
        f1 = check_obj_in_receptacle(self, "fruit1", "bowl")
        f2 = check_obj_in_receptacle(self, "fruit2", "bowl")
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return f1 and f2 and closed


class VeggieDipPrep(Kitchen):
    """Reference snack_preparation/veggie_dip_prep.py:4-107."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(1, 0.6))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Place the two vegetables and a bowl onto the tray for setting "
            "up a vegetable dip station."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="tray", obj_groups="tray",
                placement=dict(fixture=self.counter, size=(0.3, 0.6), pos=(0, -1)),
            ),
            dict(
                name="cucumber", obj_groups="cucumber",
                placement=dict(fixture=self.counter, size=(0.8, 0.6), pos=(0, -1.0)),
            ),
            dict(
                name="carrot", obj_groups="carrot",
                placement=dict(fixture=self.counter, size=(0.8, 0.6), pos=(0, -1.0)),
            ),
            dict(
                name="bowl", obj_groups="bowl", graspable=True,
                placement=dict(fixture=self.counter, size=(0.8, 0.6), pos=(0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference veggie_dip_prep.py:96-107."""
        far = (
            gripper_obj_far(self, "bowl")
            and gripper_obj_far(self, "cucumber")
            and gripper_obj_far(self, "carrot")
        )
        veg_in_tray = check_obj_in_receptacle(
            self, "cucumber", "tray"
        ) and check_obj_in_receptacle(self, "carrot", "tray")
        bowl_in_tray = check_obj_in_receptacle(self, "bowl", "tray")
        return far and veg_in_tray and bowl_in_tray


class YogurtDelightPrep(Kitchen):
    """Reference snack_preparation/yogurt_delight_prep.py:4-101."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.DOOR_TOP_HINGE_DOUBLE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Place the yogurt and fruit onto the counter."
        return ep_meta

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name="yogurt", obj_groups="yogurt",
                placement=dict(fixture=self.cab, size=(0.5, 0.3), pos=(0, -1)),
            )
        ]
        self.num_fruits = int(self.rng.choice([1, 2, 3]))
        for i in range(self.num_fruits):
            cfgs.append(
                dict(
                    name=f"fruit_{i}", obj_groups="fruit",
                    placement=dict(
                        fixture=self.cab, size=(0.5, 0.2), pos=(0, -1),
                        offset=(0.05 * i, 0),
                    ),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference yogurt_delight_prep.py:85-101."""
        items_on = all(
            check_obj_fixture_contact(self, f"fruit_{i}", self.counter)
            for i in range(self.num_fruits)
        ) and check_obj_fixture_contact(self, "yogurt", self.counter)
        far = all(
            gripper_obj_far(self, f"fruit_{i}") for i in range(self.num_fruits)
        ) and gripper_obj_far(self, "yogurt")
        return items_on and far
