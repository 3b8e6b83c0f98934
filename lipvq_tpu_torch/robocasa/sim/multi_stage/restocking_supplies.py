"""Restocking Supplies activity tasks (reference
robocasa/environments/kitchen/multi_stage/restocking_supplies/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/restocking_supplies.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    gripper_obj_far,
    obj_inside_of,
)


class BeverageSorting(Kitchen):
    """Reference restocking_supplies/beverage_sorting.py:4-116."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab1 = self.register_fixture_ref(
            "cabinet1", dict(id=FixtureType.CABINET_TOP)
        )
        self.cab2 = self.register_fixture_ref(
            "cabinet2", dict(id=FixtureType.CABINET_TOP, ref=self.cab1)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(0.5, 0.5), ref=self.cab1)
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Sort all alcoholic drinks to one cabinet, and non-alcoholic "
            "drinks to the other."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab1.set_door_state(min=0.85, max=0.9, env=self, rng=self.rng)
        self.cab2.set_door_state(min=0.85, max=0.9, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = []
        for i in (1, 2):
            cfgs.append(
                dict(
                    name=f"alcohol{i}", obj_groups="alcohol", graspable=True,
                    placement=dict(fixture=self.counter, size=(0.5, 0.40), pos=(0, -1.0)),
                )
            )
            cfgs.append(
                dict(
                    name=f"non_alcohol{i}", obj_groups="drink",
                    exclude_obj_groups="alcohol", graspable=True,
                    placement=dict(fixture=self.counter, size=(0.5, 0.40), pos=(0, -1.0)),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference beverage_sorting.py:99-116."""
        for obj_name in ("alcohol1", "alcohol2", "non_alcohol1", "non_alcohol2"):
            if not gripper_obj_far(self, obj_name=obj_name):
                return False
        for c1, c2 in ((self.cab1, self.cab2), (self.cab2, self.cab1)):
            if (
                obj_inside_of(self, "alcohol1", c1)
                and obj_inside_of(self, "alcohol2", c1)
                and obj_inside_of(self, "non_alcohol1", c2)
                and obj_inside_of(self, "non_alcohol2", c2)
            ):
                return True
        return False


class RestockBowls(Kitchen):
    """Reference restocking_supplies/restock_bowls.py:4-98."""

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
        obj_name_1 = self.get_obj_lang("obj1")
        obj_name_2 = self.get_obj_lang("obj2")
        ep_meta["lang"] = (
            "Open the cabinet. "
            f"Pick the {obj_name_1} and the {obj_name_2} from the counter and "
            "place it in the cabinet directly in front. Then close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name=f"obj{i}", obj_groups="bowl", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab, top_size=(0.6, 0.4)),
                    size=(0.50, 0.50), pos=(px, -1),
                ),
            )
            for i, px in ((1, -0.5), (2, 0.5))
        ]

    def _check_success(self):
        """Reference restock_bowls.py:87-98."""
        in1 = obj_inside_of(self, "obj1", self.cab)
        in2 = obj_inside_of(self, "obj2", self.cab)
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return in1 and in2 and closed


class RestockPantry(Kitchen):
    """Reference restocking_supplies/restock_pantry.py:4-160."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.DOOR_TOP_HINGE_DOUBLE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the cans from the counter and place them in their "
            "designated side in the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=1.0, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        side = int(self.rng.choice([-1, 1]))
        return [
            dict(
                name="obj1", obj_groups="canned_food", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.50, 0.30), pos=("ref", -1),
                ),
            ),
            dict(
                name="obj2", obj_groups="canned_food", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.50, 0.30), pos=("ref", -1),
                ),
            ),
            dict(
                name="cab_obj1", obj_groups="canned_food", graspable=True,
                placement=dict(fixture=self.cab, size=(0.2, 0.30), pos=(side, -0.3)),
            ),
            dict(
                name="cab_obj2", obj_groups="all",
                exclude_obj_groups="canned_food", graspable=True,
                placement=dict(fixture=self.cab, size=(0.2, 0.30), pos=(side * -1, 0.3)),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.30), pos=(0.0, 1.0), offset=(0.0, -0.05),
                ),
            ),
        ]

    def _close_to_cab_cans(self, obj_name, ratio=2):
        """Reference restock_pantry.py:121-146."""
        obj_pos = self.object_pos(obj_name)
        can_pos = self.object_pos("cab_obj1")
        other_pos = self.object_pos("cab_obj2")
        can_dist = np.linalg.norm(obj_pos - can_pos)
        other_dist = np.linalg.norm(other_pos - obj_pos)
        return can_dist * ratio < other_dist

    def _check_success(self):
        """Reference restock_pantry.py:148-160."""
        in1 = obj_inside_of(self, "obj1", self.cab)
        in2 = obj_inside_of(self, "obj2", self.cab)
        cans_close = self._close_to_cab_cans("obj1") and self._close_to_cab_cans("obj2")
        far = gripper_obj_far(self, "obj1") and gripper_obj_far(self, "obj2")
        return in1 and in2 and cans_close and far


class StockingBreakfastFoods(Kitchen):
    """Reference restocking_supplies/stocking_breakfast_foods.py:4-205."""

    def __init__(
        self,
        cab_id1=FixtureType.CABINET_TOP,
        cab_id2=FixtureType.CABINET_TOP,
        *args,
        **kwargs,
    ):
        self.cab_id1 = cab_id1
        self.cab_id2 = cab_id2
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        if "cab2" in self.fixture_refs:
            self.cab1 = self.fixture_refs["cab1"]
            self.cab2 = self.fixture_refs["cab2"]
            self.counter = self.fixture_refs["counter"]
            self.counter2 = self.fixture_refs["counter2"]
        else:
            self.cab1 = self.register_fixture_ref("cab1", dict(id=self.cab_id1))
            for _ in range(100):
                # sample until 2 different cabinets are selected
                self.cab2 = self.get_fixture(self.cab_id2)
                if self.cab2 is not self.cab1:
                    break
            self.fixture_refs["cab2"] = self.cab2
            self.counter = self.register_fixture_ref(
                "counter", dict(id=FixtureType.COUNTER, ref=self.cab1)
            )
            self.counter2 = self.register_fixture_ref(
                "counter2", dict(id=FixtureType.COUNTER, ref=self.cab2)
            )
        self.init_robot_base_pos = self.cab1

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj_name_1 = self.get_obj_lang("obj1")
        obj_name_2 = self.get_obj_lang("obj2")
        ep_meta["lang"] = (
            f"Pick the {obj_name_1} and {obj_name_2} from the counter and "
            "place them in the cabinets closest to them."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab1.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        self.cab2.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj1", obj_groups="packaged_food", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab1),
                    size=(0.40, 0.20), pos=("ref", -1),
                ),
            ),
            dict(
                name="obj2", obj_groups="packaged_food", graspable=True,
                placement=dict(
                    fixture=self.counter2,
                    sample_region_kwargs=dict(ref=self.cab2),
                    size=(0.40, 0.20), pos=("ref", -1),
                ),
            ),
            dict(
                name="distr_counter1", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab1),
                    size=(1.0, 0.30), pos=(0.0, 1.0), offset=(0.0, -0.05),
                ),
            ),
            dict(
                name="distr_cab1", obj_groups="all",
                placement=dict(fixture=self.cab1, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
            dict(
                name="distr_counter2", obj_groups="all",
                placement=dict(
                    fixture=self.counter2,
                    sample_region_kwargs=dict(ref=self.cab2),
                    size=(1.0, 0.30), pos=(0.0, 1.0), offset=(0.0, -0.05),
                ),
            ),
            dict(
                name="distr_cab2", obj_groups="all",
                placement=dict(fixture=self.cab2, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference stocking_breakfast_foods.py:196-205."""
        return (
            obj_inside_of(self, "obj1", self.cab1)
            and obj_inside_of(self, "obj2", self.cab2)
            and gripper_obj_far(self, "obj1")
            and gripper_obj_far(self, "obj2")
        )
