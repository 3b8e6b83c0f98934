"""Tidying Cabinets And Drawers activity tasks (reference
robocasa/environments/kitchen/multi_stage/tidying_cabinets_and_drawers/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/tidying_cabinets_and_drawers.py``,
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
)
from lipvq_tpu_torch.robocasa.sim.single_stage import ManipulateDrawer


class DrawerUtensilSort(ManipulateDrawer):
    """Reference tidying_cabinets_and_drawers/drawer_utensil_sort.py:5-99."""

    def __init__(self, drawer_id=FixtureType.TOP_DRAWER, *args, **kwargs):
        super().__init__(behavior="open", drawer_id=drawer_id, *args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.drawer, size=(0.2, 0.2))
        )

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        lang = (
            f"{self.behavior} the {self.drawer_side} drawer and push the "
            "utensils inside it."
        )
        ep_meta["lang"] = lang[0].capitalize() + lang[1:]
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name=f"utensil{i}", obj_groups="utensil", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.drawer),
                    size=(0.3, 0.4), pos=("ref", -1.0), offset=(dx, 0.0),
                ),
            )
            for i, dx in ((1, -0.05), (2, 0.05))
        ]

    def _check_success(self):
        """Reference drawer_utensil_sort.py:82-99 (counter-contact
        exclusion guards against the closed-drawer bounding-box
        overlap)."""
        u1 = obj_inside_of(self, "utensil1", self.drawer) and not (
            check_obj_fixture_contact(self, "utensil1", self.counter)
        )
        u2 = obj_inside_of(self, "utensil2", self.drawer) and not (
            check_obj_fixture_contact(self, "utensil2", self.counter)
        )
        far = gripper_obj_far(self, obj_name="utensil1") and gripper_obj_far(
            self, obj_name="utensil2"
        )
        return u1 and u2 and far


class OrganizeCleaningSupplies(Kitchen):
    """Reference tidying_cabinets_and_drawers/organize_cleaning_supplies.py:4-137."""

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id, ref=self.sink))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        cleaner_name = self.get_obj_lang("cleaner")
        ep_meta["lang"] = (
            "Open the cabinet. "
            f"Pick the {cleaner_name} and place it next to the sink. "
            "Then close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name="cleaner", obj_groups="cleaner", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0, -1.0)),
            )
        ]
        for i, off in ((1, (0.0, 0.30)), (2, (0.0, 0.0))):
            cfgs.append(
                dict(
                    name=f"distr_counter_{i}", obj_groups="all",
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                        size=(0.30, 0.30), pos=("ref", -1.0), offset=off,
                    ),
                )
            )
        return cfgs

    def _obj_sink_dist(self, obj_name):
        """Reference organize_cleaning_supplies.py:109-117."""
        sink_points = self.sink.get_ext_sites(all_points=True, relative=False)
        obj_point = self.object_pos(obj_name)
        return float(min(np.linalg.norm(p - obj_point) for p in sink_points))

    def _check_success(self):
        """Reference organize_cleaning_supplies.py:119-137."""
        far = gripper_obj_far(self, obj_name="cleaner")
        on_counter = check_obj_fixture_contact(self, "cleaner", self.counter)
        close = self._obj_sink_dist("cleaner") < 0.35
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return far and on_counter and closed and close


class PantryMishap(ManipulateDrawer):
    """Reference tidying_cabinets_and_drawers/pantry_mishap.py:5-96."""

    def __init__(self, *args, **kwargs):
        super().__init__(behavior="close", *args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.drawer)
        )
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.drawer)
        )

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        vegetable = self.get_obj_lang("vegetable")
        ep_meta["lang"] = (
            f"Place the {vegetable} on the counter and the canned food in "
            "the drawer. Close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.9, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="vegetable", obj_groups="vegetable",
                placement=dict(fixture=self.cab, size=(0.5, 0.2), pos=(0, -1.0)),
            ),
            dict(
                name="canned_food", obj_groups="canned_food",
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference pantry_mishap.py:84-96."""
        veg_on_counter = check_obj_fixture_contact(self, "vegetable", self.counter)
        can_in_drawer = obj_inside_of(self, "canned_food", self.drawer)
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return veg_on_counter and can_in_drawer and closed


class ShakerShuffle(ManipulateDrawer):
    """Reference tidying_cabinets_and_drawers/shaker_shuffle.py:5-96."""

    def __init__(self, *args, **kwargs):
        super().__init__(behavior="close", *args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref(
            "cab", dict(id=FixtureType.CABINET_TOP, ref=self.drawer)
        )

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick and place the shaker into the drawer. Then close the cabinet."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.9, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="shaker1", obj_groups="shaker",
                placement=dict(fixture=self.cab, size=(0.5, 0.2), pos=(0, -1.0)),
            ),
            dict(
                name="shaker2", obj_groups="shaker",
                placement=dict(fixture=self.cab, size=(0.5, 0.2), pos=(0, -1.0)),
            ),
            dict(
                name="condiment", obj_groups="condiment_bottle",
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference shaker_shuffle.py:82-96: only the shakers go in."""
        shakers_in = (
            obj_inside_of(self, "shaker1", self.drawer)
            and obj_inside_of(self, "shaker2", self.drawer)
            and not obj_inside_of(self, "condiment", self.drawer)
        )
        closed = all(p <= 0.05 for p in self.cab.get_door_state(env=self).values())
        return shakers_in and closed


class SnackSorting(ManipulateDrawer):
    """Reference tidying_cabinets_and_drawers/snack_sorting.py:5-90."""

    def __init__(self, *args, **kwargs):
        super().__init__(behavior="close", *args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.drawer)
        )

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Place the bar in the bowl and close the drawer."
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="bar", obj_groups="bar", graspable=True,
                max_size=(None, None, 0.10),
                placement=dict(
                    fixture=self.drawer, size=(0.30, 0.30), pos=(None, -0.75),
                    offset=(0, -self.drawer.size[1] * 0.55),
                ),
            ),
            dict(
                name="dist", obj_groups="all", max_size=(None, None, 0.10),
                placement=dict(
                    fixture=self.drawer, size=(0.30, 0.30), pos=(None, 1),
                    offset=(0, -self.drawer.size[1] * 0.55),
                ),
            ),
            dict(
                name="bowl", obj_groups="bowl",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.drawer),
                    size=(0.60, 0.40), pos=("ref", -1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference snack_sorting.py:82-90."""
        bars_in_bowl = check_obj_in_receptacle(self, "bar", "bowl")
        door_closed = super()._check_success()
        return bars_in_bowl and door_closed
