"""Setting The Table activity tasks (reference
robocasa/environments/kitchen/multi_stage/setting_the_table/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/setting_the_table.py``,
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


class ArrangeBreadBasket(Kitchen):
    """Reference setting_the_table/arrange_bread_basket.py:4-120."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def __init__(self, cab_id=FixtureType.CABINET_TOP, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter_small = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.dining_table = self.register_fixture_ref(
            "dining_table",
            dict(id=FixtureType.COUNTER, ref=FixtureType.STOOL, size=(0.75, 0.2)),
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        bread_name = self.get_obj_lang("bread")
        ep_meta["lang"] = (
            f"Open the cabinet, pick up the {bread_name} from the cabinet and "
            "place it in the bowl. Then move the bowl to the dining counter."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="bread", obj_groups="bread", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.40), pos=(0, -1.0)),
            ),
            dict(
                name="bowl", obj_groups="bowl", graspable=True,
                placement=dict(
                    fixture=self.counter_small,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.50, 0.50), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="dstr_dining", obj_groups="all",
                placement=dict(fixture=self.dining_table, size=(1, 0.30), pos=(0, 0)),
            ),
            dict(
                name="dstr_dining2", obj_groups="all",
                placement=dict(
                    fixture=self.dining_table, size=(1, 0.30), pos=(0, 0),
                    offset=(0.05, 0.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference arrange_bread_basket.py:112-120."""
        return (
            gripper_obj_far(self, obj_name="bowl")
            and check_obj_in_receptacle(self, "bread", "bowl")
            and check_obj_fixture_contact(self, "bowl", self.dining_table)
        )


class BeverageOrganization(Kitchen):
    """Reference setting_the_table/beverage_organization.py:4-90."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        if "counter" in self.fixture_refs:
            self.counter = self.fixture_refs["counter"]
            self.dining_table = self.fixture_refs["dining_table"]
        else:
            self.dining_table = self.register_fixture_ref(
                "dining_table",
                dict(id=FixtureType.COUNTER, ref=FixtureType.STOOL, size=(0.75, 0.2)),
            )
            self.counter = self.get_fixture(id=FixtureType.COUNTER)
            for _ in range(100):
                if self.counter is not self.dining_table:
                    break
                self.counter = self.get_fixture(FixtureType.COUNTER)
            self.fixture_refs["counter"] = self.counter
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "Move the drinks to the dining counter."
        return ep_meta

    def _get_obj_cfgs(self):
        self.num_bev = int(self.rng.choice([2, 3, 4]))
        return [
            dict(
                name=f"obj_{i}", obj_groups="drink",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(0.6, 0.4)),
                    size=(0.6, 0.4), pos=(0, -1.0),
                ),
            )
            for i in range(self.num_bev)
        ]

    def _check_success(self):
        """Reference beverage_organization.py:81-90."""
        drinks_on_dining = all(
            check_obj_fixture_contact(self, f"obj_{i}", self.dining_table)
            for i in range(self.num_bev)
        )
        return drinks_on_dining and gripper_obj_far(self, "obj_0")


class DateNight(Kitchen):
    """Reference setting_the_table/date_night.py:4-110."""

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
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        decoration_name = self.get_obj_lang("decoration")
        alcohol_name = self.get_obj_lang("alcohol")
        ep_meta["lang"] = (
            f"Pick up the {decoration_name} and the {alcohol_name} from the "
            "cabinet and move them to the dining counter."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="decoration", obj_groups="decoration", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(1.0, -1.0)),
            ),
            dict(
                name="alcohol", obj_groups="alcohol", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(-1.0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference date_night.py:99-110."""
        return (
            gripper_obj_far(self, obj_name="decoration")
            and check_obj_fixture_contact(self, "decoration", self.dining_table)
            and check_obj_fixture_contact(self, "alcohol", self.dining_table)
        )


class SeasoningSpiceSetup(Kitchen):
    """Reference setting_the_table/seasoning_spice_setup.py:4-135."""

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
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        condiment1_name = self.get_obj_lang("condiment1")
        condiment2_name = self.get_obj_lang("condiment2")
        ep_meta["lang"] = (
            f"Move the {condiment1_name} and {condiment2_name} from the "
            "cabinet to the dining counter."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name=f"condiment{i}", obj_groups="condiment", graspable=True,
                placement=dict(fixture=self.cab, size=(0.4, 0.20), pos=(px, -1.0)),
            )
            for i, px in ((1, -0.5), (2, 0.5))
        ]
        cfgs.append(
            dict(
                name="dstr_dining", obj_groups="all",
                placement=dict(fixture=self.dining_table, size=(1, 0.30), pos=(0, 0)),
            )
        )
        cfgs.append(
            dict(
                name="dstr_dining2", obj_groups="all",
                placement=dict(
                    fixture=self.dining_table, size=(1, 0.30), pos=(0, 0),
                    offset=(0.05, 0.0),
                ),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference seasoning_spice_setup.py:121-135."""
        return (
            gripper_obj_far(self, obj_name="condiment1")
            and gripper_obj_far(self, obj_name="condiment2")
            and check_obj_fixture_contact(self, "condiment1", self.dining_table)
            and check_obj_fixture_contact(self, "condiment2", self.dining_table)
        )


class SetBowlsForSoup(Kitchen):
    """Reference setting_the_table/set_bowls_for_soup.py:4-137."""

    EXCLUDE_LAYOUTS = [0, 2, 4, 5]

    def __init__(self, cab_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        self.cab_id = cab_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=self.cab_id))
        self.counter_large = self.register_fixture_ref(
            "dining_table",
            dict(id=FixtureType.COUNTER, ref=FixtureType.STOOL, size=(0.75, 0.2)),
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Move the bowls from the cabinet to the plates on the dining table."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="plate1", obj_groups="plate", graspable=False,
                placement=dict(
                    fixture=self.counter_large,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.80, 0.50), pos=(-0.3, -1.0), offset=(-0.05, 0),
                ),
            ),
            dict(
                name="plate2", obj_groups="plate", graspable=False,
                placement=dict(
                    fixture=self.counter_large,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.80, 0.50), pos=(0.3, -1.0), offset=(0.05, 0),
                ),
            ),
            dict(
                name="bowl1", obj_groups="bowl", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.50), pos=(-1.0, -1.0)),
            ),
            dict(
                name="bowl2", obj_groups="bowl", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.50), pos=(1.0, -1.0)),
            ),
        ]

    def _check_success(self):
        """Reference set_bowls_for_soup.py:122-137 (the reference's
        `or` in the second arrangement is reproduced verbatim)."""
        far1 = gripper_obj_far(self, obj_name="bowl1")
        far2 = gripper_obj_far(self, obj_name="bowl2")
        b1p1 = check_obj_in_receptacle(self, "bowl1", "plate1")
        b1p2 = check_obj_in_receptacle(self, "bowl1", "plate2")
        b2p1 = check_obj_in_receptacle(self, "bowl2", "plate1")
        b2p2 = check_obj_in_receptacle(self, "bowl2", "plate2")
        bowls_set = (b1p1 and b2p2) or (b1p2 or b2p1)
        return far1 and far2 and bowls_set


class SizeSorting(Kitchen):
    """Reference setting_the_table/size_sorting.py:4-86."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, size=(1, 0.4))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        stackable_cat = self.get_obj_lang("obj_0")
        ep_meta["lang"] = f"Stack the {stackable_cat}s from largest to smallest."
        return ep_meta

    def _get_obj_cfgs(self):
        self.objs = int(self.rng.choice([2, 3, 4]))
        stack_cat = str(self.rng.choice(["cup", "bowl"]))
        scale = 0.8
        return [
            dict(
                name=f"obj_{i}", obj_groups=stack_cat,
                object_scale=scale**i,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(0.6, 0.4)),
                    size=(0.6, 0.4), pos=(0, -1.0), offset=(i * 0.1, 0),
                ),
            )
            for i in range(self.objs)
        ]

    def _check_success(self):
        """Reference size_sorting.py:77-86."""
        stacked = all(
            check_obj_in_receptacle(self, f"obj_{i}", f"obj_{i - 1}")
            for i in range(1, self.objs)
        )
        return stacked and gripper_obj_far(self, "obj_0")
