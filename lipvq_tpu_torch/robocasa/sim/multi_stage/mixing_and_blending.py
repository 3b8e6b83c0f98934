"""Mixing And Blending activity tasks (reference
robocasa/environments/kitchen/multi_stage/mixing_and_blending/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/mixing_and_blending.py``,
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


class ColorfulSalsa(Kitchen):
    """Reference mixing_and_blending/colorful_salsa.py:4-116."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER_NON_CORNER, size=(1.0, 0.4))
        )
        self.init_robot_base_pos = self.counter

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Place the avocado, onion, tomato and bell pepper on the cutting board."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name="receptacle", obj_groups="cutting_board", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(top_size=(1.0, 0.4)),
                    size=(1, 0.4), pos=(0, -1),
                ),
            )
        ]
        for veg in ("bell_pepper", "tomato", "avocado", "onion"):
            cfgs.append(
                dict(
                    name=veg, obj_groups=veg,
                    placement=dict(fixture=self.counter, size=(1, 0.4), pos=(0, -1)),
                )
            )
        return cfgs

    def _check_success(self):
        """Reference colorful_salsa.py:108-116."""
        on_board = all(
            check_obj_in_receptacle(self, veg, "receptacle")
            for veg in ("onion", "avocado", "tomato", "bell_pepper")
        )
        return on_board and gripper_obj_far(self, "receptacle")


class SetupJuicing(Kitchen):
    """Reference mixing_and_blending/setup_juicing.py:4-101."""

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
            f"Open the cabinet, pick all {self.num_fruits} fruits from the "
            "cabinet and place them on the counter."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        self.num_fruits = int(self.rng.choice([2, 3, 4]))
        cfgs = [
            dict(
                name=f"obj{i}", obj_groups="fruit", graspable=True,
                placement=dict(fixture=self.cab, size=(0.60, 0.40), pos=(0, -1.0)),
            )
            for i in range(self.num_fruits)
        ]
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
        """Reference setup_juicing.py:93-101."""
        fruit_on_counter = all(
            check_obj_fixture_contact(self, f"obj{i}", self.counter)
            for i in range(self.num_fruits)
        )
        return fruit_on_counter and gripper_obj_far(self, "obj1")


class SpicyMarinade(Kitchen):
    """Reference mixing_and_blending/spicy_marinade.py:4-141."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref(
            "cabinet", dict(id=FixtureType.DOOR_TOP_HINGE_DOUBLE)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.cab

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Open the cabinet. Place the bowl and condiment on the counter. "
            "Then place the lime and garlic on the cutting board."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        return [
            dict(
                name="receptacle", obj_groups="cutting_board", graspable=False,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.8, 0.4), pos=("ref", -1),
                ),
            ),
            dict(
                name="bowl", obj_groups="bowl",
                placement=dict(fixture=self.cab, size=(0.6, 0.4), pos=(0, -1)),
            ),
            dict(
                name="condiment", obj_groups="condiment",
                placement=dict(fixture=self.cab, size=(0.5, 0.2), pos=(0, -1)),
            ),
            dict(
                name="lime", obj_groups="lime",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.3, 0.2), pos=("ref", -1),
                ),
            ),
            dict(
                name="garlic", obj_groups="garlic",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.3, 0.2), pos=("ref", -1),
                ),
            ),
        ]

    def _check_success(self):
        """Reference spicy_marinade.py:124-141."""
        objs_on_counter = check_obj_fixture_contact(
            self, "bowl", self.counter
        ) and check_obj_fixture_contact(self, "condiment", self.counter)
        objs_on_board = check_obj_in_receptacle(
            self, "lime", "receptacle"
        ) and check_obj_in_receptacle(self, "garlic", "receptacle")
        far = (
            gripper_obj_far(self, "receptacle")
            and gripper_obj_far(self, "bowl")
            and gripper_obj_far(self, "condiment")
        )
        return objs_on_counter and objs_on_board and far
