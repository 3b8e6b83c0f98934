"""Sanitize Surface activity tasks (reference
robocasa/environments/kitchen/multi_stage/sanitize_surface/).

Spec port (cited): object cfgs, language and success predicates follow
the reference task files on the first-party MuJoCo-direct kitchen sim.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/sanitize_surface.py``,
statement for statement: the same numpy RNG calls in the same order.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import FixtureType
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_fixture_contact,
    gripper_obj_far,
    obj_inside_of,
)


class CleanMicrowave(Kitchen):
    """Reference sanitize_surface/clean_microwave.py:4-89."""

    # Exclude layout 8 because the microwave is far from counters
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
            "distr_counter", dict(id=FixtureType.COUNTER, ref=self.microwave)
        )
        self.init_robot_base_pos = self.microwave

    def _reset_internal(self):
        super()._reset_internal()
        self.microwave.set_door_state(min=0, max=0, env=self, rng=self.rng)

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Open the microwave. Then pick the sponge from the counter and "
            "place it in the microwave."
        )
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj", obj_groups="sponge",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.microwave),
                    size=(0.30, 0.30), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.distr_counter,
                    sample_region_kwargs=dict(ref=self.microwave),
                    size=(0.30, 0.30), pos=("ref", 1.0),
                ),
            ),
        ]

    def _check_success(self):
        """Reference clean_microwave.py:85-89."""
        return obj_inside_of(self, "obj", self.microwave) and gripper_obj_far(self)


class CountertopCleanup(Kitchen):
    """Reference sanitize_surface/countertop_cleanup.py:4-160."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.cab = self.register_fixture_ref("cab", dict(id=FixtureType.CABINET_TOP))
        self.drawer = self.register_fixture_ref(
            "drawer", dict(id=FixtureType.TOP_DRAWER, ref=self.cab)
        )
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.cab)
        )
        self.init_robot_base_pos = self.drawer

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            "Pick the fruit and vegetable from the counter and place them in "
            "the cabinet. Then open the drawer and pick the cleaner and "
            "sponge from the drawer and place them on the counter."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        direction = float(self.rng.choice([1.0, -1.0]))
        return [
            dict(
                name="obj", obj_groups=("spray", "bar_soap", "soap_dispenser"),
                graspable=True,
                placement=dict(
                    fixture=self.drawer, size=(0.3, 0.3),
                    pos=(-1.0 * direction, -0.5),
                    rotation=np.pi / 2,
                ),
            ),
            dict(
                name="obj2", obj_groups="sponge", graspable=True,
                placement=dict(
                    fixture=self.drawer, size=(0.3, 0.3),
                    pos=(1.0 * direction, -0.5),
                ),
            ),
            dict(
                name="obj3", obj_groups="fruit", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.60, 0.30), pos=(0.0, -1.0), offset=(0.0, 0.10),
                ),
            ),
            dict(
                name="obj4", obj_groups="vegetable", graspable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.60, 0.30), pos=(0.0, -1.0), offset=(0.0, 0.10),
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
                name="distr_cab", obj_groups="all",
                placement=dict(fixture=self.cab, size=(1.0, 0.20), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference countertop_cleanup.py:150-160."""
        far = gripper_obj_far(self) and gripper_obj_far(self, "obj3")
        on_counter = check_obj_fixture_contact(
            self, "obj", self.counter
        ) and check_obj_fixture_contact(self, "obj2", self.counter)
        in_cab = obj_inside_of(self, "obj3", self.cab) and obj_inside_of(
            self, "obj4", self.cab
        )
        return far and in_cab and on_counter


class PrepForSanitizing(Kitchen):
    """Reference sanitize_surface/prep_for_sanitizing.py:4-115."""

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
        obj1_name = self.get_obj_lang("obj1")
        obj2_name = self.get_obj_lang("obj2")
        ep_meta["lang"] = (
            f"Pick the {obj1_name} and {obj2_name} from the cabinet and "
            "place them on the counter."
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.cab.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        cfgs = [
            dict(
                name=f"obj{i}", obj_groups="cleaner", graspable=True,
                placement=dict(fixture=self.cab, size=(0.50, 0.20), pos=(px, -1.0)),
            )
            for i, px in ((1, -0.5), (2, 0.5))
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
        """Reference prep_for_sanitizing.py:108-115."""
        return (
            check_obj_fixture_contact(self, "obj1", self.counter)
            and check_obj_fixture_contact(self, "obj2", self.counter)
            and gripper_obj_far(self, "obj1")
            and gripper_obj_far(self, "obj2")
        )


class PushUtensilsToSink(Kitchen):
    """Reference sanitize_surface/push_utensils_to_sink.py:4-120."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.register_fixture_ref("sink", dict(id=FixtureType.SINK))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.sink)
        )
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj1_name = self.get_obj_lang("utensil1")
        obj2_name = self.get_obj_lang("utensil2")
        ep_meta["lang"] = f"Push the {obj1_name} and {obj2_name} into the sink."
        return ep_meta

    def _get_obj_cfgs(self):
        return [
            dict(
                name="utensil1", obj_groups=["utensil"],
                graspable=False, washable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.30, 0.40), pos=("ref", -1.0), offset=(0.07, 0),
                ),
            ),
            dict(
                name="utensil2", obj_groups=["utensil"],
                graspable=False, washable=True,
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(0.30, 0.40), pos=("ref", -1.0),
                ),
            ),
            dict(
                name="distr_counter", obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                    size=(1.0, 0.30), pos=(0.0, 0.0),
                ),
            ),
            dict(
                name="distr_sink", obj_groups="all", washable=True,
                placement=dict(fixture=self.sink, size=(0.25, 0.25), pos=(0.0, 1.0)),
            ),
        ]

    def _check_success(self):
        """Reference push_utensils_to_sink.py:108-120."""
        return (
            obj_inside_of(self, "utensil1", self.sink)
            and obj_inside_of(self, "utensil2", self.sink)
            and gripper_obj_far(self, obj_name="utensil1")
            and gripper_obj_far(self, obj_name="utensil2")
        )
