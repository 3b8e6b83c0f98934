"""Single-stage (atomic) kitchen tasks.

The port's copy of ``lipvq_tpu/robocasa/sim/single_stage.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

Counterpart of reference robocasa/environments/kitchen/single_stage/
(kitchen_pnp.py, kitchen_doors.py, kitchen_drawer.py,
kitchen_microwave.py, kitchen_sink.py, kitchen_stove.py,
kitchen_coffee.py, kitchen_navigate.py — 25 registered task envs).
Each class mirrors the reference's fixture refs, episode language,
object cfgs, reset behavior, and success predicate (file:line cited
per class).
"""

from __future__ import annotations

import math

import numpy as np

from lipvq_tpu_torch.robocasa.sim.fixtures import (
    FixtureType,
    HingeCabinet,
    Microwave,
    SingleCabinet,
)
from lipvq_tpu_torch.robocasa.sim.kitchen import (
    Kitchen,
    check_obj_fixture_contact,
    check_obj_in_receptacle,
    fixture_pairwise_dist,
    gripper_obj_far,
    obj_inside_of,
)

# ===================== Doors (kitchen_doors.py:1-161) =================


class ManipulateDoor(Kitchen):
    """Reference kitchen_doors.py:4-132."""

    def __init__(self, behavior="open", door_id=FixtureType.DOOR_TOP_HINGE,
                 *args, **kwargs):
        assert behavior in ("open", "close")
        self.behavior = behavior
        self.door_id = door_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.door_fxtr = self.register_fixture_ref("door_fxtr", dict(id=self.door_id))
        self.init_robot_base_pos = self.door_fxtr

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        if isinstance(self.door_fxtr, Microwave):
            fxtr_name, door_name = "microwave", "door"
        elif isinstance(self.door_fxtr, SingleCabinet):
            fxtr_name, door_name = "cabinet", "door"
        else:
            fxtr_name, door_name = "cabinet", "doors"
        ep_meta["lang"] = f"{self.behavior} the {fxtr_name} {door_name}"
        return ep_meta

    def _reset_internal(self):
        if self.behavior == "open":
            self.door_fxtr.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)
        else:
            self.door_fxtr.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        super()._reset_internal()

    def _check_success(self):
        """Reference kitchen_doors.py:69-88."""
        door_state = self.door_fxtr.get_door_state(env=self)
        for joint_p in door_state.values():
            if self.behavior == "open" and joint_p < 0.90:
                return False
            if self.behavior == "close" and joint_p > 0.05:
                return False
        return True

    def _get_obj_cfgs(self):
        """Reference kitchen_doors.py:91-131: one object inside the
        fixture + 1-3 counter distractors."""
        cfgs = [
            dict(
                name="door_obj",
                obj_groups="all",
                graspable=True,
                microwavable=(True if isinstance(self.door_fxtr, Microwave) else None),
                placement=dict(fixture=self.door_fxtr, size=(0.30, 0.30), pos=(None, -1.0)),
            )
        ]
        num_distr = int(self.rng.integers(1, 4))
        for i in range(num_distr):
            cfgs.append(
                dict(
                    name=f"distr_counter_{i + 1}",
                    obj_groups="all",
                    placement=dict(
                        fixture=self.get_fixture(FixtureType.COUNTER, ref=self.door_fxtr),
                        sample_region_kwargs=dict(ref=self.door_fxtr),
                        size=(1.0, 0.50),
                        pos=(None, -1.0),
                        offset=(0.0, 0.10),
                    ),
                )
            )
        return cfgs


class OpenDoor(ManipulateDoor):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="open", *args, **kwargs)


class OpenSingleDoor(OpenDoor):
    def __init__(self, door_id=FixtureType.DOOR_TOP_HINGE_SINGLE, *args, **kwargs):
        super().__init__(door_id=door_id, *args, **kwargs)


class OpenDoubleDoor(OpenDoor):
    def __init__(self, door_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        super().__init__(door_id=door_id, *args, **kwargs)


class CloseDoor(ManipulateDoor):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="close", *args, **kwargs)


class CloseSingleDoor(CloseDoor):
    def __init__(self, door_id=FixtureType.DOOR_TOP_HINGE_SINGLE, *args, **kwargs):
        super().__init__(door_id=door_id, *args, **kwargs)


class CloseDoubleDoor(CloseDoor):
    def __init__(self, door_id=FixtureType.DOOR_TOP_HINGE_DOUBLE, *args, **kwargs):
        super().__init__(door_id=door_id, *args, **kwargs)


# ===================== Drawer (kitchen_drawer.py:1-291) ===============


class ManipulateDrawer(Kitchen):
    """Reference kitchen_drawer.py:4-200."""

    def __init__(self, behavior="open", drawer_id=FixtureType.TOP_DRAWER,
                 *args, **kwargs):
        assert behavior in ("open", "close")
        self.behavior = behavior
        self.drawer_id = drawer_id
        self.drawer_side = "right"
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.drawer = self.register_fixture_ref("drawer", dict(id=self.drawer_id))
        self.init_robot_base_pos = self.drawer
        # the reference randomizes robot side (kitchen_drawer.py:27-75);
        # here the base faces the drawer and the side is the label only
        self.drawer_side = "left" if self.rng.uniform() < 0.5 else "right"

    def _reset_internal(self):
        if self.behavior == "open":
            self.drawer.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)
        else:
            self.drawer.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        super()._reset_internal()

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = f"{self.behavior} the {self.drawer_side} drawer"
        return ep_meta

    def _check_success(self):
        """Reference kitchen_drawer.py:201-230."""
        frac = self.drawer.get_door_state(env=self)["drawer"]
        if self.behavior == "open":
            return frac >= 0.90
        return frac <= 0.05

    def _get_obj_cfgs(self):
        """Reference kitchen_drawer.py:232-291: object in drawer +
        distractor on nearby counter."""
        cfgs = [
            dict(
                name="drawer_obj",
                obj_groups="all",
                graspable=True,
                max_size=(0.30, 0.30, 0.15),
                placement=dict(fixture=self.drawer, size=(0.30, 0.30), pos=(None, -0.75)),
            ),
            dict(
                name="distr_counter",
                obj_groups="all",
                placement=dict(
                    fixture=self.get_fixture(FixtureType.COUNTER, ref=self.drawer),
                    sample_region_kwargs=dict(ref=self.drawer),
                    size=(0.50, 0.50),
                    pos=(None, -1.0),
                ),
            ),
        ]
        return cfgs


class OpenDrawer(ManipulateDrawer):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="open", *args, **kwargs)


class CloseDrawer(ManipulateDrawer):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="close", *args, **kwargs)


# ===================== Sink (kitchen_sink.py:1-218) ===================


class ManipulateSinkFaucet(Kitchen):
    """Reference kitchen_sink.py:4-110."""

    def __init__(self, behavior="turn_on", *args, **kwargs):
        assert behavior in ("turn_on", "turn_off")
        self.behavior = behavior
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.get_fixture(FixtureType.SINK)
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = f"{self.behavior.replace('_', ' ')} the sink faucet"
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        mode = "off" if self.behavior == "turn_on" else "on"
        self.sink.set_handle_state(mode=mode, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        """Reference kitchen_sink.py:49-90 (distractors only)."""
        cfgs = []
        num_distr = int(self.rng.integers(1, 4))
        for i in range(num_distr):
            cfgs.append(
                dict(
                    name=f"distr_counter_{i}",
                    obj_groups="all",
                    placement=dict(
                        fixture=self.get_fixture(FixtureType.COUNTER, ref=self.sink),
                        sample_region_kwargs=dict(ref=self.sink, loc="left_right"),
                        size=(0.30, 0.30),
                        pos=("ref", -1.0),
                        offset=(0.0, 0.10),
                    ),
                )
            )
        cfgs.append(
            dict(
                name="distr_sink",
                obj_groups="all",
                washable=True,
                placement=dict(fixture=self.sink, size=(0.30, 0.40), pos=(None, -1.0)),
            )
        )
        return cfgs

    def _check_success(self):
        """Reference kitchen_sink.py:92-107."""
        water_on = self.sink.get_handle_state(env=self)["water_on"]
        return water_on if self.behavior == "turn_on" else not water_on


class TurnOnSinkFaucet(ManipulateSinkFaucet):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="turn_on", *args, **kwargs)


class TurnOffSinkFaucet(ManipulateSinkFaucet):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="turn_off", *args, **kwargs)


class TurnSinkSpout(Kitchen):
    """Reference kitchen_sink.py:121-218."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.sink = self.get_fixture(FixtureType.SINK)
        if "task_refs" in self._ep_meta:
            self.behavior = self._ep_meta["task_refs"]["behavior"]
            self.init_sink_mode = self._ep_meta["task_refs"]["init_sink_mode"]
        else:
            self.behavior = str(self.rng.choice(["left", "right"]))
            self.init_sink_mode = str(self.rng.choice(["on", "off"]))
        self.init_robot_base_pos = self.sink

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = f"turn the sink spout to the {self.behavior}"
        ep_meta["task_refs"] = dict(
            behavior=self.behavior, init_sink_mode=self.init_sink_mode
        )
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        self.sink.set_handle_state(mode=self.init_sink_mode, env=self, rng=self.rng)

    _get_obj_cfgs = ManipulateSinkFaucet._get_obj_cfgs

    def _check_success(self):
        """Reference kitchen_sink.py:207-218."""
        return self.sink.get_handle_state(env=self)["spout_ori"] == self.behavior


# ===================== Stove (kitchen_stove.py:1-132) =================


class ManipulateStoveKnob(Kitchen):
    """Reference kitchen_stove.py:4-120."""

    def __init__(self, knob_id="random", behavior="turn_on", *args, **kwargs):
        assert behavior in ("turn_on", "turn_off")
        self.behavior = behavior
        self.knob_id = knob_id
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.stove = self.get_fixture(FixtureType.STOVE)
        if "task_refs" in self._ep_meta:
            self.knob = self._ep_meta["task_refs"]["knob"]
            self.cookware_burner = self._ep_meta["task_refs"]["cookware_burner"]
        else:
            valid_knobs = sorted(self.stove.knob_joints)
            if self.knob_id == "random":
                self.knob = str(self.rng.choice(valid_knobs))
            else:
                assert self.knob_id in valid_knobs
                self.knob = self.knob_id
            self.cookware_burner = (
                self.knob
                if self.rng.uniform() <= 0.50
                else str(self.rng.choice(valid_knobs))
            )
        self.init_robot_base_pos = self.stove

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = (
            f"{self.behavior.replace('_', ' ')} the "
            f"{self.knob.replace('_', ' ')} burner of the stove"
        )
        ep_meta["task_refs"] = dict(knob=self.knob, cookware_burner=self.cookware_burner)
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        mode = "off" if self.behavior == "turn_on" else "on"
        self.stove.set_knob_state(mode=mode, knob=self.knob, env=self, rng=self.rng)

    def _get_obj_cfgs(self):
        """Reference kitchen_stove.py:77-103: cookware on a burner."""
        return [
            dict(
                name="cookware",
                obj_groups="cookware",
                placement=dict(
                    fixture=self.stove,
                    ensure_object_boundary_in_range=False,
                    sample_region_kwargs=dict(locs=[self.cookware_burner]),
                    size=(0.02, 0.02),
                    rotation=[(-3 * np.pi / 8, -np.pi / 4), (np.pi / 4, 3 * np.pi / 8)],
                ),
            )
        ]

    def _check_success(self):
        """Reference kitchen_stove.py:104-120."""
        knob_value = self.stove.get_knobs_state(env=self)[self.knob]
        knob_on = 0.35 <= abs(knob_value) <= 2 * np.pi - 0.35
        return knob_on if self.behavior == "turn_on" else not knob_on


class TurnOnStove(ManipulateStoveKnob):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="turn_on", *args, **kwargs)


class TurnOffStove(ManipulateStoveKnob):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="turn_off", *args, **kwargs)


# ===================== Microwave (kitchen_microwave.py:1-90) ==========


class MicrowavePressButton(Kitchen):
    """Reference kitchen_microwave.py:4-80."""

    def __init__(self, behavior="turn_on", *args, **kwargs):
        assert behavior in ("turn_on", "turn_off")
        self.behavior = behavior
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.microwave = self.get_fixture(FixtureType.MICROWAVE)
        if self.behavior == "turn_off":
            self.microwave._turned_on = True
        self.init_robot_base_pos = self.microwave

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        btn = "start" if self.behavior == "turn_on" else "stop"
        ep_meta["lang"] = f"press the {btn} button on the microwave"
        return ep_meta

    def _reset_internal(self):
        super()._reset_internal()
        # door must be closed for the button to latch (microwave.py:96)
        self.microwave.set_door_state(min=0.0, max=0.0, env=self, rng=self.rng)
        self.microwave._turned_on = self.behavior == "turn_off"

    def _get_obj_cfgs(self):
        """Reference kitchen_microwave.py:40-63."""
        return [
            dict(
                name="obj",
                obj_groups="all",
                heatable=True,
                placement=dict(
                    fixture=self.microwave,
                    size=(0.05, 0.05),
                    ensure_object_boundary_in_range=False,
                ),
            )
        ]

    def _check_success(self):
        """Reference kitchen_microwave.py:65-80."""
        turned_on = self.microwave.get_state()["turned_on"]
        button = "start_button" if self.behavior == "turn_on" else "stop_button"
        far = self.microwave.gripper_button_far(self, button=button)
        if self.behavior == "turn_on":
            return turned_on and far
        return (not turned_on) and far


class TurnOnMicrowave(MicrowavePressButton):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="turn_on", *args, **kwargs)


class TurnOffMicrowave(MicrowavePressButton):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="turn_off", *args, **kwargs)


# ===================== Coffee (kitchen_coffee.py:1-189) ===============


class PnPCoffee(Kitchen):
    """Reference kitchen_coffee.py:5-105."""

    def __init__(self, behavior="machine_to_counter", *args, **kwargs):
        assert behavior in ("counter_to_machine", "machine_to_counter")
        self.behavior = behavior
        super().__init__(*args, **kwargs)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.coffee_machine = self.get_fixture("coffee_machine")
        self.counter = self.get_fixture(FixtureType.COUNTER, ref=self.coffee_machine)
        self.init_robot_base_pos = self.coffee_machine

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        obj_lang = self.get_obj_lang()
        if self.behavior == "counter_to_machine":
            ep_meta["lang"] = (
                f"pick the {obj_lang} from the counter and place it "
                "under the coffee machine dispenser"
            )
        else:
            ep_meta["lang"] = (
                f"pick the {obj_lang} from under the coffee machine "
                "dispenser and place it on the counter"
            )
        return ep_meta

    def _get_obj_cfgs(self):
        """Reference kitchen_coffee.py:48-91."""
        if self.behavior == "counter_to_machine":
            return [
                dict(
                    name="obj",
                    obj_groups="mug",
                    placement=dict(
                        fixture=self.counter,
                        sample_region_kwargs=dict(ref=self.coffee_machine),
                        size=(0.30, 0.40),
                        pos=("ref", -1.0),
                        rotation=[np.pi / 4, np.pi / 2],
                    ),
                )
            ]
        return [
            dict(
                name="obj",
                obj_groups="mug",
                placement=dict(
                    fixture=self.coffee_machine,
                    ensure_object_boundary_in_range=False,
                    margin=0.0,
                    ensure_valid_placement=False,
                    rotation=(np.pi / 8, np.pi / 4),
                ),
            )
        ]

    def _check_success(self):
        """Reference kitchen_coffee.py:92-105."""
        far = gripper_obj_far(self)
        if self.behavior == "counter_to_machine":
            contact = self.coffee_machine.check_receptacle_placement_for_pouring(self, "obj")
        else:
            contact = check_obj_fixture_contact(self, "obj", self.counter)
        return contact and far


class CoffeeSetupMug(PnPCoffee):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="counter_to_machine", *args, **kwargs)


class CoffeeServeMug(PnPCoffee):
    def __init__(self, *args, **kwargs):
        kwargs.pop("behavior", None)
        super().__init__(behavior="machine_to_counter", *args, **kwargs)


class CoffeePressButton(Kitchen):
    """Reference kitchen_coffee.py:127-189."""

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        self.coffee_machine = self.get_fixture("coffee_machine")
        self.counter = self.get_fixture(FixtureType.COUNTER, ref=self.coffee_machine)
        self.init_robot_base_pos = self.coffee_machine

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = "press the button on the coffee machine to serve coffee"
        return ep_meta

    def _get_obj_cfgs(self):
        """Reference kitchen_coffee.py:160-180."""
        return [
            dict(
                name="obj",
                obj_groups="mug",
                placement=dict(
                    fixture=self.coffee_machine,
                    ensure_object_boundary_in_range=False,
                    margin=0.0,
                    ensure_valid_placement=False,
                    rotation=(np.pi / 8, np.pi / 4),
                ),
            )
        ]

    def _check_success(self):
        """Reference kitchen_coffee.py:182-189."""
        return (
            self.coffee_machine.get_state()["turned_on"]
            and self.coffee_machine.gripper_button_far(self)
        )


# ===================== Navigate (kitchen_navigate.py:1-122) ===========


class NavigateKitchen(Kitchen):
    """Reference kitchen_navigate.py:4-122."""

    _VALID_SRC = (
        "CoffeeMachine", "Stove", "SingleCabinet", "HingeCabinet",
        "OpenCabinet", "Drawer", "Microwave", "Sink", "Hood", "Fridge",
        "Dishwasher",
    )
    _VALID_TARGET = (
        "CoffeeMachine", "Stove", "OpenCabinet", "Microwave", "Sink",
        "Hood", "Fridge", "Dishwasher",
    )

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        if "src_fixture" in self.fixture_refs:
            self.src_fixture = self.fixture_refs["src_fixture"]
            self.target_fixture = self.fixture_refs["target_fixture"]
        else:
            saved = self._ep_meta.get("fixture_refs", {})
            if "src_fixture" in saved and saved["src_fixture"] in self.fixtures:
                self.src_fixture = self.fixtures[saved["src_fixture"]]
                self.target_fixture = self.fixtures[saved["target_fixture"]]
            else:
                fixtures = list(self.fixtures.values())
                classes = [type(f).__name__ for f in fixtures]
                src_pool = [f for f in fixtures if type(f).__name__ in self._VALID_SRC]
                self.src_fixture = src_pool[int(self.rng.integers(len(src_pool)))]
                tgt_pool = [
                    f
                    for f in fixtures
                    if type(f).__name__ in self._VALID_TARGET
                    and classes.count(type(f).__name__) == 1
                    and f is not self.src_fixture
                    and fixture_pairwise_dist(self.src_fixture, f) > 1.0
                ]
                if not tgt_pool:
                    tgt_pool = [
                        f for f in fixtures
                        if type(f).__name__ in self._VALID_TARGET
                        and f is not self.src_fixture
                    ]
                self.target_fixture = tgt_pool[int(self.rng.integers(len(tgt_pool)))]
            self.fixture_refs["src_fixture"] = self.src_fixture
            self.fixture_refs["target_fixture"] = self.target_fixture
        self.target_pos, self.target_ori = self.compute_robot_base_placement_pose(
            self.target_fixture
        )
        self.init_robot_base_pos = self.src_fixture

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        ep_meta["lang"] = f"navigate to the {self.target_fixture.nat_lang}"
        return ep_meta

    def _check_success(self):
        """Reference kitchen_navigate.py:106-122."""
        base = self.data.body("robot0_base")
        base_pos = np.array(base.xpos)
        pos_check = np.linalg.norm(self.target_pos[:2] - base_pos[:2]) <= 0.20
        yaw = self.get_joint_qpos("robot0_base_yaw")
        ori_check = math.cos(self.target_ori[2] - yaw) >= 0.98
        return bool(pos_check and ori_check)


# ===================== PnP (kitchen_pnp.py:1-908) =====================


class PnP(Kitchen):
    """Reference kitchen_pnp.py:4-22."""

    def __init__(self, obj_groups="all", exclude_obj_groups=None, *args, **kwargs):
        self.obj_groups = obj_groups
        self.exclude_obj_groups = exclude_obj_groups
        super().__init__(*args, **kwargs)


class PnPCounterToCab(PnP):
    """Reference kitchen_pnp.py:24-139."""

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
        ep_meta["lang"] = (
            f"pick the {self.get_obj_lang()} from the counter "
            "and place it in the cabinet"
        )
        return ep_meta

    def _reset_internal(self):
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        super()._reset_internal()

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj",
                obj_groups=self.obj_groups,
                exclude_obj_groups=self.exclude_obj_groups,
                graspable=True,
                max_size=(0.08, 0.08, 0.30),
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(0.30, 0.30),
                    pos=("ref", -1.0),
                ),
            ),
            dict(
                name="distr_counter",
                obj_groups="all",
                placement=dict(
                    fixture=self.counter,
                    sample_region_kwargs=dict(ref=self.cab),
                    size=(1.0, 0.30),
                    pos=(None, 1.0),
                ),
            ),
        ]

    def _check_success(self):
        return obj_inside_of(self, "obj", self.cab) and gripper_obj_far(self)


class PnPCabToCounter(PnP):
    """Reference kitchen_pnp.py:142-258."""

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
        ep_meta["lang"] = (
            f"pick the {self.get_obj_lang()} from the cabinet "
            "and place it on the counter"
        )
        return ep_meta

    def _reset_internal(self):
        self.cab.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        super()._reset_internal()

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj",
                obj_groups=self.obj_groups,
                exclude_obj_groups=self.exclude_obj_groups,
                graspable=True,
                max_size=(0.08, 0.08, 0.30),
                placement=dict(fixture=self.cab, size=(0.30, 0.30), pos=(None, -1.0)),
            )
        ]

    def _check_success(self):
        on_counter = check_obj_fixture_contact(self, "obj", self.counter)
        return on_counter and gripper_obj_far(self)


class _PnPFixtureBase(PnP):
    """Shared source->dest structure for sink/microwave/stove PnP
    (reference kitchen_pnp.py:261-908)."""

    SRC = None  # "counter" or fixture type
    DST = None
    LANG = ("", "")
    # graspable objects must fit the 8cm gripper span; cookware tasks
    # override (cookware is carried by its handle in the reference)
    MAX_SIZE = (0.08, 0.08, 0.30)

    def _setup_kitchen_references(self):
        super()._setup_kitchen_references()
        ftype = self._fixture_type()
        self.fixture = self.register_fixture_ref("fixture", dict(id=ftype))
        self.counter = self.register_fixture_ref(
            "counter", dict(id=FixtureType.COUNTER, ref=self.fixture)
        )
        self.init_robot_base_pos = self.fixture

    def _fixture_type(self):
        raise NotImplementedError

    def get_ep_meta(self):
        ep_meta = super().get_ep_meta()
        src, dst = self.LANG
        ep_meta["lang"] = (
            f"pick the {self.get_obj_lang()} from the {src} and place it {dst}"
        )
        return ep_meta

    def _obj_start_placement(self):
        if self.SRC == "counter":
            return dict(
                fixture=self.counter,
                sample_region_kwargs=dict(ref=self.fixture),
                size=(0.30, 0.30),
                pos=("ref", -1.0),
            )
        return dict(
            fixture=self.fixture,
            size=(0.30, 0.30),
            pos=(None, -1.0),
            ensure_object_boundary_in_range=False,
        )

    def _get_obj_cfgs(self):
        return [
            dict(
                name="obj",
                obj_groups=self.obj_groups,
                exclude_obj_groups=self.exclude_obj_groups,
                graspable=True,
                washable=True if self._needs_washable() else None,
                microwavable=True if self._needs_microwavable() else None,
                max_size=self.MAX_SIZE,
                placement=self._obj_start_placement(),
            )
        ]

    def _needs_washable(self):
        return False

    def _needs_microwavable(self):
        return False

    def _success_at_dst(self):
        if self.DST == "counter":
            return check_obj_fixture_contact(self, "obj", self.counter)
        return obj_inside_of(self, "obj", self.fixture)

    def _check_success(self):
        return self._success_at_dst() and gripper_obj_far(self)


class PnPCounterToSink(_PnPFixtureBase):
    """Reference kitchen_pnp.py:261-370."""

    SRC, DST = "counter", "fixture"
    LANG = ("counter", "in the sink")

    def _fixture_type(self):
        return FixtureType.SINK

    def _needs_washable(self):
        return True


class PnPSinkToCounter(_PnPFixtureBase):
    """Reference kitchen_pnp.py:373-477."""

    SRC, DST = "fixture", "counter"
    LANG = ("sink", "on the counter")

    def _fixture_type(self):
        return FixtureType.SINK

    def _needs_washable(self):
        return True


class PnPCounterToMicrowave(_PnPFixtureBase):
    """Reference kitchen_pnp.py:480-607."""

    SRC, DST = "counter", "fixture"
    LANG = ("counter", "in the microwave")

    def _fixture_type(self):
        return FixtureType.MICROWAVE

    def _needs_microwavable(self):
        return True

    def _reset_internal(self):
        self.fixture.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        super()._reset_internal()


class PnPMicrowaveToCounter(_PnPFixtureBase):
    """Reference kitchen_pnp.py:610-726."""

    SRC, DST = "fixture", "counter"
    LANG = ("microwave", "on the counter")

    def _fixture_type(self):
        return FixtureType.MICROWAVE

    def _needs_microwavable(self):
        return True

    def _reset_internal(self):
        self.fixture.set_door_state(min=0.90, max=1.0, env=self, rng=self.rng)
        super()._reset_internal()


class PnPCounterToStove(_PnPFixtureBase):
    """Reference kitchen_pnp.py:729-819: place cookware onto a burner."""

    SRC, DST = "counter", "fixture"
    LANG = ("counter", "on the stove")
    MAX_SIZE = (0.22, 0.22, 0.30)

    def __init__(self, obj_groups="cookware", *args, **kwargs):
        super().__init__(obj_groups=obj_groups, *args, **kwargs)

    def _fixture_type(self):
        return FixtureType.STOVE

    def _success_at_dst(self):
        return check_obj_fixture_contact(self, "obj", self.fixture)


class PnPStoveToCounter(_PnPFixtureBase):
    """Reference kitchen_pnp.py:822-908."""

    SRC, DST = "fixture", "counter"
    LANG = ("stove", "on the counter")
    MAX_SIZE = (0.22, 0.22, 0.30)

    def __init__(self, obj_groups="cookware", *args, **kwargs):
        super().__init__(obj_groups=obj_groups, *args, **kwargs)

    def _fixture_type(self):
        return FixtureType.STOVE

    def _obj_start_placement(self):
        return dict(
            fixture=self.fixture,
            ensure_object_boundary_in_range=False,
            sample_region_kwargs=dict(locs=["front_left"]),
            size=(0.02, 0.02),
        )
