"""Add absolute (goal-pose) actions to a delta-action export (counterpart
of ``lipvq_tpu/scripts/conversion/robosuite_add_absolute_actions.py``, which
rewrites an HDF5 file; reference
scripts/conversion/robosuite_add_absolute_actions.py:25-190).

For the first-party kitchen the controller is
``lipvq_tpu_torch.robocasa.sim.robot.RobotController``: deltas integrate
into position-servo targets, so the absolute action at step t is the target
pose after action t at state t. The script replays that integration over
each demo's ``states`` (no physics: it is deterministic given the state)
and writes ``actions_abs`` ``[arm_target(3), wrist_target(3), gripper,
base_target(3), torso, base_mode]`` through
``data/export.py::add_arrays``. A demo's ``model_file`` attribute (its
scene XML) locates the robot's joints (``mujoco`` is imported inside
``add_absolute_actions``); without one the robot block starts at qpos[0].

    python -m lipvq_tpu_torch.scripts.conversion.robosuite_add_absolute_actions \\
        --dataset export_dir
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from lipvq_tpu_torch.data.export import Export, add_arrays
from lipvq_tpu_torch.robocasa.sim.robot import (
    ARM_POS_SCALE,
    ARM_ROT_SCALE,
    BASE_POS_SCALE,
    BASE_ROT_SCALE,
    TORSO_SCALE,
)


def _integrate(state_q: dict, action: np.ndarray) -> np.ndarray:
    """One step of RobotController.apply's target integration, over the
    joint values of the state (anti-windup omitted: the recorded states are
    the actual positions)."""
    a = np.clip(np.asarray(action, dtype=float), -1, 1)
    out = np.zeros(12, dtype=np.float32)
    base_mode = a[11] > 0
    if base_mode:
        yaw = state_q["base_yaw"]
        fwd, side = a[7] * BASE_POS_SCALE, a[8] * BASE_POS_SCALE
        dx = -np.sin(yaw) * fwd + np.cos(yaw) * side
        dy = -np.cos(yaw) * fwd - np.sin(yaw) * side
        out[7] = state_q["base_x"] + dx
        out[8] = state_q["base_y"] + dy
        out[9] = yaw + a[9] * BASE_ROT_SCALE
        out[10] = state_q["torso"] + a[10] * TORSO_SCALE
        out[0:3] = [state_q["arm_x"], state_q["arm_y"], state_q["arm_z"]]
        out[3:6] = [state_q["wrist_roll"], state_q["wrist_pitch"], state_q["wrist_yaw"]]
    else:
        out[0] = state_q["arm_x"] + a[0] * ARM_POS_SCALE
        out[1] = state_q["arm_y"] + a[1] * ARM_POS_SCALE
        out[2] = state_q["arm_z"] + a[2] * ARM_POS_SCALE
        out[3] = state_q["wrist_roll"] + a[3] * ARM_ROT_SCALE
        out[4] = state_q["wrist_pitch"] + a[4] * ARM_ROT_SCALE
        out[5] = state_q["wrist_yaw"] + a[5] * ARM_ROT_SCALE
        out[7:10] = [state_q["base_x"], state_q["base_y"], state_q["base_yaw"]]
        out[10] = state_q["torso"]
    out[6] = a[6]
    out[11] = a[11]
    return out


# joint order inside the robot qpos block (robot.py ROBOT_JOINTS)
_JOINT_NAMES = [
    "base_x", "base_y", "base_yaw", "torso", "arm_x", "arm_y", "arm_z",
    "wrist_yaw", "wrist_pitch", "wrist_roll",
]


def add_absolute_actions(dataset: str, env=None) -> int:
    """Returns the number of demos converted. ``env`` is not read (the JAX
    script's signature): each demo's ``model_file`` locates the joints."""
    import mujoco

    root = os.path.expanduser(dataset)
    export = Export(root)
    json.loads(export.data_attrs["env_args"])  # a dataset with env metadata, as in JAX
    arrays = {}
    for demo in export.demos:
        if not export.has(demo, "actions") or not export.has(demo, "states"):
            continue
        actions = export.load(demo, "actions")
        states = export.load(demo, "states")
        model_xml = export.demo_attrs(demo).get("model_file")
        if model_xml:
            model = mujoco.MjModel.from_xml_string(model_xml)
            adr = {nm: int(model.joint(f"robot0_{nm}" if nm != "torso"
                                       else "robot0_torso_joint").qposadr[0])
                   for nm in _JOINT_NAMES}
        else:
            adr = {nm: i for i, nm in enumerate(_JOINT_NAMES)}
        abs_actions = []
        for t in range(len(actions)):
            q = {nm: float(states[t][adr[nm]]) for nm in _JOINT_NAMES}
            abs_actions.append(_integrate(q, actions[t]))
        arrays[demo] = {"actions_abs": np.stack(abs_actions).astype(np.float32)}
    if arrays:
        add_arrays(root, arrays)
    return len(arrays)


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="an export directory")
    ns = parser.parse_args(args)
    n = add_absolute_actions(ns.dataset)
    print(f"added actions_abs to {n} demos in {ns.dataset}")


if __name__ == "__main__":
    main()
