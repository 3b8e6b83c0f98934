"""Convert a DROID / R2D2 raw trajectory HDF5 file into an export
(counterpart of ``lipvq_tpu/scripts/conversion/convert_r2d2.py``, which
writes an HDF5 file; reference scripts/conversion/convert_r2d2.py:19-250).

It reads the raw DROID layout (``observation/robot_state/{cartesian_position,
gripper_position, ...}``, ``action/{cartesian_velocity | cartesian_position,
gripper_position}``; ``h5py`` is imported inside ``convert_r2d2``) and
writes one ``demo_0`` as the JAX script does: the 7-dim ``actions``, the
end effector's position and 6-d rotation and the gripper in ``obs/``, every
other float robot state of the trajectory's length as ``obs/robot0_<key>``,
the ``action_dict/`` components and ``ep_meta`` with the language. Camera
recordings are not decoded.

    python -m lipvq_tpu_torch.scripts.conversion.convert_r2d2 \\
        --dataset trajectory.h5 --output export_dir
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from lipvq_tpu_torch.data.export import ExportWriter
from lipvq_tpu_torch.envs.env_base import EnvType
from lipvq_tpu_torch.utils.action_utils import axis_angle_to_rot_6d


def convert_r2d2(dataset: str, output: str, lang: str = "") -> int:
    import h5py  # the raw DROID file; only where h5py is installed

    with h5py.File(dataset, "r") as src:
        robot_state = src["observation"]["robot_state"]
        cart = np.asarray(robot_state["cartesian_position"], np.float32)
        grip_q = np.asarray(robot_state["gripper_position"], np.float32)
        if grip_q.ndim == 1:
            grip_q = grip_q[:, None]
        n = len(cart)

        act_grp = src["action"]
        if "cartesian_velocity" in act_grp:
            act_pose = np.asarray(act_grp["cartesian_velocity"], np.float32)
        else:
            act_pose = np.asarray(act_grp["cartesian_position"], np.float32)
        act_grip = np.asarray(act_grp["gripper_position"], np.float32)
        if act_grip.ndim == 1:
            act_grip = act_grip[:, None]
        actions = np.concatenate([act_pose[:, :6], act_grip], axis=1)

        arrays = {
            "actions": actions[:n].astype(np.float32),
            "rewards": np.zeros(n, np.float32),
            "dones": np.zeros(n, np.float32),
            "obs/robot0_eef_pos": cart[:, :3],
            "obs/robot0_eef_rot_6d": axis_angle_to_rot_6d(cart[:, 3:6]),
            "obs/robot0_gripper_qpos": grip_q,
        }
        # pass through any extra low-dim state keys
        for k in robot_state:
            if k in ("cartesian_position", "gripper_position"):
                continue
            arr = np.asarray(robot_state[k])
            if arr.ndim <= 2 and arr.dtype.kind == "f" and len(arr) == n:
                arrays[f"obs/robot0_{k}"] = arr.astype(np.float32)
    # action_dict (A.1 keys) from the 7-dim action
    arrays.update({
        "action_dict/rel_pos": actions[:, :3],
        "action_dict/rel_rot_axis_angle": actions[:, 3:6],
        "action_dict/rel_rot_6d": axis_angle_to_rot_6d(actions[:, 3:6]),
        "action_dict/gripper": actions[:, 6:7],
    })
    writer = ExportWriter(output)
    writer.add_demo("demo_0", {"num_samples": n,
                               "ep_meta": json.dumps({"lang": lang or "droid demo"})}, arrays)
    env_args = {"env_name": "R2D2", "type": EnvType.GYM_TYPE, "env_kwargs": {}}
    writer.finish({"env_args": json.dumps(env_args), "total": n}, {})
    return 1


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="the raw DROID .h5 file")
    parser.add_argument("--output", type=str, required=True, help="the export directory to write")
    parser.add_argument("--lang", type=str, default="")
    ns = parser.parse_args(args)
    n = convert_r2d2(ns.dataset, ns.output, ns.lang)
    print(f"wrote {n} demo(s) to {ns.output}")


if __name__ == "__main__":
    main()
