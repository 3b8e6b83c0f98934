"""Simplified mobile manipulator honoring the robocasa action layout.

The port's copy of ``lipvq_tpu/robocasa/sim/robot.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

The reference uses robosuite's PandaOmron (mobile base + 7-dof arm +
2-finger gripper) with an OSC controller; the 12-dim action vector fed
through the dataset pipeline is
``[arm_dpos(3), arm_drot(3), gripper(1), base_fwd, base_side, base_yaw,
torso, base_mode]`` (reference config_gen_utils.py:46-87 action keys;
robosuite composite controller).

Here the arm is realized as a cartesian gantry (3 slides + 3 wrist
hinges) carrying a 2-finger parallel gripper on a mobile base
(2 slides + yaw + torso lift). That preserves the *control contract*
(delta-pose EEF control, mode-switched base, normalized gripper) without
robosuite. All joints are position-servo actuated; deltas integrate
into ctrl targets exactly like robosuite's OSC goal integration.
"""

from __future__ import annotations

import math

import numpy as np

try:
    import mujoco
except ImportError:  # importable without mujoco
    mujoco = None

# arm workspace of the gantry relative to the base (meters)
ARM_RANGE = dict(x=(-0.75, 0.75), y=(-1.0, 0.2), z=(-0.75, 1.15))
GRIP_RANGE = (0.0, 0.04)

# per-step scaling of normalized deltas (reference OSC output_max)
ARM_POS_SCALE = 0.05
ARM_ROT_SCALE = 0.15
BASE_POS_SCALE = 0.05
BASE_ROT_SCALE = 0.10
TORSO_SCALE = 0.02

ACTION_DIM = 12


def build_robot(spec, base_pos=(0.0, -1.5, 0.0), base_yaw=0.0):
    """Add the robot tree to an MjSpec. Returns actuator name list."""
    world = spec.worldbody
    root = world.add_body(name="robot0_root", pos=[0, 0, 0.001])

    # base: world-aligned slides, then yaw on a child body
    root.add_joint(name="robot0_base_x", type=mujoco.mjtJoint.mjJNT_SLIDE,
                   axis=[1, 0, 0], range=[-10, 10], damping=30.0)
    root.add_joint(name="robot0_base_y", type=mujoco.mjtJoint.mjJNT_SLIDE,
                   axis=[0, 1, 0], range=[-10, 10], damping=30.0)
    rg = root.add_geom(name="robot0_root_geom", type=mujoco.mjtGeom.mjGEOM_SPHERE,
                       size=[0.04, 0, 0], pos=[0, 0, 0.04], rgba=[0, 0, 0, 0])
    rg.contype, rg.conaffinity = 0, 0  # inertia carrier only
    base = root.add_body(name="robot0_base", pos=[0, 0, 0])
    base.add_joint(name="robot0_base_yaw", type=mujoco.mjtJoint.mjJNT_HINGE,
                   axis=[0, 0, 1], range=[-4 * math.pi, 4 * math.pi], damping=20.0)
    g = base.add_geom(name="robot0_base_geom", type=mujoco.mjtGeom.mjGEOM_CYLINDER,
                      size=[0.22, 0.10, 0], pos=[0, 0, 0.10],
                      rgba=[0.15, 0.15, 0.18, 1])
    g.contype, g.conaffinity = 2, 3
    g.density = 3000.0
    gm = base.add_geom(name="robot0_mast", type=mujoco.mjtGeom.mjGEOM_BOX,
                       size=[0.06, 0.06, 0.45], pos=[0, 0.12, 0.65],
                       rgba=[0.2, 0.2, 0.24, 1])
    gm.contype, gm.conaffinity = 0, 0  # visual mast; gantry passes through

    # torso lift carries the gantry origin
    torso = base.add_body(name="robot0_torso", pos=[0, 0, 0.95])
    torso.add_joint(name="robot0_torso_joint", type=mujoco.mjtJoint.mjJNT_SLIDE,
                    axis=[0, 0, 1], range=[-0.25, 0.45], damping=60.0)
    tg = torso.add_geom(name="robot0_torso_geom", type=mujoco.mjtGeom.mjGEOM_SPHERE,
                        size=[0.05, 0, 0], pos=[0, 0.12, 0], rgba=[0.2, 0.2, 0.24, 1])
    tg.contype, tg.conaffinity = 0, 0
    tg.density = 2000.0

    # cartesian gantry: x/y/z slides in the base frame
    carr = torso.add_body(name="robot0_carriage", pos=[0, 0, 0])
    carr.add_joint(name="robot0_arm_x", type=mujoco.mjtJoint.mjJNT_SLIDE,
                   axis=[1, 0, 0], range=list(ARM_RANGE["x"]), damping=15.0)
    carr.add_joint(name="robot0_arm_y", type=mujoco.mjtJoint.mjJNT_SLIDE,
                   axis=[0, 1, 0], range=list(ARM_RANGE["y"]), damping=15.0)
    carr.add_joint(name="robot0_arm_z", type=mujoco.mjtJoint.mjJNT_SLIDE,
                   axis=[0, 0, 1], range=list(ARM_RANGE["z"]), damping=15.0)
    cg = carr.add_geom(name="robot0_carriage_geom", type=mujoco.mjtGeom.mjGEOM_SPHERE,
                       size=[0.035, 0, 0], rgba=[0.3, 0.3, 0.34, 1])
    cg.contype, cg.conaffinity = 0, 0
    cg.density = 500.0

    # wrist: roll-pitch-yaw hinges
    wrist = carr.add_body(name="robot0_wrist", pos=[0, 0, -0.05])
    wrist.add_joint(name="robot0_wrist_yaw", type=mujoco.mjtJoint.mjJNT_HINGE,
                    axis=[0, 0, 1], range=[-2 * math.pi, 2 * math.pi], damping=2.0)
    wrist.add_joint(name="robot0_wrist_pitch", type=mujoco.mjtJoint.mjJNT_HINGE,
                    axis=[0, 1, 0], range=[-math.pi, math.pi], damping=2.0)
    wrist.add_joint(name="robot0_wrist_roll", type=mujoco.mjtJoint.mjJNT_HINGE,
                    axis=[1, 0, 0], range=[-math.pi, math.pi], damping=2.0)
    wg = wrist.add_geom(name="robot0_wrist_geom", type=mujoco.mjtGeom.mjGEOM_CYLINDER,
                        size=[0.03, 0.03, 0], pos=[0, 0, -0.02],
                        rgba=[0.4, 0.4, 0.45, 1])
    wg.contype, wg.conaffinity = 2, 3
    wg.density = 800.0

    # palm + fingers (point down: -z)
    palm = wrist.add_body(name="robot0_palm", pos=[0, 0, -0.07])
    pg = palm.add_geom(name="robot0_palm_geom", type=mujoco.mjtGeom.mjGEOM_BOX,
                       size=[0.045, 0.015, 0.012], rgba=[0.5, 0.5, 0.55, 1])
    pg.contype, pg.conaffinity = 2, 3
    pg.density = 800.0
    palm.add_site(name="robot0_grip_site", pos=[0, 0, -0.085],
                  size=[0.008, 0.008, 0.008], rgba=[1, 0, 0, 0.4])
    for side, sgn in (("left", -1), ("right", 1)):
        f = palm.add_body(name=f"robot0_{side}finger", pos=[sgn * 0.045, 0, -0.06])
        f.add_joint(name=f"robot0_{side}finger_joint",
                    type=mujoco.mjtJoint.mjJNT_SLIDE,
                    axis=[-sgn, 0, 0], range=list(GRIP_RANGE), damping=8.0)
        fg = f.add_geom(name=f"robot0_{side}finger_geom",
                        type=mujoco.mjtGeom.mjGEOM_BOX,
                        size=[0.006, 0.012, 0.05], pos=[0, 0, 0],
                        rgba=[0.25, 0.25, 0.28, 1])
        fg.contype, fg.conaffinity = 2, 3
        fg.friction = [2.0, 0.05, 0.0002]
        fg.density = 600.0
        # Firm pinch contacts. MuJoCo's default solref scales contact
        # stiffness with the touched body's inertia, so light objects
        # (a 0.1 kg can) yield: the kp-1000 finger servo pressed
        # straight through them (observed: both fingers "closed" to
        # q~0.04 with a 6.6cm can between them, which then slid down
        # through the grip during lifts). priority=1 makes these
        # solparams + the high finger friction govern the pair.
        # timeconst 0.01 = 5x the 2ms physics step: firm enough to
        # stop penetration, but clear of the 2*dt stability bound
        # ([0.004, 1.0] sat exactly on it and stiff-oscillated — the
        # arm visibly jammed against counters/drawer faces).
        fg.priority = 1
        fg.solref = [0.01, 1.0]
        fg.solimp = [0.95, 0.99, 0.001, 0.5, 2.0]

    # mirror the fingers through an equality so one actuator drives both
    eq = spec.add_equality()
    eq.type = mujoco.mjtEq.mjEQ_JOINT
    eq.name1 = "robot0_leftfinger_joint"
    eq.name2 = "robot0_rightfinger_joint"
    eq.data[0:2] = [0.0, 1.0]

    # position actuators
    acts = []

    def servo(joint, kp, lo, hi):
        a = spec.add_actuator()
        a.name = f"act_{joint}"
        a.target = joint
        a.trntype = mujoco.mjtTrn.mjTRN_JOINT
        a.gaintype = mujoco.mjtGain.mjGAIN_FIXED
        a.biastype = mujoco.mjtBias.mjBIAS_AFFINE
        a.gainprm[0] = kp
        a.biasprm[0:3] = [0.0, -kp, -2.0 * math.sqrt(kp) * 0.7]
        a.ctrlrange = [lo, hi]
        acts.append(a.name)
        return a

    servo("robot0_base_x", 1500, -10, 10)
    servo("robot0_base_y", 1500, -10, 10)
    servo("robot0_base_yaw", 800, -4 * math.pi, 4 * math.pi)
    servo("robot0_torso_joint", 2000, -0.25, 0.45)
    servo("robot0_arm_x", 600, *ARM_RANGE["x"])
    servo("robot0_arm_y", 600, *ARM_RANGE["y"])
    servo("robot0_arm_z", 900, *ARM_RANGE["z"])
    servo("robot0_wrist_yaw", 40, -2 * math.pi, 2 * math.pi)
    servo("robot0_wrist_pitch", 40, -math.pi, math.pi)
    servo("robot0_wrist_roll", 40, -math.pi, math.pi)
    servo("robot0_leftfinger_joint", 1000, *GRIP_RANGE)

    # place the base
    return acts


ROBOT_JOINTS = [
    "robot0_base_x",
    "robot0_base_y",
    "robot0_base_yaw",
    "robot0_torso_joint",
    "robot0_arm_x",
    "robot0_arm_y",
    "robot0_arm_z",
    "robot0_wrist_yaw",
    "robot0_wrist_pitch",
    "robot0_wrist_roll",
    "robot0_leftfinger_joint",
]


class RobotController:
    """Integrates 12-dim normalized actions into position-servo targets.

    Action layout (reference robocasa 12-dim vector,
    config_gen_utils.py:46-87):
      [0:3]  arm delta position (base frame)
      [3:6]  arm delta rotation (wrist rpy)
      [6]    gripper (>0 close, <0 open)
      [7:9]  base forward/sideways velocity
      [9]    base yaw rate
      [10]   torso lift rate
      [11]   base_mode: >0 -> base actions active, arm held
             (reference composite controller mode switch)
    """

    def __init__(self, model, data):
        self.model = model
        self.data = data
        self._act_idx = {}
        for i in range(model.nu):
            name = mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_ACTUATOR, i)
            self._act_idx[name] = i
        self._joint_qadr = {}
        for jn in ROBOT_JOINTS:
            j = model.joint(jn)
            self._joint_qadr[jn] = int(j.qposadr[0])
        self.reset_targets()

    def reset_targets(self):
        """Sync ctrl targets to the current qpos."""
        for jn in ROBOT_JOINTS:
            aid = self._act_idx.get(f"act_{jn}")
            if aid is not None:
                self.data.ctrl[aid] = self.data.qpos[self._joint_qadr[jn]]

    def _target(self, joint):
        return self.data.ctrl[self._act_idx[f"act_{joint}"]]

    # anti-windup: never let a position target run further than this
    # from the actual joint, or contact phases spring-load the servo
    # and the arm whips to the stale target when the contact releases
    _WINDUP = {
        "robot0_arm_x": 0.20,
        "robot0_arm_y": 0.20,
        "robot0_arm_z": 0.20,
        "robot0_base_x": 0.30,
        "robot0_base_y": 0.30,
    }

    def _set(self, joint, val, lo, hi):
        w = self._WINDUP.get(joint)
        if w is not None:
            q = self.data.qpos[self._joint_qadr[joint]]
            val = float(np.clip(val, q - w, q + w))
        self.data.ctrl[self._act_idx[f"act_{joint}"]] = float(np.clip(val, lo, hi))

    def apply(self, action):
        a = np.clip(np.asarray(action, dtype=float), -1.0, 1.0)
        if a.shape[0] < ACTION_DIM:
            a = np.concatenate([a, np.zeros(ACTION_DIM - a.shape[0])])
        base_mode = a[11] > 0.0
        if base_mode:
            # base frame: forward is -y local (robot faces its arm side)
            yaw = self.data.qpos[self._joint_qadr["robot0_base_yaw"]]
            fwd = a[7] * BASE_POS_SCALE
            side = a[8] * BASE_POS_SCALE
            dx = -math.sin(yaw) * fwd + math.cos(yaw) * side
            dy = -math.cos(yaw) * fwd - math.sin(yaw) * side
            # note: robot faces local -y at yaw=0 to match fixture fronts
            self._set("robot0_base_x", self._target("robot0_base_x") + dx, -10, 10)
            self._set("robot0_base_y", self._target("robot0_base_y") + dy, -10, 10)
            self._set(
                "robot0_base_yaw",
                self._target("robot0_base_yaw") + a[9] * BASE_ROT_SCALE,
                -4 * math.pi,
                4 * math.pi,
            )
            self._set(
                "robot0_torso_joint",
                self._target("robot0_torso_joint") + a[10] * TORSO_SCALE,
                -0.25,
                0.45,
            )
        else:
            self._set("robot0_arm_x", self._target("robot0_arm_x") + a[0] * ARM_POS_SCALE, *ARM_RANGE["x"])
            self._set("robot0_arm_y", self._target("robot0_arm_y") + a[1] * ARM_POS_SCALE, *ARM_RANGE["y"])
            self._set("robot0_arm_z", self._target("robot0_arm_z") + a[2] * ARM_POS_SCALE, *ARM_RANGE["z"])
            self._set("robot0_wrist_roll", self._target("robot0_wrist_roll") + a[3] * ARM_ROT_SCALE, -math.pi, math.pi)
            self._set("robot0_wrist_pitch", self._target("robot0_wrist_pitch") + a[4] * ARM_ROT_SCALE, -math.pi, math.pi)
            self._set("robot0_wrist_yaw", self._target("robot0_wrist_yaw") + a[5] * ARM_ROT_SCALE, -2 * math.pi, 2 * math.pi)
        # gripper always active: a[6] > 0 -> close (fingers travel
        # inward to qpos max), < 0 -> open (qpos 0 = widest)
        grip_t = GRIP_RANGE[1] if a[6] > 0 else GRIP_RANGE[0]
        self._set("robot0_leftfinger_joint", grip_t, *GRIP_RANGE)

    def set_base_pose(self, xy, yaw):
        """Teleport the base (used at episode init; reference
        kitchen.py:604-683 robot placement)."""
        self.data.qpos[self._joint_qadr["robot0_base_x"]] = xy[0]
        self.data.qpos[self._joint_qadr["robot0_base_y"]] = xy[1]
        self.data.qpos[self._joint_qadr["robot0_base_yaw"]] = yaw
        self.reset_targets()
