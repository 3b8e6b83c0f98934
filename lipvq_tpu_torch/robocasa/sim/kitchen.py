"""Kitchen base environment (MuJoCo-direct).

The port's copy of ``lipvq_tpu/robocasa/sim/kitchen.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

Counterpart of reference robocasa/environments/kitchen/kitchen.py:46-1633:
- ``KitchenEnvMeta``-style registration (reference kitchen.py:46-59)
  via ``register_kitchen_env`` / the ``Kitchen.__init_subclass__`` hook;
- layout/style sampling per episode (reference kitchen.py:335-400);
- procedural scene assembly (reference scene_builder.py) from the
  layout templates in :mod:`layouts`;
- object cfgs -> placement sampling (reference kitchen.py:485-878);
- robot base placement in front of a reference fixture (reference
  kitchen.py:604-683);
- sparse reward = ``_check_success`` (reference kitchen.py:1378-1398);
- ``get_ep_meta`` with layout/style/lang/object cfgs (reference
  kitchen.py:926-956) and ``reset_to``-compatible state capture.

The env steps MuJoCo directly (no robosuite): ``step`` integrates the
position-servo targets from :class:`RobotController` and advances
``n_substeps`` physics steps per control step (control_freq=20 Hz).
"""

from __future__ import annotations

import json
import math
from collections import OrderedDict

import numpy as np

try:
    import mujoco
except ImportError:  # importable without mujoco
    mujoco = None

from lipvq_tpu_torch.robocasa.sim import layouts as L
from lipvq_tpu_torch.robocasa.sim.fixtures import (
    CoffeeMachine,
    Counter,
    Drawer,
    Fixture,
    FixtureType,
    HingeCabinet,
    Microwave,
    OpenCabinet,
    SingleCabinet,
    Sink,
    Stove,
    fixture_is_type,
    rot_z,
)
from lipvq_tpu_torch.robocasa.sim.objects import (
    groups_containing,
    make_object,
    object_lang,
    sample_kitchen_object,
)
from lipvq_tpu_torch.robocasa.sim.placement import RandomizationError, SequentialCompositeSampler
from lipvq_tpu_torch.robocasa.sim.robot import ACTION_DIM, RobotController, build_robot

REGISTERED_KITCHEN_ENVS = {}


def _wrap_pi(q):
    """Wrap an angle to [-pi, pi): hinge angles reported mod 2*pi
    (fixtures.py get_handle_state/get_knobs_state) jump 0 <-> 2*pi
    around the rest pose, which a regression target cannot track."""
    return float((q + math.pi) % (2 * math.pi) - math.pi)


def register_kitchen_env(cls):
    """Reference kitchen.py:49-50."""
    REGISTERED_KITCHEN_ENVS[cls.__name__] = cls
    return cls


class Kitchen:
    """Base kitchen env (reference kitchen.py:73-1633).

    Subclasses override ``_setup_kitchen_references``, ``_get_obj_cfgs``,
    ``_reset_internal`` and ``_check_success`` exactly like the
    reference task files.
    """

    EXCLUDE_LAYOUTS: list = []

    def __init_subclass__(cls, **kwargs):
        # KitchenEnvMeta equivalent (reference kitchen.py:53-59)
        super().__init_subclass__(**kwargs)
        register_kitchen_env(cls)

    def __init__(
        self,
        layout_ids=-1,
        style_ids=-1,
        seed=None,
        has_renderer=False,
        has_offscreen_renderer=False,
        render_camera="robot0agentview_center",
        camera_names=("robot0agentview_center",),
        camera_heights=128,
        camera_widths=128,
        use_camera_obs=False,
        control_freq=20,
        horizon=500,
        obj_registries=("objaverse",),
        obj_instance_split=None,
        generative_textures=None,
        randomize_cameras=False,
        translucent_robot=False,
        **kwargs,
    ):
        if mujoco is None:
            # the JAX package fails later here, with an AttributeError on None
            raise ModuleNotFoundError(
                f"{type(self).__name__}: the kitchen sim needs the 'mujoco' package, "
                f"which is not installed", name="mujoco")
        self.obj_registries = (
            (obj_registries,) if isinstance(obj_registries, str)
            else tuple(obj_registries)
        )
        self.obj_instance_split = obj_instance_split
        self.generative_textures = generative_textures
        self.layout_ids = [
            lid for lid in L.unpack_layout_ids(layout_ids)
            if lid not in self.EXCLUDE_LAYOUTS
        ]
        self.style_ids = L.unpack_style_ids(style_ids)
        self.rng = np.random.default_rng(seed)
        self.randomize_cameras = randomize_cameras
        self.translucent_robot = translucent_robot
        self.control_freq = control_freq
        self.horizon = horizon
        self.use_camera_obs = use_camera_obs
        self.camera_names = list(camera_names)
        self.camera_heights = camera_heights
        self.camera_widths = camera_widths
        self._physics_dt = 0.002
        self.n_substeps = max(1, int(round(1.0 / (control_freq * self._physics_dt))))
        self._renderer = None

        self.model = None
        self.data = None
        self.fixtures = OrderedDict()
        self.objects = OrderedDict()
        self.obj_body_id = {}
        self.fixture_refs = {}
        self._ep_meta = {}
        self.timestep = 0
        self.layout_id = None
        self.style_id = None
        self._object_cfgs = []
        self._placements = {}
        self._obj_fixture = {}
        self._pending_ep_meta = {}
        self._model_xml = None

    # ================= mujoco access helpers ==========================
    # These are the primitives the fixture state APIs consume
    # (reference fixtures call env.sim.data/model directly).
    def set_joint_qpos(self, joint_name, value):
        j = self.model.joint(joint_name)
        self.data.qpos[j.qposadr[0]] = value

    def get_joint_qpos(self, joint_name):
        j = self.model.joint(joint_name)
        return float(self.data.qpos[j.qposadr[0]])

    def geom_xpos(self, geom_name):
        return np.array(self.data.geom(geom_name).xpos)

    def site_xpos(self, site_name):
        return np.array(self.data.site(site_name).xpos)

    def set_site_alpha(self, site_name, alpha):
        sid = self.model.site(site_name).id
        self.model.site_rgba[sid][3] = alpha

    def eef_pos(self):
        return self.site_xpos("robot0_grip_site")

    def object_pos(self, obj_name):
        return np.array(self.data.body(self.obj_body_id[obj_name]).xpos)

    def object_quat(self, obj_name):
        return np.array(self.data.body(self.obj_body_id[obj_name]).xquat)

    def check_contact(self, prefix_a, prefix_b):
        """True if any contact pairs a geom named ``prefix_a*`` with one
        named ``prefix_b*`` (reference robosuite check_contact)."""
        for i in range(self.data.ncon):
            c = self.data.contact[i]
            n1 = mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_GEOM, c.geom1) or ""
            n2 = mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_GEOM, c.geom2) or ""
            if (n1.startswith(prefix_a) and n2.startswith(prefix_b)) or (
                n2.startswith(prefix_a) and n1.startswith(prefix_b)
            ):
                return True
        return False

    def check_gripper_contact(self, geom_prefix):
        """Gripper finger/palm touching the named geom (reference
        microwave.py:96-115 button logic)."""
        return self.check_contact("robot0_leftfinger_geom", geom_prefix) or \
            self.check_contact("robot0_rightfinger_geom", geom_prefix) or \
            self.check_contact("robot0_palm_geom", geom_prefix)

    # ================= fixture lookup =================================
    def get_fixture(self, id, ref=None, size=None):
        """Reference kitchen.py:1481-1551."""
        if isinstance(id, Fixture):
            return id
        if isinstance(id, str) and id in self.fixtures:
            return self.fixtures[id]
        matches = [f for f in self.fixtures.values() if fixture_is_type(f, id)]
        if size is not None:
            matches = [
                f for f in matches
                if f.width >= size[0] - 1e-9
            ]
        if not matches:
            raise ValueError(f"no fixture matching id {id!r}")
        if ref is None:
            idx = int(self.rng.integers(len(matches)))
            return matches[idx]
        refc = self.get_fixture(ref).center
        dists = [np.linalg.norm(f.center - refc) for f in matches]
        return matches[int(np.argmin(dists))]

    def register_fixture_ref(self, ref_name, fn_kwargs):
        """Reference kitchen.py:1552-1568 — sticky across resets via
        ep_meta (fixture names are deterministic per layout)."""
        if ref_name in self.fixture_refs:
            return self.fixture_refs[ref_name]
        saved = self._ep_meta.get("fixture_refs", {})
        if ref_name in saved and saved[ref_name] in self.fixtures:
            fx = self.fixtures[saved[ref_name]]
        else:
            fx = self.get_fixture(**fn_kwargs)
        self.fixture_refs[ref_name] = fx
        return fx

    # ================= scene assembly =================================
    def _choose_scene(self):
        saved = self._ep_meta
        if "layout_id" in saved:
            self.layout_id = int(saved["layout_id"])
            self.style_id = int(saved["style_id"])
        else:
            self.layout_id = int(self.rng.choice(self.layout_ids))
            self.style_id = int(self.rng.choice(self.style_ids))
        self.style = L.STYLES[self.style_id]

    def _build_scene(self):
        self._choose_scene()
        fixture_list = L.build_layout(self.layout_id)
        self.fixtures = OrderedDict((f.name, f) for f in fixture_list)

        spec = mujoco.MjSpec()
        # all angles/ranges in this package are radians; MjSpec
        # defaults to degrees (this silently turns joint ranges into
        # hard limits a few degrees wide)
        spec.compiler.degree = False
        spec.option.timestep = self._physics_dt
        spec.option.integrator = mujoco.mjtIntegrator.mjINT_IMPLICITFAST
        try:
            spec.option.noslip_iterations = 2
        except AttributeError:
            pass
        # ground plane (objects must never fall through)
        g = spec.worldbody.add_geom(
            name="ground", type=mujoco.mjtGeom.mjGEOM_PLANE,
            size=[20, 20, 0.1], rgba=list(self.style["floor"]),
        )
        g.contype, g.conaffinity = 1, 3  # static, but catches dynamics
        spec.worldbody.add_light(pos=[2.0, -2.0, 3.5], dir=[-0.2, 0.3, -1.0])

        for fx in self.fixtures.values():
            fx.build(spec, self.style)

        # domain-randomized procedural textures (reference
        # generative_textures kwarg + utils/texture_swap.py; see
        # sim/textures.py for the determinism contract)
        self._texture_params = None
        if self.generative_textures:
            from lipvq_tpu_torch.robocasa.sim.textures import (
                apply_generative_textures,
                draw_texture_params,
            )

            saved = self._ep_meta.get("texture_params")
            self._texture_params = saved or draw_texture_params(
                self.rng, self.style
            )
            apply_generative_textures(spec, self.fixtures, self._texture_params)

        build_robot(spec)
        self._add_cameras(spec)
        return spec

    def _add_cameras(self, spec):
        """Agentview camera looking at the scene center (reference
        camera_utils / kitchen.py:973-1018).

        With ``randomize_cameras``, the agentview pose gets per-episode
        gaussian noise — pos sigma 0.05 m, euler sigma 3 deg, matching
        reference kitchen.py:993-1018 (eye-in-hand cameras there draw
        zero noise, so body-mounted cameras here are left exact). The
        draw is recorded in ep_meta so ``reset_to`` replays the same
        camera pose bit-identically."""
        pos = np.array([2.5, -3.2, 1.9])
        xyaxes = np.array([1.0, 0.0, 0.0, 0.0, 0.45, 0.9])
        self._cam_noise = None
        if self.randomize_cameras:
            saved = self._ep_meta.get("cam_noise")
            if saved is not None:
                pos_noise = np.asarray(saved["pos"], float)
                euler_noise = np.asarray(saved["euler"], float)
            else:
                pos_noise = self.rng.normal(0.0, 0.05, 3)
                euler_noise = self.rng.normal(0.0, 3.0, 3)
            self._cam_noise = {
                "pos": [float(v) for v in pos_noise],
                "euler": [float(v) for v in euler_noise],
            }
            pos = pos + pos_noise
            from scipy.spatial.transform import Rotation

            x = xyaxes[:3] / np.linalg.norm(xyaxes[:3])
            y = xyaxes[3:] / np.linalg.norm(xyaxes[3:])
            rmat = np.column_stack([x, y, np.cross(x, y)])
            rmat = (
                Rotation.from_euler("xyz", euler_noise, degrees=True).as_matrix()
                @ rmat
            )
            xyaxes = np.concatenate([rmat[:, 0], rmat[:, 1]])
        spec.worldbody.add_camera(
            name="robot0agentview_center",
            pos=[float(v) for v in pos],
            xyaxes=[float(v) for v in xyaxes],
        )

    def _sample_cfg_object(self, cfg, name):
        """Sample one object for a cfg dict, honoring the env-level
        registry/split settings (reference kitchen.py _create_obj)."""
        saved_obj = (self._ep_meta.get("object_cats") or {}).get(name)
        if saved_obj is not None:
            return make_object(saved_obj, name=name)
        obj = sample_kitchen_object(
            self.rng,
            obj_groups=cfg.get("obj_groups", "all"),
            exclude_obj_groups=cfg.get("exclude_obj_groups"),
            graspable=cfg.get("graspable"),
            washable=cfg.get("washable"),
            microwavable=cfg.get("microwavable"),
            # NOTE: a "heatable" cfg key is deliberately NOT consulted —
            # the reference engine reads only "cookable"
            # (kitchen.py:579), silently ignoring the heatable=True
            # flags some of its own task specs pass
            # (e.g. heat_multiple_water.py:37).
            cookable=cfg.get("cookable"),
            freezable=cfg.get("freezable"),
            max_size=cfg.get("max_size", (None, None, None)),
            obj_registries=self.obj_registries,
            split=self.obj_instance_split,
            object_scale=cfg.get("object_scale"),
        )
        obj.name = name
        return obj

    def _create_objects(self, spec):
        """Sample + place task objects (reference kitchen.py:485-589).

        ``placement["try_to_place_in"]`` nests the object in a sampled
        container placed per the original cfg (reference
        kitchen.py:513-547: container gets ``{name}_container`` and the
        object is re-placed on/in it).
        """
        self.objects = OrderedDict()
        self._object_cfgs = self._get_obj_cfgs()
        sampler = SequentialCompositeSampler(self.rng)
        # counter-top accessory fixtures obstruct the counters'
        # sampling regions exactly like already-placed objects
        # (observed: a can spawned standing ON the coffee machine
        # platform, ungraspable under the dispenser head). The
        # reference gets this via its composite sampler seeing fixture
        # objects (placement_samplers.py:416-568).
        from lipvq_tpu_torch.robocasa.sim.fixtures import Toaster

        for fx in self.fixtures.values():
            if isinstance(fx, (CoffeeMachine, Toaster)):
                r = 0.5 * float(np.hypot(fx.size[0], fx.size[1]))
                sampler.placed.append(
                    (np.asarray(fx.pos, dtype=float), r)
                )
        saved_placements = self._ep_meta.get("object_placements")
        self._placements = {}
        self._obj_fixture = {}

        def place(obj, fixture, placement, name):
            # resolve FixtureType / name refs inside sample_region_kwargs
            # (reference task cfgs pass e.g. ref=FixtureType.STOOL,
            # serving_food/pan_transfer.py:79)
            srk = placement.get("sample_region_kwargs")
            if srk and not isinstance(srk.get("ref"), (Fixture, type(None))):
                placement = dict(placement)
                placement["sample_region_kwargs"] = dict(
                    srk, ref=self.get_fixture(srk["ref"])
                )
            if saved_placements is not None and name in saved_placements:
                world, yaw = saved_placements[name]
                world = np.asarray(world)
            else:
                try:
                    world, yaw = sampler.place(fixture, obj, placement)
                except RandomizationError:
                    # fall back: drop at region center
                    c, _ = fixture.sample_region(
                        **(placement.get("sample_region_kwargs") or {})
                    )
                    world, yaw = fixture.to_world(c + [0, 0, 0.002]), 0.0
            self._placements[name] = (np.asarray(world).tolist(), float(yaw))
            obj.build(spec, pos=world, yaw=yaw)
            self.objects[name] = obj
            self._obj_fixture[name] = fixture
            return world, yaw

        for i, cfg in enumerate(self._object_cfgs):
            name = cfg["name"]
            obj = self._sample_cfg_object(cfg, name)
            placement = dict(cfg.get("placement", {}))
            fixture = placement.pop("fixture", None)
            if fixture is None:
                fixture = self.get_fixture(FixtureType.COUNTER)
            elif not isinstance(fixture, Fixture):
                fixture = self.get_fixture(fixture)
            container_group = placement.pop("try_to_place_in", None)
            if placement.pop("try_to_place_in_container", None):
                container_group = placement.pop("container_group", "container")
            container_kwargs = placement.pop("container_kwargs", None) or {}
            if container_group and "in_container" in groups_containing(obj.category):
                cname = f"{name}_container"
                ccfg = {"name": cname, "obj_groups": container_group}
                ccfg.update(container_kwargs)
                container = self._sample_cfg_object(ccfg, cname)
                cworld, cyaw = place(container, fixture, placement, cname)
                # the object rides on the container's surface
                world = np.asarray(cworld) + [0.0, 0.0, container.height + 0.002]
                self._placements[name] = (world.tolist(), 0.0)
                if saved_placements is not None and name in saved_placements:
                    world = np.asarray(saved_placements[name][0])
                obj.build(spec, pos=world, yaw=0.0)
                self.objects[name] = obj
                self._obj_fixture[name] = fixture
            else:
                place(obj, fixture, placement, name)

    def _get_obj_cfgs(self):
        """Reference kitchen.py:914-925."""
        return []

    # ================= robot placement ================================
    def compute_robot_base_placement_pose(self, ref_fixture, offset=None):
        """Pose in front of a fixture, facing it (reference
        kitchen.py:604-683)."""
        ref_fixture = self.get_fixture(ref_fixture)
        face_dist = ref_fixture.depth / 2 + 0.40
        local = np.array([0.0, -face_dist, 0.0])
        if offset is not None:
            local = local + np.array([offset[0], -offset[1], 0.0])
        pos = ref_fixture.to_world(local)
        pos[2] = 0.0
        # the robot's reach direction is its local -y (robot.py
        # ARM_RANGE); facing the fixture therefore means
        # yaw = fixture.yaw + pi (fixture fronts point along local -y)
        ori = np.array([0.0, 0.0, ref_fixture.yaw + math.pi])
        # nudge outward/sideways until the base footprint clears all
        # floor-level fixtures (reference kitchen_drawer.py:27-75
        # check_fxtr_contact / check_sidewall_contact)
        if self._base_pose_collides(pos, ref_fixture):
            for extra in np.arange(0.1, 0.9, 0.1):
                for lateral in (0.0, -0.3, 0.3, -0.6, 0.6):
                    cand = ref_fixture.to_world(
                        local + np.array([lateral, -extra, 0.0])
                    )
                    cand[2] = 0.0
                    if not self._base_pose_collides(cand, ref_fixture):
                        return cand, ori
        return pos, ori

    _BASE_RADIUS = 0.30

    def _base_pose_collides(self, pos, ref_fixture=None):
        """Base circle vs floor-level fixture footprints (2D)."""
        for fx in self.fixtures.values():
            if fx.pos[2] > 0.5:  # wall cabinets etc. clear the base
                continue
            if type(fx).__name__ in ("Floor", "Hood", "CoffeeMachine"):
                continue
            p = fx.to_local(np.array([pos[0], pos[1], 0.0]))
            half = fx.size / 2.0
            dx = max(abs(p[0]) - half[0], 0.0)
            dy = max(abs(p[1]) - half[1], 0.0)
            if math.hypot(dx, dy) < self._BASE_RADIUS:
                return True
        return False

    # ================= reset / step ===================================
    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.fixture_refs = {}
        # a reset_to() seeds _pending_ep_meta for one reset; a plain
        # reset resamples everything (reference kitchen.py:879-913)
        self._ep_meta = getattr(self, "_pending_ep_meta", {}) or {}
        self._pending_ep_meta = {}
        spec = self._build_scene()
        self._setup_kitchen_references()
        self._create_objects(spec)
        self.model = spec.compile()
        self._model_xml = spec.to_xml()
        self.data = mujoco.MjData(self.model)
        self.obj_body_id = {
            name: self.model.body(name).id for name in self.objects
        }
        if self.translucent_robot:
            # reference kitchen.py:1365-1376: alpha 0.10 on robot
            # visual geoms during rendering
            for gid in range(self.model.ngeom):
                gname = self.model.geom(gid).name
                if gname.startswith("robot0") and self.model.geom_rgba[gid, 3] > 0:
                    self.model.geom_rgba[gid, 3] = 0.10
        # robot initial pose
        init_fixture = getattr(self, "init_robot_base_pos", None)
        self.controller = RobotController(self.model, self.data)
        if init_fixture is not None:
            pos, ori = self.compute_robot_base_placement_pose(init_fixture)
            self.controller.set_base_pose(pos[:2], ori[2])
        self._reset_internal()
        # objects placed inside a drawer were positioned at the CLOSED
        # pose; if _reset_internal opened the drawer, carry them along
        # (reference kitchen_doors.py:56-66 orders state-then-place for
        # the same reason)
        from lipvq_tpu_torch.robocasa.sim.fixtures import Drawer, rot_z

        for oname, fx in self._obj_fixture.items():
            if isinstance(fx, Drawer):
                s = self.get_joint_qpos(f"{fx.name}_slidejoint")
                if abs(s) > 1e-9:
                    shift = rot_z(fx.yaw) @ np.array([0.0, -s, 0.0])
                    adr = self.model.joint(f"{oname}_freejoint").qposadr[0]
                    self.data.qpos[adr : adr + 3] += shift
        mujoco.mj_forward(self.model, self.data)
        # let free objects settle onto their supports
        for _ in range(40):
            mujoco.mj_step(self.model, self.data)
        self.controller.reset_targets()
        for fx in self.fixtures.values():
            fx.update_state(self)
        self.timestep = 0
        self._ep_lang_str = self.get_ep_meta().get("lang", "")
        return self.get_observation()

    def _setup_kitchen_references(self):
        """Reference kitchen.py:590-599."""

    def _reset_internal(self):
        """Reference kitchen.py:879-913 (task state like door poses)."""

    def step(self, action):
        self.controller.apply(action)
        for _ in range(self.n_substeps):
            mujoco.mj_step(self.model, self.data)
        for fx in self.fixtures.values():
            fx.update_state(self)
        self.timestep += 1
        reward = self.reward(action)
        done = self.timestep >= self.horizon
        obs = self.get_observation()
        info = {"is_success": self.is_success()}
        return obs, reward, done, info

    def reward(self, action=None):
        """Sparse success reward (reference kitchen.py:1378-1388)."""
        return float(self._check_success())

    def _check_success(self):
        """Reference kitchen.py:1389-1398."""
        return False

    def is_success(self):
        return {"task": bool(self._check_success())}

    # ================= observations ===================================
    def get_observation(self):
        """Low-dim proprio + object obs (reference kitchen.py:1182-1302
        observable sensors)."""
        obs = {}
        base = self.data.body("robot0_base")
        obs["robot0_base_pos"] = np.array(base.xpos, dtype=np.float32)
        obs["robot0_base_quat"] = np.array(base.xquat, dtype=np.float32)
        eef = self.eef_pos()
        obs["robot0_eef_pos"] = eef.astype(np.float32)
        palm = self.data.body("robot0_palm")
        obs["robot0_eef_quat"] = np.array(palm.xquat, dtype=np.float32)
        lf = self.get_joint_qpos("robot0_leftfinger_joint")
        rf = self.get_joint_qpos("robot0_rightfinger_joint")
        obs["robot0_gripper_qpos"] = np.array([lf, rf], dtype=np.float32)
        obs["robot0_base_to_eef_pos"] = (eef - base.xpos).astype(np.float32)
        # object sensors (reference kitchen.py:1232-1302)
        obj_states = []
        for name in self.objects:
            pos = self.object_pos(name)
            quat = self.object_quat(name)
            obs[f"{name}_pos"] = pos.astype(np.float32)
            obs[f"{name}_quat"] = quat.astype(np.float32)
            obs[f"{name}_to_robot0_eef_pos"] = (pos - eef).astype(np.float32)
            obj_states.extend([pos, quat, pos - eef])
        if obj_states:
            obs["object"] = np.concatenate(obj_states).astype(np.float32)
        else:
            obs["object"] = np.zeros(0, dtype=np.float32)
        obs["obj_state"] = self._obj_state_obs(eef)
        obs["fixture_state"] = self._fixture_state_obs(eef)
        if self.use_camera_obs:
            for cam in self.camera_names:
                obs[f"{cam}_image"] = self.render_camera(cam)
        return obs

    # obj_state layout: OBJ_STATE_SLOTS slots of 10 dims each — world pos
    # (3), quat (4), pos minus eef (3). Slot order: the task's primary
    # object ("obj" by robocasa cfg convention, e.g. single_stage.py
    # PnP._get_obj_cfgs), then "container", then remaining objects in
    # sorted-name order, zero-padded. The task-INDEPENDENT fixed-dim
    # analogue of the reference's variable-dim ``object`` sensor vector
    # (reference kitchen.py:1232-1302): MetaDataset mixtures across task
    # families can batch it, which the per-task ``object`` key cannot.
    OBJ_STATE_SLOTS = 2

    def _obj_state_obs(self, eef):
        names = [n for n in ("obj", "container") if n in self.objects]
        names += [n for n in sorted(self.objects) if n not in names]
        slots = []
        for n in names[: self.OBJ_STATE_SLOTS]:
            pos = np.asarray(self.object_pos(n), dtype=float)
            quat = np.asarray(self.object_quat(n), dtype=float)
            slots.append(np.concatenate([pos, quat, pos - eef]))
        while len(slots) < self.OBJ_STATE_SLOTS:
            slots.append(np.zeros(10))
        return np.concatenate(slots).astype(np.float32)

    # fixture_state layout: FIXTURE_STATE_SLOTS slots of 8 dims each —
    # grasp-point world pos (3), grasp-point minus eef (3), up to two
    # articulation scalars (door/drawer fractions, or faucet handle +
    # spout hinge angles wrapped to [-pi, pi)). Slots are the task's
    # registered fixture refs in sorted-key order, zero-padded.
    FIXTURE_STATE_SLOTS = 2

    def _fixture_state_obs(self, eef):
        """Task-fixture articulation observation.

        The reference's low-dim configs expose manipulated-object state
        through the ``object`` sensor vector (reference
        kitchen.py:1232-1302); fixture-centric tasks (doors, drawers,
        faucets) have no movable object, so their manipulated state —
        handle world position and joint fraction — is exposed here with
        a task-independent fixed dimension so MetaDataset mixtures can
        batch it (same role the reference's per-task ``object`` key
        plays for object-centric tasks).
        """
        slots = []
        for fx in self._task_fixtures():
            task_knob = getattr(self, "knob", None)
            grasp_geoms = [getattr(fx, "handle_name", None),
                           f"{fx.name}_handlebar"]
            if isinstance(task_knob, str):
                grasp_geoms.insert(0, f"{fx.name}_knobtab_{task_knob}")
            grasp = None
            for geom in grasp_geoms:
                if geom is None:
                    continue
                try:
                    grasp = np.asarray(self.geom_xpos(geom), dtype=float)
                    break
                except Exception:
                    continue
            if grasp is None:
                grasp = fx.center
            qs = []
            try:
                if hasattr(fx, "get_door_state"):
                    d = fx.get_door_state(self)
                    qs = [float(d[k]) for k in sorted(d)]
                elif hasattr(fx, "get_handle_state"):
                    d = fx.get_handle_state(self)
                    qs = [_wrap_pi(d["handle_joint"]),
                          _wrap_pi(d["spout_joint"])]
                elif hasattr(fx, "get_knobs_state"):
                    d = fx.get_knobs_state(self)
                    order = sorted(d, key=lambda k: (k != task_knob, k))
                    qs = [_wrap_pi(d[k]) for k in order]
                if len(qs) < 2 and hasattr(fx, "get_state"):
                    st = fx.get_state()
                    qs += [float(st[k]) for k in sorted(st)
                           if isinstance(st[k], (bool, int, float))]
            except Exception:
                qs = []
            qs = (qs + [0.0, 0.0])[:2]
            slots.append(np.concatenate([grasp, grasp - eef, qs]))
        while len(slots) < self.FIXTURE_STATE_SLOTS:
            slots.append(np.zeros(8))
        return np.concatenate(slots).astype(np.float32)

    def _task_fixtures(self):
        """Fixtures whose state the task manipulates/references, most
        task-central first: the robot's staging fixture (every task
        points ``init_robot_base_pos`` at its work fixture) then any
        registered fixture refs."""
        fxs = []
        base = getattr(self, "init_robot_base_pos", None)
        if isinstance(base, Fixture):
            fxs.append(base)
        for key in sorted(self.fixture_refs):
            fx = self.fixture_refs[key]
            if all(fx is not f for f in fxs):
                fxs.append(fx)
        return fxs[: self.FIXTURE_STATE_SLOTS]

    def render_camera(self, camera_name, height=None, width=None):
        h = height or self.camera_heights
        w = width or self.camera_widths
        if self._renderer is None or getattr(self, "_renderer_hw", None) != (h, w):
            try:
                self._renderer = mujoco.Renderer(self.model, height=h, width=w)
            except Exception as e:  # no GL backend (headless container)
                raise RuntimeError(
                    "offscreen rendering needs an OpenGL backend (EGL/"
                    "OSMesa), none is available in this environment; "
                    "run with use_camera_obs=False / low-dim modalities"
                ) from e
            self._renderer_hw = (h, w)
        self._renderer.update_scene(self.data, camera=camera_name)
        return self._renderer.render()

    def render(self, mode="rgb_array", height=None, width=None, camera_name=None):
        return self.render_camera(
            camera_name or self.camera_names[0], height, width
        )

    # ================= episode metadata / state ======================
    def get_ep_meta(self):
        """Reference kitchen.py:926-956."""
        ep_meta = dict(self._ep_meta)
        ep_meta["layout_id"] = self.layout_id
        ep_meta["style_id"] = self.style_id
        ep_meta["object_cats"] = {n: o.spec_str for n, o in self.objects.items()}
        ep_meta["object_placements"] = dict(self._placements)
        if getattr(self, "_texture_params", None):
            ep_meta["texture_params"] = self._texture_params
        if getattr(self, "_cam_noise", None):
            ep_meta["cam_noise"] = self._cam_noise
        ep_meta["fixture_refs"] = {
            k: v.name for k, v in self.fixture_refs.items()
        }
        ep_meta.setdefault("lang", "")
        return ep_meta

    def get_obj_lang(self, obj_name="obj", get_preposition=False):
        """Reference kitchen.py:1569-1599."""
        lang = object_lang(self.objects[obj_name])
        if not get_preposition:
            return lang
        return lang, "in"

    def get_state(self):
        """Flat sim state for reset_to (reference EnvRobosuite
        get_state: xml + qpos/qvel)."""
        return {
            "states": np.concatenate([self.data.qpos, self.data.qvel]),
            "ep_meta": json.dumps(self.get_ep_meta()),
            "model": self._model_xml,
        }

    def reset_to(self, state):
        """Restore a captured state: ep_meta re-seeds the procedural
        build (layout/style/objects/placements), the saved model xml
        guarantees an identical compiled model, and qpos/qvel restore
        the dynamics (reference env_robosuite.py:156-217)."""
        flat = state.get("states")
        if (
            flat is not None
            and not state.get("ep_meta")
            and not state.get("model")
            and self.model is not None
            and len(flat) == self.model.nq + self.model.nv
        ):
            # hot replay path (obs extraction steps through states of
            # one demo): restore qpos/qvel on the live model without a
            # procedural rebuild
            self.data.qpos[:] = flat[: self.model.nq]
            self.data.qvel[:] = flat[self.model.nq :]
            mujoco.mj_forward(self.model, self.data)
            self.controller.reset_targets()
            return self.get_observation()
        ep_meta = state.get("ep_meta")
        if ep_meta:
            self._pending_ep_meta = (
                json.loads(ep_meta) if isinstance(ep_meta, str) else dict(ep_meta)
            )
        obs = self.reset()
        xml = state.get("model")
        if xml and xml != self._model_xml:
            # exact-model restore path: bypass the procedural rebuild
            self.model = mujoco.MjModel.from_xml_string(xml)
            self._model_xml = xml
            self.data = mujoco.MjData(self.model)
            self.obj_body_id = {
                name: self.model.body(name).id for name in self.objects
            }
            self.controller = RobotController(self.model, self.data)
            self._renderer = None
        flat = state.get("states")
        if flat is not None:
            nq = self.model.nq
            self.data.qpos[:] = flat[:nq]
            self.data.qvel[:] = flat[nq : nq + self.model.nv]
            mujoco.mj_forward(self.model, self.data)
            self.controller.reset_targets()
            obs = self.get_observation()
        return obs

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None


# -------- object-utils helpers (reference robocasa/utils/object_utils.py)
def obj_inside_of(env, obj_name, fixture, partial_check=False):
    """Reference object_utils.py:12-60 — interior-box containment."""
    fixture = env.get_fixture(fixture)
    pos = env.object_pos(obj_name)
    return fixture.point_inside(pos, margin=0.02)


def check_obj_in_receptacle(env, obj_name, receptacle_name, th=None):
    """Reference object_utils.py:323-337."""
    obj = env.objects[obj_name]
    recep = env.objects[receptacle_name]
    opos = env.object_pos(obj_name)
    rpos = env.object_pos(receptacle_name)
    if th is None:
        th = recep.horizontal_radius * 0.7
    in_contact = env.check_contact(f"{obj.name}_", f"{recep.name}_")
    return bool(in_contact and np.linalg.norm(opos[:2] - rpos[:2]) < th)


def check_obj_fixture_contact(env, obj_name, fixture):
    """Reference object_utils.py:340-346."""
    fixture = env.get_fixture(fixture)
    return env.check_contact(f"{obj_name}_", fixture.name)


def gripper_obj_far(env, obj_name="obj", th=0.25):
    """Reference object_utils.py:349-356."""
    opos = env.object_pos(obj_name)
    return bool(np.linalg.norm(env.eef_pos() - opos) > th)


def obj_location_on_stove(env, obj_name, stove, threshold=0.08, require_on=True):
    """Burner location an object sits on, or None.

    Mirrors the `_check_obj_location_on_stove` helper the reference
    repeats across boiling/frying/steaming tasks (e.g.
    heat_multiple_water.py:94-125): object must contact the stove,
    be within ``threshold`` of a burner site center and (when
    ``require_on``) that burner's knob must be turned on.
    """
    from lipvq_tpu_torch.robocasa.sim.fixtures import STOVE_LOCATIONS

    knobs = stove.get_knobs_state(env)
    if not check_obj_fixture_contact(env, obj_name, stove):
        return None
    opos = env.object_pos(obj_name)[:2]
    for loc in STOVE_LOCATIONS:
        bpos = env.site_xpos(f"{stove.name}_burner_on_{loc}")[:2]
        if np.linalg.norm(bpos - opos) < threshold:
            q = knobs[loc]
            knob_on = 0.35 <= abs(q) <= 2 * math.pi - 0.35
            if knob_on or not require_on:
                return loc
    return None


def fixture_pairwise_dist(f1, f2):
    """Reference object_utils.py:232-240."""
    p1s = f1.get_ext_sites(all_points=True)
    p2s = f2.get_ext_sites(all_points=True)
    return float(min(np.linalg.norm(p1 - p2) for p1 in p1s for p2 in p2s))
