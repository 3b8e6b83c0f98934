"""USD trajectory/scene export for kitchen episodes (the port's twin of
``lipvq_tpu/robocasa/usd_export.py``: the same env, steps and seed give the
same USDA text, byte for byte).

Counterpart of reference robocasa/utils/usd/ (exporter.py + helpers):
exports a kitchen scene's geometry and a recorded trajectory as USD so
episodes can be inspected/rendered in external DCC tools (Omniverse,
usdview, Blender). The reference drives Pixar's ``pxr`` bindings; those
are not installable here, so this writes the **USDA text format**
directly (USDA is a stable, documented ASCII encoding — no
dependencies needed to author it).

Exported structure:

    /World
      /Geometry/<body>/geom_i   (Cube/Cylinder/Sphere prims, colors)
      time-sampled xformOp:translate / xformOp:orient on moving bodies

    python -m lipvq_tpu_torch.robocasa.usd_export --env OpenDrawer \\
        --steps 40 --output /tmp/episode.usda
"""

from __future__ import annotations

import argparse

import numpy as np


def _fmt(x) -> str:
    if isinstance(x, (tuple, list, np.ndarray)):
        return "(" + ", ".join(_fmt(v) for v in x) + ")"
    return f"{float(x):.6g}"


_GEOM_PRIMS = {0: None, 2: "Sphere", 3: None, 4: None, 5: "Cylinder", 6: "Cube"}


def _sanitize(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if (out and not out[0].isdigit()) else "_" + out


def export_usda(model, data_frames: list, dt: float, path: str,
                include_static: bool = True) -> str:
    """Write a USDA stage.

    model: compiled MjModel; data_frames: list of (xpos [nbody,3],
    xquat [nbody,4]) snapshots captured per control step.
    """
    import mujoco

    n_frames = len(data_frames)
    lines = [
        "#usda 1.0",
        "(",
        '    defaultPrim = "World"',
        f"    endTimeCode = {max(n_frames - 1, 0)}",
        "    startTimeCode = 0",
        f"    timeCodesPerSecond = {1.0 / max(dt, 1e-6):.4g}",
        "    upAxis = \"Z\"",
        ")",
        "",
        'def Xform "World"',
        "{",
    ]

    # which bodies move? (any dof on the body or an ancestor)
    moving = set()
    for b in range(model.nbody):
        node = b
        while node != 0:
            if model.body_dofnum[node] > 0:
                moving.add(b)
                break
            node = int(model.body_parentid[node])

    for b in range(1, model.nbody):
        bname = _sanitize(
            mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_BODY, b)
            or f"body_{b}"
        )
        geoms = [g for g in range(model.ngeom) if model.geom_bodyid[g] == b]
        prims = []
        for g in geoms:
            gtype = int(model.geom_type[g])
            prim = _GEOM_PRIMS.get(gtype)
            if prim is None:
                continue
            prims.append((g, prim))
        if not prims:
            continue
        if (b not in moving) and not include_static:
            continue
        lines.append(f'    def Xform "{bname}"')
        lines.append("    {")
        if b in moving and n_frames:
            lines.append(
                "        double3 xformOp:translate.timeSamples = {"
            )
            for t, (xpos, _) in enumerate(data_frames):
                lines.append(f"            {t}: {_fmt(xpos[b])},")
            lines.append("        }")
            lines.append("        quatf xformOp:orient.timeSamples = {")
            for t, (_, xquat) in enumerate(data_frames):
                w, x, y, z = xquat[b]
                lines.append(f"            {t}: ({_fmt(w)}, {_fmt(x)}, "
                             f"{_fmt(y)}, {_fmt(z)}),")
            lines.append("        }")
            lines.append(
                '        uniform token[] xformOpOrder = '
                '["xformOp:translate", "xformOp:orient"]'
            )
        else:
            xpos, xquat = data_frames[0] if data_frames else (
                model.body_pos, model.body_quat
            )
            lines.append(
                f"        double3 xformOp:translate = {_fmt(xpos[b])}"
            )
            w, x, y, z = xquat[b]
            lines.append(
                f"        quatf xformOp:orient = ({_fmt(w)}, {_fmt(x)}, "
                f"{_fmt(y)}, {_fmt(z)})"
            )
            lines.append(
                '        uniform token[] xformOpOrder = '
                '["xformOp:translate", "xformOp:orient"]'
            )
        for g, prim in prims:
            gname = _sanitize(
                mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_GEOM, g)
                or f"geom_{g}"
            )
            size = model.geom_size[g]
            rgba = model.geom_rgba[g]
            lines.append(f'        def {prim} "{gname}"')
            lines.append("        {")
            if prim == "Cube":
                lines.append("            double size = 2")
                lines.append(
                    f"            float3 xformOp:scale = {_fmt(size[:3])}"
                )
            elif prim == "Sphere":
                lines.append(f"            double radius = {_fmt(size[0])}")
            elif prim == "Cylinder":
                lines.append(f"            double radius = {_fmt(size[0])}")
                lines.append(
                    f"            double height = {_fmt(2 * size[1])}"
                )
                lines.append('            uniform token axis = "Z"')
            lines.append(
                f"            color3f[] primvars:displayColor = "
                f"[{_fmt(rgba[:3])}]"
            )
            lines.append(
                f"            float[] primvars:displayOpacity = "
                f"[{_fmt(rgba[3])}]"
            )
            lines.append(
                f"            double3 xformOp:translate = "
                f"{_fmt(model.geom_pos[g])}"
            )
            if prim == "Cube":
                lines.append(
                    '            uniform token[] xformOpOrder = '
                    '["xformOp:translate", "xformOp:scale"]'
                )
            else:
                lines.append(
                    '            uniform token[] xformOpOrder = '
                    '["xformOp:translate"]'
                )
            lines.append("        }")
        lines.append("    }")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def export_episode(env_name: str, steps: int, output: str, seed: int = 0,
                   use_expert: bool = True) -> str:
    """Roll an episode (expert policy when available) and export it."""
    from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS

    env = REGISTERED_KITCHEN_ENVS[env_name](seed=seed)
    env.reset()
    policy = None
    if use_expert:
        try:
            from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy

            policy = make_scripted_policy(env_name, env)
        except KeyError:
            policy = None
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(steps):
        frames.append(
            (np.array(env.data.xpos), np.array(env.data.xquat))
        )
        a = policy.get_action() if policy else rng.uniform(-1, 1, 12)
        env.step(a)
    dt = env.n_substeps * env._physics_dt
    path = export_usda(env.model, frames, dt, output)
    env.close()
    return path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", type=str, default="OpenDrawer")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    path = export_episode(args.env, args.steps, args.output, args.seed)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
