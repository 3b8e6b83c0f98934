"""Procedural texture randomization (generative_textures).

The port's copy of ``lipvq_tpu/robocasa/sim/textures.py``, statement for
statement: the same numpy RNG calls in the same order, so the same seed
gives bit-equal results in both packages
(``tests/test_torch_port_kitchen_*.py``).

Functional analogue of reference robocasa/utils/texture_swap.py:1-676 +
the ``generative_textures`` Kitchen kwarg (reference kitchen.py ctor):
the reference swaps in AI-generated texture PNGs per surface class
(wall / floor / counter / cabinet); the asset pack is unavailable, so
this module synthesizes MuJoCo builtin textures (checker / gradient /
flat) with style-derived, RNG-jittered colors and applies them to the
same four surface classes.

Determinism contract: all color/repeat draws come from one
``draw_texture_params(rng, style)`` call whose output dict is stored in
``ep_meta["texture_params"]`` — ``reset_to`` replays bit-identically by
passing the saved dict back in (same pattern as object placements).
"""

from __future__ import annotations

import numpy as np

try:
    import mujoco
except ImportError:  # importable without mujoco
    mujoco = None

# surface class -> (builtin pattern, repeat range)
_SURFACES = {
    "floor": ("checker", (6, 14)),
    "wall": ("gradient", (1, 3)),
    "counter": ("checker", (10, 24)),
    "cabinet": ("gradient", (1, 4)),
}


def _jitter(rng, rgb, amt=0.12):
    c = np.asarray(rgb[:3], dtype=float)
    c = np.clip(c + rng.uniform(-amt, amt, size=3), 0.02, 0.98)
    return [float(x) for x in c]


def draw_texture_params(rng, style):
    """One dict of per-surface texture parameters, drawn from the env
    RNG (reference texture_swap.py replace_*_texture choose random
    files; here colors/repeats are the random payload)."""
    params = {}
    for surf, (builtin, rep_range) in _SURFACES.items():
        base = style[surf if surf in style else "cabinet"]
        shade = rng.uniform(0.55, 0.85)
        params[surf] = dict(
            builtin=builtin,
            rgb1=_jitter(rng, base),
            rgb2=[float(x * shade) for x in _jitter(rng, base)],
            repeat=int(rng.integers(rep_range[0], rep_range[1] + 1)),
        )
    return params


_BUILTINS = {
    "checker": lambda: mujoco.mjtBuiltin.mjBUILTIN_CHECKER,
    "gradient": lambda: mujoco.mjtBuiltin.mjBUILTIN_GRADIENT,
    "flat": lambda: mujoco.mjtBuiltin.mjBUILTIN_FLAT,
}


def apply_generative_textures(spec, fixtures, params):
    """Create one texture+material per surface class and assign them to
    the matching fixture geoms in ``spec``.

    Surface classing mirrors reference texture_swap.py:
    - floor   -> Floor fixture geoms
    - wall    -> Wall fixture geoms
    - counter -> Counter top/body geoms
    - cabinet -> cabinet/drawer shells and door panels
    """
    from lipvq_tpu_torch.robocasa.sim.fixtures import (
        Counter,
        Drawer,
        Floor,
        HingeCabinet,
        OpenCabinet,
        SingleCabinet,
        Wall,
    )

    for surf, p in params.items():
        spec.add_texture(
            name=f"gtex_{surf}",
            type=mujoco.mjtTexture.mjTEXTURE_2D,
            builtin=_BUILTINS[p["builtin"]](),
            rgb1=list(p["rgb1"]),
            rgb2=list(p["rgb2"]),
            width=128,
            height=128,
        )
        mat = spec.add_material(name=f"gmat_{surf}")
        mat.textures[mujoco.mjtTextureRole.mjTEXROLE_RGB] = f"gtex_{surf}"
        mat.texrepeat = [p["repeat"], p["repeat"]]

    surf_of = {}
    for fx in fixtures.values():
        if isinstance(fx, Floor):
            surf_of[fx.name] = "floor"
        elif isinstance(fx, Wall):
            surf_of[fx.name] = "wall"
        elif isinstance(fx, Counter):
            surf_of[fx.name] = "counter"
        elif isinstance(fx, (SingleCabinet, HingeCabinet, OpenCabinet, Drawer)):
            surf_of[fx.name] = "cabinet"

    n_assigned = 0
    for g in spec.geoms:
        name = g.name or ""
        owner = name.rsplit("_", 1)[0]
        # fixture geoms are named "<fixture>_<part>"; walk prefixes
        surf = None
        probe = name
        while probe:
            if probe in surf_of:
                surf = surf_of[probe]
                break
            if "_" not in probe:
                break
            probe = probe.rsplit("_", 1)[0]
        del owner
        if surf is not None:
            g.material = f"gmat_{surf}"
            n_assigned += 1
    return n_assigned
