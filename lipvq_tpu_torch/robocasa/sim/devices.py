"""Teleoperation input devices for demo collection (the port's copy of
``lipvq_tpu/robocasa/sim/devices.py``; the key map, actions and controls are
the same).

Counterpart of reference robocasa scripts/collect_demos.py:481-491
(robosuite Keyboard / SpaceMouse devices). robosuite's devices need a
GUI window; this Keyboard device reads raw terminal input (termios)
so kitchen demos can be teleoperated over SSH. The SpaceMouse needs
the ``hid`` package + hardware and stays import-gated.

Key map (reference robosuite Keyboard bindings, adapted to the 12-dim
kitchen action layout):

    w/s   arm +/-x        up/down      arm +/-y (k/j fallback)
    a/d   arm -/+y        r/f          arm +/-z
    z/x   wrist yaw -/+   t/g          wrist pitch -/+
    space toggle gripper  b            toggle base mode
    8/2   base fwd/back   4/6          base left/right (base mode)
    q     end episode     .            mark success
"""

from __future__ import annotations

import select
import sys

import numpy as np


class Device:
    """Input device protocol (reference robosuite Device)."""

    def start_control(self):
        ...

    def get_action(self):
        """-> (action [12] | None, control dict)"""
        raise NotImplementedError


KEY_BINDINGS = {
    "w": (0, +1.0), "s": (0, -1.0),
    "a": (1, -1.0), "d": (1, +1.0),
    "r": (2, +1.0), "f": (2, -1.0),
    "x": (3, +1.0), "z": (3, -1.0),
    "t": (4, +1.0), "g": (4, -1.0),
    "k": (5, +1.0), "j": (5, -1.0),
    "8": (7, +1.0), "2": (7, -1.0),
    "4": (8, -1.0), "6": (8, +1.0),
    "7": (9, -1.0), "9": (9, +1.0),
    "+": (10, +1.0), "-": (10, -1.0),
}


class Keyboard(Device):
    """Raw-terminal keyboard teleop (non-blocking reads).

    ``get_action`` polls pending keystrokes and emits one 12-dim action
    per call; holding a key repeats it via terminal auto-repeat.
    """

    def __init__(self, scale: float = 1.0, stdin=None):
        self.scale = scale
        self._stdin = stdin or sys.stdin
        self._grip = -1.0
        self._base_mode = -1.0
        self._old_attrs = None
        self.done = False
        self.success = False

    # ---- terminal handling -------------------------------------------
    def start_control(self):
        import termios
        import tty

        if self._stdin.isatty():
            self._old_attrs = termios.tcgetattr(self._stdin.fileno())
            tty.setcbreak(self._stdin.fileno())
        self.done = False
        self.success = False

    def stop_control(self):
        import termios

        if self._old_attrs is not None:
            termios.tcsetattr(
                self._stdin.fileno(), termios.TCSADRAIN, self._old_attrs
            )
            self._old_attrs = None

    def _pending_keys(self):
        try:
            self._stdin.fileno()
        except Exception:
            return []  # non-tty stdin (tests drive process_key directly)
        keys = []
        while True:
            r, _, _ = select.select([self._stdin], [], [], 0)
            if not r:
                break
            keys.append(self._stdin.read(1))
        return keys

    # ---- device protocol ---------------------------------------------
    def process_key(self, key: str, action: np.ndarray):
        """Apply one keystroke to an action vector (separated from IO
        so the mapping is unit-testable)."""
        if key == " ":
            self._grip = -self._grip
        elif key == "b":
            self._base_mode = -self._base_mode
        elif key == "q":
            self.done = True
        elif key == ".":
            self.success = True
            self.done = True
        elif key in KEY_BINDINGS:
            idx, sign = KEY_BINDINGS[key]
            action[idx] += sign * self.scale
        return action

    def get_action(self):
        action = np.zeros(12, np.float32)
        for key in self._pending_keys():
            self.process_key(key, action)
        action[6] = self._grip
        action[11] = self._base_mode
        np.clip(action, -1.0, 1.0, out=action)
        ctrl = {"done": self.done, "success": self.success}
        return action, ctrl


class SpaceMouse(Device):  # pragma: no cover - hardware-gated
    """3Dconnexion SpaceMouse (reference robosuite SpaceMouse). Needs
    the ``hid`` package and the physical device."""

    def __init__(self, *args, **kwargs):
        try:
            import hid  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "SpaceMouse teleop requires the `hid` package and a "
                "connected device; use the Keyboard device instead"
            ) from e
        raise NotImplementedError(
            "SpaceMouse support requires hardware not present in this "
            "environment; Keyboard teleop covers headless collection"
        )


def make_device(name: str, **kwargs) -> Device:
    if name == "keyboard":
        return Keyboard(**kwargs)
    if name == "spacemouse":
        return SpaceMouse(**kwargs)
    raise ValueError(f"unknown device {name!r}")
