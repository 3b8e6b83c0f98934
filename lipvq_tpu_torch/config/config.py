"""Locked nested-dict configuration kernel (copy of ``lipvq_tpu/config/config.py``).

Capability parity with the reference's ``Config`` class
(reference: robomimic/config/config.py:14-321): an attribute-accessible
nested dictionary that can be *key-locked* (no new keys may be added — a
typo'd override raises instead of silently creating a key) and
*value-locked* (existing values cannot be mutated), with scoped unlock
context managers and JSON round-tripping.

The implementation here is original: a thin subclass of ``dict`` with
explicit lock flags propagated through the tree, rather than the
reference's addict fork.
"""

from __future__ import annotations

import contextlib
import copy
import json
from typing import Any


class ConfigLockError(RuntimeError):
    """Raised on illegal mutation of a locked Config."""


class Config(dict):
    """Nested attribute dict with key/value locking.

    - ``lock()`` locks both keys and values recursively.
    - ``lock_keys()`` / ``unlock_keys()`` control only key creation/deletion.
    - ``values_unlocked()`` / ``unlocked()`` are context managers for scoped
      mutation (used when applying JSON overrides, mirroring
      reference train.py:491-497 semantics: unknown keys error).
    """

    # Internal attribute names (stored on the instance __dict__, not as keys).
    _META = ("_key_locked", "_value_locked")

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "_key_locked", False)
        object.__setattr__(self, "_value_locked", False)
        super().__init__()
        if args:
            (src,) = args
            for k, v in dict(src).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    # -- wrapping ----------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    # -- mapping protocol --------------------------------------------------
    def __setitem__(self, key, value):
        if key not in self and self._key_locked:
            raise ConfigLockError(
                f"Config is key-locked; cannot create new key {key!r}"
            )
        if key in self and self._value_locked:
            raise ConfigLockError(
                f"Config is value-locked; cannot overwrite key {key!r}"
            )
        super().__setitem__(key, self._wrap(value))

    def __getitem__(self, key):
        # Auto-vivify missing keys only while keys are unlocked (addict-style
        # config authoring: cfg.algo.optim.lr = 1e-4).
        if key not in self:
            if self._key_locked:
                raise ConfigLockError(f"Config has no key {key!r} (key-locked)")
            child = Config()
            super().__setitem__(key, child)
            return child
        return super().__getitem__(key)

    def __delitem__(self, key):
        if self._key_locked:
            raise ConfigLockError(f"Config is key-locked; cannot delete {key!r}")
        super().__delitem__(key)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self[name]

    def __setattr__(self, name, value):
        if name in Config._META:
            object.__setattr__(self, name, value)
        else:
            self[name] = value

    def __delattr__(self, name):
        del self[name]

    # -- locking -----------------------------------------------------------
    def _walk(self):
        yield self
        for v in self.values():
            if isinstance(v, Config):
                yield from v._walk()
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, Config):
                        yield from item._walk()

    def lock(self):
        for node in self._walk():
            object.__setattr__(node, "_key_locked", True)
            object.__setattr__(node, "_value_locked", True)

    def unlock(self):
        for node in self._walk():
            object.__setattr__(node, "_key_locked", False)
            object.__setattr__(node, "_value_locked", False)

    def lock_keys(self):
        for node in self._walk():
            object.__setattr__(node, "_key_locked", True)

    def unlock_keys(self):
        for node in self._walk():
            object.__setattr__(node, "_key_locked", False)

    def do_not_lock_keys(self):
        """Exempt this subtree from key locking (kwargs-style sections)."""
        object.__setattr__(self, "_lock_exempt", True)

    def _is_lock_exempt(self):
        return getattr(self, "_lock_exempt", False)

    @property
    def is_locked(self):
        return self._key_locked and self._value_locked

    @contextlib.contextmanager
    def values_unlocked(self):
        """Temporarily allow value mutation; key set stays locked."""
        states = [(n, n._key_locked, n._value_locked) for n in self._walk()]
        for n, _, _ in states:
            object.__setattr__(n, "_value_locked", False)
        try:
            yield self
        finally:
            for n, kl, vl in states:
                object.__setattr__(n, "_key_locked", kl)
                object.__setattr__(n, "_value_locked", vl)

    @contextlib.contextmanager
    def unlocked(self):
        """Temporarily allow both key and value mutation."""
        states = [(n, n._key_locked, n._value_locked) for n in self._walk()]
        for n, _, _ in states:
            object.__setattr__(n, "_key_locked", False)
            object.__setattr__(n, "_value_locked", False)
        try:
            yield self
        finally:
            for n, kl, vl in states:
                object.__setattr__(n, "_key_locked", kl)
                object.__setattr__(n, "_value_locked", vl)

    # -- merging / IO ------------------------------------------------------
    def update_from(self, other: dict, strict: bool = True):
        """Recursively merge ``other`` into this config.

        With ``strict`` (the default, matching the reference's locked-key
        override semantics), a key in ``other`` that does not already exist
        here raises ``ConfigLockError``. Sections marked
        ``do_not_lock_keys`` accept arbitrary keys.
        """
        for k, v in other.items():
            if k not in self:
                if strict and not self._is_lock_exempt():
                    raise ConfigLockError(
                        f"Override contains unknown config key {k!r}"
                    )
                with self.unlocked():
                    self[k] = v
                continue
            cur = super().__getitem__(k)
            if isinstance(cur, Config) and isinstance(v, dict):
                cur.update_from(v, strict=strict)
            else:
                with self.values_unlocked():
                    self[k] = v

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = [x.to_dict() if isinstance(x, Config) else x for x in v]
            else:
                out[k] = v
        return out

    def dump(self, indent: int = 4) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, path_or_str: str) -> "Config":
        try:
            data = json.loads(path_or_str)
        except (json.JSONDecodeError, ValueError):
            with open(path_or_str) as f:
                data = json.load(f)
        return cls(data)

    def __deepcopy__(self, memo):
        new = Config()
        for k, v in self.items():
            with new.unlocked():
                new[k] = copy.deepcopy(v, memo)
        if self._key_locked or self._value_locked:
            object.__setattr__(new, "_key_locked", self._key_locked)
            object.__setattr__(new, "_value_locked", self._value_locked)
        return new

    def __reduce__(self):
        """Pickles (the spawned ranks of ``scripts/train.py`` get the config
        so) as its items and its flags, node by node."""
        return (_unpickle_config, (type(self), dict(self), self._key_locked,
                                   self._value_locked, self._is_lock_exempt()))

    def __repr__(self):
        return f"Config({super().__repr__()})"


def _unpickle_config(cls: type, items: dict, key_locked: bool, value_locked: bool,
                     lock_exempt: bool) -> Config:
    new = cls.__new__(cls)
    for k, v in items.items():
        dict.__setitem__(new, k, v)
    object.__setattr__(new, "_key_locked", key_locked)
    object.__setattr__(new, "_value_locked", value_locked)
    if lock_exempt:
        new.do_not_lock_keys()
    return new
