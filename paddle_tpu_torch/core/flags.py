"""Runtime flag registry (counterpart of ``paddle_tpu/core/flags.py``).

Typed, documented flags, each overridable from the environment as
``FLAGS_<name>`` when it is defined, and set from Python with
``set_flags({"FLAGS_<name>": value})``.  The port defines the flags it
reads: ``check_nan_inf``, which ``SpmdTrainer`` reads when it is built
(a trainer built with it on returns one finite flag per checked tensor
from each step and raises on the host, naming the bad ones).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict

from .errors import NotFoundError

__all__ = ["FlagRegistry", "GLOBAL_FLAGS", "set_flags", "get_flags"]


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str


class FlagRegistry:
    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.RLock()

    def define(self, name, default, help="", type=None):
        with self._lock:
            t = type if type is not None else default.__class__
            self._flags[name] = _Flag(name, default, t, help)
            env = os.environ.get("FLAGS_" + name)
            self._values[name] = self._parse(t, env) if env is not None \
                else default

    @staticmethod
    def _parse(t, s):
        if t is bool:
            return s.strip().lower() in ("1", "true", "yes", "on")
        return t(s)

    def set(self, name, value):
        with self._lock:
            if name not in self._flags:
                raise NotFoundError(f"Unknown flag {name!r}")
            f = self._flags[name]
            if isinstance(value, f.type):
                self._values[name] = value
            elif isinstance(value, str):
                # as the environment parses it: "false"/"0" turn a bool off
                self._values[name] = self._parse(f.type, value)
            else:
                self._values[name] = f.type(value)

    def get(self, name):
        with self._lock:
            if name not in self._values:
                raise NotFoundError(f"Unknown flag {name!r}")
            return self._values[name]


GLOBAL_FLAGS = FlagRegistry()
GLOBAL_FLAGS.define(
    "check_nan_inf", False,
    "SpmdTrainer checks the loss and every trainable gradient for nan/inf "
    "after each step and raises naming the bad tensors (read when the "
    "trainer is built).")


def _name(key: str) -> str:
    return key[6:] if key.startswith("FLAGS_") else key


def set_flags(flags: dict):
    """``{"FLAGS_<name>" or "<name>": value}``; an unknown name raises
    ``NotFoundError``."""
    for k, v in flags.items():
        GLOBAL_FLAGS.set(_name(k), v)


def get_flags(flags):
    """The values of one flag name or a list of them, keyed as asked."""
    if isinstance(flags, str):
        flags = [flags]
    return {k: GLOBAL_FLAGS.get(_name(k)) for k in flags}
