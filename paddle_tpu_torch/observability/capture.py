"""Profile capture windowed over a step range (counterpart of
``paddle_tpu/observability/capture.py``).

``PADDLE_TPU_PROFILE=start:stop[:logdir]`` arms a ``ProfileWindow``:
``SpmdTrainer`` ticks it per train step and ``InferenceEngine`` per
decode tick, so the same knob captures either, after warmup and for a
few steady steps.  The capture is a ``torch.profiler`` trace
(``profiler.start_profiler``/``stop_profiler``) holding the device
kernels by name; its Chrome trace lands under ``<logdir>/<kind>`` and
the window keeps its path in ``trace_path``.  Host spans recorded while
it is live nest inside it.  With the variable unset, ``from_env``
returns None and the entry points hold a literal None: one ``is not
None`` test per step.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

from .. import profiler as _prof

__all__ = ["ProfileWindow", "parse_profile_spec"]


def parse_profile_spec(spec: str):
    """``"start:stop[:logdir]"`` -> (start, stop, logdir).  Raises
    ``ValueError`` on non-integers or an empty or negative window, so a
    mistyped variable fails at startup."""
    parts = spec.split(":", 2)
    if len(parts) < 2:
        raise ValueError(
            f"PADDLE_TPU_PROFILE must be 'start:stop[:logdir]', "
            f"got {spec!r}")
    start, stop = int(parts[0]), int(parts[1])
    if stop <= start or start < 0:
        raise ValueError(
            f"PADDLE_TPU_PROFILE window [{start}:{stop}) is empty or "
            f"negative")
    logdir = parts[2] if len(parts) > 2 and parts[2] \
        else _prof.default_log_dir()
    return start, stop, logdir


class ProfileWindow:
    """Capture device and host activity over steps [start, stop).

    ``on_step(n)`` is called with the step or tick count before step n
    runs: the capture starts when n reaches ``start`` and stops when it
    reaches ``stop``.  One window per object."""

    def __init__(self, start: int, stop: int,
                 log_dir: Optional[str] = None, kind: str = "train"):
        self.start = int(start)
        self.stop = int(stop)
        self.log_dir = log_dir or _prof.default_log_dir()
        self.kind = kind
        self.active = False
        self.done = False
        self.trace_dir: Optional[str] = None
        self.trace_path: Optional[str] = None

    @classmethod
    def from_env(cls, kind: str = "train",
                 env: str = "PADDLE_TPU_PROFILE"
                 ) -> Optional["ProfileWindow"]:
        spec = os.environ.get(env, "").strip()
        if not spec:
            return None
        start, stop, logdir = parse_profile_spec(spec)
        return cls(start, stop, log_dir=os.path.join(logdir, kind),
                   kind=kind)

    def on_step(self, step: int):
        """Advance the window clock.  Never raises: a profiler that fails
        to start warns and disarms the window instead of ending the
        loop."""
        if self.done:
            return
        if self.active:
            if step >= self.stop:
                self._stop()
        elif step >= self.start:
            if step >= self.stop:       # the window is already behind
                self.done = True
                return
            self._start()

    def _start(self):
        try:
            self.trace_dir = _prof.start_profiler(self.log_dir)
            self.active = True
        except Exception as e:
            warnings.warn(f"PADDLE_TPU_PROFILE capture failed to start "
                          f"({type(e).__name__}: {e}); disarmed")
            self.done = True

    def _stop(self):
        try:
            self.trace_path = _prof.stop_profiler()
        except Exception as e:
            warnings.warn(f"PADDLE_TPU_PROFILE capture failed to stop "
                          f"({type(e).__name__}: {e})")
        self.active = False
        self.done = True

    def close(self):
        """Stop an open capture (drain and teardown)."""
        if self.active:
            self._stop()
