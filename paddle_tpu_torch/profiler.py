"""Profiler: trace annotations, capture control, per-step timing
(counterpart of ``paddle_tpu/profiler.py``).

What the framework owns on top of the CUDA timeline that CUPTI records:
(1) host-side annotations that nest inside the device trace
(``RecordEvent`` over ``torch.profiler.record_function``; while the span
tracer is armed the same pair also lands in its buffer), (2) capture
control writing a Chrome trace that holds the device kernels
(``start_profiler``/``stop_profiler``/``profiler`` over
``torch.profiler.profile`` with CPU and, on the card, CUDA activities),
and (3) wall-clock step statistics (``StepTimer``).

The JAX package's ``memory_stats`` and ``cost_stats`` are left out: they
read XLA's analyses of a compiled executable, and the port runs eager
PyTorch and hand-written kernels, with no executable to analyse.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import time
from typing import Optional

from .observability import spans as _spans

__all__ = ["RecordEvent", "record_event", "profiler", "start_profiler",
           "stop_profiler", "StepTimer", "default_log_dir"]

# the one live capture: (torch.profiler.profile, log_dir)
_ACTIVE = {"prof": None, "log_dir": None}
_SEQ = itertools.count()


def default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_profile")


class RecordEvent:
    """Host-side trace annotation, as a context manager or decorator:
    a ``record_function`` range in any live ``torch.profiler`` capture
    and, while the span tracer is armed, a span in its buffer."""

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name = name
        self.args = args
        self._rf = None
        self._t0_us = 0.0

    def __enter__(self):
        from torch.profiler import record_function
        self._rf = record_function(self.name)
        self._rf.__enter__()
        tr = _spans.tracer()
        if tr.active:
            self._t0_us = tr.now_us()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._rf = None
        tr = _spans.tracer()
        if tr.active:
            now = tr.now_us()
            tr.complete(self.name, self._t0_us, now - self._t0_us,
                        cat="record_event", args=self.args)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)
        return wrapped


record_event = RecordEvent


def start_profiler(log_dir: Optional[str] = None,
                   tracer_option: Optional[str] = None) -> str:
    """Begin a capture (CPU activity, and CUDA activity when a card is
    present) whose Chrome trace ``stop_profiler`` writes under
    ``log_dir``.  One capture at a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _ACTIVE["prof"] is not None:
        raise RuntimeError("profiler already started")
    log_dir = log_dir or default_log_dir()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _ACTIVE.update(prof=prof, log_dir=log_dir)
    _spans._CAPTURE["live"] = True
    return log_dir


def stop_profiler(sorted_key=None, profile_path: Optional[str] = None
                  ) -> Optional[str]:
    """End the capture and write its Chrome trace (``profile_path``, or
    ``<log_dir>/trace_<pid>_<n>.json``); returns the file's path, None
    when no capture was live."""
    prof, log_dir = _ACTIVE["prof"], _ACTIVE["log_dir"]
    if prof is None:
        return None
    _spans._CAPTURE["live"] = False
    _ACTIVE.update(prof=None, log_dir=None)
    prof.stop()
    path = profile_path or os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_SEQ)}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler(log_dir: Optional[str] = None, state=None,
             tracer_option=None, profile_path=None):
    """Capture the body of the ``with`` block."""
    start_profiler(log_dir, tracer_option)
    try:
        yield
    finally:
        stop_profiler(profile_path=profile_path)


class StepTimer:
    """Wall-clock step statistics: ``tick()`` after each step; read
    ``last_ms``, ``mean_ms``, ``p50_ms`` (the first ``warmup`` steps are
    not kept)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times_ms = []
        self._t0 = None
        self._seen = 0

    def start(self):
        self._t0 = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._t0 is not None:
            self._seen += 1
            if self._seen > self.warmup:
                self.times_ms.append((now - self._t0) * 1e3)
        self._t0 = now

    @property
    def last_ms(self):
        return self.times_ms[-1] if self.times_ms else None

    @property
    def mean_ms(self):
        return sum(self.times_ms) / len(self.times_ms) \
            if self.times_ms else None

    @property
    def p50_ms(self):
        if not self.times_ms:
            return None
        s = sorted(self.times_ms)
        return s[len(s) // 2]

    def summary(self):
        return {"steps": len(self.times_ms), "mean_ms": self.mean_ms,
                "p50_ms": self.p50_ms, "last_ms": self.last_ms}
