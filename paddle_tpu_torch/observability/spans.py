"""Structured host spans exported as Chrome-trace / Perfetto JSON
(counterpart of ``paddle_tpu/observability/spans.py``).

``profiler.RecordEvent`` marks the device timeline through
``torch.profiler.record_function``; this module is its host-side twin: a
process-wide bounded buffer of structured spans that exports as a
Chrome-trace document (``chrome://tracing`` and ``ui.perfetto.dev`` open
it).  The document layout, span names and categories are the JAX
package's, so one trace viewer reads both packages' files.

Tracks (Chrome-trace pid/tid):

- ``pid=1`` "host": named phase spans (the train step's h2d, dispatch,
  sync and data_wait, decode and spec ticks); ``tid`` is the thread;
- ``pid=2`` "requests": one track per request (``tid`` = request id)
  holding its lifecycle, ``queued``, ``prefill``, ``decode``, and a
  ``preempt`` instant where it was preempted.

Tracing costs nothing when off: every site guards on ``tracer().active``
(one attribute read), and recording is timestamp arithmetic and a
``list.append``: no device read, no allocation on the device.  When a
``torch.profiler`` capture started by ``profiler.start_profiler`` (a
``capture.ProfileWindow``) is live, ``span`` also enters
``torch.profiler.record_function`` so the host span nests in the device
trace; with neither active it creates nothing.

Knobs: ``PADDLE_TPU_SPANS=1`` arms the tracer at import;
``PADDLE_TPU_SPANS=<path>.json`` also names the default export path.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional


__all__ = ["SpanTracer", "tracer", "span", "export_chrome_trace",
           "validate_chrome_trace", "PID_HOST", "PID_REQUESTS"]

PID_HOST = 1
PID_REQUESTS = 2

_DEFAULT_CAPACITY = 250_000

# whether a torch.profiler capture of profiler.start_profiler is live
# (set and cleared there): spans then nest in the device trace
_CAPTURE = {"live": False}


class SpanTracer:
    """Bounded in-memory span buffer: past ``capacity`` events it counts
    drops instead of growing.  ``active`` is the hot-path gate."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.active = False
        self.capacity = int(capacity)
        self._events: List[dict] = []
        self.dropped = 0
        # one epoch for every thread; perf_counter and perf_counter_ns
        # share a clock
        self._t0_ns = time.perf_counter_ns()

    def start(self):
        self.active = True
        return self

    def stop(self):
        self.active = False
        return self

    def clear(self):
        self._events = []
        self.dropped = 0

    def __len__(self):
        return len(self._events)

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def to_us(self, perf_counter_s: float) -> float:
        """Map a ``time.perf_counter()`` float (the engine's request
        timestamps) onto the trace clock."""
        return max(perf_counter_s * 1e6 - self._t0_ns / 1e3, 0.0)

    def _push(self, ev: dict):
        if len(self._events) >= self.capacity:
            self.dropped += 1
            return
        self._events.append(ev)     # list.append is atomic under the GIL

    def complete(self, name: str, ts_us: float, dur_us: float,
                 pid: int = PID_HOST, tid: Optional[int] = None,
                 cat: str = "host", args: Optional[dict] = None):
        """One finished span (an 'X' event)."""
        ev = {"name": name, "ph": "X", "ts": round(ts_us, 3),
              "dur": round(max(dur_us, 0.0), 3), "pid": pid,
              "tid": tid if tid is not None else threading.get_ident()
              % 1_000_000, "cat": cat}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, pid: int = PID_HOST,
                tid: Optional[int] = None, cat: str = "host",
                args: Optional[dict] = None,
                ts_us: Optional[float] = None):
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": round(self.now_us() if ts_us is None else ts_us, 3),
              "pid": pid,
              "tid": tid if tid is not None else threading.get_ident()
              % 1_000_000, "cat": cat}
        if args:
            ev["args"] = args
        self._push(ev)

    def chrome_trace(self) -> dict:
        """The Chrome-trace document."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": PID_HOST, "tid": 0,
             "args": {"name": "paddle_tpu host"}},
            {"name": "process_name", "ph": "M", "pid": PID_REQUESTS,
             "tid": 0, "args": {"name": "requests"}},
        ]
        rids = sorted({ev["tid"] for ev in self._events
                       if ev["pid"] == PID_REQUESTS})
        meta += [{"name": "thread_name", "ph": "M", "pid": PID_REQUESTS,
                  "tid": rid, "args": {"name": f"request {rid}"}}
                 for rid in rids]
        return {"traceEvents": meta + list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON atomically (``framework.fs``)."""
        from ..framework.fs import open_for_write
        with open_for_write(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_TRACER = SpanTracer()
if os.environ.get("PADDLE_TPU_SPANS", "") not in ("", "0"):
    _TRACER.start()


def tracer() -> SpanTracer:
    return _TRACER


def default_export_path() -> Optional[str]:
    env = os.environ.get("PADDLE_TPU_SPANS", "")
    return env if env not in ("", "0", "1") else None


class span:
    """Context manager recording one host span while the tracer is
    active, nested in the device trace while a capture is live.  Hot
    loops guard on ``tracer().active`` and call ``complete`` with
    timestamps they already hold instead."""

    __slots__ = ("name", "cat", "args", "_t0", "_rf")

    def __init__(self, name: str, cat: str = "host",
                 args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._rf = None

    def __enter__(self):
        if _CAPTURE["live"]:
            from torch.profiler import record_function
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if _TRACER.active:
            self._t0 = _TRACER.now_us()
        return self

    def __exit__(self, *exc):
        if _TRACER.active:
            now = _TRACER.now_us()
            _TRACER.complete(self.name, self._t0, now - self._t0,
                             cat=self.cat, args=self.args)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


def export_chrome_trace(path: Optional[str] = None) -> Optional[str]:
    """Export the global tracer's buffer (default path from
    ``PADDLE_TPU_SPANS=<path>``); None when there is nowhere to write."""
    path = path or default_export_path()
    if not path:
        return None
    return _TRACER.export(path)


def validate_chrome_trace(doc) -> int:
    """Structural check of a Chrome-trace document: every event needs
    name, ph, pid and tid; 'X' events need numeric, non-negative ts and
    dur.  Returns the event count; raises ``ValueError`` on the first
    malformed event."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    for i, ev in enumerate(events):
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event {i} missing {k!r}: {ev}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("ts"), (int, float)) or \
                    not isinstance(ev.get("dur"), (int, float)):
                raise ValueError(f"event {i} has non-numeric ts/dur: {ev}")
            if ev["dur"] < 0 or ev["ts"] < 0:
                raise ValueError(f"event {i} has negative ts/dur: {ev}")
    return len(events)
