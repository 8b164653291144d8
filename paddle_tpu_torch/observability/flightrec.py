"""Flight recorder: a bounded black box for crashed, killed or stalled
runs (counterpart of ``paddle_tpu/observability/flightrec.py``).

- **Ring**: a bounded deque of the latest step and tick records (train
  steps, decode, chunk and spec ticks: kind, wall time and the counters
  the caller already holds on the host).  Recording is a small dict and
  a ``deque.append``: no device read (``PADDLE_TPU_FLIGHTREC_RING``
  entries, default 256).
- **Events**: a second bounded deque of notable instants (checkpoint
  saves and restores, anomaly rollbacks, preemptions, stalls), stamped
  on the span tracer's clock so ring, events and spans align.
- **Dump**: ``dump(reason)`` writes a post-mortem bundle atomically: a
  directory staged as ``.tmp`` and renamed into place, holding
  ``bundle.json`` (reason, ring, events, metrics snapshot, every
  thread's stack, the exec registry and HBM ledger) and ``trace.json``
  (a Chrome trace: the span buffer's tail plus the ring as spans).

The bundle format is the JAX package's (``paddle_tpu.flightrec.v1``), so
either package's ``load_bundle`` reads the other's bundles.

Dumps are written on an unhandled exception (``install()`` chains
``sys.excepthook`` and ``threading.excepthook``), on SIGTERM/SIGINT
under ``distributed.resilience.PreemptionGuard``, on an
``anomaly_policy='rollback'`` rollback and on a watchdog stall.

Knobs: ``PADDLE_TPU_FLIGHTREC=0`` disables recording and dumping;
``PADDLE_TPU_FLIGHTREC=<dir>`` or ``PADDLE_TPU_FLIGHTREC_DIR`` names the
dump directory (default ``$TMPDIR/paddle_tpu_flightrec``);
``PADDLE_TPU_FLIGHTREC_KEEP`` (default 32) bounds the bundles kept.  A
process writes at most 16 bundles.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import spans as _spans

__all__ = ["FlightRecorder", "recorder", "record", "note_event", "dump",
           "install", "enabled", "dump_dir", "load_bundle", "gc_bundles",
           "find_bundles", "all_thread_stacks", "PID_FLIGHTREC"]

# Chrome-trace pid of the ring's spans (1 host, 2 requests)
PID_FLIGHTREC = 3
FORMAT = "paddle_tpu.flightrec.v1"

_RING_DEFAULT = 256
_EVENTS_DEFAULT = 64
_SPAN_TAIL_DEFAULT = 2048
_MAX_DUMPS = 16
_KEEP_DEFAULT = 32
_TMP_ORPHAN_AGE_S = 3600.0


def enabled() -> bool:
    return os.environ.get("PADDLE_TPU_FLIGHTREC", "1") != "0"


def dump_dir() -> str:
    """Where bundles land: ``PADDLE_TPU_FLIGHTREC_DIR``, then a path in
    ``PADDLE_TPU_FLIGHTREC``, then the temporary directory."""
    d = os.environ.get("PADDLE_TPU_FLIGHTREC_DIR", "").strip()
    if d:
        return d
    env = os.environ.get("PADDLE_TPU_FLIGHTREC", "").strip()
    if env not in ("", "0", "1"):
        return env
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_flightrec")


def all_thread_stacks() -> Dict[str, List[str]]:
    """``{"thread name (id)": formatted frames}`` for every live
    thread; safe from any thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')} ({tid})"
        out[label] = traceback.format_stack(frame)
    return out


class FlightRecorder:
    """Bounded telemetry ring and post-mortem dumper.  One process-wide
    instance (``recorder()``); tests may build private ones."""

    def __init__(self, ring: Optional[int] = None,
                 events: int = _EVENTS_DEFAULT,
                 span_tail: int = _SPAN_TAIL_DEFAULT):
        if ring is None:
            try:
                ring = int(os.environ.get("PADDLE_TPU_FLIGHTREC_RING",
                                          _RING_DEFAULT))
            except ValueError:
                ring = _RING_DEFAULT
        self.ring: deque = deque(maxlen=max(int(ring), 1))
        self.events: deque = deque(maxlen=max(int(events), 1))
        self.span_tail = int(span_tail)
        self.dumps = 0
        self.last_dump_path: Optional[str] = None
        self._seq = 0
        # re-entrant: a SIGTERM handler dumps too and can land on the
        # main thread inside another dump's critical section
        self._dump_lock = threading.RLock()
        self._m_dumps = _metrics.counter(
            "flightrec_dumps_total", "post-mortem bundles written",
            labels=("reason",))

    def record(self, kind: str, dur_ms: Optional[float] = None,
               **payload):
        """One step or tick record into the ring; ``dur_ms`` lets the
        dump draw it as a span.  Payload: JSON-safe host scalars."""
        now = _spans.tracer().now_us()
        d = (dur_ms or 0.0) * 1e3
        entry = {"kind": kind, "ts_us": round(now - d, 3),
                 "dur_us": round(d, 3)}
        entry.update(payload)
        self.ring.append(entry)

    def note_event(self, kind: str, **info):
        """One notable instant into the bounded event log."""
        ev = {"kind": kind, "ts_us": round(_spans.tracer().now_us(), 3),
              "wall": time.time()}
        ev.update(info)
        self.events.append(ev)

    def bundle(self, reason: str, extra: Optional[dict] = None) -> dict:
        """The post-mortem document (JSON-safe)."""
        from . import exec_registry as _er
        doc = {
            "format": FORMAT,
            "reason": reason,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "ring": list(self.ring),
            "events": list(self.events),
            "stacks": all_thread_stacks(),
            "metrics": _metrics.snapshot(),
            "executables": _er.snapshot(),
            "hbm": _er.ledger().snapshot(),
        }
        if extra:
            doc.update(extra)
        return doc

    def chrome_trace(self) -> dict:
        """The bundle's Chrome trace: the span buffer's tail plus the
        ring as 'X' spans on the flight-recorder track, a timeline even
        when ``PADDLE_TPU_SPANS`` was never on."""
        doc = _spans.tracer().chrome_trace()
        events = doc["traceEvents"]
        meta = [e for e in events if e.get("ph") == "M"]
        tail = [e for e in events if e.get("ph") != "M"][-self.span_tail:]
        meta.append({"name": "process_name", "ph": "M",
                     "pid": PID_FLIGHTREC, "tid": 0,
                     "args": {"name": "flight recorder"}})
        ring_spans = [{
            "name": e["kind"], "ph": "X", "ts": max(e["ts_us"], 0.0),
            "dur": max(e["dur_us"], 0.0), "pid": PID_FLIGHTREC,
            "tid": 1, "cat": "flightrec",
            "args": {k: v for k, v in e.items()
                     if k not in ("kind", "ts_us", "dur_us")},
        } for e in self.ring]
        doc["traceEvents"] = meta + tail + ring_spans
        return doc

    def dump(self, reason: str, directory: Optional[str] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write one bundle directory atomically; returns its path (None
        when the recorder is off or the process's dump cap is reached).
        Never raises: a broken dump path must not hide the failure it
        records."""
        if not enabled():
            return None
        with self._dump_lock:
            if self.dumps >= _MAX_DUMPS:
                return None
            self.dumps += 1
            self._seq += 1
            seq = self._seq
        try:
            base = directory or dump_dir()
            final = os.path.join(
                base, f"flightrec-{os.getpid()}-{seq:03d}-{reason}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            for name, doc, kw in (
                    ("bundle.json", self.bundle(reason, extra=extra),
                     {"default": str}),
                    ("trace.json", self.chrome_trace(), {})):
                with open(os.path.join(tmp, name), "w") as f:
                    json.dump(doc, f, **kw)
                    f.flush()
                    os.fsync(f.fileno())
            if os.path.exists(final):
                return None
            os.rename(tmp, final)
            self.last_dump_path = final
            self._m_dumps.labels(reason=reason).inc()
            gc_bundles(base)
            print(f"flightrec: wrote post-mortem bundle {final} "
                  f"(reason={reason})", file=sys.stderr, flush=True)
            return final
        except Exception as e:
            print(f"flightrec: bundle dump failed "
                  f"({type(e).__name__}: {e})", file=sys.stderr,
                  flush=True)
            return None


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, dur_ms: Optional[float] = None, **payload):
    """Ring record on the process recorder (the entry points' one-liner;
    off under ``PADDLE_TPU_FLIGHTREC=0``)."""
    if enabled():
        _RECORDER.record(kind, dur_ms=dur_ms, **payload)


def note_event(kind: str, **info):
    if enabled():
        _RECORDER.note_event(kind, **info)


def dump(reason: str, directory: Optional[str] = None,
         extra: Optional[dict] = None) -> Optional[str]:
    return _RECORDER.dump(reason, directory=directory, extra=extra)


_INSTALLED = {"done": False}
_install_lock = threading.Lock()


def install():
    """Chain ``sys.excepthook`` and ``threading.excepthook`` so an
    unhandled exception leaves a bundle first.  Idempotent; the engine
    and trainer constructors call it.  The previous hooks still run:
    this observes, it never swallows."""
    if not enabled():
        return
    with _install_lock:
        if _INSTALLED["done"]:
            return
        _INSTALLED["done"] = True
        prev_exc = sys.excepthook

        def _hook(etype, value, tb):
            note_event("unhandled_exception", type=etype.__name__,
                       message=str(value)[:500])
            dump("exception",
                 extra={"exception": "".join(
                     traceback.format_exception(etype, value, tb))[-8000:]})
            prev_exc(etype, value, tb)

        sys.excepthook = _hook
        prev_thread = threading.excepthook

        def _thook(args):
            note_event("thread_exception",
                       type=args.exc_type.__name__,
                       thread=getattr(args.thread, "name", "?"),
                       message=str(args.exc_value)[:500])
            prev_thread(args)

        threading.excepthook = _thook


def load_bundle(path: str) -> dict:
    """Read a bundle directory back as ``{"bundle": ..., "trace":
    ...}``; raises on a malformed one."""
    with open(os.path.join(path, "bundle.json")) as f:
        bundle = json.load(f)
    with open(os.path.join(path, "trace.json")) as f:
        trace = json.load(f)
    if bundle.get("format") != FORMAT:
        raise ValueError(f"{path}: not a flightrec bundle")
    return {"bundle": bundle, "trace": trace}


def gc_bundles(directory: Optional[str] = None):
    """Prune the oldest committed bundles beyond
    ``PADDLE_TPU_FLIGHTREC_KEEP`` (by modification time) and ``.tmp``
    staging orphans older than an hour.  Never raises."""
    base = directory or dump_dir()
    try:
        keep = int(os.environ.get("PADDLE_TPU_FLIGHTREC_KEEP",
                                  _KEEP_DEFAULT))
    except ValueError:
        keep = _KEEP_DEFAULT
    keep = max(keep, 1)
    try:
        names = os.listdir(base)
    except OSError:
        return
    now = time.time()
    committed = []
    for n in names:
        if not n.startswith("flightrec-"):
            continue
        p = os.path.join(base, n)
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            continue
        if n.endswith(".tmp"):
            if now - mtime > _TMP_ORPHAN_AGE_S:
                shutil.rmtree(p, ignore_errors=True)
            continue
        committed.append((mtime, p))
    committed.sort()
    for _, p in committed[:max(len(committed) - keep, 0)]:
        shutil.rmtree(p, ignore_errors=True)


def find_bundles(directory: Optional[str] = None,
                 reason: Optional[str] = None) -> List[str]:
    """Committed bundle directories under ``directory`` (default
    ``dump_dir()``), in name order; ``.tmp`` orphans are skipped."""
    base = directory or dump_dir()
    try:
        names = sorted(os.listdir(base))
    except OSError:
        return []
    return [os.path.join(base, n) for n in names
            if n.startswith("flightrec-") and not n.endswith(".tmp")
            and (reason is None or n.endswith(f"-{reason}"))]
