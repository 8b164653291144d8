"""Stall watchdog and straggler detection (counterpart of
``paddle_tpu/observability/watchdog.py``).

A wedged step loop crashes nothing and logs nothing: the metrics just
stop moving.  ``Watchdog`` is a monitor thread armed by the step loops
(``SpmdTrainer`` per train step, ``InferenceEngine`` per decode tick).
The loop calls ``beat()`` (one clock read and a store) and the monitor
fires when no beat lands for ``timeout_s``:

- it captures every thread's stack, the evidence of where the process
  is stuck;
- writes a flight-recorder bundle (reason ``stall``) with the stall
  attached;
- counts it (``watchdog_stalls_total``) and, per ``on_stall``:
  ``"dump"`` (default) records and keeps watching, ``"raise"`` also
  interrupts the main thread (a ``KeyboardInterrupt`` at the stall
  site), a callable gets the stall dict.

``idle()`` parks the watchdog (an engine without work is not stalled);
the next ``beat()`` re-arms it.  A stall fires once per episode.  The
clock is injectable (``clock=``) and ``poll()`` runs one check of the
monitor's loop, so a test can drive a stall without waiting.

Armed by ``PADDLE_TPU_WATCHDOG_S=<seconds>`` (unset or 0: off) with
``PADDLE_TPU_WATCHDOG_ACTION=dump|raise``.

``detect_stragglers`` turns per-replica mean tick times into a verdict
(median, ratios, flagged replicas) against
``PADDLE_TPU_STRAGGLER_FACTOR`` (default 1.75) times the median of each
replica's peers.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

from . import flightrec as _flightrec
from . import metrics as _metrics

__all__ = ["Watchdog", "watchdog_seconds", "detect_stragglers",
           "straggler_factor"]

_STRAGGLER_FACTOR_DEFAULT = 1.75


def watchdog_seconds() -> Optional[float]:
    """The timeout armed by ``PADDLE_TPU_WATCHDOG_S``, or None (off)."""
    v = os.environ.get("PADDLE_TPU_WATCHDOG_S", "").strip()
    if not v:
        return None
    try:
        t = float(v)
    except ValueError:
        return None
    return t if t > 0 else None


class Watchdog:
    """No-progress monitor for one step or tick loop::

        wd = Watchdog(timeout_s=30, label="spmd_train").arm()
        while training:
            wd.beat()
            train_step(...)
        wd.disarm()
    """

    def __init__(self, timeout_s: float, label: str = "loop",
                 on_stall: Union[str, Callable, None] = None,
                 poll_s: Optional[float] = None,
                 dump_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got "
                             f"{timeout_s}")
        self.timeout_s = float(timeout_s)
        self.label = label
        if on_stall is None:
            on_stall = os.environ.get("PADDLE_TPU_WATCHDOG_ACTION",
                                      "dump").strip() or "dump"
        if isinstance(on_stall, str) and on_stall not in ("dump",
                                                          "raise"):
            raise ValueError(
                f"on_stall must be 'dump', 'raise' or a callable, got "
                f"{on_stall!r}")
        self.on_stall = on_stall
        # poll fast enough to see a stall within about 1.25 x timeout
        self.poll_s = poll_s if poll_s is not None \
            else max(min(self.timeout_s / 4.0, 1.0), 0.01)
        self.dump_dir = dump_dir
        self.clock = clock
        self.stalls = 0
        self.last_stall: Optional[dict] = None
        self._last_beat = clock()
        self._idle = True            # not a stall until the first beat
        self._fired = False          # one dump per stall episode
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_stalls = _metrics.counter(
            "watchdog_stalls_total", "no-progress stalls detected",
            labels=("label",)).labels(label=label)

    # ---- the loop's side ------------------------------------------------
    def beat(self):
        """The loop made progress: re-arms after ``idle()`` and closes a
        fired episode."""
        self._last_beat = self.clock()
        self._idle = False
        self._fired = False

    def idle(self):
        """No work to do: a quiet loop is not a stall."""
        self._idle = True

    # ---- lifecycle --------------------------------------------------------
    def arm(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._monitor, name=f"watchdog-{self.label}",
                daemon=True)
            self._thread.start()
        return self

    def disarm(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.poll_s + 1.0)
            self._thread = None

    @property
    def stalled(self) -> bool:
        return self._fired

    # ---- the monitor ------------------------------------------------------
    def poll(self) -> bool:
        """One check: fire if the loop is busy and its last beat is older
        than the timeout.  Returns whether this call fired."""
        if self._idle or self._fired:
            return False
        age = self.clock() - self._last_beat
        if age <= self.timeout_s:
            return False
        self._fired = True
        self._handle_stall(age)
        return True

    def _monitor(self):
        while not self._stop.wait(self.poll_s):
            self.poll()

    def _handle_stall(self, age_s: float):
        self.stalls += 1
        self._m_stalls.inc()
        stall = {"label": self.label, "age_s": round(age_s, 3),
                 "timeout_s": self.timeout_s}
        info = dict(stall, stacks=_flightrec.all_thread_stacks())
        _flightrec.note_event("watchdog_stall", **stall)
        info["bundle"] = _flightrec.dump("stall", directory=self.dump_dir,
                                         extra={"stall": stall})
        self.last_stall = info
        if callable(self.on_stall):
            try:
                self.on_stall(info)
            except Exception:       # a broken callback must not end the
                pass                # monitor thread
        elif self.on_stall == "raise":
            import _thread
            _thread.interrupt_main()


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------
def straggler_factor() -> float:
    v = os.environ.get("PADDLE_TPU_STRAGGLER_FACTOR", "").strip()
    try:
        return float(v) if v else _STRAGGLER_FACTOR_DEFAULT
    except ValueError:
        return _STRAGGLER_FACTOR_DEFAULT


def detect_stragglers(per_replica_ms: Sequence[Optional[float]],
                      factor: Optional[float] = None,
                      min_ms: float = 0.05) -> dict:
    """Per-replica step or tick time against the others'.

    ``per_replica_ms[i]`` is replica i's mean time (None: no work).  A
    replica is a straggler when its mean exceeds ``factor`` times the
    median of its peers (leave-one-out: in a two-replica fleet the
    overall median sits halfway to the straggler) and the gap exceeds
    ``min_ms``.  Returns ``{"median_ms", "factor", "per_replica_ms",
    "ratio", "stragglers": [indexes]}``; ``median_ms`` and ``ratio`` use
    the all-replica median."""
    factor = float(factor) if factor is not None else straggler_factor()
    vals = [(i, float(v)) for i, v in enumerate(per_replica_ms)
            if v is not None and v > 0]
    out = {"factor": factor,
           "per_replica_ms": [round(float(v), 3) if v is not None
                              else None for v in per_replica_ms],
           "median_ms": None, "ratio": None, "stragglers": []}
    if not vals:
        return out
    med = float(np.median([v for _, v in vals]))
    out["median_ms"] = round(med, 3)
    if med <= 0:
        return out
    valid = dict(vals)
    out["ratio"] = [round(valid[i] / med, 3) if i in valid else None
                    for i in range(len(per_replica_ms))]
    if len(vals) < 2:
        return out                  # no peers, no verdict
    for i, v in vals:
        peers = float(np.median([pv for pi, pv in vals if pi != i]))
        if peers > 0 and v > factor * peers and (v - peers) > min_ms:
            out["stragglers"].append(i)
    return out
