"""Preemption handling (counterpart of the ``PreemptionGuard`` of
``paddle_tpu/distributed/resilience.py``).

``PreemptionGuard`` turns SIGTERM/SIGINT into a flag that a training
loop or a serving engine polls, so the in-flight work drains and the
process exits cleanly.  ``InferenceEngine.attach_preemption_guard``
hooks it into serving: once it fires, the engine stops admitting,
finishes its in-flight slots and parks the queue in ``undelivered``.
The JAX package's guard also dumps its flight recorder when the signal
arrives; the port has no flight recorder yet.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Optional

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a poll-able flag.

    Usage::

        with PreemptionGuard() as guard:
            engine.attach_preemption_guard(guard)
            engine.run()             # drains once a signal arrives

    A second signal while draining falls through to the previous handler
    (default: terminate), so a stuck drain can still be killed.
    Installation does nothing off the main thread (Python restricts
    ``signal.signal`` to it): ``preempted`` then stays False.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}
        self.signum: Optional[int] = None

    def _handler(self, signum, frame):
        if self._event.is_set():
            # second delivery: restore and re-raise, so the previous
            # action runs instead of another drain
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self.signum = signum
        self._event.set()

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
