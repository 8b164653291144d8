"""Preemption handling and asynchronous checkpoints (counterpart of
``paddle_tpu/distributed/resilience.py``: ``PreemptionGuard`` and
``CheckpointManager``; the JAX manager's wait for an elastic mesh
re-formation has no counterpart on one device).

``PreemptionGuard`` turns SIGTERM/SIGINT into a flag that a training
loop or a serving engine polls, so the in-flight work drains and the
process exits cleanly.  ``InferenceEngine.attach_preemption_guard``
hooks it into serving: once it fires, the engine stops admitting,
finishes its in-flight slots and parks the queue in ``undelivered``.
When the signal arrives the guard notes a ``preemption`` event and dumps
a ``sigterm`` flight-recorder bundle before anything drains.
"""
from __future__ import annotations

import os
import shutil
import signal
import sys
import threading
import time
from typing import Optional

from . import checkpoint

__all__ = ["PreemptionGuard", "CheckpointManager"]


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
        # the black box before the drain: the bundle exists even if the
        # drain or the checkpoint after it wedges (dump never raises)
        from ..observability import flightrec
        flightrec.note_event("preemption", signum=int(signum))
        flightrec.dump("sigterm")

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


class CheckpointManager:
    """Asynchronous, checked, keep-last-K trainer checkpoints.

    ``save(trainer, step)`` copies the training state to the host on the
    calling thread (the only part that must wait for the device) and
    commits the manifest directory ``{prefix}{step}`` on a background
    thread.  Saves are serialized: a new save first joins the previous
    one and re-raises its failure there (or hands it to ``on_error``), so
    an I/O error can delay training but never silently drop checkpoints.
    After each commit only the newest ``keep_last`` stay, and ``.tmp``
    orphans of crashed saves are removed.

    ``restore_latest(trainer)`` restores the newest checkpoint that
    validates and unpickles, falling back past corrupt or truncated
    ones.
    """

    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True, prefix: str = "ckpt-",
                 on_error=None):
        self.directory = directory
        self.keep_last = max(1, int(keep_last))
        self.async_save = bool(async_save)
        self.prefix = prefix
        self.on_error = on_error
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stuck = False   # a wait(timeout) expired on this commit
        self._saves = 0
        self._fallbacks = 0
        self._commit_failures = 0
        self.last_snapshot_ms: Optional[float] = None
        self.last_commit_ms: Optional[float] = None

    def _path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}{int(step)}")

    def save(self, trainer, step: Optional[int] = None,
             extra: Optional[dict] = None, block: bool = False) -> str:
        """Checkpoint ``trainer`` as ``{prefix}{step}`` (default: its step
        count).  Returns the final path at once; with ``async_save`` the
        commit runs in the background (``wait()`` or the next save joins
        it)."""
        self.wait()
        if step is None:
            step = getattr(trainer, "_step_count", 0)
        path = self._path_for(step)
        t0 = time.perf_counter()
        state = checkpoint.snapshot_trainer(trainer, extra=extra)
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1e3

        def commit():
            t1 = time.perf_counter()
            os.makedirs(self.directory, exist_ok=True)
            checkpoint.write_checkpoint(state, path)
            self._gc()
            self.last_commit_ms = (time.perf_counter() - t1) * 1e3

        self._saves += 1
        if self.async_save and not block:
            def run():
                try:
                    commit()
                except BaseException as e:  # surfaced by wait()
                    self._commit_failures += 1
                    self._error = e
            self._thread = threading.Thread(target=run, name="ckpt-writer",
                                            daemon=True)
            self._thread.start()
        else:
            try:
                commit()
            except BaseException:
                self._commit_failures += 1
                raise
        return path

    def wait(self, timeout: Optional[float] = None):
        """Join the background save in flight and surface its failure
        (re-raised, or passed to ``on_error``).  With ``timeout``
        (seconds) a commit stuck on dead storage raises ``TimeoutError``
        instead of hanging; later untimed waits then refuse at once."""
        t = self._thread
        if t is not None:
            if timeout is None and self._stuck and t.is_alive():
                raise TimeoutError(
                    f"previous checkpoint commit is still stuck "
                    f"(directory {self.directory!r}); refusing an "
                    f"untimed join behind dead storage")
            t.join(timeout)
            if t.is_alive():
                self._stuck = True
                raise TimeoutError(
                    f"checkpoint commit still running after {timeout}s "
                    f"(directory {self.directory!r}; slow or dead "
                    f"storage?)")
            self._stuck = False
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            if self.on_error is not None:
                self.on_error(err)
            else:
                raise err

    def _candidates(self):
        return checkpoint.checkpoint_candidates(self.directory, self.prefix)

    def _gc(self):
        """Keep the newest ``keep_last``; drop older ones and ``.tmp``
        orphans."""
        for _, path in self._candidates()[self.keep_last:]:
            try:
                shutil.rmtree(path) if os.path.isdir(path) \
                    else os.remove(path)
            except OSError:
                pass
        checkpoint.gc_stale_tmps(self.directory, self.prefix)

    def latest(self, validate: bool = True) -> Optional[str]:
        """Path of the newest valid checkpoint (no restore)."""
        self.wait()
        return checkpoint.latest_checkpoint(
            self.directory, prefix=self.prefix, validate=validate,
            gc_tmp=False)

    def restore_latest(self, trainer) -> Optional[dict]:
        """Restore the newest checkpoint that validates and unpickles,
        falling back past corrupt ones; returns its ``extra`` dict, or
        None when none is usable.  A checkpoint of another model still
        raises: that is a configuration error, not bit rot."""
        self.wait()
        for _, path in self._candidates():
            try:
                state = checkpoint.read_checkpoint(path)
            except Exception as e:
                self._fallbacks += 1
                print(f"resilience: skipping corrupt checkpoint {path} "
                      f"({type(e).__name__}: {e}); falling back",
                      file=sys.stderr, flush=True)
                continue
            return checkpoint.restore_trainer(trainer, state)
        return None

    @property
    def stats(self) -> dict:
        return {"saves": self._saves, "fallbacks": self._fallbacks,
                "commit_failures": self._commit_failures,
                "async": self.async_save, "keep_last": self.keep_last,
                "last_snapshot_ms": self.last_snapshot_ms,
                "last_commit_ms": self.last_commit_ms}
