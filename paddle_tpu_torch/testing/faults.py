"""Deterministic fault injection (counterpart of part of
``paddle_tpu/testing/faults.py``).

Each injector reads its ``PADDLE_FAULT_*`` variable when it is reached,
so processes the program forks (DataLoader workers) inherit the plan
through the environment, and tests can set it per case.  Counts are
1-indexed, so a fault hits the same call in every run.

PADDLE_FAULT_NAN_STEP="k"
    ``SpmdTrainer`` fills every floating gradient with NaN on train
    step k (1-indexed).  Read when the trainer is built.
PADDLE_FAULT_WORKER_KILL="w:after_n"
    DataLoader worker process w calls ``os._exit(137)`` once it has
    produced ``after_n`` batches: a crash like an OOM kill (its ring
    never closed, no traceback), which the loader's liveness polling
    must see and ``worker_restarts`` may revive.  A flight-recorder
    bundle is written first, as a real death would leave one.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = ["nan_poison_step", "maybe_kill_worker", "flightrec_dump"]


def nan_poison_step() -> Optional[int]:
    """The step (1-indexed) whose gradients ``SpmdTrainer`` poisons with
    NaN, or None when ``PADDLE_FAULT_NAN_STEP`` is unset or not an
    integer."""
    v = os.environ.get("PADDLE_FAULT_NAN_STEP")
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def flightrec_dump(reason: str, timeout_s: float = 5.0):
    """Best effort: a flight-recorder bundle before a fault point kills
    the process.  Never raises, and never waits more than ``timeout_s``:
    the dump runs on a thread of its own, because in a forked worker a
    lock the dump takes may have been held by another thread of the
    parent at the fork, and would never be released."""
    def run():
        try:
            from ..observability import flightrec
            flightrec.note_event("injected_fault", reason=reason)
            flightrec.dump(reason)
        except Exception:  # a broken dump must not change the fault
            pass

    t = threading.Thread(target=run, daemon=True, name="fault-flightrec")
    t.start()
    t.join(timeout_s)


def maybe_kill_worker(worker_id: int, batches_done: int):
    """Fault point inside a DataLoader worker process: hard exit (no
    cleanup, as an OOM kill) once the armed worker has produced
    ``after_n`` batches."""
    spec = os.environ.get("PADDLE_FAULT_WORKER_KILL")
    if not spec:
        return
    try:
        w, after_n = (int(x) for x in spec.split(":"))
    except ValueError:
        return
    if worker_id == w and batches_done >= after_n:
        flightrec_dump("worker_kill")
        os._exit(137)
