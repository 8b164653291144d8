"""Deterministic fault injection (counterpart of part of
``paddle_tpu/testing/faults.py``).

Each injector reads its ``PADDLE_FAULT_*`` variable when it is reached,
so processes the program forks (DataLoader workers) inherit the plan
through the environment, and tests can set it per case.  Counts are
1-indexed, so a fault hits the same call in every run.

PADDLE_FAULT_FS="op:nth[:count][,op2:nth2...]"
    The nth (to nth + count - 1) call of the named file-system op raises
    ``InjectedFault`` (an ``OSError``, so ``framework.fs``'s retries treat
    it as a transient storage error).  ``op`` is one of put, get,
    exists, mkdir, remove, list, open_read, open_write, run, or ``*``
    for any op (one shared count).
PADDLE_FAULT_FS_DELAY_MS="op:ms[,op2:ms2...]"
    Sleep ms milliseconds before each matching file-system op (``*``
    matches any): slow storage.  Composes with PADDLE_FAULT_FS.
PADDLE_FAULT_NAN_STEP="k"
    ``SpmdTrainer`` fills every floating gradient with NaN on train
    step k (1-indexed).  Read when the trainer is built.
PADDLE_FAULT_WORKER_KILL="w:after_n"
    DataLoader worker process w calls ``os._exit(137)`` once it has
    produced ``after_n`` batches: a crash like an OOM kill (its ring
    never closed, no traceback), which the loader's liveness polling
    must see and ``worker_restarts`` may revive.  A flight-recorder
    bundle is written first, as a real death would leave one.
PADDLE_FAULT_SIGTERM_STEP="k"
    The training process sends itself SIGTERM right after train step k
    completes (once a process): a preemption for kill-and-resume tests.
PADDLE_FAULT_CKPT_TRUNCATE="n"
    The nth ``write_checkpoint`` commit of the process writes half its
    state payload, renames the staging directory into its final name,
    writes a flight-recorder bundle and exits 137: a checkpoint killed
    mid-commit that looks committed on disk and fails its manifest
    check, which resume must walk past.
PADDLE_FAULT_HANG="step:seconds"
    The step loop sleeps ``seconds`` right after train step or decode
    tick number ``step`` (once a process), on the loop's own thread, as
    a wedged store would: the stall watchdog's no-progress hang.

The multi-device injectors of the JAX package (``mesh_shrink``,
``slice_down``, ``slice_is_down``, ``maybe_delay_dcn``) wait for the
port's meshes.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

__all__ = ["InjectedFault", "reset", "maybe_fail_fs", "maybe_delay_fs",
           "nan_poison_step", "maybe_kill_worker", "flightrec_dump",
           "maybe_sigterm", "ckpt_truncate_commit", "maybe_hang"]


class InjectedFault(IOError):
    """Raised by an armed fault point (an ``OSError``, so the file
    systems' retries treat it as a real transient error)."""


_lock = threading.Lock()
_fs_counts: dict = {}
_sigterm_fired = False
_ckpt_commits = 0
_hang_fired = False


def reset():
    """Clear the injection counts (tests call it between cases)."""
    global _sigterm_fired, _ckpt_commits, _hang_fired
    with _lock:
        _fs_counts.clear()
        _sigterm_fired = False
        _ckpt_commits = 0
        _hang_fired = False


def _parse_fs_spec(spec: str):
    """``[(op, first, last)]`` windows, 1-indexed and inclusive."""
    out = []
    for part in spec.split(","):
        bits = part.strip().split(":")
        if len(bits) < 2:
            continue
        try:
            first = int(bits[1])
            count = int(bits[2]) if len(bits) > 2 else 1
        except ValueError:
            continue
        out.append((bits[0], first, first + count - 1))
    return out


def maybe_fail_fs(op: str):
    """Fault point of a file-system op: raises ``InjectedFault`` where
    ``PADDLE_FAULT_FS`` arms this op's call number."""
    spec = os.environ.get("PADDLE_FAULT_FS")
    if not spec:
        return
    with _lock:
        for w_op, first, last in _parse_fs_spec(spec):
            if w_op != op and w_op != "*":
                continue
            # "*" windows share one count across ops
            n = _fs_counts.get(w_op, 0) + 1
            _fs_counts[w_op] = n
            if first <= n <= last:
                raise InjectedFault(
                    f"injected fs fault: op={op!r} call #{n} "
                    f"(PADDLE_FAULT_FS={spec!r})")
            return  # the first matching window owns the count


def maybe_delay_fs(op: str):
    """Delay point of a file-system op: sleeps where
    ``PADDLE_FAULT_FS_DELAY_MS`` arms this op (the op then runs)."""
    spec = os.environ.get("PADDLE_FAULT_FS_DELAY_MS")
    if not spec:
        return
    for part in spec.split(","):
        w_op, _, ms = part.strip().partition(":")
        if not ms or (w_op != op and w_op != "*"):
            continue
        try:
            delay = float(ms)
        except ValueError:
            continue
        if delay > 0:
            time.sleep(delay / 1e3)
        return


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


def maybe_sigterm(step: int):
    """Fault point on the training thread: SIGTERM to this process once
    ``step`` reaches ``PADDLE_FAULT_SIGTERM_STEP`` (once a process)."""
    global _sigterm_fired
    v = os.environ.get("PADDLE_FAULT_SIGTERM_STEP")
    if not v or _sigterm_fired:
        return
    try:
        k = int(v)
    except ValueError:
        return
    if step >= k:
        _sigterm_fired = True
        os.kill(os.getpid(), signal.SIGTERM)


def ckpt_truncate_commit() -> bool:
    """Fault point inside ``write_checkpoint``: True on exactly the armed
    nth commit of this process (the caller then commits a truncated
    payload and exits 137)."""
    global _ckpt_commits
    v = os.environ.get("PADDLE_FAULT_CKPT_TRUNCATE")
    if not v:
        return False
    try:
        nth = int(v)
    except ValueError:
        return False
    with _lock:
        _ckpt_commits += 1
        return _ckpt_commits == nth


def maybe_hang(step: int):
    """Fault point in the step and tick loops (``PADDLE_FAULT_HANG=
    "step:seconds"``): the calling thread sleeps ``seconds`` once
    ``step`` reaches the armed step (once a process)."""
    global _hang_fired
    spec = os.environ.get("PADDLE_FAULT_HANG")
    if not spec or _hang_fired:
        return
    k_s, _, secs_s = spec.partition(":")
    try:
        k, secs = int(k_s), float(secs_s)
    except ValueError:
        return
    if step >= k and secs > 0:
        _hang_fired = True
        time.sleep(secs)
