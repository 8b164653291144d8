"""Process-wide compile counters (counterpart of
``paddle_tpu/utils/compile_counter.py``).

The JAX package counts XLA backend compiles and jaxpr traces through
``jax.monitoring``.  The port runs eager PyTorch, which compiles nothing
per shape; what it does build, and what a warmed serving loop or a
measured training window must not build again, is counted here:

- ``kernel_build``: one ``nvcc`` compile of a ``csrc/*.cu`` source by
  ``ops._build.build`` (a library found on disk is not a build);
- ``capture``: one ``torch.export`` capture, by ``jit.to_static`` (a new
  key of a ``StaticFunction``) or ``SpmdTrainer.export_train_step``;
- ``step_kind``: a step kind an engine or a trainer runs for the first
  time, registered by the exec registry's ``note_call`` (a new prefill
  bucket, the first decode step, a trainer's first step): the port's
  stand-in for a new executable, since its first call loads kernel
  libraries, cuBLAS handles and allocator blocks.

``compiles`` is the sum of the three; ``traces`` counts captures alone
(a trace, as a jaxpr trace is).  The counters are monotone: bracket a
region with ``snapshot()`` and subtract, or use
``assert_no_recompiles``.  Each count is mirrored into the metrics
registry (``compiles_total{kind}``).
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["note", "compile_counts", "CompileCountSnapshot", "snapshot",
           "assert_no_recompiles", "KINDS"]

KINDS = ("kernel_build", "capture", "step_kind")

_lock = threading.Lock()
_COUNTS = {k: 0 for k in KINDS}


def note(kind: str, **detail) -> None:
    """Count one compile of ``kind`` (one of ``KINDS``) and note it, with
    ``detail``, in the flight recorder's event log (compiles are rare
    after warm-up, so this is a cold path)."""
    if kind not in _COUNTS:
        raise ValueError(f"compile kind must be one of {KINDS}, got "
                         f"{kind!r}")
    with _lock:
        _COUNTS[kind] += 1
        n = sum(_COUNTS.values())
    from ..observability import flightrec as _flightrec
    from ..observability import metrics as _metrics
    _metrics.counter("compiles_total", "kernel builds, captures and new "
                     "step kinds", labels=("kind",)).labels(kind=kind).inc()
    _flightrec.note_event("compile", compile_kind=kind, n=n, **detail)


def compile_counts() -> dict:
    """Every kind's count in this process, with their sum (``compiles``)
    and the captures (``traces``)."""
    with _lock:
        out = dict(_COUNTS)
    out["compiles"] = sum(out[k] for k in KINDS)
    out["traces"] = out["capture"]
    return out


class CompileCountSnapshot:
    """``snap = snapshot(); ...; snap.new_compiles``."""

    def __init__(self):
        with _lock:
            self._c0 = dict(_COUNTS)

    def by_kind(self) -> dict:
        with _lock:
            return {k: _COUNTS[k] - self._c0[k] for k in KINDS}

    @property
    def new_compiles(self) -> int:
        return sum(self.by_kind().values())

    @property
    def new_traces(self) -> int:
        return self.by_kind()["capture"]


def snapshot() -> CompileCountSnapshot:
    return CompileCountSnapshot()


@contextlib.contextmanager
def assert_no_recompiles(what: str = "region", traces: bool = True):
    """A region that must compile nothing (a warmed decode loop, a live
    retune episode): raises AssertionError on exit if anything counted
    here happened inside (``traces=False`` lets captures through)."""
    snap = snapshot()
    yield snap
    got = snap.by_kind()
    if not traces:
        got["capture"] = 0
    if any(got.values()):
        raise AssertionError(
            f"{sum(got.values())} compile(s) inside {what} (expected 0): "
            f"{ {k: n for k, n in got.items() if n} }")
