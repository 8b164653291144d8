"""Lazy step results and host-sync accounting (counterpart of
``paddle_tpu/distributed/async_dispatch.py``, without the metrics
registry).

PyTorch on the card runs ahead of the device for as long as nobody
reads a value back: ``float(loss)`` after every step would serialize
the host against the device.  :class:`StepResult` wraps the device
scalar a train step returns and becomes the number (one blocking
read-back, counted) only when somebody calls ``float()`` or formats
it.  The process-wide counter lets tests and ``chip_smoke.py``
show how many read-backs a window of steps made.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

__all__ = ["StepResult", "host_sync_count", "record_host_sync",
           "reset_host_sync_count"]

_lock = threading.Lock()
_SYNC_COUNT = 0


def record_host_sync(n: int = 1) -> None:
    """Count a blocking host <- device read-back (or an explicit
    barrier)."""
    global _SYNC_COUNT
    with _lock:
        _SYNC_COUNT += n


def host_sync_count() -> int:
    return _SYNC_COUNT


def reset_host_sync_count() -> int:
    """Zero the counter, returning the old value."""
    global _SYNC_COUNT
    with _lock:
        old, _SYNC_COUNT = _SYNC_COUNT, 0
    return old


class StepResult:
    """Lazy result of one training step.

    Wraps the on-device loss scalar.  Reading it (``float()``, ``item()``,
    formatting) waits for the device once, counts one host sync and
    caches the float.
    """

    __slots__ = ("_raw", "_value", "_timings")

    def __init__(self, loss: torch.Tensor, timings: Optional[dict] = None):
        self._raw = loss
        self._value: Optional[float] = None
        self._timings = timings

    @property
    def loss(self) -> torch.Tensor:
        """The underlying device tensor (no sync)."""
        return self._raw

    def item(self) -> float:
        """The loss as a float (one counted host sync on first call)."""
        if self._value is None:
            t0 = time.perf_counter()
            self._value = float(self._raw.item())
            record_host_sync()
            if self._timings is not None:
                self._timings["sync_ms"] += (time.perf_counter() - t0) * 1e3
        return self._value

    def __float__(self):
        return self.item()

    def __format__(self, spec):
        return format(self.item(), spec)

    def __repr__(self):
        if self._value is None:
            return "StepResult(<pending>)"
        return f"StepResult({self._value!r})"
