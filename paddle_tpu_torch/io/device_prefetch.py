"""DevicePrefetcher: overlap host -> device transfer with compute
(counterpart of ``paddle_tpu/io/device_prefetch.py``).

A background thread turns each host batch (numpy arrays or CPU
tensors) into pinned host tensors and copies them to the card on a
side CUDA stream, ``depth`` batches ahead of the consumer, recording an
event after each batch's copies.  The consumer's stream waits on that
event (a device-side wait: the host does not block) and the tensors are
marked as used on the consumer's stream, so the allocator does not
reuse their memory while the step still reads them.  On the CPU the
batches are only converted to tensors.

Timings: the consumer adds ``data_wait_ms`` (blocked on the queue) and
each batch's ``h2d_ms`` (the thread's host time pinning and enqueuing
its copies) to ``timings`` when it takes the batch, so only the
consuming thread writes the dict; with the span tracer armed each wait
is also a ``data_wait`` span.  Worker exceptions surface on the
consumer at the failed batch; ``close()`` (also on early loop exit)
stops and joins the thread.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..observability import spans as _spans

__all__ = ["DevicePrefetcher"]

_BATCH, _ERROR, _END = 0, 1, 2


def _host_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


class DevicePrefetcher:
    """Iterate device batches (tuples of tensors), transferred ``depth``
    ahead.

    Parameters
    ----------
    host_iter : iterable of host batches (tuples of numpy arrays / CPU
        tensors).
    device : target device (default: the CUDA device).
    depth : batches in flight ahead of the consumer.
    timings : optional dict accumulating ``data_wait_ms`` / ``h2d_ms``
        (e.g. ``SpmdTrainer._timings``).
    """

    def __init__(self, host_iter: Iterable, device=None, depth: int = 2,
                 timings: Optional[dict] = None):
        self._iter = iter(host_iter)
        self.device = resolve_device(device)
        self._depth = max(1, int(depth))
        self._timings = timings if timings is not None else {}
        self._timings.setdefault("data_wait_ms", 0.0)
        self._timings.setdefault("h2d_ms", 0.0)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer --------------------------------------------------------
    def _transfer(self, batch):
        host = tuple(_host_tensor(x) for x in batch)
        if self._stream is None:
            return tuple(t.to(self.device) for t in host), None
        with torch.cuda.stream(self._stream):
            dev = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in host)
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _post(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                try:
                    batch = next(self._iter)
                except StopIteration:
                    break
                t0 = time.perf_counter()
                dev, done = self._transfer(batch)
                h2d = (time.perf_counter() - t0) * 1e3
                if not self._post((_BATCH, (dev, done, h2d))):
                    return
        except BaseException as e:  # surfaces on the consumer
            self._post((_ERROR, e))
            return
        self._post((_END, None))

    def _ensure_started(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="device-prefetch", daemon=True)
            self._thread.start()

    # -- consumer --------------------------------------------------------
    def __iter__(self):
        self._ensure_started()
        try:
            while True:
                t0 = time.perf_counter()
                kind, payload = self._q.get()
                dt = (time.perf_counter() - t0) * 1e3
                self._timings["data_wait_ms"] += dt
                tr = _spans.tracer()
                if tr.active:
                    now = tr.now_us()
                    tr.complete("data_wait", now - dt * 1e3, dt * 1e3,
                                cat="train")
                if kind == _END:
                    return
                if kind == _ERROR:
                    raise payload
                dev, done, h2d = payload
                self._timings["h2d_ms"] += h2d
                if done is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    for t in dev:
                        t.record_stream(stream)
                yield dev
        finally:
            self.close()

    def close(self, join_timeout: float = 5.0):
        """Stop the transfer thread; safe to call repeatedly."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
