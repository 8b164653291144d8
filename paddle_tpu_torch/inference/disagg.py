"""Disaggregated prefill/decode serving, shared-pool mode (counterpart of
``paddle_tpu/inference/disagg.py``).

An engine that interleaves prefill and decode stalls every live stream
for the whole of a long prompt's prefill, so decode latency grows with
prompt length although a decode tick's work does not.  DistServe (Zhong
et al.) splits the phases: prefill workers take prompts at their own
pace, the decode engine ticks without interruption, and the KV handoff
is the only coupling.  The paged pool makes the handoff nearly free: a
prefill writes pool blocks, and handing the request to the decode engine
is handing it the block ids (refcounted, the radix cache's currency), no
KV copy.

``DisaggServingEngine(model)`` is shared-pool disaggregation: the
``PrefillWorker`` runs the engine's paged prefill over the same weights
and the same pool on the same device, under its own timing key
(``disagg``).  The scheduling boundary is real (the decode engine's
``step()`` never runs a prefill), the device boundary is not: both
halves launch on the current stream.

A ``step()``:

1. prefill phase: up to ``prefills_per_step`` queued requests run on the
   worker (radix match, block allocation, suffix prefill, trim and
   adoption into the radix tree) and park as handoff records ``(req,
   blocks, logits)``, at most ``handoff_depth`` parked at once (they hold
   pool blocks);
2. admission: free decode slots adopt parked handoffs and sample their
   first token from the handed-off logits (``InferenceEngine.
   admit_handoff``; a speculative engine's draft prefill runs here);
3. one decode tick (or spec tick).

Spec decoding, int8 and fp8 pools and MoE models come along through the
decode engine's arguments.  Disjoint device groups (``prefill_devices``,
``prefill_tp``, ``decode_tp``, ``prefill_ep``, ``decode_ep``) need device
meshes the port does not have yet and raise.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..observability import metrics as _metrics
from .engine import InferenceEngine, Request

__all__ = ["DisaggServingEngine", "PrefillWorker"]


class PrefillWorker:
    """The prefill half: the engine's paged prefill over the engine's own
    pool, allocator and radix cache, timed under ``disagg``.  The wrapper
    alternates the phases on one thread, so pool and cache state is never
    raced.  The worker runs the kernels the engine's warmup already
    loaded, so it has no warmup of its own."""

    def __init__(self, engine: InferenceEngine):
        if engine.kv_layout != "paged":
            raise ValueError(
                "disaggregated prefill needs kv_layout='paged': the KV "
                "handoff travels through the block pool")
        self.engine = engine
        self.prefills = 0

    def try_prefill(self, req: Request):
        """One request's prefill; returns the handoff record ``(req,
        blocks, logits)`` or None when the pool cannot hold it yet (it
        stays queued: head-of-line FIFO, as engine admission)."""
        rec = self.engine._paged_prefill(req, family="disagg")
        if rec is None:
            return None
        blocks, _plen, logits = rec
        self.prefills += 1
        return req, blocks, logits


class DisaggServingEngine:
    """Prefill/decode-disaggregated serving with the ``InferenceEngine``
    driving surface (``add_request``, ``step``, ``step_or_raise``,
    ``has_work``, ``run``, ``drain``, ``results``, ``stats()``), so the
    load harness and the router treat it as one more replica.  Engine
    arguments (``batch_slots``, ``kv_block_size``, ``kv_dtype``,
    ``spec_k``, ``draft_model``, ``device`` ...) go to the decode engine;
    ``kv_layout`` defaults to ``'paged'``."""

    def __init__(self, model, prefills_per_step: int = 1,
                 handoff_depth: int = 4, prefill_devices: int = 0,
                 prefill_tp: Optional[int] = None,
                 decode_tp: Optional[int] = None,
                 prefill_ep: Optional[int] = None,
                 decode_ep: Optional[int] = None, **engine_kw):
        disjoint = {"prefill_devices": prefill_devices or None,
                    "prefill_tp": prefill_tp, "decode_tp": decode_tp,
                    "prefill_ep": prefill_ep, "decode_ep": decode_ep}
        asked = {k: v for k, v in disjoint.items() if v is not None}
        if asked:
            raise NotImplementedError(
                f"{asked}: disjoint prefill/decode device groups need "
                f"device meshes, which the port does not have yet (ROADMAP "
                f"Queue 1 item 3.1); DisaggServingEngine runs shared-pool "
                f"disaggregation on one device")
        engine_kw.setdefault("kv_layout", "paged")
        self.decode = InferenceEngine(model, **engine_kw)
        self.worker = PrefillWorker(self.decode)
        self.prefills_per_step = int(prefills_per_step)
        self.handoff_depth = int(handoff_depth)
        self._queue: deque = deque()
        self._handoffs: deque = deque()
        self.handoffs_total = 0
        lbl = dict(engine=self.decode.telemetry_label)
        self._m_handoffs = _metrics.counter(
            "disagg_handoffs_total", "prefill->decode KV handoffs",
            labels=("engine",)).labels(**lbl)
        self._m_handoff_q = _metrics.gauge(
            "disagg_handoff_queue", "parked handoff records",
            labels=("engine",)).labels(**lbl)

    # ---- the decode engine's surface ----------------------------------
    @property
    def model(self):
        return self.decode.model

    @property
    def results(self) -> Dict[int, np.ndarray]:
        return self.decode.results

    @property
    def request_stats(self) -> Dict[int, dict]:
        return self.decode.request_stats

    @property
    def _timings(self) -> dict:
        return self.decode._timings

    @property
    def _prefix(self):
        return self.decode._prefix

    @property
    def _is_moe(self) -> bool:
        return self.decode._is_moe

    @property
    def _moe_assigned(self) -> float:
        return self.decode._moe_assigned

    def moe_load(self):
        """The decode engine's expert load, worker prefills included."""
        return self.decode.moe_load()

    @property
    def kv_layout(self) -> str:
        return self.decode.kv_layout

    @property
    def batch_slots(self) -> int:
        return self.decode.batch_slots

    @property
    def num_active(self) -> int:
        return self.decode.num_active

    @property
    def blocks_in_use(self) -> Optional[int]:
        return self.decode.blocks_in_use

    @property
    def telemetry_label(self) -> str:
        return self.decode.telemetry_label

    def prefix_summary(self) -> Optional[dict]:
        return self.decode.prefix_summary()

    def warmup(self, buckets: Optional[List[int]] = None):
        """The decode engine's warmup: it runs the paged prefill of each
        bucket the worker will run, the samplers and the decode step."""
        self.decode.warmup(buckets)
        return self

    def add_request(self, prompt, **kw) -> int:
        """Queue on the wrapper (the decode engine's own queue stays
        empty, so its admission never runs a prefill).  The engine's
        ``add_request`` validates, then the request is lifted out."""
        rid = self.decode.add_request(prompt, **kw)
        self._queue.append(self.decode._queue.pop())
        return rid

    # ---- the disaggregated step ---------------------------------------
    def _reclaim_preempted(self):
        """A decode-side preemption parks its victim on the decode
        engine's queue: pull it back to the front of the wrapper's, so its
        resume prefill runs on the worker."""
        if self.decode._queue:
            self._queue = deque(list(self.decode._queue) + list(self._queue))
            self.decode._queue.clear()

    def _expire_queued(self):
        now = time.perf_counter()
        for r in [r for r in self._queue
                  if r.deadline is not None and now >= r.deadline]:
            self._queue.remove(r)
            self.decode.expire_queued_request(r, now)

    def step(self) -> int:
        """Prefill phase, handoff admission, then one decode tick.
        Returns the tokens produced (first tokens included)."""
        produced = 0
        self._reclaim_preempted()
        self._expire_queued()
        done = 0
        while (self._queue and done < self.prefills_per_step
               and len(self._handoffs) < self.handoff_depth
               and self.decode._admitting):
            rec = self.worker.try_prefill(self._queue[0])
            if rec is None:
                break                     # pool full; the head waits
            self._queue.popleft()
            self._handoffs.append(rec)
            self.handoffs_total += 1
            self._m_handoffs.inc()
            done += 1
        self._m_handoff_q.set(len(self._handoffs))
        for slot in range(self.decode.batch_slots):
            if not self._handoffs or not self.decode._admitting:
                break
            if self.decode._slots[slot] is None:
                req, blocks, logits = self._handoffs.popleft()
                self.decode.admit_handoff(req, slot, blocks, logits)
                produced += 1
        return produced + self.decode.step()

    def step_or_raise(self) -> int:
        produced = self.step()
        if (produced == 0 and self.decode.num_active == 0
                and not self._handoffs and self._queue
                and self.decode._admitting):
            raise RuntimeError(
                "admission stalled: queued requests but the prefill "
                "worker cannot place them and nothing active to retire")
        return produced

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._handoffs)
                or self.decode.has_work)

    def run(self) -> Dict[int, np.ndarray]:
        while self.has_work:
            self.step_or_raise()
        return self.decode.results

    def generate(self, prompt, **kw) -> np.ndarray:
        rid = self.add_request(prompt, **kw)
        while rid not in self.decode.results:
            self.step_or_raise()
        return self.decode.results[rid]

    def _release_handoffs(self) -> List[Request]:
        """Give parked handoffs' blocks back to the pool and their
        requests to the caller (the drain path)."""
        out = []
        while self._handoffs:
            req, blocks, _ = self._handoffs.popleft()
            self.decode._alloc.decref(blocks)
            out.append(req)
        return out

    def drain(self, timeout_s: Optional[float] = None) -> List[Request]:
        """Close admission and finish the live slots (the decode engine's
        ``drain``, which checks the pool leak-free); returns the requests
        never admitted: preempted ones first, then parked handoffs, then
        the queue."""
        leftover = list(self._queue)
        self._queue.clear()
        leftover = self._release_handoffs() + leftover
        return self.decode.drain(timeout_s) + leftover

    def check_leak_free(self):
        """With no parked handoff and a drained decode engine, every pool
        block is free (after the prefix flush)."""
        if self._handoffs:
            raise AssertionError("leak check requires drained handoffs")
        self.decode.check_leak_free()

    def stats(self) -> dict:
        """The decode engine's stats plus the disaggregation counters."""
        s = self.decode.stats()
        s["disaggregated"] = True
        s["prefill_worker_prefills"] = self.worker.prefills
        s["handoffs"] = self.handoffs_total
        s["handoff_queue"] = len(self._handoffs)
        s["disjoint_groups"] = False
        return s
