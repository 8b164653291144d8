"""Open-loop serving load harness (counterpart of
``paddle_tpu/inference/loadgen.py``).

A closed loop (every request queued up front) measures only peak
throughput.  Real traffic is open-loop: requests arrive on their own
clock whether or not the server keeps up, and what users feel is the
time to first token at the tail, the gap between tokens, sustained
tokens/s and how many requests missed their deadline.  ``run_loadtest``
drives the engine with Poisson arrivals at ``rate_rps`` and reports
those from the engine's per-request records
(``InferenceEngine.request_stats``).

``SharedPrefixWorkload`` mints prompts of which a fraction share one
system prefix, the pattern the radix prefix cache serves; it draws the
same ``np.random.RandomState`` sequence as the JAX package's, so a seed
gives the same prompts in both.

Everything here is host-side scheduling around ``engine.step()``.  The
report carries the window's SLO verdict (``slo``, from an
``observability.SLOMonitor``) and the doctor's verdicts over the
engine's stats and the window's columns (``doctor``).  A MoE engine's
report carries the window's expert-balance columns (``moe_*``, ``ep``
= 1), from the engine's accumulator read at the window's start and by
the closing ``stats()``.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..observability import doctor as _doctor
from ..observability.slo import SLOMonitor

__all__ = ["SharedPrefixWorkload", "run_loadtest"]


class SharedPrefixWorkload:
    """Prompt generator: with probability ``shared_frac`` a prompt is
    ``system_prefix + random tail``, otherwise the tail alone.  Tail and
    generation lengths are uniform over the given (inclusive) ranges."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 shared_frac: float = 0.5, prefix_len: int = 16,
                 tail_len=(3, 12), max_new=(4, 12)):
        self._rng = np.random.RandomState(seed)
        self.vocab = int(vocab_size)
        self.shared_frac = float(shared_frac)
        self.tail_len = tail_len
        self.max_new = max_new
        self.system_prefix = self._rng.randint(
            1, self.vocab, (int(prefix_len),)).astype(np.int32)

    def sample(self):
        """Returns ``(prompt ids, max_new_tokens)``."""
        rng = self._rng
        tail = rng.randint(1, self.vocab, (rng.randint(
            self.tail_len[0], self.tail_len[1] + 1),)).astype(np.int32)
        if rng.rand() < self.shared_frac:
            prompt = np.concatenate([self.system_prefix, tail])
        else:
            prompt = tail
        return prompt, int(rng.randint(self.max_new[0],
                                       self.max_new[1] + 1))


def _pct(values, q, digits=3):
    return round(float(np.percentile(values, q)), digits) if values else None


def _moe_window(engine, st, load0, assigned0) -> dict:
    """The window's expert-balance columns (the JAX report's): assigned
    assignments, dropped rate, load per expert and max / mean skew."""
    assigned = engine._moe_assigned - assigned0
    out = {"moe_num_experts": st["moe_num_experts"], "ep": st["ep"],
           "moe_assigned_tokens": round(assigned, 1),
           "moe_dropped_rate": 0.0}
    # the stats' load per expert: counts, exact after rounding to 0.1
    if st["moe_expert_load"] is None:
        return out
    wload = np.asarray(st["moe_expert_load"], np.float64) - \
        (load0 if load0 is not None else 0.0)
    dropped = max(0.0, assigned - float(wload.sum()))
    out["moe_dropped_rate"] = round(dropped / assigned, 4) \
        if assigned > 0 else 0.0
    out["moe_expert_load"] = [round(float(v), 1) for v in wload]
    mean = float(wload.mean())
    out["moe_load_skew"] = round(float(wload.max()) / mean, 3) \
        if mean > 0 else None
    return out


def run_loadtest(engine, num_requests: int, rate_rps: float,
                 workload: Optional[SharedPrefixWorkload] = None,
                 seed: int = 0, eos_id: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 slo_monitor: Optional[SLOMonitor] = None) -> dict:
    """Open-loop Poisson load test against a warmed engine.

    Arrival times are drawn up front (exponential gaps at ``rate_rps``);
    the loop enqueues every request whose arrival time has passed, then
    runs ``engine.step_or_raise()``, or sleeps until the next arrival
    when the engine is idle.

    Returns the report: TTFT p50/p99 (from enqueue, queueing included),
    ITL p50/p99 pooled over every request's token gaps, per-request
    decode tokens/s p50, wall-clock tokens/s, offered and achieved
    request rate, slot (and paged: block) occupancy, prefix hit rate,
    preemptions and, with ``deadline_s`` on every request, the requests
    that missed it (``timed_out_requests``), the SLO verdict over the
    window's TTFTs (``slo``: ``slo_monitor``, default a fresh
    ``SLOMonitor``) and the doctor's verdicts (``doctor``).  Counters are
    scoped to this window, so an engine can be reused.
    """
    workload = workload or SharedPrefixWorkload(
        engine.model.cfg.vocab_size, seed=seed)
    t_snap = dict(engine._timings)
    moe_snap = (engine.moe_load(), engine._moe_assigned) \
        if engine._is_moe else None
    pc = engine._prefix
    pc_snap = (pc.queries, pc.hit_queries, pc.hit_blocks) \
        if pc is not None else None
    rng = np.random.RandomState(seed + 1)
    gaps = rng.exponential(1.0 / float(rate_rps), size=int(num_requests))
    arrivals = np.cumsum(gaps)
    plan = [(t,) + workload.sample() for t in arrivals]

    rids: List[int] = []
    pending = set()
    recs = {}
    # coordinated-omission correction: a request whose arrival passed
    # while the loop was inside a step is enqueued late; its user's
    # clock started at the planned arrival
    late_ms = {}

    def _collect():
        """Take finished requests' records and results out of the engine
        as they retire, so its bounded history never truncates them."""
        for r in [r for r in pending if r in engine.request_stats]:
            rec = engine.request_stats.pop(r)
            if rec["ttft_ms"] is not None:
                rec["ttft_ms"] = round(rec["ttft_ms"] + late_ms[r], 3)
            # lateness delays the first gap the user sees as well
            itl = rec["itl_gaps_ms"]
            if itl:
                itl[0] = round(itl[0] + late_ms[r], 3)
            recs[r] = rec
            engine.results.pop(r, None)
            pending.discard(r)

    t0 = time.perf_counter()
    i = 0
    while i < len(plan) or engine.has_work:
        now = time.perf_counter() - t0
        while i < len(plan) and plan[i][0] <= now:
            arrival_t, prompt, max_new = plan[i]
            rid = engine.add_request(prompt, max_new_tokens=max_new,
                                     eos_id=eos_id, deadline_s=deadline_s)
            late_ms[rid] = max(
                time.perf_counter() - t0 - arrival_t, 0.0) * 1e3
            rids.append(rid)
            pending.add(rid)
            i += 1
        if engine.has_work:
            engine.step_or_raise()
            _collect()
        elif i < len(plan):
            time.sleep(min(max(plan[i][0] - now, 0.0), 0.05))
    _collect()
    wall_s = time.perf_counter() - t0

    st = engine.stats()
    t1 = engine._timings
    steps = max(t1["decode_steps"] - t_snap["decode_steps"], 1)
    recs = [recs[r] for r in rids if r in recs]
    ttfts = [r["ttft_ms"] for r in recs if r["ttft_ms"] is not None]
    dtps = [r["decode_tokens_per_sec"] for r in recs
            if r["decode_tokens_per_sec"]]
    itl = [g for r in recs for g in r["itl_gaps_ms"]]
    total_tokens = sum(r["tokens"] for r in recs)
    report = {
        "num_requests": len(recs),
        "offered_rps": round(float(rate_rps), 3),
        "achieved_rps": round(len(recs) / wall_s, 3) if wall_s else None,
        "wall_s": round(wall_s, 3),
        "tokens_generated": total_tokens,
        "tokens_per_sec": round(total_tokens / wall_s, 2)
        if wall_s else None,
        "ttft_ms_p50": _pct(ttfts, 50),
        "ttft_ms_p99": _pct(ttfts, 99),
        "itl_ms_p50": _pct(itl, 50),
        "itl_ms_p99": _pct(itl, 99),
        "decode_tokens_per_sec_p50": _pct(dtps, 50, 2),
        "slot_occupancy": round(
            (t1["occupancy_sum"] - t_snap["occupancy_sum"]) / steps, 4),
        "preemptions": t1["preemptions"] - t_snap["preemptions"],
        "deadline_s": deadline_s,
        "timed_out_requests": sum(1 for r in recs if r["timed_out"]),
        "kv_layout": st["kv_layout"],
    }
    # the SLO verdict over this window's corrected TTFTs: reported,
    # never asserted
    mon = slo_monitor or SLOMonitor()
    for t in ttfts:
        mon.observe(t)
    report["slo"] = mon.check()
    for k in ("kv_block_size", "kv_blocks_total"):
        if k in st:
            report[k] = st[k]
    if engine.kv_layout == "paged":
        report["block_occupancy"] = round(
            (t1["block_occupancy_sum"] - t_snap["block_occupancy_sum"])
            / steps, 4)
    if pc_snap is not None:
        dq = pc.queries - pc_snap[0]
        dh = pc.hit_queries - pc_snap[1]
        report["prefix_queries"] = dq
        report["prefix_hit_rate"] = round(dh / dq, 4) if dq else 0.0
        report["prefix_hit_blocks"] = pc.hit_blocks - pc_snap[2]
    if moe_snap is not None:
        report.update(_moe_window(engine, st, *moe_snap))
    # the doctor over the engine's steady signals with this window's
    # columns on top
    merged = {k: v for k, v in st.items()
              if k not in ("per_request", "doctor")}
    merged.update(report)
    report["doctor"] = _doctor.diagnose(merged, kind="serve")
    return report
