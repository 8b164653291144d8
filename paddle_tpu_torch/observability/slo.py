"""Fleet aggregation and a rolling SLO watch (counterpart of
``paddle_tpu/observability/slo.py``).

- :class:`FleetAggregator` scrapes engine replicas in one process
  (their finished-request records and load) into fleet-level registry
  metrics: a TTFT histogram and token and request counters per replica,
  queue-depth, block and tick-time gauges, and a straggler verdict.
- :class:`SLOMonitor` keeps a rolling window of per-request TTFTs and
  flags (a) a p99 over the target (``PADDLE_TPU_SLO_TTFT_P99_MS``) and
  (b) a regression against the best measured row of the bench history
  (``BENCH_rows.jsonl``, or ``BENCH_ROWS_FILE``).

Everything here reads host-side dicts: no device state, no sync.  The
router that places requests across replicas comes with the fleet.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import metrics

__all__ = ["FleetAggregator", "SLOMonitor", "load_bench_baseline"]


class FleetAggregator:
    """Pull each replica's request records into fleet registry metrics.

    ``scrape()`` consumes NEW finished-request records since the last
    scrape (tracked by rid — records themselves stay in the engine's
    bounded history for the load harness) and refreshes per-replica
    load gauges.  Optionally feeds an :class:`SLOMonitor`."""

    def __init__(self, replicas: Sequence, monitor:
                 Optional["SLOMonitor"] = None):
        self.replicas = list(replicas)
        self.monitor = monitor
        self._seen: List[set] = [set() for _ in self.replicas]
        self._m_ttft = metrics.histogram(
            "fleet_ttft_ms", "per-request time to first token",
            labels=("replica",))
        self._m_tokens = metrics.counter(
            "fleet_tokens_total", "generated tokens", labels=("replica",))
        self._m_requests = metrics.counter(
            "fleet_requests_total", "finished requests",
            labels=("replica", "outcome"))
        self._m_queue = metrics.gauge(
            "fleet_queue_depth", "queued + active requests",
            labels=("replica",))
        self._m_blocks = metrics.gauge(
            "fleet_kv_blocks_in_use", "paged KV blocks in use",
            labels=("replica",))
        self._m_tick_ms = metrics.gauge(
            "fleet_tick_ms", "mean decode-tick wall time per replica",
            labels=("replica",))

    def _tick_ms(self) -> List[Optional[float]]:
        """Per-replica mean decode-tick wall time (engine lifetime);
        None for replicas without timing surfaces or with no ticks."""
        out: List[Optional[float]] = []
        for r in self.replicas:
            t = getattr(r, "_timings", None)
            if not isinstance(t, dict) or not t.get("decode_steps") \
                    or not isinstance(t.get("decode_ms"), (int, float)):
                out.append(None)
                continue
            out.append(t["decode_ms"] / t["decode_steps"])
        return out

    def stragglers(self) -> dict:
        """Tick-time skew vs the fleet median (watchdog.
        detect_stragglers over the replicas' live timing surfaces)."""
        from .watchdog import detect_stragglers
        return detect_stragglers(self._tick_ms())

    def scrape(self) -> dict:
        """One aggregation pass; returns {"new_requests": n,
        "straggler": <detect_stragglers verdict>}."""
        new = 0
        for i, r in enumerate(self.replicas):
            lbl = str(i)
            # a replica that caches its stats refreshes them first
            refresh = getattr(r, "refresh_stats", None)
            if callable(refresh):
                refresh()
            seen = self._seen[i]
            for rid, rec in list(r.request_stats.items()):
                if rid in seen:
                    continue
                seen.add(rid)
                new += 1
                ttft = rec.get("ttft_ms")
                if ttft is not None:
                    self._m_ttft.labels(replica=lbl).observe(ttft)
                    if self.monitor is not None:
                        self.monitor.observe(ttft)
                self._m_tokens.labels(replica=lbl).inc(
                    rec.get("tokens", 0))
                outcome = "timed_out" if rec.get("timed_out") else "ok"
                self._m_requests.labels(replica=lbl,
                                        outcome=outcome).inc()
            # bound the seen-set like the engine bounds request_stats
            if len(seen) > 2 * getattr(r, "_request_stats_cap", 4096):
                live = set(r.request_stats)
                self._seen[i] = seen & live
            q = len(getattr(r, "_queue", ())) + r.num_active
            self._m_queue.labels(replica=lbl).set(q)
            blocks = getattr(r, "blocks_in_use", None)
            if blocks is not None:
                self._m_blocks.labels(replica=lbl).set(blocks)
        tick_ms = self._tick_ms()
        for i, ms in enumerate(tick_ms):
            if ms is not None:
                self._m_tick_ms.labels(replica=str(i)).set(ms)
        from .watchdog import detect_stragglers
        return {"new_requests": new,
                "straggler": detect_stragglers(tick_ms)}


def load_bench_baseline(rows_path: Optional[str] = None,
                        kind: str = "loadtest",
                        field: str = "ttft_ms_p99") -> Optional[float]:
    """Best (lowest) measured `field` among non-smoke `kind` rows in the
    bench history file (default: BENCH_rows.jsonl next to bench.py —
    i.e. the repo root).  None when no usable row exists."""
    if rows_path is None:
        rows_path = os.environ.get("BENCH_ROWS_FILE", "").strip() or \
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
                "BENCH_rows.jsonl")
    best = None
    # a missing, empty, unreadable, or CORRUPT history file all mean
    # the same thing: no baseline.  Binary garbage raises
    # UnicodeDecodeError during line iteration (not json.loads), and a
    # monitor constructed inside a serving loop must never die on it.
    try:
        with open(rows_path, errors="replace") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict) or rec.get("kind") != kind:
                    continue
                if "smoke" in str(rec.get("metric", "")):
                    continue            # smoke rows are not a perf record
                v = rec.get(field)
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool) and v > 0:
                    best = v if best is None else min(best, v)
    except (OSError, ValueError):
        return None
    return best


class SLOMonitor:
    """Rolling TTFT watch: threshold breaches + bench-history regression.

    observe() per finished request (FleetAggregator feeds it); check()
    computes the window p50/p99 and returns breach flags.  Cheap enough
    to call every scrape — percentiles over a bounded deque."""

    def __init__(self, ttft_p99_ms: Optional[float] = None,
                 window: int = 512,
                 regression_factor: float = 2.0,
                 baseline_ttft_p99_ms: Optional[float] = None,
                 rows_path: Optional[str] = None):
        env = os.environ.get("PADDLE_TPU_SLO_TTFT_P99_MS", "").strip()
        if ttft_p99_ms is None and env:
            ttft_p99_ms = float(env)
        self.ttft_p99_ms = ttft_p99_ms
        self.regression_factor = float(regression_factor)
        if baseline_ttft_p99_ms is None:
            baseline_ttft_p99_ms = load_bench_baseline(rows_path)
        self.baseline_ttft_p99_ms = baseline_ttft_p99_ms
        self._window: deque = deque(maxlen=int(window))
        self.breaches = 0
        self.regressions = 0
        # verdict listeners: every check() verdict is pushed to them; a
        # listener's exception must never take the serving loop down
        self._listeners: List = []
        self._g_p99 = metrics.gauge("slo_ttft_ms_p99",
                                    "rolling-window TTFT p99")
        self._g_p50 = metrics.gauge("slo_ttft_ms_p50",
                                    "rolling-window TTFT p50")
        self._c_breach = metrics.counter(
            "slo_breaches_total", "rolling p99 over target",
            labels=("kind",))

    def observe(self, ttft_ms: float):
        self._window.append(float(ttft_ms))

    def check(self) -> dict:
        """Evaluate the window; returns the verdict dict and updates the
        registry gauges/counters."""
        out: Dict[str, object] = {
            "window": len(self._window),
            "ttft_p99_target_ms": self.ttft_p99_ms,
            "baseline_ttft_p99_ms": self.baseline_ttft_p99_ms,
            "p50_ms": None, "p99_ms": None,
            "breached": False, "regressed": False,
        }
        if not self._window:
            return out
        p50, p99 = np.percentile(list(self._window), [50, 99])
        out["p50_ms"] = round(float(p50), 3)
        out["p99_ms"] = round(float(p99), 3)
        self._g_p50.set(float(p50))
        self._g_p99.set(float(p99))
        if self.ttft_p99_ms is not None and p99 > self.ttft_p99_ms:
            out["breached"] = True
            self.breaches += 1
            self._c_breach.labels(kind="threshold").inc()
        if self.baseline_ttft_p99_ms is not None and \
                p99 > self.baseline_ttft_p99_ms * self.regression_factor:
            out["regressed"] = True
            self.regressions += 1
            self._c_breach.labels(kind="regression").inc()
        for cb in self._listeners:
            try:
                cb(out)
            except Exception:
                pass
        return out

    def add_listener(self, cb) -> "SLOMonitor":
        """Subscribe ``cb(verdict_dict)`` to every check() result.
        Returns self for chaining."""
        self._listeners.append(cb)
        return self
