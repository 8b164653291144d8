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

The fleet half: ``MultiTenantWorkload`` (tenants with their own system
prefixes, Zipf-weighted; the JAX workload's draws for a seed),
``warm_fleet`` and ``run_fleet_loadtest``, the open-loop test of a
``Router`` over replicas, each replica driven by a thread of its own.
Replicas in one process share the card's one queue of work (the
current stream), and their launching threads share the interpreter
lock, so one replica's step can wait for another's queued prefill: the
fleet's TTFT and ITL include that.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from ..observability import doctor as _doctor
from ..observability import metrics as _metrics
from ..observability.slo import SLOMonitor
from ..observability.watchdog import detect_stragglers

__all__ = ["SharedPrefixWorkload", "MultiTenantWorkload", "run_loadtest",
           "run_fleet_loadtest", "warm_fleet"]


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


class MultiTenantWorkload:
    """Skewed multi-tenant traffic: ``num_tenants`` tenants, each with its
    own system prefix, arriving with weights ``1 / rank^skew``: a few hot
    tenants dominate, a long tail of cold ones trickles.  A prefix-aware
    router turns N replicas into N sharded caches on this traffic.  Draws
    the same ``RandomState`` sequence as the JAX package's workload."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 num_tenants: int = 8, skew: float = 1.2,
                 prefix_len: int = 16, tail_len=(3, 12), max_new=(4, 12)):
        self._rng = np.random.RandomState(seed)
        self.vocab = int(vocab_size)
        self.tail_len = tail_len
        self.max_new = max_new
        self.prefixes = [
            self._rng.randint(1, self.vocab,
                              (int(prefix_len),)).astype(np.int32)
            for _ in range(int(num_tenants))]
        w = 1.0 / np.arange(1, num_tenants + 1) ** float(skew)
        self.weights = w / w.sum()

    def sample(self):
        """Returns ``(tenant id, prompt ids, max_new_tokens)``."""
        rng = self._rng
        tenant = int(rng.choice(len(self.prefixes), p=self.weights))
        tail = rng.randint(1, self.vocab, (rng.randint(
            self.tail_len[0], self.tail_len[1] + 1),)).astype(np.int32)
        prompt = np.concatenate([self.prefixes[tenant], tail])
        return tenant, prompt, int(rng.randint(self.max_new[0],
                                               self.max_new[1] + 1))


def warm_fleet(router, workload, passes: int = 2):
    """Steady-state warmup: every tenant's prefix through the router
    (closed loop, ``passes`` rounds), so the measured window describes the
    fleet's steady behaviour and not its first-touch misses; under a
    prefix-aware policy each tenant also settles on its home replica.
    The warmup's records and results are then dropped."""
    for _ in range(int(passes)):
        for prefix in workload.prefixes:
            router.add_request(prefix, max_new_tokens=1)
    router.run()
    for r in router.replicas:
        r.results.clear()
        r.request_stats.clear()


def _fleet_rpc(router, *args, **kw) -> dict:
    """``run_fleet_loadtest`` with every replica behind a
    ``ReplicaRPCServer`` and a fresh ``Router`` (same policy and load
    gap) over ``RPCReplicaProxy`` clients."""
    from .router import ReplicaRPCServer, Router, RPCReplicaProxy
    servers = [ReplicaRPCServer(r).start() for r in router.replicas]
    proxies = []
    try:
        proxies = [RPCReplicaProxy(s.address) for s in servers]
        rpc_router = Router(proxies, policy=router.policy,
                            max_load_gap=router.max_load_gap)
        report = run_fleet_loadtest(rpc_router, *args, **kw)
    finally:
        for p in proxies:
            p.close()
        for s in servers:
            s.stop()
    report["rpc"] = True
    return report


def run_fleet_loadtest(router, num_requests: int, rate_rps: float,
                       workload: Optional[MultiTenantWorkload] = None,
                       seed: int = 0, eos_id: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       slo_monitor: Optional[SLOMonitor] = None,
                       rpc: bool = False) -> dict:
    """Open-loop Poisson load test against a routed fleet (a ``Router``
    over warmed replicas): requests arrive on the Poisson clock, the
    router places each by its policy, and each replica steps on its own
    driver thread while it has work (a lock per replica serializes its
    step and the arrivals it takes).

    The report has ``run_loadtest``'s latency columns (TTFT and ITL with
    the arrival lateness added) and the fleet's: requests and slot
    occupancy per replica, the router hit rate and the aggregate radix
    hit rate over the window, ``accepted_tokens_per_tick`` when the
    replicas speculate, MoE balance columns when they route experts, a
    straggler verdict over the replicas' decode-tick times, the SLO
    verdict and the doctor's.  Each finished request's corrected TTFT
    goes into ``fleet_ttft_ms{replica}`` and its tokens into
    ``fleet_tokens_total{replica}``.

    ``rpc=True`` puts every replica behind the socket transport and
    re-routes the same plan through proxies: every placement, summary
    read and step crosses the wire."""
    if rpc:
        return _fleet_rpc(router, num_requests, rate_rps, workload=workload,
                          seed=seed, eos_id=eos_id, deadline_s=deadline_s,
                          slo_monitor=slo_monitor)
    replicas = router.replicas
    workload = workload or MultiTenantWorkload(
        replicas[0].model.cfg.vocab_size, seed=seed)
    t_snaps = [dict(r._timings) for r in replicas]
    pcs = [r._prefix for r in replicas]
    pc_snaps = [(pc.queries, pc.hit_queries) if pc is not None else None
                for pc in pcs]
    moe_snaps = [(r.moe_load(), r._moe_assigned)
                 if getattr(r, "_is_moe", False) else None
                 for r in replicas]
    # router counters live as long as the router (warm_fleet routes
    # through them too): this window's are differences
    rt_snap = (router.requests, router.prefix_routed, list(router.routed))
    rng = np.random.RandomState(seed + 1)
    gaps = rng.exponential(1.0 / float(rate_rps), size=int(num_requests))
    arrivals = np.cumsum(gaps)
    plan = [(t,) + workload.sample() for t in arrivals]

    pending = {}                  # (ridx, rid) -> arrival lateness ms
    order: List[tuple] = []
    recs = {}
    tenants = {}
    mon = slo_monitor or SLOMonitor()
    m_ttft = _metrics.histogram("fleet_ttft_ms",
                                "per-request time to first token",
                                labels=("replica",))
    m_tokens = _metrics.counter("fleet_tokens_total", "generated tokens",
                                labels=("replica",))
    locks = [threading.Lock() for _ in replicas]

    def _collect():
        """Take finished requests' records and results out of the
        replicas (their bounded history never truncates them)."""
        for key in [k for k in pending
                    if k[1] in replicas[k[0]].request_stats]:
            ridx, rid = key
            # single dict operations: no lock, so the arrival loop never
            # waits behind a replica's step
            rec = replicas[ridx].request_stats.pop(rid)
            replicas[ridx].results.pop(rid, None)
            late = pending.pop(key)
            if rec["ttft_ms"] is not None:
                rec["ttft_ms"] = round(rec["ttft_ms"] + late, 3)
                m_ttft.labels(replica=str(ridx)).observe(rec["ttft_ms"])
                mon.observe(rec["ttft_ms"])
            itl = rec.get("itl_gaps_ms")
            if itl:
                itl[0] = round(itl[0] + late, 3)
            m_tokens.labels(replica=str(ridx)).inc(rec.get("tokens", 0))
            rec["replica"] = ridx
            recs[key] = rec

    stop = threading.Event()
    errors: List[BaseException] = []

    def _drive(ridx):
        replica, lock = replicas[ridx], locks[ridx]
        try:
            while not stop.is_set():
                if replica.has_work:
                    with lock:
                        replica.step_or_raise()
                else:
                    time.sleep(0.001)
        except BaseException as e:   # handed to the caller's thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=_drive, args=(i,), daemon=True)
               for i in range(len(replicas))]
    for th in threads:
        th.start()
    i = 0
    try:
        while i < len(plan) or router.has_work or pending:
            if errors:
                raise errors[0]
            now = time.perf_counter() - t0
            while i < len(plan) and plan[i][0] <= now:
                arrival_t, tenant, prompt, max_new = plan[i]
                ridx = router.route(prompt)     # reads only: no lock
                with locks[ridx]:
                    rid = replicas[ridx].add_request(
                        prompt, max_new_tokens=max_new, eos_id=eos_id,
                        deadline_s=deadline_s)
                pending[(ridx, rid)] = max(
                    time.perf_counter() - t0 - arrival_t, 0.0) * 1e3
                order.append((ridx, rid))
                tenants[(ridx, rid)] = tenant
                i += 1
            _collect()
            if i < len(plan):
                time.sleep(min(max(plan[i][0] - now, 0.0), 0.005))
            else:
                time.sleep(0.001)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60.0)
    if errors:
        raise errors[0]
    _collect()
    wall_s = time.perf_counter() - t0

    recs_l = [recs[k] for k in order if k in recs]
    ttfts = [r["ttft_ms"] for r in recs_l if r["ttft_ms"] is not None]
    itl = [g for r in recs_l for g in r.get("itl_gaps_ms") or ()]
    total_tokens = sum(r["tokens"] for r in recs_l)
    occ = []
    tick_ms: List[Optional[float]] = []
    steps_total = preemptions = pq = ph = 0
    spec_committed = spec_slot_ticks = 0
    moe_assigned = moe_kept = 0.0
    for r, snap, pc, pc0, moe0 in zip(replicas, t_snaps, pcs, pc_snaps,
                                      moe_snaps):
        t1 = r._timings
        d_steps = t1["decode_steps"] - snap["decode_steps"]
        steps_total += d_steps
        occ.append(round((t1["occupancy_sum"] - snap["occupancy_sum"])
                         / max(d_steps, 1), 4))
        # the window's mean decode-tick wall time: the straggler input
        tick_ms.append((t1["decode_ms"] - snap["decode_ms"]) / d_steps
                       if d_steps > 0 else None)
        preemptions += t1["preemptions"] - snap["preemptions"]
        spec_committed += (t1["spec_tokens_committed"]
                           - snap["spec_tokens_committed"])
        spec_slot_ticks += t1["spec_slot_ticks"] - snap["spec_slot_ticks"]
        if pc0 is not None:
            pq += pc.queries - pc0[0]
            ph += pc.hit_queries - pc0[1]
        if moe0 is not None:
            load0, assigned0 = moe0
            load1 = r.moe_load()
            moe_assigned += r._moe_assigned - assigned0
            moe_kept += (float(load1.sum()) if load1 is not None else 0.0) \
                - (float(load0.sum()) if load0 is not None else 0.0)
    report = {
        "num_requests": len(recs_l),
        "num_replicas": len(replicas),
        "policy": router.policy,
        "offered_rps": round(float(rate_rps), 3),
        "achieved_rps": round(len(recs_l) / wall_s, 3) if wall_s else None,
        "wall_s": round(wall_s, 3),
        "tokens_generated": total_tokens,
        "tokens_per_sec": round(total_tokens / wall_s, 2)
        if wall_s else None,
        "ttft_ms_p50": _pct(ttfts, 50),
        "ttft_ms_p99": _pct(ttfts, 99),
        "itl_ms_p50": _pct(itl, 50),
        "itl_ms_p99": _pct(itl, 99),
        "replica_occupancy": occ,
        "requests_per_replica": [n - n0 for n, n0 in
                                 zip(router.routed, rt_snap[2])],
        "router_hit_rate": round(
            (router.prefix_routed - rt_snap[1])
            / max(router.requests - rt_snap[0], 1), 4),
        "prefix_queries": pq,
        "prefix_hit_rate": round(ph / pq, 4) if pq else 0.0,
        "preemptions": preemptions,
        "deadline_s": deadline_s,
        "timed_out_requests": sum(1 for r in recs_l if r.get("timed_out")),
        "decode_steps": steps_total,
        "tenants_seen": len(set(tenants.values())),
    }
    if spec_slot_ticks:
        report["accepted_tokens_per_tick"] = round(
            spec_committed / spec_slot_ticks, 3)
    if moe_assigned:
        report["moe_assigned_tokens"] = round(moe_assigned, 1)
        report["moe_dropped_rate"] = round(
            max(0.0, moe_assigned - moe_kept) / moe_assigned, 4)
    report["straggler"] = detect_stragglers(tick_ms)
    report["slo"] = mon.check()
    report["doctor"] = _doctor.diagnose(report, kind="serve")
    return report
