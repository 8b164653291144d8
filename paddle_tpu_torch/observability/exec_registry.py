"""Step-kind registry, HBM ledger and device peak tables (counterpart of
``paddle_tpu/observability/exec_registry.py``).

- **ExecRegistry**: one entry per step kind an owner runs, keyed
  ``(component, key)``: ``component`` names the owner (``"engine:e0"``,
  ``"trainer:s1"``), ``key`` the owner's own key (``("prefill", 128)``,
  ``("decode", 0)``).  Where the JAX package registers a compiled XLA
  executable, the port registers a step kind of its eager engine or
  trainer, under the JAX package's kind names: ``prefill`` (monolithic
  and chunked), ``decode``, ``megakernel_decode``, ``spec_verify``,
  ``sample``, ``train_step``.  ``note_compile`` records the first call's
  wall time (it includes loading the kernels' libraries and the first
  cuBLAS handles), ``note_runtime`` each later call's: one dict lookup
  and two adds, no device read.
- **Peaks**: per-device peak FLOP/s and HBM bytes/s, matched on
  ``torch.cuda.get_device_name()``: the H100's data-sheet figures (dense
  bf16 989e12 FLOP/s, HBM3 3350 GB/s).  A CPU run gets the JAX
  package's nominal host figures, flagged ``peaks_nominal`` so the
  doctor does not read a roofline off them.
- **HBMLedger**: resident device bytes by owner and category (params,
  optimizer state, KV pool, draft cache, gradient-merge buffers) as
  tensor bytes (``numel() * element_size()``), each held under a weakref
  to its owner so a dead engine drops out, against the capacity that
  ``torch.cuda.get_device_properties(dev).total_memory`` reports.

Analysis: ``analyze(entry)`` (``analyze_all``, ``snapshot(analyze=
True)``) folds in the entry's cost and memory.  Where the JAX package
re-lowers the executable for XLA's ``cost_analysis`` and
``memory_analysis``, the port asks the entry's owner (an engine or a
trainer, held by weakref) for the analytic cost of that step kind from
its model config and this run's shapes (``cost_model.gpt_step_cost``:
model flops, per-op bytes, argument / output / temp bytes): the
kernels of rows 4-11 are ``ctypes`` launches that no tracer can see, so
nothing is traced.  An entry whose owner is gone, or whose owner has no
cost for its kind, stays timing-only and counts
``exec_analysis_failures_total{stage}``.  An analyzed entry's snapshot
row carries its roofline position (achieved FLOP/s and bytes/s, MFU,
arithmetic intensity against the ridge, compute- or bandwidth-bound,
fraction of its roof, its share of the gap to the 45% target), and
``profile(component)`` builds the per-kind digest the doctor's roofline
rules read (None until something is analyzed: reading stats never
analyzes).  The step time behind a row is the owner's host time per
call: a trainer's step ends when its host work does, and with no read
back in the loop the host waits on the card's queue, so a steady step's
host time is its device time.

Knobs: ``PADDLE_TPU_EXEC_REGISTRY=0`` disables registration;
``PADDLE_TPU_PEAK_FLOPS``, ``PADDLE_TPU_PEAK_HBM_GBPS`` and
``PADDLE_TPU_HBM_BYTES`` override the tables.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import compile_counter as _compile_counter
from . import metrics as _metrics

__all__ = [
    "ExecEntry", "ExecRegistry", "HBMLedger", "registry", "ledger",
    "register", "note_runtime", "analyze", "analyze_all", "profile",
    "profile_from_snapshot", "snapshot", "track_bytes", "tree_bytes",
    "enabled", "device_kind", "peak_flops", "peak_hbm_bytes_per_s",
    "device_hbm_capacity", "MFU_TARGET", "OOM_HEADROOM_MIN",
]

MFU_TARGET = 0.45
OOM_HEADROOM_MIN = 0.08    # headroom fraction below which: oom risk

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_FLOPS_BF16 = {"h100": 989e12}
PEAK_HBM_GBPS = {"h100": 3350.0}

# the JAX package's nominal host figures: a CPU run does the same
# arithmetic without claiming a device number
HOST_PEAK_FLOPS = 5e10
HOST_PEAK_HBM_GBPS = 10.0


def enabled() -> bool:
    return os.environ.get("PADDLE_TPU_EXEC_REGISTRY", "1") != "0"


def _has_card() -> bool:
    """A card this process may query: not in a process forked after its
    parent initialized CUDA (a DataLoader worker), where CUDA raises."""
    return torch.cuda.is_available() and not torch.cuda._is_in_bad_fork()


def device_kind() -> str:
    """The card's short kind ("h100"; ``utils.tuning.device_kind``, one
    copy for the tuning table and the peak tables), "" without a card."""
    if not _has_card():
        return ""
    from ..utils.tuning import device_kind as _kind
    return _kind()


def _kind_lookup(table: Dict[str, float], kind: Optional[str]
                 ) -> Optional[float]:
    kind = (kind if kind is not None else device_kind()).lower()
    for key in sorted(table, key=len, reverse=True):
        if key in kind:
            return table[key]
    return None


def peak_flops(kind: Optional[str] = None) -> Tuple[float, bool]:
    """(peak FLOP/s, nominal?); ``PADDLE_TPU_PEAK_FLOPS`` overrides."""
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    if env:
        return float(env), False
    hit = _kind_lookup(PEAK_FLOPS_BF16, kind)
    return (hit, False) if hit else (HOST_PEAK_FLOPS, True)


def peak_hbm_bytes_per_s(kind: Optional[str] = None) -> Tuple[float, bool]:
    """(peak HBM bytes/s, nominal?); ``PADDLE_TPU_PEAK_HBM_GBPS``
    overrides."""
    env = os.environ.get("PADDLE_TPU_PEAK_HBM_GBPS")
    if env:
        return float(env) * 1e9, False
    hit = _kind_lookup(PEAK_HBM_GBPS, kind)
    return (hit * 1e9, False) if hit else (HOST_PEAK_HBM_GBPS * 1e9, True)


def device_hbm_capacity() -> Optional[int]:
    """Device memory in bytes: ``PADDLE_TPU_HBM_BYTES``, else the card's
    ``total_memory``, else None (a CPU run)."""
    env = os.environ.get("PADDLE_TPU_HBM_BYTES")
    if env:
        return int(float(env))
    if not _has_card():
        return None
    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory)


def tree_bytes(obj) -> int:
    """Bytes of every tensor in a tensor, a dict, list or tuple of them,
    or a module's parameters (shape arithmetic only, no device read)."""
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    if isinstance(obj, torch.nn.Module):
        return sum(tree_bytes(p) for p in obj.parameters())
    if isinstance(obj, dict):
        return sum(tree_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tree_bytes(v) for v in obj)
    return 0


class ExecEntry:
    """One step kind's record."""

    def __init__(self, component: str, key, kind: str, name: str,
                 meta: Optional[dict] = None, owner=None):
        self.component = component
        self.key = key
        self.kind = kind
        self.name = name
        self.meta = dict(meta or {})
        self.compile_ms: Optional[float] = None
        self.calls = 0
        self.runtime_ms = 0.0
        self.analysis: Optional[dict] = None
        self.analysis_error: Optional[str] = None
        self._owner = weakref.ref(owner) if owner is not None else None

    @property
    def alive(self) -> bool:
        return self._owner is not None and self._owner() is not None


class ExecRegistry:
    """Process-wide step-kind registry (``registry()``; tests may build
    private ones)."""

    _CAP = 1024     # entries of dead owners go first

    def __init__(self):
        self._entries: Dict[Tuple[str, Any], ExecEntry] = {}
        self._lock = threading.Lock()
        self._m_registered = _metrics.counter(
            "exec_registered_total", "executables joined the registry",
            labels=("kind",))
        self._m_failures = _metrics.counter(
            "exec_analysis_failures_total",
            "executable cost/memory analyses that degraded to "
            "timing-only", labels=("stage",))

    def register(self, component: str, key, kind: str,
                 meta: Optional[dict] = None, name: Optional[str] = None,
                 owner=None) -> Optional[ExecEntry]:
        """Join one step kind (idempotent per ``(component, key)``)."""
        if not enabled():
            return None
        k = (component, key)
        e = self._entries.get(k)
        if e is not None:
            return e
        e = ExecEntry(component, key, kind, name or _default_name(key, kind),
                      meta=meta, owner=owner)
        with self._lock:
            if k not in self._entries:
                if len(self._entries) >= self._CAP:
                    self._evict_locked()
                self._entries[k] = e
        self._m_registered.labels(kind=kind).inc()
        return e

    def _evict_locked(self):
        dead = [k for k, e in self._entries.items() if not e.alive]
        for k in dead[:max(len(self._entries) - self._CAP + 1,
                           len(dead) // 2)]:
            self._entries.pop(k, None)
        while len(self._entries) >= self._CAP:    # all alive: oldest
            self._entries.pop(next(iter(self._entries)))

    def note_compile(self, component: str, key, dt_ms: float):
        e = self._entries.get((component, key))
        if e is not None and e.compile_ms is None:
            e.compile_ms = dt_ms

    def note_runtime(self, component: str, key, dt_ms: float):
        """One steady call: a dict lookup and two adds."""
        e = self._entries.get((component, key))
        if e is not None:
            e.calls += 1
            e.runtime_ms += dt_ms

    def note_call(self, component: str, key, kind: str, dt_ms: float,
                  meta: Optional[dict] = None, owner=None):
        """One call of a step kind: the first registers it with its time
        (``note_compile``), later ones add theirs (``note_runtime``)."""
        if (component, key) in self._entries:
            self.note_runtime(component, key, dt_ms)
        elif self.register(component, key, kind, meta=meta,
                           owner=owner) is not None:
            self.note_compile(component, key, dt_ms)
            _compile_counter.note("step_kind", component=component,
                                  step=kind)

    # ---- analysis (explicit, off the hot path) ------------------------
    def analyze(self, e: ExecEntry) -> bool:
        """Fold in the entry's analytic cost from its owner's
        ``_exec_cost(key, kind)``; an owner gone or without a cost for
        the kind leaves the entry timing-only (counted), never raises."""
        if e.analysis is not None:
            return True
        owner = e._owner() if e._owner is not None else None
        if owner is None:
            self._m_failures.labels(stage="owner_released").inc()
            e.analysis_error = e.analysis_error or "owner released"
            return False
        try:
            cost = owner._exec_cost(e.key, e.kind)
        except Exception as exc:
            self._m_failures.labels(stage="cost_model").inc()
            e.analysis_error = (f"cost_model: {type(exc).__name__}: "
                                f"{str(exc)[:200]}")
            return False
        if not cost:
            self._m_failures.labels(stage="cost_model").inc()
            e.analysis_error = f"cost_model: no model for {e.kind!r}"
            return False
        e.analysis = {
            "cost": {"flops": cost["flops"],
                     "bytes_accessed": cost["bytes_accessed"]},
            "memory": {k: cost[k] for k in
                       ("argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes", "peak_bytes") if k in cost}}
        e.analysis_error = None
        return True

    def analyze_all(self, component: Optional[str] = None) -> int:
        """Analyze every (matching) entry; returns how many have an
        analysis afterwards."""
        return sum(self.analyze(e) for e in self.entries(component))

    def entries(self, component: Optional[str] = None) -> List[ExecEntry]:
        with self._lock:
            es = list(self._entries.values())
        if component is not None:
            es = [e for e in es if e.component == component]
        return es

    @staticmethod
    def _entry_snapshot(e: ExecEntry, pf: float, pb: float,
                        nominal: bool) -> dict:
        mean_ms = (e.runtime_ms / e.calls) if e.calls else None
        d = {
            "component": e.component, "name": e.name, "kind": e.kind,
            "key": str(e.key), "calls": e.calls,
            "runtime_ms": round(e.runtime_ms, 3),
            "mean_ms": round(mean_ms, 4) if mean_ms is not None else None,
            "compile_ms": round(e.compile_ms, 2)
            if e.compile_ms is not None else None,
            "analyzed": e.analysis is not None,
            "flops": None, "bytes_accessed": None,
            "peaks_nominal": nominal,
        }
        if e.meta:
            d["meta"] = dict(e.meta)
        if e.analysis_error:
            d["analysis_error"] = e.analysis_error
        if e.analysis is None:
            return d
        cost, mem = e.analysis["cost"], e.analysis["memory"]
        d["flops"] = cost.get("flops")
        d["bytes_accessed"] = cost.get("bytes_accessed")
        d.update({k: int(v) for k, v in mem.items()})
        flops = d["flops"] or 0.0
        nbytes = d["bytes_accessed"] or 0.0
        if mean_ms and mean_ms > 0:
            sec = mean_ms / 1e3
            if flops:
                d["achieved_flops_per_s"] = round(flops / sec, 1)
                d["mfu"] = round(flops / sec / pf, 6)
            if nbytes:
                d["achieved_hbm_gbps"] = round(nbytes / sec / 1e9, 3)
                d["hbm_bw_frac"] = round(nbytes / sec / pb, 6)
        if flops and nbytes:
            ai = flops / nbytes
            ridge = pf / pb
            d["arithmetic_intensity"] = round(ai, 3)
            d["ridge_ai"] = round(ridge, 3)
            d["bound"] = "compute" if ai >= ridge else "bandwidth"
            if mean_ms and mean_ms > 0:
                # the roof this step kind can reach at its intensity
                d["roof_frac"] = round(
                    flops / (mean_ms / 1e3) / min(pf, ai * pb), 6)
        return d

    def snapshot(self, component: Optional[str] = None,
                 analyze: bool = False) -> dict:
        """JSON-safe snapshot: per-entry records sorted by runtime, each
        with its share of the total and, once analyzed, its roofline
        position and its share of the gap to the MFU target; the
        device's peaks.  ``analyze=True`` analyzes the entries first."""
        if analyze:
            self.analyze_all(component)
        kind = device_kind()
        pf, f_nom = peak_flops(kind)
        pb, b_nom = peak_hbm_bytes_per_s(kind)
        nominal = f_nom or b_nom
        rows = [self._entry_snapshot(e, pf, pb, nominal)
                for e in self.entries(component)]
        rows.sort(key=lambda r: -(r["runtime_ms"] or 0.0))
        total_rt = sum(r["runtime_ms"] for r in rows) or 0.0
        total_flops = 0.0
        for r in rows:
            if total_rt > 0:
                r["time_share"] = round(r["runtime_ms"] / total_rt, 4)
                mfu = r.get("mfu")
                if mfu is not None:
                    r["mfu_weighted"] = round(r["time_share"] * mfu, 6)
                    r["gap_share"] = round(
                        r["time_share"] *
                        max(MFU_TARGET - mfu, 0.0) / MFU_TARGET, 4)
                    total_flops += (r.get("flops") or 0.0) * r["calls"]
        overall_mfu = (total_flops / (total_rt / 1e3) / pf) \
            if total_rt > 0 and total_flops else None
        out = {
            "device_kind": kind or "host",
            "peak_flops": pf,
            "peak_hbm_gbps": round(pb / 1e9, 1),
            "peaks_nominal": nominal,
            "mfu_target": MFU_TARGET,
            "executables": rows,
            "overall": {"runtime_ms": round(total_rt, 3),
                        "analyzed": sum(1 for r in rows if r["analyzed"]),
                        "registered": len(rows),
                        "mfu": round(overall_mfu, 6)
                        if overall_mfu is not None else None},
        }
        self._export_gauges(rows)
        return out

    @staticmethod
    def _export_gauges(rows: List[dict]):
        """Mirror the registry into gauges (at snapshot time only)."""
        g_rt = _metrics.gauge("exec_runtime_ms_total",
                              "cumulative steady-state wall ms",
                              labels=("component", "exec"))
        g_calls = _metrics.gauge("exec_calls_total", "steady-state calls",
                                 labels=("component", "exec"))
        for r in rows:
            lbl = dict(component=r["component"], exec=r["name"])
            g_rt.labels(**lbl).set(r["runtime_ms"])
            g_calls.labels(**lbl).set(r["calls"])

    def profile(self, component: str) -> Optional[dict]:
        """Per-kind roofline digest of one component (what
        ``stats()['exec_profile']`` carries): dict math over entries
        already analyzed, None when none is; never analyzes."""
        if not any(e.analysis is not None
                   for e in self.entries(component)):
            return None
        return profile_from_snapshot(self.snapshot(component))


def profile_from_snapshot(snap: dict) -> Optional[dict]:
    """The per-kind ``exec_profile`` digest the doctor's rules read, from
    a registry snapshot, live or reloaded by the report: the analyzed row
    of most runtime for each kind, with ``_overall`` and ``_peaks``."""
    prof: Dict[str, dict] = {}
    for r in snap.get("executables") or []:
        if not r.get("analyzed") or r.get("kind") is None:
            continue
        cur = prof.get(r["kind"])
        if cur is None or (r.get("runtime_ms") or 0) > \
                (cur.get("runtime_ms") or 0):
            prof[r["kind"]] = r
    if not prof:
        return None
    prof["_overall"] = snap.get("overall")
    prof["_peaks"] = {"device_kind": snap.get("device_kind"),
                      "peak_flops": snap.get("peak_flops"),
                      "peak_hbm_gbps": snap.get("peak_hbm_gbps"),
                      "peaks_nominal": snap.get("peaks_nominal")}
    return prof


def _default_name(key, kind: str) -> str:
    if isinstance(key, tuple):
        parts = [str(p) for p in key if not (isinstance(p, int) and
                                             p == 0)]
        return "/".join(parts) if parts else kind
    return str(key)


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------
class HBMLedger:
    """Resident device memory: ``track(owner, category, name, nbytes)``
    records one allocation under a weakref to its owner, and
    ``snapshot()`` reports it against the device's capacity."""

    def __init__(self):
        self._tracked: Dict[Tuple[str, str], dict] = {}
        self._lock = threading.Lock()

    def track(self, owner, category: str, name: str, nbytes: int,
              **meta):
        rec = {"category": category, "name": name, "bytes": int(nbytes),
               "meta": meta or None,
               "ref": weakref.ref(owner) if owner is not None else None}
        with self._lock:
            self._tracked[(category, name)] = rec

    def clear(self):
        with self._lock:
            self._tracked.clear()

    def _live(self) -> List[dict]:
        with self._lock:
            recs = list(self._tracked.items())
        out, dead = [], []
        for key, r in recs:
            if r["ref"] is not None and r["ref"]() is None:
                dead.append(key)
            else:
                out.append(r)
        if dead:
            with self._lock:
                for key in dead:
                    self._tracked.pop(key, None)
        return out

    def snapshot(self, exec_registry: Optional[ExecRegistry] = None
                 ) -> dict:
        live = self._live()
        by_cat: Dict[str, int] = {}
        for r in live:
            by_cat[r["category"]] = by_cat.get(r["category"], 0) + \
                r["bytes"]
        live_bytes = sum(by_cat.values())
        reg = exec_registry if exec_registry is not None else registry()
        exec_temp, exec_worst = 0, None
        for e in reg.entries():
            t = int(((e.analysis or {}).get("memory") or {}).get(
                "temp_bytes", 0) or 0)
            if t > exec_temp:
                exec_temp, exec_worst = t, f"{e.component}:{e.name}"
        cap = device_hbm_capacity()
        out = {
            "capacity_bytes": cap,
            "tracked_bytes": live_bytes,
            "by_category": by_cat,
            "tracked": [{"category": r["category"], "name": r["name"],
                         "bytes": r["bytes"]} for r in live],
            # the worst analyzed step kind's temp bytes (activations)
            "exec_temp_bytes": exec_temp,
            "exec_temp_worst": exec_worst,
        }
        if cap:
            headroom = cap - live_bytes - exec_temp
            out["headroom_bytes"] = int(headroom)
            out["headroom_frac"] = round(headroom / cap, 4)
            out["oom_risk"] = headroom / cap < OOM_HEADROOM_MIN
        else:
            out["headroom_bytes"] = None
            out["headroom_frac"] = None
            out["oom_risk"] = None
        g = _metrics.gauge("hbm_tracked_bytes",
                           "ledger-resident device bytes",
                           labels=("category",))
        for cat, b in by_cat.items():
            g.labels(category=cat).set(b)
        if cap:
            _metrics.gauge("hbm_capacity_bytes",
                           "device memory capacity").set(cap)
            _metrics.gauge("hbm_headroom_bytes",
                           "capacity - tracked - worst exec temp").set(
                out["headroom_bytes"])
        return out


_REGISTRY = ExecRegistry()
_LEDGER = HBMLedger()


def registry() -> ExecRegistry:
    return _REGISTRY


def ledger() -> HBMLedger:
    return _LEDGER


def register(component: str, key, kind: str, **kw):
    return _REGISTRY.register(component, key, kind, **kw)


def note_runtime(component: str, key, dt_ms: float):
    _REGISTRY.note_runtime(component, key, dt_ms)


def analyze(e: ExecEntry) -> bool:
    return _REGISTRY.analyze(e)


def analyze_all(component: Optional[str] = None) -> int:
    return _REGISTRY.analyze_all(component)


def profile(component: str) -> Optional[dict]:
    return _REGISTRY.profile(component)


def snapshot(component: Optional[str] = None, analyze: bool = False
             ) -> dict:
    return _REGISTRY.snapshot(component, analyze=analyze)


def track_bytes(owner, category: str, name: str, nbytes: int, **meta):
    _LEDGER.track(owner, category, name, nbytes, **meta)
