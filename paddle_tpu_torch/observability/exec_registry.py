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

Not ported: XLA's ``cost_analysis`` and ``memory_analysis`` have no
counterpart for eager PyTorch, so an entry's ``flops`` and
``bytes_accessed`` are None, nothing is ever ``analyzed``,
``profile()`` returns None, and the doctor takes its threshold rules
(the path the JAX package takes before its analyses run).  An analytic
cost per step kind (the bound formulas ``chip_smoke.py`` uses) is left
for later.

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

from . import metrics as _metrics

__all__ = [
    "ExecEntry", "ExecRegistry", "HBMLedger", "registry", "ledger",
    "register", "note_runtime", "profile",
    "snapshot", "track_bytes", "tree_bytes", "enabled", "device_kind",
    "peak_flops", "peak_hbm_bytes_per_s", "device_hbm_capacity",
    "MFU_TARGET", "OOM_HEADROOM_MIN",
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


def device_kind() -> str:
    """The card's name, lower case ("" without a card)."""
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name().lower()


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
    if not torch.cuda.is_available():
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

    def entries(self, component: Optional[str] = None) -> List[ExecEntry]:
        with self._lock:
            es = list(self._entries.values())
        if component is not None:
            es = [e for e in es if e.component == component]
        return es

    @staticmethod
    def _entry_snapshot(e: ExecEntry, nominal: bool) -> dict:
        mean_ms = (e.runtime_ms / e.calls) if e.calls else None
        d = {
            "component": e.component, "name": e.name, "kind": e.kind,
            "key": str(e.key), "calls": e.calls,
            "runtime_ms": round(e.runtime_ms, 3),
            "mean_ms": round(mean_ms, 4) if mean_ms is not None else None,
            "compile_ms": round(e.compile_ms, 2)
            if e.compile_ms is not None else None,
            "analyzed": False,
            "flops": None, "bytes_accessed": None,
            "peaks_nominal": nominal,
        }
        if e.meta:
            d["meta"] = dict(e.meta)
        return d

    def snapshot(self, component: Optional[str] = None) -> dict:
        """JSON-safe snapshot: per-entry records sorted by runtime, each
        with its share of the total, and the device's peaks."""
        kind = device_kind()
        pf, f_nom = peak_flops(kind)
        pb, b_nom = peak_hbm_bytes_per_s(kind)
        nominal = f_nom or b_nom
        rows = [self._entry_snapshot(e, nominal)
                for e in self.entries(component)]
        rows.sort(key=lambda r: -(r["runtime_ms"] or 0.0))
        total_rt = sum(r["runtime_ms"] for r in rows) or 0.0
        for r in rows:
            if total_rt > 0:
                r["time_share"] = round(r["runtime_ms"] / total_rt, 4)
        out = {
            "device_kind": kind or "host",
            "peak_flops": pf,
            "peak_hbm_gbps": round(pb / 1e9, 1),
            "peaks_nominal": nominal,
            "mfu_target": MFU_TARGET,
            "executables": rows,
            "overall": {"runtime_ms": round(total_rt, 3), "analyzed": 0,
                        "registered": len(rows), "mfu": None},
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
        """The per-kind roofline digest the doctor reads, built from
        analyzed entries: the port analyses none, so it is None."""
        return None


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

    def snapshot(self) -> dict:
        live = self._live()
        by_cat: Dict[str, int] = {}
        for r in live:
            by_cat[r["category"]] = by_cat.get(r["category"], 0) + \
                r["bytes"]
        live_bytes = sum(by_cat.values())
        cap = device_hbm_capacity()
        out = {
            "capacity_bytes": cap,
            "tracked_bytes": live_bytes,
            "by_category": by_cat,
            "tracked": [{"category": r["category"], "name": r["name"],
                         "bytes": r["bytes"]} for r in live],
            # no executable analyses in the port: no temp bytes
            "exec_temp_bytes": 0,
            "exec_temp_worst": None,
        }
        if cap:
            headroom = cap - live_bytes
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


def profile(component: str) -> Optional[dict]:
    return _REGISTRY.profile(component)


def snapshot(component: Optional[str] = None) -> dict:
    return _REGISTRY.snapshot(component)


def track_bytes(owner, category: str, name: str, nbytes: int, **meta):
    _LEDGER.track(owner, category, name, nbytes, **meta)
