"""Process-wide metrics registry: counters, gauges, histograms
(counterpart of ``paddle_tpu/observability/metrics.py``).

One sink that the engine, the load generator, the paged pool, the
trainer, checkpoints and the host-sync counter all feed, readable by a
Prometheus scraper:

- **Counter** (monotone), **Gauge** (any direction), **Histogram**
  (fixed buckets, sum, count), each with optional label dimensions.
- The hot path takes no lock: ``metric.labels(...)`` returns a cached
  child whose ``inc``/``set``/``observe`` are plain attribute
  arithmetic, and callers bind the child once.  ``+=`` is not atomic
  across threads, so a child written from several threads needs the
  caller's own lock (the host-sync counter updates its mirror under the
  lock it already holds).  Locks guard registration and child creation.
- Children live as long as the process: a label value minted per object
  (``engine="e3"``) keeps exporting its last value after the object
  dies.  Keep label cardinality small.
- Exposition is the Prometheus text format (``exposition()``), the same
  text the JAX package writes for the same operations, with a parser
  (``parse_exposition``) that reads either package's text back, and an
  atomic JSONL snapshot writer (``framework.fs.open_for_write``: fsync,
  temporary file, rename, so a crash mid-write never truncates the
  history file).

``PADDLE_TPU_METRICS=0`` disables the registry: every factory returns a
shared null metric whose children are no-ops, so the disabled path
allocates nothing per step.  ``PADDLE_TPU_METRICS=<path>`` names the
default snapshot file; ``PADDLE_TPU_METRICS_HISTORY`` (lines, default
512) and ``PADDLE_TPU_METRICS_SNAPSHOT_MAX_MB`` (default 64) bound it.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Registry", "registry", "counter", "gauge", "histogram",
           "snapshot", "write_snapshot", "parse_exposition",
           "metrics_enabled", "DEFAULT_MS_BUCKETS"]

# latency buckets in milliseconds, from sub-ms CPU runs to multi-second
# prefills
DEFAULT_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def metrics_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_METRICS", "1") != "0"


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = v

    def inc(self, n: float = 1.0):
        self.value += n

    def dec(self, n: float = 1.0):
        self.value -= n


class _HistChild:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(bounds)
        # one slot per bound and the +Inf overflow slot
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-resolution percentile: the upper bound of the bucket
        the q-quantile falls in, as a scraper would compute it."""
        if not self.count:
            return None
        target = q / 100.0 * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) \
                    else float("inf")
        return float("inf")


class _NullChild:
    """Shared no-op child of the disabled registry: no state, accepts
    every child method."""
    __slots__ = ()

    def inc(self, n: float = 1.0):
        pass

    set = dec = observe = inc
    value = 0.0
    sum = 0.0
    count = 0


_NULL_CHILD = _NullChild()


class Metric:
    """One named metric family; ``labels(**kv)`` returns the cached
    child for that label combination (created once under a lock, then
    lock-free)."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = tuple(buckets) if buckets else None
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _new_child(self):
        if self.kind == "counter":
            return _CounterChild()
        if self.kind == "gauge":
            return _GaugeChild()
        return _HistChild(self.buckets or DEFAULT_MS_BUCKETS)

    def labels(self, **kv):
        key = tuple(str(kv.get(n, "")) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    # a metric without labels is its own single child
    def inc(self, n: float = 1.0):
        self.labels().inc(n)

    def set(self, v: float):
        self.labels().set(v)

    def observe(self, v: float):
        self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value


class _NullMetric(Metric):
    def __init__(self):
        super().__init__("", "counter", "", ())

    def labels(self, **kv):
        return _NULL_CHILD

    def inc(self, n: float = 1.0):
        pass

    set = observe = inc


_NULL_METRIC = _NullMetric()


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _escape_label_value(v) -> str:
    """Label-value escaping of the text format: backslash first, then
    quote and newline."""
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _escape_help(text: str) -> str:
    """HELP-line escaping (backslash and newline): a raw newline would
    split the line into a garbage sample line."""
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [(n, v) for n, v in zip(names, values)] + list(extra)
    if not pairs:
        return ""
    body = ",".join('%s="%s"' % (n, _escape_label_value(v))
                    for n, v in pairs)
    return "{" + body + "}"


class Registry:
    """Metric store.  One process-wide instance (``registry()``); tests
    may build private ones."""

    # history lines kept when rewriting the snapshot file
    _HISTORY_DEFAULT = 512

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, help: str,
             labels: Sequence[str],
             buckets: Optional[Sequence[float]]) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = Metric(name, kind, help, tuple(labels),
                               buckets=buckets)
                    self._metrics[name] = m
        if m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {kind}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Metric:
        return self._get("counter", name, help, labels, None)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Metric:
        return self._get("gauge", name, help, labels, None)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Metric:
        return self._get("histogram", name, help, labels, buckets)

    def exposition(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if not m._children:
                continue
            lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key in sorted(m._children):
                c = m._children[key]
                if m.kind == "histogram":
                    acc = 0
                    bounds = list(c.bounds) + [float("inf")]
                    for b, n in zip(bounds, c.counts):
                        acc += n
                        le = (("le", _fmt_value(b)),)
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(m.labelnames, key, le)} {acc}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(m.labelnames, key)} "
                        f"{_fmt_value(c.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(m.labelnames, key)} "
                        f"{c.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(m.labelnames, key)} "
                        f"{_fmt_value(c.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-safe view: ``{metric: {"kind", "help", "series":
        [{labels, value | sum, count, buckets}]}}``."""
        out = {}
        for name, m in self._metrics.items():
            series = []
            for key, c in m._children.items():
                labels = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    series.append({
                        "labels": labels, "sum": round(c.sum, 6),
                        "count": c.count,
                        "buckets": dict(zip(
                            [_fmt_value(b) for b in c.bounds] + ["+Inf"],
                            c.counts)),
                    })
                else:
                    series.append({"labels": labels,
                                   "value": round(float(c.value), 6)})
            if series:
                out[name] = {"kind": m.kind, "help": m.help,
                             "series": series}
        return out

    def write_snapshot(self, path: str, extra: Optional[dict] = None
                       ) -> str:
        """Append one snapshot line to a JSONL history file atomically:
        the kept history and the new line land by fsync and rename.  The
        history keeps the last ``PADDLE_TPU_METRICS_HISTORY`` lines and at
        most ``PADDLE_TPU_METRICS_SNAPSHOT_MAX_MB`` (the new line always
        lands); writers in one process are serialized, and the path
        expects one writing process."""
        rec = {"ts": time.time(), **(extra or {}),
               "metrics": self.snapshot()}
        line = json.dumps(rec, default=str) + "\n"
        keep = int(os.environ.get("PADDLE_TPU_METRICS_HISTORY",
                                  self._HISTORY_DEFAULT)) - 1
        with self._lock:
            prior: List[str] = []
            try:
                with open(path) as f:
                    prior = f.readlines()
            except OSError:
                pass
            if keep >= 0 and len(prior) > keep:
                prior = prior[-keep:] if keep else []
            try:
                max_mb = float(os.environ.get(
                    "PADDLE_TPU_METRICS_SNAPSHOT_MAX_MB", 64))
            except ValueError:
                max_mb = 64.0
            if max_mb > 0:
                budget = max_mb * 1e6 - len(line)
                total = sum(len(p) for p in prior)
                while prior and total > budget:
                    total -= len(prior.pop(0))
            from ..framework.fs import open_for_write
            with open_for_write(path, "w") as f:
                f.write("".join(prior) + line)
        return path

    def clear(self):
        """Drop every metric (test isolation)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str, help: str = "",
            labels: Sequence[str] = ()) -> Metric:
    if not metrics_enabled():
        return _NULL_METRIC
    return _REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Metric:
    if not metrics_enabled():
        return _NULL_METRIC
    return _REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Metric:
    if not metrics_enabled():
        return _NULL_METRIC
    return _REGISTRY.histogram(name, help, labels, buckets=buckets)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def write_snapshot(path: Optional[str] = None,
                   extra: Optional[dict] = None) -> Optional[str]:
    """Write a snapshot line to ``path`` (default: ``PADDLE_TPU_METRICS``
    when it names a file).  Returns the path, or None when there is
    nowhere to write."""
    if path is None:
        env = os.environ.get("PADDLE_TPU_METRICS", "")
        path = env if env not in ("", "0", "1") else None
    if not path:
        return None
    return _REGISTRY.write_snapshot(path, extra=extra)


# ---------------------------------------------------------------------------
# exposition parser
# ---------------------------------------------------------------------------
def _parse_labels(text: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    i = 0
    while i < len(text):
        eq = text.index("=", i)
        name = text[i:eq].strip().lstrip(",").strip()
        if text[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {text!r}")
        j = eq + 2
        buf = []
        while text[j] != '"':
            if text[j] == "\\":
                nxt = text[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                buf.append(text[j])
                j += 1
        out[name] = "".join(buf)
        i = j + 1
    return out


def parse_exposition(text: str) -> dict:
    """Parse text exposition into ``{name: {"type": ..., "samples":
    [(sample name, labels dict, value)]}}``; raises on a malformed
    line."""
    out: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            out.setdefault(name, {"type": kind, "samples": []})
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            lbl_text = rest[:rest.rindex("}")]
            val_text = rest[rest.rindex("}") + 1:].strip()
            labels = _parse_labels(lbl_text)
        else:
            name, val_text = line.split(None, 1)
            labels = {}
        value = float("inf") if val_text == "+Inf" else float(val_text)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types \
                    and types[name[:-len(suffix)]] == "histogram":
                base = name[:-len(suffix)]
        out.setdefault(base, {"type": types.get(base, "untyped"),
                              "samples": []})
        out[base]["samples"].append((name, labels, value))
    return out
