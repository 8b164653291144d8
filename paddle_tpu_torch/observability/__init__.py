"""Telemetry (counterpart of ``paddle_tpu/observability``, the platform
layer's profiler and monitor registry).

- **metrics**: the process-wide registry (counters, gauges, histograms
  with labels, no lock on the hot path), Prometheus exposition and its
  parser, atomic JSONL snapshots.  Fed by the engine's decode tick and
  admissions, the paged pool, the trainer's steps, checkpoint saves and
  restores, the host-sync counter and the load generator.
- **spans**: host spans (the train step's phases, each request's
  lifecycle) exported as Chrome-trace JSON, nested in a live capture
  through ``torch.profiler.record_function``.
- **capture**: ``PADDLE_TPU_PROFILE=start:stop`` windows a
  ``torch.profiler`` capture over decode ticks or train steps.
- **flightrec**: a bounded ring of recent steps and ticks and an event
  log, dumped as an atomic post-mortem bundle (the JAX package's format)
  on an unhandled exception, SIGTERM, a rollback or a stall.
- **watchdog**: a monitor thread fed by per-step beats; a stall dumps
  every thread's stack and a bundle.  Plus straggler detection.
- **exec_registry**: the step-kind registry, the HBM ledger and the
  device peak tables.
- **doctor**: rule-based bottleneck verdicts over the stats the entry
  points already report.
- **slo**: a rolling TTFT watch and a fleet aggregator over engines in
  one process.

The metric names and label sets, span names and categories, bundle
layout and environment knobs are the JAX package's, so one scraper, one
trace viewer and one deployment configuration serve both.  Telemetry
reads no device value: turning it on adds no host sync.
"""
from . import metrics
from . import spans
from . import capture
from . import exec_registry
from . import flightrec
from . import watchdog
from . import doctor
from . import slo
from .capture import ProfileWindow, parse_profile_spec
from .doctor import diagnose
from .exec_registry import ExecRegistry, HBMLedger
from .flightrec import FlightRecorder
from .metrics import counter, gauge, histogram, parse_exposition, registry
from .slo import FleetAggregator, SLOMonitor, load_bench_baseline
from .spans import (export_chrome_trace, span, tracer,
                    validate_chrome_trace)
from .watchdog import Watchdog, detect_stragglers

__all__ = [
    "metrics", "spans", "capture", "slo", "counter", "gauge", "histogram",
    "registry",
    "snapshot", "write_snapshot", "parse_exposition",
    "span", "tracer", "export_chrome_trace", "validate_chrome_trace",
    "ProfileWindow", "parse_profile_spec",
    "FleetAggregator", "SLOMonitor", "load_bench_baseline",
    "flightrec", "FlightRecorder", "watchdog", "Watchdog",
    "detect_stragglers", "doctor", "diagnose",
    "exec_registry", "ExecRegistry", "HBMLedger",
]


def snapshot() -> dict:
    """Every registered metric, the step-kind registry, the HBM ledger
    and the tracer's state, JSON-safe."""
    return {
        "metrics": metrics.snapshot(),
        "executables": exec_registry.snapshot(),
        "hbm": exec_registry.ledger().snapshot(),
        "spans": {"buffered": len(spans.tracer()),
                  "dropped": spans.tracer().dropped,
                  "active": spans.tracer().active},
    }


def write_snapshot(path=None, extra=None):
    """Append one full snapshot line (metrics, step kinds, HBM) to the
    JSONL history file, atomically, with the rotation of
    ``metrics.write_snapshot``."""
    full = {"executables": exec_registry.snapshot(),
            "hbm": exec_registry.ledger().snapshot()}
    if extra:
        full.update(extra)
    return metrics.write_snapshot(path, extra=full)
