"""The port's telemetry against the JAX package's, on the CPU.

The same operations, from a numpy seed, go through both packages'
metrics registries, span tracers, doctors, SLO monitors and straggler
detectors; the outputs must be equal (exposition text character for
character, Chrome-trace events, verdict lists, SLO verdicts).  Then the
engines and trainers of both packages, on the same converted weights
with telemetry on: the same metric names and label sets, equal tick,
token, prefill and step counters, the same span names on every request
track (a preemption included) and the same kinds in the flight
recorder's ring.  In the port alone, telemetry on (tracer, metrics,
flight recorder, watchdog, a capture window) against off: identical
tokens and an identical ``host_sync_count()`` delta.  No wall time is
asserted.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.distributed import async_dispatch as jasync
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.observability import doctor as jdoctor
from paddle_tpu.observability import flightrec as jflightrec
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import spans as jspans
from paddle_tpu.observability import watchdog as jwatchdog

from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.distributed import async_dispatch as tasync
from paddle_tpu_torch.inference import InferenceEngine, run_loadtest
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.observability import doctor as tdoctor
from paddle_tpu_torch.observability import flightrec as tflightrec
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import spans as tspans
from paddle_tpu_torch.observability import watchdog as twatchdog

HOSTILE = ['back\\slash', 'a"b', 'nl\nx', 'end\\', 'mix\\"q\n,=}{',
           'tab\tv', '{br}ace']


# ---- metrics ---------------------------------------------------------------

def drive_registry(mod, seed=0):
    """One private registry of package ``mod`` driven by a seeded
    sequence of operations (hostile label values and help text
    included)."""
    rng = np.random.RandomState(seed)
    r = mod.Registry()
    c = r.counter("req_total", 'requests\nserved, \\ "quoted"',
                  labels=("engine", "outcome"))
    g = r.gauge("depth", "queue depth", labels=("engine",))
    h = r.histogram("ttft_ms", "enqueue -> first token", labels=("engine",))
    h2 = r.histogram("small_ms", buckets=(1.0, 10.0))
    r.counter("never_touched_total")
    for _ in range(60):
        e = f"e{rng.randint(3)}"
        c.labels(engine=e, outcome=("ok", "timed_out")[rng.randint(2)]).inc(
            float(rng.randint(1, 4)))
        g.labels(engine=e).set(float(np.round(rng.randn(), 3)))
        h.labels(engine=e).observe(float(rng.exponential(40.0)))
        h2.observe(float(rng.rand() * 20.0))
    for value in HOSTILE:
        c.labels(engine=value, outcome="ok").inc()
    return r


def test_exposition_text_equals_jax_character_for_character():
    j, t = drive_registry(jmetrics), drive_registry(tmetrics)
    assert t.exposition() == j.exposition()
    assert t.snapshot() == j.snapshot()
    # each package's parser reads the other's text to the same dict
    for text in (j.exposition(), t.exposition()):
        assert tmetrics.parse_exposition(text) == \
            jmetrics.parse_exposition(text)
    parsed = tmetrics.parse_exposition(j.exposition())
    got = {lbl["engine"] for _, lbl, _ in parsed["req_total"]["samples"]}
    assert set(HOSTILE) <= got


def test_disabled_registry_hands_out_one_null_child(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
    a = tmetrics.counter("x_total", labels=("k",)).labels(k="1")
    b = tmetrics.histogram("y_ms").labels()
    assert a is b
    a.inc()
    b.observe(3.0)
    assert a.value == 0.0


def test_snapshot_file_is_bounded_and_atomic(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_METRICS_HISTORY", "3")
    r = drive_registry(tmetrics)
    path = str(tmp_path / "m.jsonl")
    for i in range(5):
        r.write_snapshot(path, extra={"i": i})
    lines = [json.loads(x) for x in open(path)]
    assert [x["i"] for x in lines] == [2, 3, 4]
    assert lines[-1]["metrics"] == r.snapshot()
    assert not os.path.exists(path + ".tmp")


# ---- spans -----------------------------------------------------------------

def drive_tracer(mod):
    tr = mod.SpanTracer(capacity=12)
    tr.start()
    rng = np.random.RandomState(3)
    for i in range(10):
        ts = float(np.round(rng.rand() * 1e4, 3))
        tr.complete("decode_tick", ts, float(np.round(rng.rand() * 50, 3)),
                    tid=7, cat="serve", args={"active": i})
        tr.complete("queued", ts, 1.5, pid=mod.PID_REQUESTS, tid=i % 3,
                    cat="request", args={"prompt_tokens": i})
    tr.instant("preempt", pid=mod.PID_REQUESTS, tid=1, cat="request",
               ts_us=5.0)
    return tr


def test_chrome_trace_events_equal_jax():
    j, t = drive_tracer(jspans), drive_tracer(tspans)
    assert (tspans.PID_HOST, tspans.PID_REQUESTS) == \
        (jspans.PID_HOST, jspans.PID_REQUESTS) == (1, 2)
    assert t.chrome_trace() == j.chrome_trace()
    assert t.dropped == j.dropped == 9            # bounded: drops, no growth
    for doc in (j.chrome_trace(), t.chrome_trace()):
        assert tspans.validate_chrome_trace(doc) == \
            jspans.validate_chrome_trace(doc)


MALFORMED = [
    {"events": []},
    {"traceEvents": "x"},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1,
                      "ts": "0", "dur": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1,
                      "ts": 0, "dur": -1}]},
    {"traceEvents": [{"name": "a", "ph": "i", "pid": 1}]},
]


@pytest.mark.parametrize("doc", MALFORMED, ids=range(len(MALFORMED)))
def test_validators_reject_the_same_fixtures(doc):
    for validate in (jspans.validate_chrome_trace,
                     tspans.validate_chrome_trace):
        with pytest.raises(ValueError):
            validate(doc)
        with pytest.raises(ValueError):
            validate(json.dumps(doc))


def test_span_is_free_when_off_and_nests_in_a_capture(tmp_path):
    tr = tspans.tracer()
    tr.stop()
    tr.clear()
    with tspans.span("nothing") as s:
        assert s._rf is None
    assert len(tr) == 0
    tr.start()
    try:
        w = tobs.ProfileWindow(0, 1, log_dir=str(tmp_path))
        w.on_step(0)
        assert w.active and tspans._CAPTURE["live"]
        with tspans.span("nested_span"):
            torch.ones(4).add_(1)
        w.on_step(1)
    finally:
        tr.stop()
    assert w.done and not tspans._CAPTURE["live"]
    doc = json.load(open(w.trace_path))
    assert "nested_span" in {e.get("name") for e in doc["traceEvents"]}
    assert [e["name"] for e in tr.chrome_trace()["traceEvents"]
            if e["ph"] == "X"] == ["nested_span"]
    tr.clear()


def test_profile_window_spec_and_env(monkeypatch, tmp_path):
    assert tobs.parse_profile_spec("3:7:/x") == \
        jobs.parse_profile_spec("3:7:/x")[:2] + ("/x",)
    for bad in ("3", "7:3", "-1:2", "a:b"):
        with pytest.raises(ValueError):
            tobs.parse_profile_spec(bad)
    monkeypatch.delenv("PADDLE_TPU_PROFILE", raising=False)
    assert tobs.ProfileWindow.from_env() is None
    monkeypatch.setenv("PADDLE_TPU_PROFILE", f"3:7:{tmp_path}")
    w = tobs.ProfileWindow.from_env(kind="serve")
    assert (w.start, w.stop) == (3, 7) and w.log_dir.endswith("serve")
    late = tobs.ProfileWindow(1, 2)
    late.on_step(10)                      # the window is behind: no capture
    assert late.done and late.trace_path is None


def test_record_event_and_step_timer():
    tr = tspans.tracer()
    tr.clear()
    tr.start()
    try:
        with tprof.RecordEvent("annotated", args={"k": 1}):
            pass

        @tprof.record_event("decorated")
        def f():
            return 3
        assert f() == 3
    finally:
        tr.stop()
    names = [e["name"] for e in tr.chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    assert names == ["annotated", "decorated"]
    tr.clear()
    timer = tprof.StepTimer(warmup=1)
    timer.start()
    for _ in range(3):
        timer.tick()
    assert timer.summary()["steps"] == 2 and timer.mean_ms >= 0


# ---- doctor ----------------------------------------------------------------

def _decode_profile(bw_frac, bound="bandwidth", nominal=False):
    return {
        "decode": {"kind": "decode", "bound": bound,
                   "hbm_bw_frac": bw_frac, "achieved_hbm_gbps": 590.0,
                   "arithmetic_intensity": 1.2, "ridge_ai": 240.0,
                   "mfu": 0.04, "calls": 100, "runtime_ms": 500.0},
        "_peaks": {"peaks_nominal": nominal, "device_kind": "h100"},
    }


# the fixtures of the JAX package's doctor tests (test_flightrec.py and
# test_exec_observatory.py), with the kinds they pass
DOCTOR_FIXTURES = [
    ({"comm_fraction": 0.41,
      "comm_by_op": {"all-reduce": {"count": 4, "bytes": 1 << 20},
                     "all-gather": {"count": 2, "bytes": 1 << 10}}},
     "train"),
    ({"host_syncs_measured": 20, "steps": 10}, "train"),
    ({"data_wait_ms": 600.0, "dispatch_ms": 400.0}, "train"),
    ({"comm_fraction": 0.03, "data_wait_ms": 5.0, "dispatch_ms": 5000.0,
      "sync_ms": 2.0, "host_syncs_measured": 1, "steps": 20,
      "h2d_ms": 10.0}, "train"),
    ({"comm_fraction": 0.3, "data_wait_ms": 900.0, "dispatch_ms": 100.0},
     "train"),
    ({"block_occupancy": 0.95, "preemptions": 7,
      "spec_acceptance_rate": 0.1, "prefix_hit_rate": 0.02,
      "prefix_queries": 100}, "serve"),
    ({}, None),
    ({"comm_fraction": None, "data_wait_ms": "nan?"}, None),
    ({"decode_steps": 100, "kv_dtype": None, "decode_megakernel": False,
      "exec_profile": _decode_profile(0.72)}, "serve"),
    ({"decode_steps": 100, "kv_dtype": "int8", "decode_megakernel": True,
      "exec_profile": _decode_profile(0.9, nominal=True)}, "serve"),
    ({"decode_steps": 100, "decode_hbm_bytes_per_tok": 10_000_000,
      "kv_dtype": None, "decode_megakernel": False}, "serve"),
    ({"decode_steps": 100, "decode_hbm_bytes_per_tok": 10_000_000,
      "kv_dtype": None, "decode_megakernel": False,
      "exec_profile": _decode_profile(0.2, bound="compute")}, "serve"),
    ({"exec_profile": {
        "train_step": {"kind": "train_step", "bound": "compute",
                       "mfu": 0.35, "arithmetic_intensity": 300.0,
                       "ridge_ai": 240.0, "mean_ms": 120.0,
                       "gap_share": 0.2, "runtime_ms": 2400.0,
                       "calls": 20},
        "_peaks": {"peaks_nominal": False}}}, "train"),
    ({"hbm": {"headroom_frac": 0.03, "tracked_bytes": 15 << 30,
              "capacity_bytes": 16 << 30, "exec_temp_bytes": 400 << 20,
              "exec_temp_worst": "trainer:s0:fused/1/1"}}, "train"),
    ({"hbm": {"headroom_frac": 0.4}}, None),
    ({"prefill_stall_ms": 300.0, "decode_ms": 700.0, "itl_ms_p99": 80.0},
     "serve"),
    ({"slot_occupancy": 0.2, "decode_steps": 50}, "serve"),
    ({"xla_compiles_measured": 3}, None),
    ({"spec_acceptance_rate": 0.05, "spec_k": 8,
      "accepted_tokens_per_tick": 1.1}, "serve"),
]


@pytest.mark.parametrize("case", range(len(DOCTOR_FIXTURES)))
def test_doctor_verdicts_equal_jax(case):
    stats, kind = DOCTOR_FIXTURES[case]
    want = jdoctor.diagnose(stats, kind=kind)
    assert tdoctor.diagnose(stats, kind=kind) == want
    assert tdoctor.diagnose(stats) == jdoctor.diagnose(stats)


def test_doctor_rule_table_equals_jax():
    assert [(r.bottleneck, r.kinds, r.knob) for r in tdoctor.RULES] == \
        [(r.bottleneck, r.kinds, r.knob) for r in jdoctor.RULES]


# ---- slo and stragglers ------------------------------------------------------

STRAGGLER_INPUTS = [[10.0, 10.5, 30.0], [None, 12.0, 11.0], [], [None],
                    [5.0], [1.0, 1.02], [0.0, 3.0, 3.1, 9.0],
                    [20.0, 10.0, 10.0, 10.0, 10.1]]


@pytest.mark.parametrize("factor", [None, 1.5])
def test_detect_stragglers_equals_jax(factor, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_STRAGGLER_FACTOR", "2.5")
    for vals in STRAGGLER_INPUTS:
        assert twatchdog.detect_stragglers(vals, factor=factor) == \
            jwatchdog.detect_stragglers(vals, factor=factor), vals


def test_slo_monitor_check_equals_jax(tmp_path):
    rng = np.random.RandomState(5)
    ttfts = rng.exponential(80.0, size=200)
    rows = tmp_path / "rows.jsonl"
    rows.write_text("\n".join(json.dumps(r) for r in (
        {"kind": "loadtest", "ttft_ms_p99": 40.0},
        {"kind": "loadtest", "ttft_ms_p99": 25.0, "metric": "smoke"},
        {"kind": "train", "ttft_ms_p99": 1.0})) + "\nnot json\n")
    mons = [mod.SLOMonitor(ttft_p99_ms=150.0, window=64,
                           rows_path=str(rows)) for mod in (jslo, tslo)]
    for mon in mons:
        assert mon.check()["window"] == 0
    for t in ttfts:
        for mon in mons:
            mon.observe(t)
    got = [mon.check() for mon in mons]
    assert got[1] == got[0]
    assert got[1]["baseline_ttft_p99_ms"] == 40.0 and got[1]["regressed"]


def test_load_bench_baseline_equals_jax_on_bad_files(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    corrupt = tmp_path / "corrupt.jsonl"
    corrupt.write_bytes(b"\xff\xfe\x00garbage\n{\"kind\": \"loadtest\"")
    for path in (tmp_path / "missing.jsonl", empty, corrupt):
        assert tslo.load_bench_baseline(str(path)) is \
            jslo.load_bench_baseline(str(path)) is None


# ---- engines ---------------------------------------------------------------

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=64, initializer_range=0.2)
FORMS = {
    "dense": dict(batch_slots=2, prefill_buckets=[8, 16]),
    "paged": dict(batch_slots=2, prefill_buckets=[8, 16], kv_layout="paged",
                  kv_block_size=8),
    # a 6-block pool that runs dry mid-decode: preemptions
    "pressure": dict(batch_slots=3, prefill_buckets=[8, 32],
                     kv_layout="paged", kv_block_size=8, kv_num_blocks=6,
                     prefix_cache=False),
}
SERVE_FAMILY = ("serve_decode_ticks_total", "serve_tokens_total",
                "serve_prefills_total", "serve_preemptions_total",
                "serve_requests_total", "serve_ttft_ms",
                "serve_queue_depth", "serve_active_slots")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


def prompts_for(form):
    rng = np.random.RandomState(11)
    n, new = (3, 14) if form == "pressure" else (3, 6)
    lens = (7, 7, 7) if form == "pressure" else (5, 11, 3)
    return [rng.randint(1, 97, (k,)).astype(np.int32) for k in lens[:n]], new


def fresh_telemetry():
    for sp, fr in ((jspans, jflightrec), (tspans, tflightrec)):
        sp.tracer().clear()
        sp.tracer().start()
        fr.recorder().ring.clear()
        fr.recorder().events.clear()


def stop_tracers():
    for sp in (jspans, tspans):
        sp.tracer().stop()
        sp.tracer().clear()


def engine_view(eng, registry, tracer, ring, rids):
    """What the parity test compares of one engine's telemetry: its
    metric names and label sets, each request's track, the decode-tick
    spans, its counters (and its pool's gauge), the ring's kinds."""
    label = eng.telemetry_label
    snap = registry.snapshot()
    names = {name: sorted({tuple(sorted(s["labels"]))
                           for s in m["series"]
                           if s["labels"].get("engine") == label})
             for name, m in snap.items() if name.startswith("serve_")}
    names = {k: v for k, v in names.items() if v}
    if eng._alloc is not None:
        assert eng._alloc._m_in_use.value == eng._alloc.num_in_use
        names.update({name: sorted({tuple(s["labels"])
                                    for s in snap[name]["series"]})
                      for name in ("kv_blocks_in_use",
                                   "kv_blocks_capacity")})
    events = tracer.chrome_trace()["traceEvents"]
    tracks = [[e["name"] for e in events
               if e.get("pid") == 2 and e.get("tid") == rid
               and e["ph"] in ("X", "i")] for rid in rids]
    ticks = sum(1 for e in events if e["name"] == "decode_tick")
    counters = (eng._m_ticks.value, eng._m_tokens.value,
                eng._m_prefills.value, eng._m_preempts.value,
                eng._alloc._m_in_use.value if eng._alloc else None)
    return names, tracks, ticks, counters, [e["kind"] for e in ring]


@pytest.mark.parametrize("form", list(FORMS))
def test_engine_telemetry_equals_jax(models, form):
    jm, tm = models
    ps, new = prompts_for(form)
    kw = FORMS[form]
    fresh_telemetry()
    try:
        views = []
        for eng, reg, sp, fr in (
                (JaxEngine(jm, **kw), jmetrics.registry(), jspans,
                 jflightrec),
                (InferenceEngine(tm, device="cpu", **kw),
                 tmetrics.registry(), tspans, tflightrec)):
            rids = [eng.add_request(p, max_new_tokens=new) for p in ps]
            eng.run()
            views.append((engine_view(eng, reg, sp.tracer(),
                                      fr.recorder().ring, rids),
                          [np.asarray(eng.results[r]).tolist()
                           for r in rids]))
    finally:
        stop_tracers()
    (jv, jtok), (tv, ttok) = views
    assert ttok == jtok
    names, tracks, ticks, counters, ring = tv
    assert names == jv[0]
    assert {n for n in names if n.startswith("serve_")} == set(SERVE_FAMILY)
    assert tracks == jv[1]
    assert all(t[:3] == ["queued", "prefill", "decode"] for t in tracks)
    if form == "pressure":
        assert any("preempt" in t for t in tracks)
    assert ticks == jv[2] > 0
    assert counters == jv[3]
    assert ring == jv[4] and set(ring) == {"decode_tick"}


@pytest.mark.parametrize("form", ["dense", "paged", "chunked", "spec"])
def test_telemetry_on_changes_no_token_and_no_sync(models, form, tmp_path,
                                                   monkeypatch):
    """Telemetry off (metrics and the flight recorder disabled, tracer
    stopped) against on (tracer, metrics, flight recorder, a watchdog and
    a capture window over decode ticks 1-3): the same tokens and the
    same host-sync count, one a decode step and one an admission."""
    _, tm = models
    kw = {"dense": dict(), "paged": dict(kv_layout="paged", kv_block_size=8),
          "chunked": dict(prefill_chunk=4),
          "spec": dict(spec_k=2, draft_model=tm)}[form]
    ps, new = prompts_for("dense")
    runs = []
    for on in (False, True):
        monkeypatch.setenv("PADDLE_TPU_METRICS", "1" if on else "0")
        monkeypatch.setenv("PADDLE_TPU_FLIGHTREC", "1" if on else "0")
        if on:
            monkeypatch.setenv("PADDLE_TPU_WATCHDOG_S", "600")
            monkeypatch.setenv("PADDLE_TPU_PROFILE", f"1:3:{tmp_path}")
            tspans.tracer().clear()
            tspans.tracer().start()
        try:
            eng = InferenceEngine(tm, device="cpu", batch_slots=2,
                                  prefill_buckets=[8, 16], **kw)
            s0 = tasync.host_sync_count()
            rids = [eng.add_request(p, max_new_tokens=new) for p in ps]
            eng.run()
            syncs = tasync.host_sync_count() - s0
        finally:
            tspans.tracer().stop()
        st = eng.stats()
        assert syncs == st["host_syncs"] == \
            st["decode_steps"] + st["prefill_host_syncs"]
        runs.append(([eng.results[r].tolist() for r in rids], syncs))
        if on:
            assert eng.watchdog is not None and eng.watchdog.stalls == 0
            eng.watchdog.disarm()
            assert eng._profile.done and os.path.exists(
                eng._profile.trace_path)
            events = tspans.tracer().chrome_trace()["traceEvents"]
            assert tobs.validate_chrome_trace({"traceEvents": events}) > 0
            tspans.tracer().clear()
            assert eng._m_ticks.value == st["decode_steps"]
            assert isinstance(st["doctor"], list) and st["hbm"]["by_category"]
        else:
            assert eng.watchdog is None and eng._profile is None
            assert eng._m_ticks.value == 0.0
    assert runs[1] == runs[0]


def test_engine_ledger_and_registry_lines(models):
    _, tm = models
    eng = InferenceEngine(tm, device="cpu", batch_slots=2,
                          prefill_buckets=[8], spec_k=2, draft_model=tm)
    eng.generate(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    st = eng.stats()
    mine = {t["category"]: t["bytes"] for t in st["hbm"]["tracked"]
            if t["name"] == eng.telemetry_label}
    c = eng.cache
    assert mine["params"] == sum(p.numel() * p.element_size()
                                 for p in tm.parameters())
    assert mine["kv_cache"] == (c.k.numel() * c.k.element_size()
                                + c.v.numel() * c.v.element_size())
    assert mine["spec_draft"] > mine["params"]
    assert st["exec_profile"] is None and st["hbm"]["capacity_bytes"] is None
    reg = tobs.exec_registry.registry()
    kinds = {e.kind: e for e in reg.entries(eng._exec_component)}
    assert set(kinds) == {"prefill", "sample", "spec_verify"}
    assert kinds["spec_verify"].calls + 1 == st["spec_ticks"]
    assert kinds["prefill"].compile_ms is not None
    snap = tobs.exec_registry.snapshot(eng._exec_component)
    assert snap["peaks_nominal"] and snap["device_kind"] == "host"
    assert all(r["flops"] is None and not r["analyzed"]
               for r in snap["executables"])


def test_load_report_has_slo_and_doctor_of_jax_shape(models):
    _, tm = models
    eng = InferenceEngine(tm, device="cpu", batch_slots=2,
                          prefill_buckets=[8, 32], kv_layout="paged",
                          kv_block_size=8)
    rep = run_loadtest(eng, num_requests=4, rate_rps=1000.0, seed=3)
    assert set(rep["slo"]) == set(jslo.SLOMonitor(
        baseline_ttft_p99_ms=None).check())
    assert rep["slo"]["window"] == rep["num_requests"] == 4
    assert isinstance(rep["doctor"], list)
    for v in rep["doctor"]:
        assert {"bottleneck", "evidence", "knob", "score"} <= set(v)


# ---- trainer ---------------------------------------------------------------

def test_trainer_metrics_and_spans_equal_jax():
    """The port's SpmdTrainer against JAX's on a {"dp": 1} mesh (as the
    JAX package's telemetry test drives it): train_steps_total moves by
    the step count in both, the step timer reaches stats, and the h2d,
    dispatch and sync spans land in both tracers."""
    import jax
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
    from paddle_tpu.distributed import create_mesh
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import SpmdTrainer
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 10))
    jtr = JaxTrainer(jm, paddle.optimizer.SGD(learning_rate=0.1,
                                              parameters=jm.parameters()),
                     lambda out, y: JF.cross_entropy(out, y),
                     mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                     anomaly_policy="rollback")
    tm = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                             torch.nn.Linear(32, 10))
    ttr = SpmdTrainer(tm, topt.SGD(learning_rate=0.1),
                      lambda out, y: torch.nn.functional.cross_entropy(
                          out, y.long()), anomaly_policy="rollback")
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 10, size=(8,)).astype(np.int64)
    fresh_telemetry()
    c0 = (jtr._m_steps.value, ttr._m_steps.value)
    try:
        for _ in range(3):
            jtr.train_step(x, y)
            ttr.train_step(x, y)
        names = [{e["name"] for e in sp.tracer().chrome_trace()[
            "traceEvents"] if e["ph"] == "X"} for sp in (jspans, tspans)]
        rings = [[e["kind"] for e in fr.recorder().ring]
                 for fr in (jflightrec, tflightrec)]
    finally:
        stop_tracers()
    assert (jtr._m_steps.value - c0[0], ttr._m_steps.value - c0[1]) == (3, 3)
    assert {"h2d", "dispatch", "sync"} <= names[1] and \
        {"h2d", "dispatch", "sync"} <= names[0]
    assert rings[1] == rings[0] == ["train_step"] * 3
    st = ttr.stats
    assert st["step_time_ms"] is not None and st["step_time_mean_ms"] >= 0
    assert ttr._m_step_ms.value == pytest.approx(st["step_time_ms"],
                                                 abs=1e-3)
    assert isinstance(st["doctor"], list)
    assert {"params", "opt_state"} <= set(st["hbm"]["by_category"])
    reg = tobs.exec_registry.registry()
    [entry] = reg.entries(ttr._exec_component)
    assert entry.kind == "train_step" and entry.calls == 2


def test_host_sync_mirror_counts_into_the_registry():
    c = tmetrics.counter("host_syncs_total")
    before, s0 = c.value, tasync.host_sync_count()
    tasync.record_host_sync(3)
    assert c.value - before == 3 == tasync.host_sync_count() - s0
    assert jasync.host_sync_count() >= 0       # the packages count apart


def test_fleet_aggregator_scrapes_engines_once(models):
    """Two port engines in one process: each finished request is scraped
    once into the fleet metrics and the SLO window, with the straggler
    verdict over the replicas' tick times."""
    _, tm = models
    engines = [InferenceEngine(tm, device="cpu", batch_slots=2,
                               prefill_buckets=[8, 16]) for _ in range(2)]
    ps, new = prompts_for("dense")
    for i, eng in enumerate(engines):
        for p in ps[:i + 2]:
            eng.add_request(p, max_new_tokens=new)
        eng.run()
    mon = tslo.SLOMonitor(baseline_ttft_p99_ms=None)
    agg = tslo.FleetAggregator(engines, monitor=mon)
    out = agg.scrape()
    assert out["new_requests"] == 5 and agg.scrape()["new_requests"] == 0
    assert out["straggler"]["per_replica_ms"][0] > 0
    assert mon.check()["window"] == 5
    tokens = tmetrics.counter("fleet_tokens_total", labels=("replica",))
    for i, eng in enumerate(engines):
        want = sum(r["tokens"] for r in eng.request_stats.values())
        assert tokens.labels(replica=str(i)).value >= want > 0
