"""The port's autotune package, cost model and analyses against the JAX
package's on the CPU.

- knobs: the same registry; the axes with no single-GPU meaning stay out
  of the controller's default axes;
- the controller: on the synthetic objective surfaces of
  ``tests/test_autotune.py`` the port's and JAX's controllers give the
  same trial logs, configs, commits and rollbacks (each rollback with an
  ``autotune-rollback`` bundle), and no compile outside trials;
- the live tier: ``_merge`` / ``_mean_cost`` equal JAX's on the same
  times; the edge trigger, the cooldown and the quiesce gate behave as
  JAX's; an episode on a tiny warmed CPU engine (dense and paged) runs
  with no compile, keeps a subset of the warmed buckets, persists it,
  and the engine serves on; ``TrainerRetuner`` gives one advisory a
  regression, the same as JAX's;
- the cost model: the analytic flops of a train step, a prefill and a
  decode step equal ``profiler.cost_stats`` over the plain path exactly,
  under the stated terms (model flops over the full attention square;
  the plain flash backward's recomputed QK^T, 2 B H S^2 D a layer; the
  plain decode's attention over all ``max_seq_len`` positions, i.e. a
  context of ``max_seq_len - 1``); the analytic train bytes hold the
  op-level sum within 10%;
- ``profile()`` of an analyzed engine and trainer, and the doctor's
  roofline verdicts and actions equal to the JAX doctor's for the same
  stats dict;
- ``cost_stats`` / ``memory_stats`` degrade to ``{}`` and count the
  failure.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import os

import numpy as np
import pytest
import torch

from paddle_tpu.autotune import AutotuneController as JController
from paddle_tpu.autotune import live as jlive
from paddle_tpu.observability import doctor as jdoctor
from paddle_tpu.utils import tuning as jtuning

import paddle_tpu_torch.autotune as tautotune
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.autotune import AutotuneController as TController
from paddle_tpu_torch.autotune import knobs as tknobs
from paddle_tpu_torch.autotune import live as tlive
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.observability import cost_model
from paddle_tpu_torch.observability import doctor as tdoctor
from paddle_tpu_torch.observability import exec_registry as tregistry
from paddle_tpu_torch.observability import flightrec as tflightrec
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability.slo import SLOMonitor
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.utils import compile_counter as tcc
from paddle_tpu_torch.utils import tuning as ttuning


@pytest.fixture
def tmp_tables(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("PADDLE_TPU_FLIGHTREC_DIR", str(tmp_path / "fr"))
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()
    yield tmp_path
    ttuning.reset_for_tests()
    jtuning.reset_for_tests()


# ---- knobs ----------------------------------------------------------------
def test_registry_matches_and_one_gpu_axes_are_not_eligible():
    from paddle_tpu.autotune.knobs import AXES as JAXES
    assert set(tknobs.AXES) == set(JAXES)
    for name, ax in tknobs.AXES.items():
        j = JAXES[name]
        assert (ax.kinds, ax.candidates, ax.env, ax.table_op,
                ax.hot_apply) == (j.kinds, j.candidates, j.env,
                                  j.table_op, j.hot_apply)
    for kind in ("train", "serve"):
        assert not set(tknobs.eligible(kind)) & set(tknobs.NOT_ON_ONE_GPU)
    assert "remat_policy" in tknobs.eligible("train")
    ctl = TController(lambda c: {"mfu": 0.1}, kind="train")
    assert set(ctl.axes) == set(tknobs.eligible("train"))


# ---- the controller against JAX's -------------------------------------------
START = {"quantize": None, "remat_policy": "dots_no_batch",
         "overlap": False, "prefetch_depth": 2, "scan": True}


def _objective(cfg):
    mfu = 0.30
    mfu += 0.05 if cfg["quantize"] == "int8" else 0.0
    mfu += 0.04 if cfg["remat_policy"] == "off" else 0.0
    mfu += 0.03 if cfg["overlap"] else 0.0
    if cfg["prefetch_depth"] == 4:
        mfu += 0.02
    elif cfg["prefetch_depth"] == 0:
        mfu -= 0.20
    return round(mfu, 6)


def _verdicts(cfg):
    v = []
    if cfg["quantize"] != "int8":
        v.append({"bottleneck": "mfu-below-target", "score": 0.9,
                  "action": {"op": "qmm_tiles", "param": "quantize",
                             "env": "BENCH_QUANTIZE",
                             "candidates": ["int8"]}})
    if cfg["remat_policy"] != "off":
        v.append({"bottleneck": "mfu-below-target", "score": 0.8,
                  "action": {"op": "remat_policy", "param": "remat_policy",
                             "env": None, "candidates": ["off"]}})
    if not cfg["overlap"]:
        v.append({"bottleneck": "comm-bound", "score": 0.7,
                  "action": {"op": None, "param": "overlap",
                             "env": "PADDLE_TPU_OVERLAP",
                             "candidates": [True]}})
    if cfg["prefetch_depth"] != 4:
        v.append({"bottleneck": "data-starved", "score": 0.6,
                  "action": {"op": None, "param": "prefetch_depth",
                             "env": "PADDLE_TPU_PREFETCH_DEPTH",
                             "candidates": [0, 4]}})
    v.append({"bottleneck": "host-sync-bound", "score": 0.55,
              "action": {"op": None, "param": None, "env": None,
                         "candidates": []}})
    v.append({"bottleneck": "mfu-below-target", "score": 0.5,
              "action": {"op": None, "param": "scan", "env": None,
                         "candidates": [False]}})
    return v


def _measure(cfg):
    return {"mfu": _objective(cfg), "doctor": _verdicts(cfg),
            "xla_compiles_measured": 7 if cfg["scan"] is False else 0}


def _both(measure, start, root=None, **kw):
    """The JAX and the port controller over one surface, each with its
    own bundles directory under ``root``."""
    out = []
    for ctl_cls, fr, tuning in ((JController, "fr_jax", jtuning),
                                (TController, "fr_port", ttuning)):
        if root is not None:
            os.environ["PADDLE_TPU_FLIGHTREC_DIR"] = str(root / fr)
        ctl = ctl_cls(measure, **kw)
        out.append((ctl.run(dict(start)), tuning))
    return out


def _bundles(d):
    return [b for b in tflightrec.find_bundles(str(d))
            if b.endswith("autotune-rollback")]


@pytest.mark.parametrize("noise", [0.02, 0.2])
def test_controller_matches_jax_on_the_synthetic_surface(tmp_tables, noise):
    kw = dict(kind="train", objective_key="mfu", noise_floor=noise,
              run_id="t-run",
              commit_keys={"remat_policy":
                           ("remat_policy", ("t", "64", "2", "32"))},
              axes=["quantize", "remat_policy", "overlap",
                    "prefetch_depth", "scan"])
    (js, _), (ts, _) = _both(_measure, START, root=tmp_tables, **kw)
    keys = ("axis", "value", "outcome", "reason", "objective",
            "improvement", "bottleneck", "compiles")
    assert [{k: t.get(k) for k in keys} for t in ts["trials"]] == \
        [{k: t.get(k) for k in keys} for t in js["trials"]]
    for k in ("config", "best", "baseline", "improvement", "accepted",
              "rolled_back", "committed", "converged", "measured_trials"):
        assert ts[k] == js[k], k
    assert ts["compiles_outside_trials"] == 0
    n_rb = ts["rolled_back"]
    # every rollback shipped a bundle, in each package
    for fr in ("fr_jax", "fr_port"):
        assert len(_bundles(tmp_tables / fr)) == n_rb
    if noise == 0.02:
        assert ts["accepted"] == 4 and n_rb == 2
        _fresh = ttuning.reset_for_tests
        _fresh()
        meta = ttuning.provenance("remat_policy", ("t", "64", "2", "32"))
        assert meta["source"] == "autotune" and meta["run"] == "t-run"


def test_controller_minimize_error_and_missing_objective(tmp_tables):
    def measure(cfg):
        if cfg.get("overlap"):
            raise RuntimeError("watchdog: stalled")
        ms = 10.0 - (3.0 if cfg["kv_dtype"] == "int8" else 0.0)
        return {"ttft_ms": ms, "doctor": [
            {"bottleneck": "kv-pressure", "score": 0.9,
             "action": {"op": None, "param": "kv_dtype", "env": None,
                        "candidates": ["int8"]}},
            {"bottleneck": "comm-bound", "score": 0.5,
             "action": {"op": None, "param": "overlap", "env": None,
                        "candidates": [True]}}]}
    (js, _), (ts, _) = _both(measure, {"kv_dtype": "dense",
                                       "overlap": False},
                             kind="serve", objective_key="ttft_ms",
                             maximize=False, noise_floor=0.02,
                             axes=["kv_dtype", "overlap"])
    assert ts["config"] == js["config"] == {"kv_dtype": "int8",
                                            "overlap": False}
    assert [(t["outcome"], t.get("reason")) for t in ts["trials"]] == \
        [(t["outcome"], t.get("reason")) for t in js["trials"]]
    assert ts["trials"][-1]["reason"] == "error" and \
        "watchdog" in ts["trials"][-1]["error"]
    s = TController(lambda cfg: {"rows": []},
                    axes=["overlap"]).run({"overlap": False})
    assert "error" in s and s["measured_trials"] == 0


def test_controller_counts_compiles_outside_trials(tmp_tables):
    def measure(cfg):
        return {"mfu": 0.3 + (0.1 if cfg["prefetch_depth"] == 4 else 0),
                "doctor": [{"bottleneck": "data-starved", "score": 0.5,
                            "action": {"param": "prefetch_depth",
                                       "candidates": [4]}}]}
    ctl = TController(measure, noise_floor=0.02, axes=["prefetch_depth"])
    real = ctl._measure_window

    def window(cfg, label):
        tcc.note("step_kind", where="between trials")
        return real(cfg, label)
    ctl._measure_window = window
    s = ctl.run({"prefetch_depth": 2})
    assert s["compiles_outside_trials"] == 2 and s["accepted"] == 1


# ---- the live tier -----------------------------------------------------------
class FakeEngine:
    kv_layout = "dense"
    max_seq_len = 64
    batch_slots = 2

    def __init__(self, buckets=(8, 16, 64)):
        self.buckets = sorted(buckets)
        self._queue = []
        self.num_active = 0


def test_merge_and_mean_cost_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(50):
        bs = sorted(set(int(b) for b in 2 ** rng.randint(3, 12, 5)))
        times = {b: float(rng.uniform(0.1, 5.0)) for b in bs}
        kept = tlive.LiveRetuner._merge(bs, times)
        assert kept == jlive.LiveRetuner._merge(bs, times)
        for lst in (bs, kept):
            assert tlive.LiveRetuner._mean_cost(lst, times) == \
                jlive.LiveRetuner._mean_cost(lst, times)


def _signal_script(mod, monkeypatch):
    """One script of SLO verdicts and ticks; what each call returned."""
    eng = FakeEngine()
    r = mod.LiveRetuner(eng, cooldown_s=3600.0)
    ran = []
    monkeypatch.setattr(r, "_episode", lambda: ran.append(1))
    healthy = {"regressed": False, "breached": False}
    bad = {"regressed": True, "p99_ms": 99.0}
    out = [r.on_tick(), r.notify_slo(healthy), r.notify_slo(bad)]
    out += [r.notify_slo(bad) for _ in range(3)]
    eng.num_active = 1
    out.append(r.on_tick())
    eng.num_active, eng._queue = 0, ["queued"]
    out.append(r.on_tick())
    eng._queue = []
    out += [r.on_tick(), r.on_tick()]
    # healthy resets the latch; the cooldown then suppresses a signal
    out += [r.notify_slo(healthy), r.notify_slo(bad), r._pending]
    r.cooldown_s = 0.0
    out += [r.notify_slo(healthy), r.notify_slo(bad), r._pending]
    return out, ran


def test_edge_trigger_cooldown_and_quiesce_match_jax(monkeypatch):
    got, ran = _signal_script(tlive, monkeypatch)
    want, jran = _signal_script(jlive, monkeypatch)
    assert got == want and ran == jran == [1]
    assert got[2] is True and not any(got[3:6])


def test_episode_hot_applies_and_persists(tmp_tables, monkeypatch):
    eng = FakeEngine([8, 16, 64])
    r = tlive.LiveRetuner(eng)
    monkeypatch.setattr(r, "_time_buckets",
                        lambda bs: {8: 2.0, 16: 1.0, 64: 5.0})
    r._pending = True
    assert r.on_tick() is True
    assert eng.buckets == [16, 64] and r.applied[0]["improvement"] > 0.02
    assert r.last_episode["merged"] == [16, 64]
    ttuning.reset_for_tests()
    assert ttuning.lookup("prefill_buckets", ("cpu", 64)) == [16, 64]
    meta = ttuning.provenance("prefill_buckets", ("cpu", 64))
    assert meta["source"] == "autotune" and meta["run"] == "live-1"
    # a failing episode keeps the list, counts the failure, leaves a bundle
    monkeypatch.setattr(r, "_time_buckets", lambda bs: 1 / 0)
    r._pending = True
    assert r.on_tick() is True and eng.buckets == [16, 64]
    assert r.failures and "ZeroDivisionError" in r.failures[0]
    assert len(_bundles(tmp_tables / "fr")) == 1


def test_arm_gating_follows_env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE", raising=False)
    assert tautotune.autotune_mode() == "off"
    assert tlive.arm_engine(FakeEngine()) is None
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "once")
    assert tlive.arm_engine(FakeEngine()) is None
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "Live")
    assert isinstance(tlive.arm_engine(FakeEngine()), tlive.LiveRetuner)


class FakeTrainer:
    _timings = {"dispatch_ms": 100.0, "sync_ms": 900.0,
                "data_wait_ms": 0.0, "steps_timed": 64}


def test_trainer_retuner_one_advisory_like_jax(tmp_tables):
    advice = []
    for mod in (jlive, tlive):
        r = mod.TrainerRetuner(FakeTrainer(), window=4, cooldown_steps=0)
        fired = [r.on_step(10.0) for _ in range(8)]
        fired += [r.on_step(30.0) for _ in range(8)]
        assert sum(fired) == 1 and r.episodes == 1
        advice.append(r.last_advice)
    assert advice[0] == advice[1]
    assert advice[1][0]["bottleneck"] == "host-sync-bound"


def _tiny(layers=2, vocab=97, hidden=32, seq=64):
    cfg = GPTConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                    num_heads=4, max_seq_len=seq)
    return GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                          generator=prandom.seed(3, "cpu"))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_live_episode_on_a_cpu_engine(tmp_tables, monkeypatch, layout):
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "live")
    model = _tiny()
    kw = dict(kv_layout="paged", kv_block_size=8) if layout == "paged" \
        else {}
    eng = InferenceEngine(model, device="cpu", batch_slots=2,
                          prefill_buckets=[8, 16, 32], **kw)
    eng.warmup(eng.buckets)
    prompt = np.arange(1, 6, dtype=np.int32)
    before = eng.generate(prompt, max_new_tokens=4)
    r = eng._retuner
    assert isinstance(r, tlive.LiveRetuner)
    mon = SLOMonitor(ttft_p99_ms=1e-6).add_listener(r.notify_slo)
    mon.observe(5.0)
    assert mon.check()["breached"] and r._pending
    old = list(eng.buckets)
    with tcc.assert_no_recompiles("live episode"):
        eng.step()                      # the tick hook runs the episode
    assert r.episodes == 1 and not r.failures
    assert set(eng.buckets) <= set(old) and eng.buckets[-1] == old[-1]
    assert set(r.last_episode["times_ms"]) == set(old)
    # the engine serves on; bucket 8 (5 tokens) kept: the same tokens
    after = eng.generate(prompt, max_new_tokens=4)
    if 8 in eng.buckets:
        assert np.array_equal(after, before)
    assert eng.check_leak_free() is None if layout == "paged" else True
    # a second signal inside the cooldown schedules nothing
    mon.observe(5.0)
    mon.check()
    assert not r._pending


# ---- the cost model against cost_stats over the plain path ------------------
def test_train_step_flops_equal_cost_stats():
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=32)
    model = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=prandom.seed(1, "cpu"))
    st = DistributedStrategy()
    st.amp = True
    crit = GPTPretrainingCriterion()
    tr = SpmdTrainer(model, topt.Adam(learning_rate=1e-3),
                     lambda o, lab: crit(o, lab), strategy=st)
    b, s = 2, 32
    ids = np.random.RandomState(0).randint(0, 256, (b, s))
    tr.train_step(ids, np.roll(ids, -1, 1))
    got = tprofiler.cost_stats(tr.train_step, ids, np.roll(ids, -1, 1))
    want = cost_model.gpt_step_cost(cfg, "train_step", batch=b, seq=s)
    recompute = 2 * b * s * s * cfg.hidden_size * cfg.num_layers
    assert got["flops"] == want["flops"] + recompute
    # bytes at a sequence of 4: the plain attention's S x S intermediates,
    # which rows 1-3 never store, are not in the model
    ids = np.random.RandomState(1).randint(0, 256, (16, 4))
    tr.train_step(ids, np.roll(ids, -1, 1))
    got = tprofiler.cost_stats(tr.train_step, ids, np.roll(ids, -1, 1))
    want4 = cost_model.gpt_step_cost(cfg, "train_step", batch=16, seq=4)
    assert abs(got["bytes_accessed"] / want4["bytes_accessed"] - 1) < 0.1
    ids = np.random.RandomState(0).randint(0, 256, (b, s))
    tr.train_step(ids, np.roll(ids, -1, 1))
    # the registry's analysis is the same cost model
    assert tregistry.analyze_all(tr._exec_component) == 1
    prof = tregistry.profile(tr._exec_component)
    assert prof["train_step"]["flops"] == want["flops"]
    assert prof["_peaks"]["peaks_nominal"]


def test_serve_step_flops_equal_cost_stats():
    model = _tiny(layers=2, vocab=97, hidden=32, seq=64).to(torch.bfloat16)
    cfg = model.cfg
    cache = model.init_kv_cache(4, cfg.max_seq_len)
    with torch.no_grad():
        p = tprofiler.cost_stats(model.prefill,
                                 torch.zeros(1, 16, dtype=torch.int64),
                                 cache, 0, 16)
        d = tprofiler.cost_stats(model.decode_step,
                                 torch.zeros(4, dtype=torch.int64), cache,
                                 torch.ones(4, dtype=torch.int32))
    assert p["flops"] == cost_model.gpt_step_cost(cfg, "prefill",
                                                  seq=16)["flops"]
    assert d["flops"] == cost_model.gpt_step_cost(
        cfg, "decode", batch=4, context=cfg.max_seq_len - 1)["flops"]


def test_engine_profile_and_doctor_actions_match_jax(tmp_tables,
                                                     monkeypatch):
    model = _tiny(seq=64)
    eng = InferenceEngine(model, device="cpu", batch_slots=2,
                          prefill_buckets=[8, 16])
    for i in range(3):
        eng.generate(np.arange(1, 6 + i, dtype=np.int32), max_new_tokens=12)
    assert eng.stats()["exec_profile"] is None      # not analyzed yet
    assert tregistry.analyze_all(eng._exec_component) == 3
    st = eng.stats()
    prof = st["exec_profile"]
    assert {"prefill", "decode", "sample"} <= set(prof)
    dec = prof["decode"]
    assert dec["bound"] in ("compute", "bandwidth") and dec["mfu"] > 0
    # the doctor's roofline rules on this digest, forced past the nominal
    # host peaks, against the JAX doctor on the same dict
    monkeypatch.setenv("PADDLE_TPU_ROOFLINE_DOCTOR", "1")
    for kind in ("serve", None):
        assert tdoctor.diagnose(st, kind) == jdoctor.diagnose(st, kind)
    train = {"exec_profile": {
        "train_step": {"mfu": 0.2854, "bound": "bandwidth",
                       "arithmetic_intensity": 110.0, "ridge_ai": 295.2,
                       "mean_ms": 245.5, "hbm_bw_frac": 0.8},
        "_peaks": {"peaks_nominal": False, "device_kind": "h100"}}}
    v = tdoctor.diagnose(train, "train")
    assert v == jdoctor.diagnose(train, "train")
    assert v[0]["bottleneck"] == "mfu-below-target" and \
        v[0]["action"]["param"] == "remat_policy"


def test_analyses_degrade_and_count():
    fails = tmetrics.counter("exec_analysis_failures_total", "",
                             labels=("stage",))
    c0 = fails.labels(stage="cost_analysis").value
    m0 = fails.labels(stage="memory_analysis").value
    assert tprofiler.cost_stats(42) == {}
    assert tprofiler.cost_stats(lambda: 1 / 0) == {}
    assert tprofiler.memory_stats(object()) == {}
    assert fails.labels(stage="cost_analysis").value == c0 + 2
    assert fails.labels(stage="memory_analysis").value == m0 + 1
    lin = torch.nn.Linear(8, 4)
    x = torch.ones(3, 8)
    c = tprofiler.cost_stats(lin, x)
    assert c["flops"] == 2 * 3 * 8 * 4
    # on fake tensors nothing computes; the count is the same
    assert tprofiler.cost_stats(lin, x, fake=True)["flops"] == c["flops"]
    m = tprofiler.memory_stats(lin, x)
    assert m["argument_bytes"] == 4 * (3 * 8 + 8 * 4 + 4) and \
        m["output_bytes"] == 4 * 3 * 4
    # an owner gone: timing-only, counted
    reg = tregistry.ExecRegistry()

    class Owner:
        pass
    o = Owner()
    reg.note_call("c", ("x", 1), "decode", 1.0, owner=o)
    del o
    e = reg.entries("c")[0]
    assert reg.analyze(e) is False and e.analysis_error == "owner released"
