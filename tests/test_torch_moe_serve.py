"""The port's MoE serving against the JAX package's, on the CPU.

A tiny GPT-MoE (every second block MoE, E = 4, top-2, capacity factor
1.0 so that prefills drop assignments) serves the same prompts through
the JAX engine and the port's, with weights moved by the port's bridge:
greedy streams must be identical and the expert-balance stats
(``moe_*``) equal, dense, paged, chunked and speculative (a dense draft),
after ``warmup()``.  Then the load report's ``moe_*`` columns, the
doctor's ``expert-imbalance`` verdict on a low-capacity engine, the HBM
ledger's ``moe_experts`` line and the host reads per decode step.

Tolerance: none.  Routing decisions are discrete and the streams equal;
the loads are counts (exact), the rates and skews their ratios rounded
as the JAX engine rounds them.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference.loadgen import \
    SharedPrefixWorkload as JaxWorkload
from paddle_tpu.inference.loadgen import run_loadtest as jax_run_loadtest
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT

from paddle_tpu_torch.distributed import async_dispatch
from paddle_tpu_torch.inference import (InferenceEngine,
                                        SharedPrefixWorkload, run_loadtest)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.observability import exec_registry

MOE = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=64, initializer_range=0.2,
           moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
           moe_every_n_layers=2)
PROMPT_LENS = (3, 20, 9, 17, 33, 5)
MAX_NEW = (6, 4, 9, 5, 3, 7)
FORMS = {
    "dense": dict(batch_slots=2),
    "paged": dict(batch_slots=2, kv_layout="paged", kv_block_size=8),
    "chunked": dict(batch_slots=2, prefill_chunk=8),
    "spec": dict(batch_slots=2, spec_k=2),
}
MOE_KEYS = ("moe_num_experts", "moe_expert_load", "moe_dropped_rate",
            "moe_load_skew", "moe_assigned_tokens", "moe_dropped_tokens")


def pair(**over):
    kw = {**MOE, **over}
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**kw))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return pair()


@pytest.fixture(scope="module")
def drafts():
    """A one-layer dense draft of the same vocabulary."""
    return pair(num_layers=1, moe_num_experts=0)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(1, 97, (n,)).astype(np.int32) for n in PROMPT_LENS]


def serve(engine, prompts):
    rids = [engine.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, MAX_NEW)]
    out = engine.run()
    return [np.asarray(out[r]).tolist() for r in rids]


def engines(models, drafts, form):
    (jm, tm), kw = models, dict(FORMS[form])
    jkw, tkw = dict(kw), dict(kw)
    if form == "spec":
        jkw["draft_model"], tkw["draft_model"] = drafts
    return JaxEngine(jm, **jkw), InferenceEngine(tm, device="cpu", **tkw)


@pytest.mark.parametrize("form", list(FORMS))
def test_streams_and_expert_stats_equal_jax(models, drafts, prompts, form):
    """Both engines warmed, then 6 requests through 2 slots: identical
    greedy streams and equal ``moe_*`` stats (warmup's throwaway tokens
    counted by neither); assignments were dropped."""
    jeng, eng = engines(models, drafts, form)
    jeng.warmup()
    eng.warmup()
    assert eng.stats()["moe_expert_load"] is None       # nothing counted
    want = serve(jeng, prompts)
    got = serve(eng, prompts)
    assert got == want
    assert len({t for g in got for t in g}) > 5
    js, ts = jeng.stats, eng.stats()
    for key in MOE_KEYS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert ts["ep"] == js["ep"] == 1
    assert ts["moe_dropped_rate"] > 0
    assert sum(ts["moe_expert_load"]) + ts["moe_dropped_tokens"] == \
        ts["moe_assigned_tokens"]
    if form == "spec":
        assert ts["spec_ticks"] > 0
    if form == "paged":
        assert eng.drain() == []
        eng.check_leak_free()


def test_load_report_moe_columns_equal_jax(models):
    """One window through warmed paged engines, every request arriving
    before the first step: the report's ``moe_*`` columns (and ``ep``)
    equal the JAX report's; a second window is scoped to itself."""
    jm, tm = models
    kw = dict(batch_slots=2, prefill_buckets=[16, 32], kv_layout="paged",
              kv_block_size=4)
    wl = dict(seed=0, shared_frac=0.5, prefix_len=8, tail_len=(3, 6),
              max_new=(2, 4))
    jeng = JaxEngine(jm, **kw).warmup()
    eng = InferenceEngine(tm, device="cpu", **kw).warmup()
    for window in range(2):
        want = jax_run_loadtest(jeng, 6, 1e9, seed=window,
                                workload=JaxWorkload(97, **wl))
        got = run_loadtest(eng, 6, 1e9, seed=window,
                           workload=SharedPrefixWorkload(97, **wl))
        cols = {k for k in want if k.startswith("moe_") or k == "ep"}
        assert cols == {"moe_num_experts", "ep", "moe_assigned_tokens",
                        "moe_dropped_rate", "moe_expert_load",
                        "moe_load_skew"}
        assert {k for k in got if k.startswith("moe_") or k == "ep"} == cols
        for key in sorted(cols):
            assert got[key] == want[key], (window, key, got[key], want[key])
        assert got["tokens_generated"] == want["tokens_generated"]


def _imbalance(verdicts):
    return [v for v in verdicts if v["bottleneck"] == "expert-imbalance"]


def test_doctor_expert_imbalance_verdict_equals_jax(prompts):
    """A capacity factor of 0.25 drops most assignments: the port's
    doctor, fed by the port engine's ``stats()``, gives the verdict the
    JAX doctor gives on the JAX engine's stats."""
    jm, tm = pair(moe_capacity_factor=0.25)
    jeng = JaxEngine(jm, batch_slots=2)
    eng = InferenceEngine(tm, batch_slots=2, device="cpu")
    serve(jeng, prompts)
    serve(eng, prompts)
    want = _imbalance(jeng.stats["doctor"])
    got = _imbalance(eng.stats()["doctor"])
    assert len(want) == 1 and got == want
    assert got[0]["evidence"]["moe_dropped_rate"] > 0.05
    assert got[0]["action"]["param"] == "moe_capacity_factor"


def lines(engine):
    """The engine's ``moe_experts`` lines in the HBM ledger."""
    return [r for r in exec_registry.ledger().snapshot()["tracked"]
            if r["category"] == "moe_experts"
            and r["name"] == engine.telemetry_label]


def test_ledger_line_host_reads_and_dense_keys(models, prompts):
    """The ``moe_experts`` ledger line is the expert tensors' bytes (the
    JAX formula: E x (2 H F + F + H) per MoE layer, f32 here); a MoE
    engine reads the host once per decode step and admission, as a
    dense engine on the same prompts does; a dense engine reports no
    ``moe_*`` key and no ledger line."""
    _, tm = models
    eng = InferenceEngine(tm, batch_slots=2, device="cpu")
    h, f, e = MOE["hidden_size"], 4 * MOE["hidden_size"], 4
    line = lines(eng)
    assert len(line) == 1
    assert line[0]["bytes"] == 1 * e * (2 * h * f + f + h) * 4

    dense = GPTForCausalLM(GPTConfig(**{**MOE, "moe_num_experts": 0}),
                           device="cpu")
    counts = []
    for engine in (eng, InferenceEngine(dense, batch_slots=2, device="cpu")):
        async_dispatch.reset_host_sync_count()
        serve(engine, prompts)
        st = engine.stats()
        counts.append((async_dispatch.host_sync_count(), st["decode_steps"],
                       st["prefills"]))
    (moe_reads, steps, prefills), dense_counts = counts
    assert moe_reads == steps + prefills
    assert counts[0] == dense_counts
    assert not any(k.startswith("moe_") for k in st)
    assert lines(engine) == []
