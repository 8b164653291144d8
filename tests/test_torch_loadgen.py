"""The port's open-loop load generator against the JAX package's, on the
CPU.

``SharedPrefixWorkload`` must draw the JAX workload's prompts for the
same seed; ``run_loadtest``'s report must carry the JAX report's keys
(``slo`` and ``doctor`` included; the MoE columns are absent from both
for a dense model) with the same deterministic
values (requests, tokens, timed-out requests); the timed-out column and
the ITL columns behave as in the JAX tests.  Times are only held to be
ordered and non-negative.
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
from paddle_tpu_torch.inference import (InferenceEngine,
                                        SharedPrefixWorkload, run_loadtest)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, initializer_range=0.2)
FORMS = {
    "dense": dict(batch_slots=2, prefill_buckets=[16]),
    "paged": dict(batch_slots=2, prefill_buckets=[16], kv_layout="paged",
                  kv_block_size=4),
    "chunked": dict(batch_slots=2, prefill_buckets=[16], prefill_chunk=4),
}
WORKLOAD = dict(seed=0, shared_frac=0.5, prefix_len=8, tail_len=(3, 6),
                max_new=(2, 4))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


def both(models, form):
    jm, tm = models
    return (JaxEngine(jm, **FORMS[form]),
            InferenceEngine(tm, device="cpu", **FORMS[form]))


@pytest.mark.parametrize("vocab,kw", [
    (97, dict(seed=0)),
    (97, WORKLOAD),
    (97, dict(seed=3, shared_frac=0.0, prefix_len=0, tail_len=(1, 4),
              max_new=(1, 1))),
    (50304, dict(seed=11, shared_frac=0.5, prefix_len=1024,
                 tail_len=(32, 512), max_new=(16, 64))),
], ids=["defaults", "small", "no-prefix", "chip-A"])
def test_workload_draws_jax_prompts(vocab, kw):
    want, got = JaxWorkload(vocab, **kw), SharedPrefixWorkload(vocab, **kw)
    assert np.array_equal(got.system_prefix, want.system_prefix)
    assert got.system_prefix.dtype == np.int32
    for _ in range(48):
        (wp, wn), (gp, gn) = want.sample(), got.sample()
        assert np.array_equal(gp, wp) and gp.dtype == np.int32
        assert gn == wn


@pytest.mark.parametrize("form", list(FORMS))
def test_report_has_jax_keys_and_values(models, form):
    """The same workload at 200 rps through both engines: the port's
    report has the JAX keys, an ``slo`` verdict of the same keys and a
    ``doctor`` verdict list, the same
    requests, tokens and timed-out count, ordered percentiles and a
    window-scoped prefix hit rate; a drained paged pool is leak-free."""
    jeng, eng = both(models, form)
    want = jax_run_loadtest(jeng, 8, 200.0, workload=JaxWorkload(
        97, **WORKLOAD), deadline_s=30.0)
    got = run_loadtest(eng, 8, 200.0, workload=SharedPrefixWorkload(
        97, **WORKLOAD), deadline_s=30.0)
    moe = {k for k in want if k.startswith("moe_") or k == "ep"}
    assert moe == set()          # a dense model reports no MoE columns
    assert set(got) == set(want)
    assert set(got["slo"]) == set(want["slo"])
    assert got["slo"]["window"] == want["slo"]["window"] == 8
    assert isinstance(got["doctor"], list)
    for key in ("num_requests", "tokens_generated", "timed_out_requests",
                "offered_rps", "deadline_s", "kv_layout", "kv_block_size",
                "kv_blocks_total", "prefix_queries"):
        assert got.get(key) == want.get(key), key
    assert got["num_requests"] == 8 and got["timed_out_requests"] == 0
    assert got["ttft_ms_p99"] >= got["ttft_ms_p50"] >= 0
    assert got["itl_ms_p99"] >= got["itl_ms_p50"] >= 0
    assert got["tokens_per_sec"] > 0 and got["achieved_rps"] > 0
    assert 0 < got["slot_occupancy"] <= 1
    assert got["preemptions"] == 0
    if form == "paged":
        assert 0 <= got["prefix_hit_rate"] <= 1
        assert 0 < got["block_occupancy"] <= 1
    # the engine's records were consumed as they retired
    assert eng.request_stats == {} and eng.results == {}
    assert eng.drain() == []
    eng.check_leak_free()


@pytest.mark.parametrize("form", list(FORMS))
def test_loadtest_reports_timed_out_column(models, form):
    """JAX's timed-out column test on both engines: 0 of 6 at a 30 s
    deadline, 6 of 6 at 0.0 (each expires in the queue), tokens/s still
    reported."""
    seen = []
    for eng in both(models, form):
        run = jax_run_loadtest if isinstance(eng, JaxEngine) else run_loadtest
        wl = JaxWorkload if isinstance(eng, JaxEngine) else \
            SharedPrefixWorkload
        kw = dict(seed=0, shared_frac=0.0, prefix_len=4, tail_len=(3, 6),
                  max_new=(2, 4))
        report = run(eng, num_requests=6, rate_rps=200.0,
                     workload=wl(97, **kw), deadline_s=30.0)
        assert report["deadline_s"] == 30.0
        assert report["timed_out_requests"] == 0
        report2 = run(eng, num_requests=6, rate_rps=200.0,
                      workload=wl(97, **kw), deadline_s=0.0)
        assert report2["timed_out_requests"] == 6
        assert report2["tokens_generated"] == 0
        assert report2["ttft_ms_p50"] is None
        assert report2["tokens_per_sec"] is not None
        seen.append((report["tokens_generated"], report2["num_requests"]))
    assert seen[1] == seen[0]


def test_loadtest_report_itl_columns(models):
    """A chunked, warmed engine: the report's ITL percentiles are there
    and ordered, as in the JAX test."""
    jm, tm = models
    kw = dict(batch_slots=2, prefill_buckets=[16], prefill_chunk=4)
    wkw = dict(seed=0, shared_frac=0.0, prefix_len=8, tail_len=(3, 10),
               max_new=(4, 8))
    jeng = JaxEngine(jm, **kw)
    jeng.warmup()
    want = jax_run_loadtest(jeng, 8, 200.0, workload=JaxWorkload(97, **wkw))
    eng = InferenceEngine(tm, device="cpu", **kw).warmup()
    rep = run_loadtest(eng, 8, 200.0, workload=SharedPrefixWorkload(97, **wkw))
    assert rep["itl_ms_p50"] is not None
    assert rep["itl_ms_p99"] >= rep["itl_ms_p50"] >= 0
    assert rep["num_requests"] == 8
    assert rep["tokens_generated"] == want["tokens_generated"]
    assert eng.stats()["prefill_stall_ms"] == 0
