"""The port's request lifecycle against the JAX package's, on the CPU.

Both engines serve the same converted weights and the same prompts:
drain (in-flight slots finish, the queue comes back in FIFO order),
drain with a timeout (force-retired partial output), the preemption
guard (SIGTERM mid-run parks the queue in ``undelivered``), deadlines
(queued and live requests past theirs retire ``timed_out``), the
per-request records, and ``warmup()`` followed by greedy tokens equal to
the JAX engine's and to an unwarmed port engine's.  Requests are
compared by position: request ids come from one counter per package.
Only orderings, non-negative times and deterministic deadlines (0.0,
one already passed, a generous 60.0) are asserted, never a wall time.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.distributed import PreemptionGuard
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, initializer_range=0.2)

FORMS = {
    "dense": dict(batch_slots=2, prefill_buckets=[8]),
    "paged": dict(batch_slots=2, prefill_buckets=[8], kv_layout="paged",
                  kv_block_size=8),
    "chunked": dict(batch_slots=2, prefill_buckets=[8], prefill_chunk=4),
}
RECORD_KEYS = {"prompt_tokens", "tokens", "ttft_ms", "queued_ms",
               "decode_tokens_per_sec", "itl_ms_p50", "itl_ms_p99",
               "itl_gaps_ms", "preemptions", "timed_out"}


def build_pair(seed=0, **over):
    kw = {**TINY, **over}
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(**kw))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return build_pair()


@pytest.fixture(scope="module")
def drafts():
    return build_pair(seed=1, num_layers=1)


def both(models, form, **over):
    """The JAX engine and the port's engine of one form."""
    jm, tm = models
    kw = {**FORMS[form], **over}
    return JaxEngine(jm, **kw), InferenceEngine(tm, device="cpu", **kw)


def stats_of(eng) -> dict:
    """``stats`` is a property of the JAX engine, a method of the port's."""
    return eng.stats() if callable(eng.stats) else eng.stats


def tokens(eng, rid):
    return np.asarray(eng.results[rid]).tolist()


# ---- drain ---------------------------------------------------------------

@pytest.mark.parametrize("form", list(FORMS))
def test_drain_finishes_inflight_and_returns_queued(models, form):
    """Two steps admit two requests; drain finishes them (a chunked
    engine's still-prefilling slots included), returns the other three in
    FIFO order and leaves the pool leak-free; the engine serves again."""
    seen = []
    for eng in both(models, form):
        rng = np.random.RandomState(3)
        rids = [eng.add_request(rng.randint(1, 97, (5,)), max_new_tokens=6)
                for _ in range(5)]
        for _ in range(2):
            eng.step()
        leftover = eng.drain()
        assert eng.num_active == 0 and not eng.has_work
        assert [r.rid for r in leftover] == rids[2:]
        assert [len(eng.results[r]) for r in rids[:2]] == [6, 6]
        eng.check_leak_free()
        late = eng.add_request(rng.randint(1, 97, (5,)), max_new_tokens=2)
        eng.run()
        st = stats_of(eng)
        seen.append(([tokens(eng, r) for r in rids[:2] + [late]],
                     st["deadline_retirements"],
                     st["drain_forced_retirements"]))
    assert seen[1] == seen[0]
    assert seen[1][1:] == (0, 0)


@pytest.mark.parametrize("form", list(FORMS))
def test_drain_timeout_force_retires_with_partial_output(models, form):
    """``drain(timeout_s=0.0)`` force-retires the bound slot: monolithic
    engines with the tokens they have, a chunked engine's slot still
    prefilling with none (and no TTFT)."""
    seen = []
    for eng in both(models, form, batch_slots=1):
        rid = eng.add_request(np.arange(1, 6, dtype=np.int32),
                              max_new_tokens=10_000)
        eng.step()
        assert eng.drain(timeout_s=0.0) == [] and eng.num_active == 0
        rec = eng.request_stats[rid]
        st = stats_of(eng)
        assert rec["timed_out"] and st["drain_forced_retirements"] == 1
        assert rec["queued_ms"] >= 0
        seen.append((tokens(eng, rid), rec["tokens"], rec["ttft_ms"] is None,
                     len(rec["itl_gaps_ms"])))
        eng.check_leak_free()
    assert seen[1] == seen[0]
    toks, n, no_ttft, n_gaps = seen[1]
    if form == "chunked":
        assert n == 0 and no_ttft and n_gaps == 0
    else:
        assert n >= 1 and not no_ttft and n_gaps == n - 1


# ---- the preemption guard --------------------------------------------------

@pytest.mark.parametrize("form", list(FORMS))
def test_preemption_guard_drains_server(models, form):
    """SIGTERM mid-run (sent to this process inside the guard's block):
    in-flight slots finish, the never-admitted requests land in
    ``undelivered`` and ``run()`` returns; a later guard's drain through
    ``step_or_raise`` accumulates into ``undelivered``."""
    seen = []
    for eng in both(models, form):
        rng = np.random.RandomState(4)
        rids = [eng.add_request(rng.randint(1, 97, (5,)), max_new_tokens=8)
                for _ in range(6)]
        with PreemptionGuard() as g:
            eng.attach_preemption_guard(g)
            eng.step()
            os.kill(os.getpid(), signal.SIGTERM)
            res = eng.run()
        assert g.preempted and g.signum == signal.SIGTERM
        assert eng.num_active == 0
        assert [r.rid for r in eng.undelivered] == rids[2:]
        done = [r for r in rids if r in res]
        assert done == rids[:2] and all(len(res[r]) == 8 for r in done)
        with PreemptionGuard() as g2:
            eng.attach_preemption_guard(g2)
            late = eng.add_request(rng.randint(1, 97, (5,)), max_new_tokens=4)
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(10):
                if not eng.has_work:
                    break
                eng.step_or_raise()
        assert not eng.has_work
        assert [r.rid for r in eng.undelivered] == rids[2:] + [late]
        seen.append([tokens(eng, r) for r in done])
    assert seen[1] == seen[0]


def test_generate_drains_on_a_fired_guard(models):
    """``generate`` on a preempted engine drains and returns what exists:
    nothing for a request that never took a slot."""
    seen = []
    for eng in both(models, "dense", batch_slots=1):
        busy = eng.add_request(np.arange(1, 6, dtype=np.int32),
                               max_new_tokens=5)
        with PreemptionGuard() as g:
            eng.attach_preemption_guard(g)
            eng.step()
            os.kill(os.getpid(), signal.SIGTERM)
            out = eng.generate(np.arange(2, 7, dtype=np.int32),
                               max_new_tokens=3)
        assert np.asarray(out).size == 0 and len(eng.undelivered) == 1
        seen.append(tokens(eng, busy))
    assert seen[1] == seen[0] and len(seen[1]) == 5


def test_guard_second_signal_falls_through_and_off_main_thread():
    """A second signal reaches the previous handler; installed off the
    main thread the guard changes nothing and never fires."""
    calls = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: calls.append(s))
    try:
        with PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert g.preempted and calls == []
            os.kill(os.getpid(), signal.SIGUSR1)
            assert calls == [signal.SIGUSR1]
        box = []
        t = threading.Thread(target=lambda: box.append(
            PreemptionGuard(signals=(signal.SIGUSR1,)).install()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and not box[0].preempted
        assert box[0]._prev == {}
    finally:
        signal.signal(signal.SIGUSR1, prev)


# ---- deadlines -------------------------------------------------------------

@pytest.mark.parametrize("form", list(FORMS))
def test_deadline_expires_queued_and_active(models, form):
    """A queued request with ``deadline_s=0.0`` is delivered empty at the
    next sweep (no slot, no TTFT); a live request whose deadline has
    passed is retired mid-generation with its partial tokens; a generous
    deadline never fires."""
    seen = []
    for eng in both(models, form, batch_slots=1):
        rng = np.random.RandomState(5)
        r_active = eng.add_request(rng.randint(1, 97, (5,)),
                                   max_new_tokens=10_000, deadline_s=60.0)
        r_queued = eng.add_request(rng.randint(1, 97, (5,)),
                                   max_new_tokens=4, deadline_s=0.0)
        for _ in range(3):
            eng.step_or_raise()
        assert r_queued in eng.results and r_active not in eng.results
        live = eng._slots[0]
        assert live.rid == r_active
        live.deadline = time.perf_counter()          # already passed
        eng.step_or_raise()
        ra, rq = eng.request_stats[r_active], eng.request_stats[r_queued]
        assert ra["timed_out"] and 0 < ra["tokens"] < 10_000
        assert rq["timed_out"] and rq["tokens"] == 0 and rq["ttft_ms"] is None
        assert rq["itl_gaps_ms"] == [] and rq["queued_ms"] >= 0
        assert stats_of(eng)["deadline_retirements"] == 2
        assert eng.num_active == 0 and not eng.has_work
        out = eng.generate(rng.randint(1, 97, (5,)), max_new_tokens=3,
                           deadline_s=60.0)
        assert len(out) == 3
        assert stats_of(eng)["deadline_retirements"] == 2
        seen.append((tokens(eng, r_active), np.asarray(out).tolist()))
    assert seen[1] == seen[0]


# ---- per-request records -----------------------------------------------------

@pytest.mark.parametrize("form", list(FORMS))
def test_per_request_records_match_jax(models, form):
    """Every finished request leaves a record with the JAX keys; its
    tokens, gaps (one fewer than its tokens) and preemptions equal the
    JAX engine's, and the pooled TTFT and ITL percentiles are ordered."""
    rng = np.random.RandomState(3)
    work = [(rng.randint(1, 97, (n,)).astype(np.int32), mn)
            for n, mn in zip((5, 9, 7, 11, 6), (6, 8, 10, 7, 9))]
    seen = []
    for eng in both(models, form, prefill_buckets=[16]):
        rids = [eng.add_request(p, max_new_tokens=mn) for p, mn in work]
        eng.run()
        st = stats_of(eng)
        recs = [st["per_request"][r] for r in rids]
        for rec, (p, mn) in zip(recs, work):
            assert RECORD_KEYS <= set(rec)
            assert rec["tokens"] == mn and rec["prompt_tokens"] == p.size
            assert len(rec["itl_gaps_ms"]) == mn - 1
            assert rec["itl_ms_p99"] >= rec["itl_ms_p50"] >= 0
            assert rec["ttft_ms"] >= rec["queued_ms"] >= 0
            assert rec["decode_tokens_per_sec"] > 0
            assert not rec["timed_out"]
        assert st["ttft_ms_p99"] >= st["ttft_ms_p50"] >= 0
        assert st["itl_ms_p99"] >= st["itl_ms_p50"] >= 0
        assert 0 < st["slot_occupancy"] <= 1
        assert {"per_request", "slot_occupancy", "occupancy_sum",
                "deadline_retirements", "drain_forced_retirements",
                "ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50",
                "itl_ms_p99"} <= set(st)
        seen.append(([tokens(eng, r) for r in rids],
                     [r["preemptions"] for r in recs],
                     sorted(k for k in recs[0] if k in RECORD_KEYS)))
    assert seen[1] == seen[0]


def test_per_request_preemptions_match_jax(models):
    """A 6-block pool that runs dry mid-decode: the same requests are
    preempted as in the JAX engine, each record counts its preemptions,
    and a resumed request still has one gap per token after its first."""
    kw = dict(batch_slots=3, prefill_buckets=[8, 32], kv_layout="paged",
              kv_block_size=8, kv_num_blocks=6, prefix_cache=False)
    jm, tm = models
    rng = np.random.RandomState(7)
    ps = [rng.randint(1, 97, (7,)).astype(np.int32) for _ in range(3)]
    seen = []
    for eng in (JaxEngine(jm, **kw), InferenceEngine(tm, device="cpu", **kw)):
        rids = [eng.add_request(p, max_new_tokens=14) for p in ps]
        eng.run()
        recs = [eng.request_stats[r] for r in rids]
        assert all(len(r["itl_gaps_ms"]) == 13 for r in recs)
        seen.append(([tokens(eng, r) for r in rids],
                     [r["preemptions"] for r in recs]))
        eng.check_leak_free()
    assert seen[1] == seen[0] and sum(seen[1][1]) > 0


def test_request_history_is_bounded(models):
    _, tm = models
    eng = InferenceEngine(tm, batch_slots=2, device="cpu")
    eng._request_stats_cap, eng._results_cap = 2, 3
    rids = [eng.add_request(np.arange(1, 4 + i, dtype=np.int32),
                            max_new_tokens=2) for i in range(5)]
    eng.run()
    assert list(eng.request_stats) == rids[-2:]
    assert list(eng.results) == rids[-3:]


# ---- warmup ------------------------------------------------------------------

WARM_FORMS = {
    "dense": dict(prefill_buckets=[8, 16]),
    "paged": dict(prefill_buckets=[8, 16], kv_layout="paged",
                  kv_block_size=8),
    "chunked": dict(prefill_buckets=[8, 16], prefill_chunk=4),
    "chunked-paged": dict(prefill_buckets=[8, 16], prefill_chunk=4,
                          kv_layout="paged", kv_block_size=8),
    "spec": dict(prefill_buckets=[8, 16], spec_k=2),
    "spec-paged": dict(prefill_buckets=[8, 16], spec_k=2, kv_layout="paged",
                       kv_block_size=8),
}


@pytest.mark.parametrize("form", list(WARM_FORMS))
def test_warmup_then_tokens_equal_jax_and_unwarmed(models, drafts, form):
    """``warmup()`` leaves the engine clean (lengths 0, every block back in
    the pool, an empty radix cache, no counters moved) and the greedy
    streams that follow equal the JAX engine's after its warmup and an
    unwarmed port engine's; paged pools end leak-free."""
    (jm, tm), (jd, td) = models, drafts
    kw = dict(batch_slots=2, **WARM_FORMS[form])
    spec = "spec_k" in kw
    jeng = JaxEngine(jm, **kw, **({"draft_model": jd} if spec else {}))
    jeng.warmup()

    def port():
        return InferenceEngine(tm, device="cpu", **kw,
                               **({"draft_model": td} if spec else {}))

    eng, cold = port(), port()
    before = eng.stats()
    assert eng.warmup([8, 16]) is eng
    if eng.kv_layout == "dense":
        assert not eng.cache.lengths.any()
    else:
        assert eng._alloc.num_free == eng._alloc.capacity
        assert len(eng._prefix) == 0
        assert not eng._tables.any()
    if spec:
        assert not eng._spec.draft_cache.lengths.any()
    after = eng.stats()
    for key in ("prefills", "prefill_tokens", "decode_steps", "host_syncs",
                "chunk_ticks"):
        assert after[key] == before[key], key

    rng = np.random.RandomState(9)
    prefix = rng.randint(1, 97, (8,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(1, 97, (n,))]).astype(
        np.int32) for n in (3, 6)] + [
        rng.randint(1, 97, (n,)).astype(np.int32) for n in (5, 12, 2)]

    def serve(e):
        rids = [e.add_request(p, max_new_tokens=7) for p in prompts]
        out = e.run()
        return [np.asarray(out[r]).tolist() for r in rids]

    got = serve(eng)
    assert got == serve(jeng) == serve(cold)
    assert all(len(g) == 7 for g in got)
    st, st_cold = eng.stats(), cold.stats()
    for key in ("prefills", "decode_steps", "host_syncs"):
        assert st[key] == st_cold[key], key
    if eng.kv_layout == "paged":
        assert st["prefix_hit_queries"] == st_cold["prefix_hit_queries"]
        eng.check_leak_free()


def test_warmup_refuses_a_busy_engine(models):
    _, tm = models
    eng = InferenceEngine(tm, batch_slots=2, device="cpu")
    eng.add_request(np.arange(1, 5, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="before traffic"):
        eng.warmup()


# ---- host syncs ----------------------------------------------------------------

@pytest.mark.parametrize("form", ["dense", "paged", "chunked", "spec"])
def test_one_host_sync_per_step_with_deadlines(models, drafts, form,
                                               monkeypatch):
    """Deadlines on every request (one expiring in the queue) add no
    device-to-host read: one per decode step or spec tick, one per
    admission or graduating chunk tick."""
    _, tm = models
    kw = dict(FORMS.get(form, FORMS["dense"]), prefill_buckets=[16])
    if form == "spec":
        kw.update(spec_k=2, draft_model=drafts[1])
    eng = InferenceEngine(tm, device="cpu", **kw)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 97, (n,)).astype(np.int32)
               for n in (5, 9, 7, 11)]
    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    rids = [eng.add_request(p, max_new_tokens=6, deadline_s=60.0)
            for p in prompts]
    expired = eng.add_request(prompts[0], max_new_tokens=6, deadline_s=0.0)
    out = eng.run()
    monkeypatch.undo()
    st = eng.stats()
    assert [len(out[r]) for r in rids] == [6] * 4 and len(out[expired]) == 0
    assert st["deadline_retirements"] == 1
    assert st["decode_host_syncs"] == st["decode_steps"] > 0
    assert reads["n"] == st["host_syncs"] == \
        st["decode_steps"] + st["prefill_host_syncs"]
    if form == "spec":
        assert st["spec_ticks"] == st["decode_steps"]
