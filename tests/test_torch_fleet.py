"""The port's serving fleet against the JAX package's, on the CPU: prefix
scoring, the Router's decisions over two replicas, the multi-tenant
workload, the fleet load harness, the RPC shim, and the launch count of
a kernel wrapper under threads.

Router parity runs a closed-loop sequence (requests added in rounds,
each round followed by two fleet steps) through two port replicas and
two JAX replicas on the same weights: placement depends on the loads and
radix summaries at each arrival, so both fleets must evolve alike step
by step.  Open-loop routing depends on timing and is held only to the
load test's contract.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference import Router as JaxRouter
from paddle_tpu.inference import score_overlap as jax_score_overlap
from paddle_tpu.inference.loadgen import \
    MultiTenantWorkload as JaxMultiTenant
from paddle_tpu.inference.loadgen import \
    run_fleet_loadtest as jax_run_fleet_loadtest
from paddle_tpu.inference.loadgen import warm_fleet as jax_warm_fleet
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import (InferenceEngine,
                                        MultiTenantWorkload, Router,
                                        run_fleet_loadtest, score_overlap,
                                        warm_fleet)
from paddle_tpu_torch.inference.router import (ReplicaRPCServer,
                                               RPCReplicaProxy)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.observability.slo import FleetAggregator
from paddle_tpu_torch.ops import _build

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, initializer_range=0.2)
PAGED = dict(batch_slots=2, prefill_buckets=[16, 32], kv_layout="paged",
             kv_block_size=8)
TENANTS = dict(seed=5, num_tenants=4, skew=1.0, prefix_len=16,
               tail_len=(3, 8), max_new=(2, 4))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


def port_fleet(tm, policy="prefix", **kw):
    return Router([InferenceEngine(tm, device="cpu", seed=i, **PAGED)
                   for i in range(2)], policy=policy, **kw)


@pytest.fixture(scope="module")
def fleets(models):
    """A port fleet and a JAX fleet after the same closed-loop sequence,
    with each request's route and tokens in arrival order."""
    jm, tm = models
    out = {}
    for name, fleet, wl in (
            ("port", port_fleet(tm), MultiTenantWorkload(97, **TENANTS)),
            ("jax", JaxRouter([JaxEngine(jm, seed=i, **PAGED)
                               for i in range(2)], policy="prefix"),
             JaxMultiTenant(97, **TENANTS))):
        (warm_fleet if name == "port" else jax_warm_fleet)(fleet, wl,
                                                           passes=1)
        keys = []
        for _ in range(4):
            for _ in range(3):
                _, prompt, max_new = wl.sample()
                keys.append(fleet.add_request(prompt,
                                              max_new_tokens=max_new))
            fleet.step()
            fleet.step()
        results = fleet.run()
        st = fleet.stats() if name == "port" else fleet.stats
        out[name] = dict(fleet=fleet, routes=[k[0] for k in keys],
                         tokens=[results[k].tolist() for k in keys],
                         stats=st)
    return out


def test_score_overlap_equals_radix_match_and_jax(models):
    """The router's probe over a replica summary equals the radix match
    (and leaves no footprint), and equals JAX's score on the same
    traffic; the two packages' summaries hold the same fingerprints."""
    jm, tm = models
    eng, jeng = InferenceEngine(tm, device="cpu", **PAGED), JaxEngine(
        jm, **PAGED)
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 97, (16,)).astype(np.int32)
    for e in (eng, jeng):
        e.add_request(np.concatenate(
            [prefix, np.arange(1, 6, dtype=np.int32)]), max_new_tokens=4)
        e.run()
    summ, jsumm = eng.prefix_summary(), jeng.prefix_summary()
    assert summ["fingerprints"] == jsumm["fingerprints"]
    assert summ["cached_blocks"] == jsumm["cached_blocks"] == 2
    probe = np.concatenate([prefix, rng.randint(1, 97, (4,))
                            .astype(np.int32)])
    q0 = eng._prefix.queries
    score = score_overlap(probe, summ)
    assert eng._prefix.queries == q0
    blocks, matched = eng._prefix.match(probe)
    assert score == len(blocks) == matched // 8 == 2
    assert jax_score_overlap(probe, jsumm) == score
    cold = rng.randint(1, 97, (20,)).astype(np.int32)
    assert score_overlap(cold, summ) == jax_score_overlap(cold, jsumm) == 0
    eng.flush_prefix_cache()
    assert score_overlap(probe, eng.prefix_summary()) == 0


def test_router_decisions_equal_jax(fleets):
    """Route indices, per-replica counts, router hit rate, prefix blocks
    routed and every request's tokens."""
    port, jax = fleets["port"], fleets["jax"]
    assert port["routes"] == jax["routes"]
    assert port["tokens"] == jax["tokens"]
    for key in ("routed_per_replica", "router_hit_rate",
                "router_prefix_blocks", "requests_routed", "replica_loads",
                "policy", "replicas"):
        assert port["stats"][key] == jax["stats"][key], key
    assert port["stats"]["router_hit_rate"] > 0
    assert len(set(port["routes"])) == 2


def test_router_policies_and_load_gap(models):
    """A prompt whose prefix lives on replica 1 routes there; a cold one
    falls back to the least loaded; round robin ignores both; past
    ``max_load_gap`` balance beats affinity."""
    _, tm = models
    fleet = port_fleet(tm)
    a, b = fleet.replicas
    rng = np.random.RandomState(2)
    prefix = rng.randint(1, 97, (16,)).astype(np.int32)
    b.add_request(np.concatenate([prefix, rng.randint(1, 97, (3,))
                                  .astype(np.int32)]), max_new_tokens=2)
    b.run()
    probe = np.concatenate([prefix, rng.randint(1, 97, (4,))
                            .astype(np.int32)])
    assert fleet.route(probe) == 1
    assert fleet.route(rng.randint(1, 97, (10,)).astype(np.int32)) == 0
    st = fleet.stats()
    assert st["router_hit_rate"] == 0.5 and st["router_prefix_blocks"] == 2
    assert fleet.max_load_gap == 2          # the largest batch_slots
    rr = Router([a, b], policy="round_robin")
    assert [rr.route(probe) for _ in range(4)] == [0, 1, 0, 1]
    for _ in range(4):
        b.add_request(rng.randint(1, 97, (6,)).astype(np.int32),
                      max_new_tokens=2)
    assert Router([a, b], max_load_gap=2).route(probe) == 0
    assert Router([a, b], max_load_gap=100).route(probe) == 1
    assert Router([a, b], policy="least_loaded").route(probe) == 0
    with pytest.raises(ValueError):
        Router([a, b], policy="random")
    b.run()
    assert len(fleet.drain()) == 0          # both pools leak-free


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (5, TENANTS), (3, dict(num_tenants=8, skew=1.2,
                                    prefix_len=512, tail_len=(32, 256),
                                    max_new=(16, 32)))],
    ids=["defaults", "small", "chip"])
def test_multitenant_workload_draws_jax_samples(seed, kw):
    kw = dict(kw, seed=seed)
    vocab = 50304 if kw.get("prefix_len") == 512 else 97
    want, got = JaxMultiTenant(vocab, **kw), MultiTenantWorkload(vocab, **kw)
    for a, b in zip(got.prefixes, want.prefixes):
        assert np.array_equal(a, b) and a.dtype == np.int32
    np.testing.assert_array_equal(got.weights, want.weights)
    for _ in range(64):
        (wt, wp, wn), (gt, gp, gn) = want.sample(), got.sample()
        assert (gt, gn) == (wt, wn)
        assert np.array_equal(gp, wp) and gp.dtype == np.int32


def planned_tokens(n, seed):
    """The harness samples the workload in plan order: the tokens it
    must deliver without EOS."""
    wl = MultiTenantWorkload(97, **dict(TENANTS, seed=seed))
    return sum(wl.sample()[2] for _ in range(n))


def test_fleet_loadtest_report_has_jax_keys(fleets):
    """Open loop at 200 rps over the warmed fleets: the port's report has
    the JAX report's keys, delivers every planned token, counts this
    window only, and leaves both pools leak-free."""
    reports = {}
    for name, run in (("port", run_fleet_loadtest),
                      ("jax", jax_run_fleet_loadtest)):
        wl = (MultiTenantWorkload if name == "port" else JaxMultiTenant)(
            97, **dict(TENANTS, seed=9))
        reports[name] = run(fleets[name]["fleet"], 10, 200.0, workload=wl,
                            seed=3, deadline_s=60.0)
    rep, jrep = reports["port"], reports["jax"]
    assert set(rep) == set(jrep)
    assert set(rep["slo"]) == set(jrep["slo"])
    assert set(rep["straggler"]) == set(jrep["straggler"])
    assert rep["num_requests"] == jrep["num_requests"] == 10
    assert rep["tokens_generated"] == jrep["tokens_generated"] \
        == planned_tokens(10, 9)
    assert sum(rep["requests_per_replica"]) == 10
    assert rep["timed_out_requests"] == 0 and rep["num_replicas"] == 2
    assert rep["ttft_ms_p99"] >= rep["ttft_ms_p50"] > 0
    assert rep["prefix_queries"] == 10 and rep["prefix_hit_rate"] > 0
    assert isinstance(rep["doctor"], list)
    for r in fleets["port"]["fleet"].replicas:
        assert not r.has_work
        r.check_leak_free()


def test_rpc_proxy_and_fleet_loadtest(models):
    """A replica behind the socket shim: results, summary fingerprints
    equal to the in-process engine's, a FleetAggregator scrape through
    the proxy; then ``rpc=True`` end to end."""
    _, tm = models
    fleet = port_fleet(tm)
    srv = ReplicaRPCServer(fleet.replicas[0]).start()
    px = RPCReplicaProxy(srv.address)
    try:
        assert px.batch_slots == 2 and px.model.cfg.vocab_size == 97
        rid = px.add_request(np.arange(1, 20, dtype=np.int32),
                             max_new_tokens=4)
        assert px.has_work
        while px.has_work:
            px.step_or_raise()
        px.refresh_stats()
        assert len(px.results[rid]) == 4
        assert px.results[rid].tolist() == \
            fleet.replicas[0].results[rid].tolist()
        summ = px.prefix_summary()
        assert isinstance(summ["fingerprints"], set)
        assert summ["fingerprints"] == \
            fleet.replicas[0].prefix_summary()["fingerprints"]
        assert len(summ["fingerprints"]) == 2
        assert FleetAggregator([px]).scrape()["new_requests"] == 1
        with pytest.raises(RuntimeError, match="unknown RPC method"):
            px._call("nope")
    finally:
        px.close()
        srv.stop()
    threads0 = set(threading.enumerate())
    rep = run_fleet_loadtest(fleet, 6, 200.0,
                             workload=MultiTenantWorkload(97, **TENANTS),
                             seed=0, rpc=True)
    assert rep["rpc"] is True and rep["num_requests"] == 6
    assert rep["tokens_generated"] == planned_tokens(6, 5)
    assert sum(rep["requests_per_replica"]) == 6
    # the servers' accept and connection threads end with their sockets
    deadline = time.monotonic() + 10.0
    while set(threading.enumerate()) - threads0 and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - threads0
    fleet.drain()


def test_launch_count_exact_under_threads():
    """8 threads call one kernel wrapper (a stub entry point) 10 000 times
    each, with a short switch interval: no launch is lost."""
    kernel = _build.CudaKernel("none.cu", "none", [])
    kernel._fn = lambda *args: 0
    calls = 10_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernel() for _ in range(calls)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches == 8 * calls
