"""The port's disaggregated serving engine against the JAX package's, on
the CPU, and the engine's environment knobs against the JAX engine's.

Both packages serve the same weights (moved through the port's weight
bridge); greedy streams must be identical.  The JAX
``DisaggServingEngine`` is the token oracle only (its compile counter is
not used).  The decode engine's own prefill path is shown never to run
through the step-kind registry: every prefill of a disaggregated engine
is timed under the worker's ``disagg`` key, none under
``prefill_paged``.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import DisaggServingEngine as JaxDisagg
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import DisaggServingEngine, InferenceEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.observability import exec_registry

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, initializer_range=0.2)
PAGED = dict(batch_slots=2, prefill_buckets=[16, 32], kv_layout="paged",
             kv_block_size=8)
KNOBS = ("PADDLE_TPU_DECODE_SLOTS", "PADDLE_TPU_KV_LAYOUT",
         "PADDLE_TPU_CHUNKED_PREFILL", "PADDLE_TPU_KV_BLOCK_SIZE",
         "PADDLE_TPU_KV_BLOCKS", "PADDLE_TPU_PREFIX_CACHE",
         "PADDLE_TPU_PREFILL_BUCKETS", "PADDLE_TPU_SPEC_K",
         "PADDLE_TPU_SERVE_TP", "PADDLE_TPU_SERVE_EP")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


def serve(engine, prompts, max_new):
    rids = [engine.add_request(p, max_new_tokens=max_new) for p in prompts]
    out = engine.run()
    return [out[r].tolist() for r in rids]


def prefill_families(eng):
    return {e.key[0] for e in
            exec_registry.registry().entries(eng._exec_component)
            if e.kind == "prefill"}


def test_disagg_tokens_equal_paged_and_jax(models):
    """Prompts of 5, 9, 3, 12 and 7 tokens, 10 new each, through 2 slots:
    the port's disaggregated engine gives the port's paged engine's and
    JAX's disaggregated engine's greedy tokens exactly; every request is
    one worker prefill and one handoff; the decode engine's own prefill
    never runs; the pool drains leak-free."""
    jm, tm = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 97, (n,)).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    want = serve(InferenceEngine(tm, device="cpu", **PAGED), prompts, 10)
    jax_dis = JaxDisagg(jm, batch_slots=2, prefill_buckets=[16, 32],
                        kv_block_size=8)
    dis = DisaggServingEngine(tm, batch_slots=2, prefill_buckets=[16, 32],
                              kv_block_size=8, device="cpu")
    got = serve(dis, prompts, 10)
    assert got == want == serve(jax_dis, prompts, 10)
    assert [len(g) for g in got] == [10] * 5
    st = dis.stats()
    assert st["disaggregated"] and not st["disjoint_groups"]
    assert st["handoffs"] == st["prefill_worker_prefills"] == len(prompts)
    assert st["handoff_queue"] == 0 and st["prefills"] == len(prompts)
    assert prefill_families(dis.decode) == {"disagg"}
    assert dis.drain() == []
    dis.check_leak_free()
    assert dis.decode._alloc.num_in_use == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_disagg_spec_and_prefix_cache_compose(models, kv_dtype):
    """Spec decoding (the target as its own draft, spec_k=2) with the
    radix cache over a full-precision and an int8 pool: greedy streams
    equal the non-disaggregated spec engine's, shared prefixes hit across
    handoffs, every tick commits K+1, the pool drains leak-free."""
    _, tm = models
    rng = np.random.RandomState(6)
    prefix = rng.randint(1, 97, (16,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(1, 97, (3,))
                               .astype(np.int32)]) for _ in range(4)]
    kw = dict(PAGED, kv_dtype=kv_dtype, spec_k=2, draft_model=tm,
              device="cpu")
    want = serve(InferenceEngine(tm, **kw), prompts, 8)
    kw.pop("kv_layout")
    dis = DisaggServingEngine(tm, **kw)
    assert serve(dis, prompts, 8) == want
    st = dis.stats()
    assert st["prefix_hit_queries"] >= 3
    assert st["accepted_tokens_per_tick"] > 1.5
    assert st["handoffs"] == 4 and prefill_families(dis.decode) == {"disagg"}
    dis.drain()
    dis.check_leak_free()


def test_disagg_deadline_and_drain(models):
    """A queued request past its deadline expires on the wrapper's queue
    without a prefill; drain hands back parked handoffs and the queue and
    leaves the pool clean."""
    _, tm = models
    dis = DisaggServingEngine(tm, batch_slots=1, prefill_buckets=[16],
                              kv_block_size=8, prefills_per_step=1,
                              handoff_depth=1, device="cpu")
    dis.warmup()
    rng = np.random.RandomState(8)
    rid = dis.add_request(rng.randint(1, 97, (5,)).astype(np.int32),
                          max_new_tokens=4, deadline_s=0.0)
    time.sleep(0.01)
    dis.step()
    rec = dis.request_stats[rid]
    assert rec["timed_out"] and rec["tokens"] == 0
    assert dis.worker.prefills == 0
    ids = [dis.add_request(rng.randint(1, 97, (5,)).astype(np.int32),
                           max_new_tokens=4) for _ in range(3)]
    dis.step()
    assert dis.stats()["handoff_queue"] == 0 and dis.num_active == 1
    dis.step()
    assert dis.stats()["handoff_queue"] == 1
    leftover = dis.drain()
    dis.check_leak_free()
    assert not dis.has_work
    assert [r.rid for r in leftover] == ids[1:]
    assert all(r.slot is None for r in leftover)
    assert len(dis.results[ids[0]]) == 4


@pytest.mark.parametrize("kw,env", [
    (dict(prefill_devices=1), {}),
    (dict(prefill_tp=1), {}),
    (dict(decode_tp=2), {}),
    (dict(prefill_ep=2), {}),
    (dict(decode_ep=1), {}),
    ({}, {"PADDLE_TPU_SERVE_EP": "2"}),
    ({}, {"PADDLE_TPU_SERVE_TP": "2"}),
], ids=["prefill_devices", "prefill_tp", "decode_tp", "prefill_ep",
        "decode_ep", "env-ep", "env-tp"])
def test_disjoint_options_raise(models, monkeypatch, kw, env):
    _, tm = models
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3.1"):
        DisaggServingEngine(tm, batch_slots=2, kv_block_size=8,
                            device="cpu", **kw)
    if env:
        with pytest.raises(NotImplementedError, match="Queue 1 item 3.1"):
            InferenceEngine(tm, batch_slots=2, device="cpu")


def test_entry_points_default_to_cuda(models):
    """Without an explicit device the engines ask for the card: without
    one they raise instead of running on the CPU."""
    _, tm = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggServingEngine(tm, batch_slots=2, kv_block_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tm, batch_slots=2)


def _jax_view(eng):
    return dict(batch_slots=eng.batch_slots, kv_layout=eng.kv_layout,
                prefill_chunk=eng.prefill_chunk, buckets=list(eng.buckets),
                block_size=getattr(eng, "block_size", None),
                num_blocks=getattr(eng, "num_blocks", None),
                prefix=getattr(eng, "_prefix", None) is not None,
                spec_k=eng._spec.k if eng._spec is not None else 0)


@pytest.mark.parametrize("env,arg,want", [
    ({"PADDLE_TPU_DECODE_SLOTS": "3"}, dict(batch_slots=5),
     dict(batch_slots=3)),
    ({"PADDLE_TPU_KV_LAYOUT": "paged"}, dict(kv_layout="dense"),
     dict(kv_layout="paged")),
    ({"PADDLE_TPU_CHUNKED_PREFILL": "4"}, dict(prefill_chunk=8),
     dict(prefill_chunk=4)),
    ({"PADDLE_TPU_KV_LAYOUT": "paged", "PADDLE_TPU_KV_BLOCK_SIZE": "4"},
     dict(kv_layout="paged", kv_block_size=16), dict(block_size=4)),
    ({"PADDLE_TPU_KV_LAYOUT": "paged", "PADDLE_TPU_KV_BLOCKS": "20"},
     dict(kv_layout="paged", kv_num_blocks=30), dict(num_blocks=20)),
    ({"PADDLE_TPU_KV_LAYOUT": "paged", "PADDLE_TPU_PREFIX_CACHE": "0"},
     dict(kv_layout="paged", prefix_cache=True), dict(prefix=False)),
    ({"PADDLE_TPU_PREFILL_BUCKETS": "8,32,500"},
     dict(prefill_buckets=[16, 64]), dict(buckets=[8, 32])),
    ({"PADDLE_TPU_SPEC_K": "2"}, dict(spec_k=3), dict(spec_k=2)),
], ids=["slots", "layout", "chunk", "block_size", "blocks", "prefix",
        "buckets", "spec_k"])
def test_env_knobs_resolve_as_jax(models, monkeypatch, env, arg, want):
    """Each knob read where its argument is unset gives the JAX engine's
    value; an explicit argument wins over the environment in both."""
    jm, tm = models
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    draft = dict(draft_model=tm) if "PADDLE_TPU_SPEC_K" in env else {}
    jdraft = dict(draft_model=jm) if draft else {}
    got = _jax_view(InferenceEngine(tm, device="cpu", **draft))
    ref = _jax_view(JaxEngine(jm, **jdraft))
    assert got == ref
    assert {k: got[k] for k in want} == want
    got_arg = _jax_view(InferenceEngine(tm, device="cpu", **arg, **draft))
    assert got_arg == _jax_view(JaxEngine(jm, **arg, **jdraft))
    assert {k: got_arg[k] for k in want} != want
