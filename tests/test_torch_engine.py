"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the same weights (moved through the port's weight
bridge) and the same prompts; greedy decoding must give identical
tokens.  The init range is raised from 0.02 to 0.2 so random weights
produce varied tokens instead of one repeated id.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import (InferenceEngine,
                                        default_prefill_buckets)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, initializer_range=0.2)
PROMPT_LENS = (3, 20, 9, 40, 17, 33)   # buckets 16, 32 and 64
MAX_NEW = (6, 4, 9, 5, 7, 3)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(0, 97, (n,)).astype(np.int32) for n in PROMPT_LENS]


def serve(engine, prompts, **kw):
    rids = [engine.add_request(p, max_new_tokens=n, **kw)
            for p, n in zip(prompts, MAX_NEW)]
    out = engine.run()
    return [out[r].tolist() for r in rids]


def test_default_buckets():
    assert default_prefill_buckets(64) == [16, 32, 64]
    assert default_prefill_buckets(2048) == [16, 32, 64, 128, 256, 512,
                                             1024, 2048]
    assert default_prefill_buckets(100) == [16, 32, 64, 100]


def test_greedy_tokens_identical_to_jax_engine(models, prompts):
    """6 requests through 2 slots (queueing, mid-stream admission) over
    three prefill buckets."""
    jm, tm = models
    want = serve(JaxEngine(jm, batch_slots=2), prompts)
    got = serve(InferenceEngine(tm, batch_slots=2, device="cpu"), prompts)
    assert got == want
    assert [len(g) for g in got] == list(MAX_NEW)
    assert len({t for g in got for t in g}) > 5      # not one repeated id


def test_capacity_retirement_matches_jax(models):
    """A 60-token prompt in a 64-token engine retires when its sequence
    reaches max_seq_len, before max_new_tokens."""
    jm, tm = models
    p = np.random.RandomState(6).randint(0, 97, (60,)).astype(np.int32)
    want = JaxEngine(jm, batch_slots=1).generate(p, max_new_tokens=10)
    got = InferenceEngine(tm, batch_slots=1, device="cpu").generate(
        p, max_new_tokens=10)
    assert got.tolist() == np.asarray(want).tolist()
    assert len(got) == 4            # 60 + 4 = max_seq_len


def test_custom_buckets_and_short_max_seq_len_match_jax(models, prompts):
    """``prefill_buckets`` (unsorted, not powers of two) and a
    ``max_seq_len`` below the model's: the cache and the padding follow
    them, tokens match JAX, and the 33-token prompt retires at
    max_seq_len (33 + 7 = 40) before its 10 new tokens."""
    jm, tm = models
    kw = dict(batch_slots=2, max_seq_len=40, prefill_buckets=[24, 8, 40])
    ps = [p for p in prompts if p.size < 40]        # lengths 3 20 9 17 33

    def run(eng):
        rids = [eng.add_request(p, max_new_tokens=10) for p in ps]
        out = eng.run()
        return [out[r].tolist() for r in rids]

    eng = InferenceEngine(tm, device="cpu", **kw)
    assert eng.buckets == [8, 24, 40] and eng.cache.capacity == 40
    got = run(eng)
    assert got == run(JaxEngine(jm, **kw))
    assert [len(g) for g in got] == [10, 10, 10, 10, 7]
    assert sorted(eng.stats()["prefill_ms_by_bucket"]) == [8, 24, 40]


def test_eos_and_max_new_retirement(models, prompts):
    _, tm = models
    eng = InferenceEngine(tm, batch_slots=2, device="cpu")
    base = eng.generate(prompts[2], max_new_tokens=9).tolist()
    assert len(base) == 9
    eos = base[4]
    cut = base.index(eos) + 1
    got = eng.generate(prompts[2], max_new_tokens=9, eos_id=eos).tolist()
    assert got == base[:cut] and got[-1] == eos
    assert eng.num_active == 0 and not eng.has_work


def test_top_k_1_sampling_equals_greedy(models, prompts):
    _, tm = models
    greedy = serve(InferenceEngine(tm, batch_slots=2, device="cpu"), prompts)
    sampled = serve(InferenceEngine(tm, batch_slots=2, top_k=1, seed=3,
                                    device="cpu"), prompts, temperature=1.0)
    assert sampled == greedy


def test_sampling_is_seeded(models, prompts):
    _, tm = models

    def run(seed):
        eng = InferenceEngine(tm, batch_slots=2, top_k=20, seed=seed,
                              device="cpu")
        return serve(eng, prompts, temperature=1.0, top_p=0.9)

    a, b = run(11), run(11)
    assert a == b
    assert run(12) != a


def test_one_host_sync_per_decode_step(models, prompts, monkeypatch):
    """Every device-to-host read the engine makes is counted: one per
    decode step (the sampled ids) plus one per admission (first token)."""
    _, tm = models
    eng = InferenceEngine(tm, batch_slots=2, device="cpu")
    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    serve(eng, prompts)
    monkeypatch.undo()
    st = eng.stats()
    assert st["decode_host_syncs"] == st["decode_steps"] > 0
    assert st["prefill_host_syncs"] == st["prefills"] == len(prompts)
    assert reads["n"] == st["host_syncs"] == st["decode_steps"] + len(prompts)
    assert st["tokens_generated"] + len(prompts) == sum(MAX_NEW)


def test_generate_wrapper_matches_engine(models, prompts):
    _, tm = models
    want = InferenceEngine(tm, batch_slots=1, device="cpu").generate(
        prompts[0], max_new_tokens=5).tolist()
    got = tm.generate(prompts[0], max_new_tokens=5, include_prompt=True)
    assert got.tolist() == prompts[0].tolist() + want


def test_engine_device_none_without_cuda_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    _, tm = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tm, batch_slots=1)


def test_engine_rejects_oversized_prompts(models):
    _, tm = models
    eng = InferenceEngine(tm, batch_slots=1, device="cpu")
    with pytest.raises(ValueError):
        eng.add_request(np.zeros(64, np.int32))
    with pytest.raises(ValueError):
        eng.add_request(np.zeros(0, np.int32))
