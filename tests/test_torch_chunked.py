"""The port's chunked-prefill engine against its monolithic engine and the
JAX package's engines, on the CPU.

Chunked prefill only changes the schedule, so the greedy streams must be
identical to the monolithic engine of the same cache form (dense or
paged, fp or int8), for chunks of 1, 4 and 64 tokens, GQA, preemption
and resume over progressively adopted radix blocks, and a budget
switched between steps; and identical to the JAX package's engines on
the same converted weights.  Host side: a chunk tick reads nothing back
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
from the device unless a slot graduates, and then once.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, initializer_range=0.2)


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
def mha():
    return build_pair()


@pytest.fixture(scope="module")
def prompts():
    # lengths straddle every chunk-4 phase and 16 ends on a chunk and a
    # bucket boundary at once (the JAX tests' prompts)
    rng = np.random.RandomState(0)
    return [rng.randint(1, 97, (n,)).astype(np.int32) for n in (5, 9, 3, 16)]


def serve(eng, prompts, max_new=10):
    if isinstance(max_new, int):
        max_new = [max_new] * len(prompts)
    rids = [eng.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


def port(tm, **kw):
    return InferenceEngine(tm, batch_slots=2, prefill_buckets=[16],
                           device="cpu", **kw)


def layout_kw(layout):
    return {"kv_layout": layout, **({"kv_block_size": 8}
                                    if layout == "paged" else {})}


@pytest.fixture(scope="module")
def reference(mha, prompts):
    """The JAX package's monolithic dense engine: the port's monolithic
    engine gives the same streams, and every chunked form must too."""
    jm, tm = mha
    want = serve(JaxEngine(jm, batch_slots=2, prefill_buckets=[16]), prompts)
    assert serve(port(tm), prompts) == want
    return want


@pytest.mark.parametrize("chunk,kv_dtype,layout", [
    (1, None, "dense"), (1, "int8", "paged"), (64, None, "paged"),
    (64, "int8", "dense"), (4, None, "dense"), (4, "int8", "paged")])
def test_chunked_token_identity_matrix(mha, prompts, reference, chunk,
                                       kv_dtype, layout):
    """Chunked greedy output equals the monolithic engine of the same
    cache form (and, fp, the JAX engine's); the whole prompt is fed once
    with no prefill stall; paged pools drain leak-free."""
    _, tm = mha
    kw = dict(kv_dtype=kv_dtype, **layout_kw(layout))
    want = reference if kv_dtype is None else serve(port(tm, **kw), prompts)
    eng = port(tm, prefill_chunk=chunk, **kw)
    assert serve(eng, prompts) == want
    st = eng.stats()
    assert st["chunked_prefill"] and st["prefill_chunk"] == chunk
    assert st["prefill_stall_ms"] == 0
    assert st["prefill_tokens"] == sum(p.size for p in prompts)
    assert st["prefills"] == len(prompts)
    assert st["chunk_ticks"] >= -(-max(p.size for p in prompts) // chunk)
    if layout == "paged":
        eng.check_leak_free()


@pytest.mark.parametrize("chunk,kv_dtype,layout", [
    (4, "int8", "paged"), (3, None, "dense")])
def test_chunked_tokens_equal_jax_chunked_engine(mha, prompts, chunk,
                                                 kv_dtype, layout):
    jm, tm = mha
    kw = dict(kv_dtype=kv_dtype, prefill_chunk=chunk, **layout_kw(layout))
    got = serve(port(tm, **kw), prompts)
    assert got == serve(JaxEngine(jm, batch_slots=2, prefill_buckets=[16],
                                  **kw), prompts)


def test_chunked_token_identity_gqa(prompts):
    """Grouped-query KV through the chunk step, both layouts, against
    the monolithic port and JAX engines."""
    jm, tm = build_pair(num_kv_heads=2)
    want = serve(JaxEngine(jm, batch_slots=2, prefill_buckets=[16]), prompts)
    assert serve(port(tm), prompts) == want
    for layout in ("dense", "paged"):
        eng = port(tm, prefill_chunk=4, **layout_kw(layout))
        assert serve(eng, prompts) == want


def test_chunked_preempt_resume_radix_rehit(mha):
    """Two full-length slots cannot share an 8-block pool: a chunked slot
    is preempted mid-stream, resumes through chunked admission over the
    radix blocks its prompt left behind, and every stream equals the
    roomy monolithic engine's and the JAX chunked engine's, with the same
    preemptions."""
    jm, tm = mha
    rng = np.random.RandomState(11)
    prefix = rng.randint(1, 97, (16,)).astype(np.int32)
    ps = [np.concatenate([prefix, rng.randint(1, 97, (4,)).astype(np.int32)])
          for _ in range(4)]
    want = serve(InferenceEngine(tm, batch_slots=2, prefill_buckets=[32],
                                 device="cpu"), ps, 20)
    kw = dict(batch_slots=2, prefill_chunk=4, kv_layout="paged",
              kv_block_size=8, kv_num_blocks=8)
    eng = InferenceEngine(tm, device="cpu", **kw)
    assert serve(eng, ps, 20) == want
    jeng = JaxEngine(jm, **kw)
    assert serve(jeng, ps, 20) == want
    st = eng.stats()
    assert st["preemptions"] == jeng.stats["preemptions"] >= 1
    assert eng._prefix.hit_blocks > 0
    eng.check_leak_free()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_chunk_tick_spares_live_slot_in_last_block(mha, kv_dtype):
    """A slot decoding in the last block of its table rides a chunk tick
    as a non-participant: its window rows run past the table's capacity
    and must land in the null block, not on its own cached positions.
    Both streams equal the monolithic engine's."""
    _, tm = mha
    rng = np.random.RandomState(7)
    pa = rng.randint(1, 97, (40,)).astype(np.int32)
    pb = rng.randint(1, 97, (24,)).astype(np.int32)
    kw = dict(batch_slots=2, prefill_buckets=[64], kv_layout="paged",
              kv_block_size=8, kv_dtype=kv_dtype, device="cpu")
    want = serve(InferenceEngine(tm, **kw), [pa, pb], [23, 4])
    eng = InferenceEngine(tm, prefill_chunk=8, **kw)
    ra = eng.add_request(pa, max_new_tokens=23)
    while eng._slot_len[0] < 57:        # block 7 of 8 held, past offset 0
        eng.step()
    rb = eng.add_request(pb, max_new_tokens=4)
    out = eng.run()
    assert eng.stats()["decode_steps_with_chunk"] >= 2
    assert [np.asarray(out[r]).tolist() for r in (ra, rb)] == want
    eng.check_leak_free()


@pytest.mark.parametrize("chunk", [0, 4])
def test_hol_blocked_head_not_reprobed(mha, chunk):
    """A queue head refused for lack of blocks is not re-probed until a
    release frees something (monolithic and chunked admission alike):
    the allocator's probes equal the JAX engine's over the same script."""
    jm, tm = mha
    rng = np.random.RandomState(5)
    pa = rng.randint(1, 97, (35,)).astype(np.int32)
    pb = rng.randint(1, 97, (5,)).astype(np.int32)
    probes = []
    for eng in (InferenceEngine(tm, batch_slots=2, prefill_buckets=[16, 40],
                                kv_layout="paged", kv_block_size=8,
                                kv_num_blocks=5, prefill_chunk=chunk,
                                device="cpu"),
                JaxEngine(jm, batch_slots=2, prefill_buckets=[16, 40],
                          kv_layout="paged", kv_block_size=8,
                          kv_num_blocks=5, prefill_chunk=chunk)):
        ra = eng.add_request(pa, max_new_tokens=5)
        for _ in range(1 if chunk == 0 else -(-35 // chunk)):
            eng.step()
        rb = eng.add_request(pb, max_new_tokens=4)
        eng.step()                      # one probe: refused, memoized
        p0 = eng._alloc.probes
        for _ in range(2):
            eng.step()
        assert eng._alloc.probes == p0
        out = eng.run()
        assert eng._alloc.probes > p0
        assert len(out[ra]) == 5 and len(out[rb]) == 4
        eng.check_leak_free()
        probes.append((p0, eng._alloc.probes,
                       [np.asarray(out[r]).tolist() for r in (ra, rb)]))
    assert probes[0] == probes[1]


def test_set_prefill_chunk_switches_between_steps(mha, prompts, reference):
    """A monolithic engine switched to chunks of 4 serves the same
    streams; a slot still prefilling pins the budget (False, unchanged);
    switching back off restores monolithic admission."""
    _, tm = mha
    eng = port(tm)
    assert eng.set_prefill_chunk(4)
    assert eng.stats()["chunked_prefill"] is True
    assert serve(eng, prompts) == reference
    eng.add_request(prompts[3], max_new_tokens=2)
    eng.step()                          # 4 of 16 prompt tokens fed
    assert eng.set_prefill_chunk(8) is False
    assert eng.prefill_chunk == 4
    eng.run()
    assert eng.set_prefill_chunk(0)
    assert eng.stats()["chunked_prefill"] is False
    with pytest.raises(ValueError):
        eng.set_prefill_chunk(-1)
    with pytest.raises(ValueError):
        port(tm, prefill_chunk=-2)


def test_stall_counter_and_decode_during_chunks(mha):
    """A monolithic admission while streams are live counts prefill
    stall time; chunked admission counts none, and decode steps run in
    the same steps as chunk ticks."""
    _, tm = mha
    rng = np.random.RandomState(3)
    ps = [rng.randint(1, 97, (n,)).astype(np.int32) for n in (4, 30, 30)]
    mono = InferenceEngine(tm, batch_slots=3, prefill_buckets=[32],
                           device="cpu")
    chunked = InferenceEngine(tm, batch_slots=3, prefill_buckets=[32],
                              prefill_chunk=4, device="cpu")
    for eng in (mono, chunked):
        eng.add_request(ps[0], max_new_tokens=12)
        eng.step()
        eng.step()
        for p in ps[1:]:
            eng.add_request(p, max_new_tokens=4)
        eng.run()
    assert mono.stats()["prefill_stall_ms"] > 0
    st = chunked.stats()
    assert st["prefill_stall_ms"] == 0
    assert st["decode_steps_with_chunk"] >= 2


def test_chunk_tick_syncs_only_to_graduate(mha, prompts, monkeypatch):
    """Every device-to-host read is a decode step's sampled ids or a
    graduating chunk tick's first tokens: chunk ticks that graduate no
    slot read nothing."""
    _, tm = mha
    eng = port(tm, prefill_chunk=2, kv_layout="paged", kv_block_size=8)
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
    assert st["chunk_ticks"] > st["chunk_graduation_ticks"] > 0
    assert st["prefill_host_syncs"] == st["chunk_graduation_ticks"]
    assert reads["n"] == st["host_syncs"] == \
        st["decode_steps"] + st["chunk_graduation_ticks"]
