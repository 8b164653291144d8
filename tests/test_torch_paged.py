"""The port's paged KV serving against the JAX package's, on the CPU.

Ops: the port's ``_paged_plain`` (what a CPU tensor runs) against the
JAX gather composite ``_paged_composite`` and the Pallas paged kernels
run in interpret mode (``_paged_gqa``, ``_paged_gqa_q``), in f32 on the
same numpy inputs: f32 rounding, 2e-5 (as tests/test_paged_kv.py holds
the kernel to the composite).  Host side: the block allocator and the
radix prefix cache give the JAX ones' results over one scripted
sequence.  Model: ``prefill_paged`` (cold and over a cached prefix) and
``decode_step_paged`` against JAX's in f32, logits at 1e-4 (the
cache-vs-forward tolerance of tests/test_inference_engine.py) and the
pool contents at every valid position equal to JAX's at 1e-5.  Engine:
greedy tokens identical to the JAX engine in every scheduling regime of
tests/test_paged_kv.py (mixed lengths, GQA, prefix hits, preemption,
prefix shedding, memory-capped retirement, the head-of-line memo),
with the same scheduler counters.  The JAX ops and model methods run
staged under ``jax.jit`` (one compile a shape instead of one an eager
op).
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import BlockAllocator as JaxAllocator
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference import RadixPrefixCache as JaxRadix
from paddle_tpu.inference.paged_kv import init_paged_cache as jax_pool
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.inference.paged_kv import (BlockAllocator,
                                                 init_paged_cache)
from paddle_tpu_torch.inference.prefix_cache import RadixPrefixCache
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

jda = importlib.import_module("paddle_tpu.ops.decode_attention")
jqm = importlib.import_module("paddle_tpu.ops.quantized_matmul")
tda = importlib.import_module("paddle_tpu_torch.ops.decode_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
_paged_composite = jax.jit(jda._paged_composite)
_paged_kernel = jax.jit(jda.paged_decode_attention)
_JIT = {}


def jit(model, method, **kw):
    """The JAX model's method under ``jax.jit`` (one compile per shape
    instead of one per eager op)."""
    key = (id(model), method)
    if key not in _JIT:
        _JIT[key] = jax.jit(getattr(model, method), **kw)
    return _JIT[key]

LOGITS = dict(rtol=1e-4, atol=1e-4)
TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, initializer_range=0.2)


def build_pair(**over):
    kw = {**TINY, **over}
    paddle.seed(0)
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
def gqa():
    return build_pair(num_kv_heads=2)


def prompts_of(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, (n,)).astype(np.int32) for n in lengths]


def serve(eng, prompts, max_new):
    if isinstance(max_new, int):
        max_new = [max_new] * len(prompts)
    rids = [eng.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


def both(pair, **kw):
    jm, tm = pair
    return JaxEngine(jm, **kw), InferenceEngine(tm, device="cpu", **kw)


# ---- ops -----------------------------------------------------------------

def paged_case(seed, hkv, quantized, b=3, h=4, d=64, bs=128, mb=2, nb=8):
    """q, pools, shuffled tables and lengths 1, 140 and 256 (an exact
    block multiple); int8 pools with f32 scale pools when quantized."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, d) * 0.3).astype(np.float32)
    k = (rng.randn(nb, bs, hkv, d) * 0.3).astype(np.float32)
    v = (rng.randn(nb, bs, hkv, d) * 0.3).astype(np.float32)
    tables = (1 + rng.permutation(nb - 1))[:b * mb].reshape(b, mb) \
        .astype(np.int32)
    lengths = np.asarray([1, 140, 256], np.int32)[:b]
    scales = (None, None)
    if quantized:
        kq, ks = jqm.quantize_kv(jnp.asarray(k))
        vq, vs = jqm.quantize_kv(jnp.asarray(v))
        k, v = np.asarray(kq), np.asarray(vq)
        scales = (np.asarray(ks), np.asarray(vs))
    return q, k, v, tables, lengths, scales


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_paged_plain_matches_jax(hkv, quantized):
    q, k, v, tables, lengths, (ks, vs) = paged_case(hkv, hkv, quantized)
    t = [torch.from_numpy(x) if x is not None else None
         for x in (q, k, v, tables, lengths, ks, vs)]
    out = tda.paged_decode_attention(*t).numpy()
    j = [jnp.asarray(x) if x is not None else None
         for x in (q, k, v, tables, lengths, ks, vs)]
    ref = np.asarray(_paged_composite(*j))
    np.testing.assert_allclose(out, ref, **TOL)
    if not jda._fa._HAS_PLTPU:
        pytest.skip("pallas TPU backend unavailable: composite checked only")
    jda.set_interpret_mode(True)
    try:
        kern = np.asarray(_paged_kernel(*j))
    finally:
        jda.set_interpret_mode(None)
    np.testing.assert_allclose(out, kern, **TOL)


def test_paged_plain_equals_dense_plain_on_same_contents():
    """Gathering through a shuffled table gives the dense plain version's
    result bitwise (the JAX composites' relation, held by the port)."""
    q, k, v, tables, lengths, _ = paged_case(7, 2, False)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    tt, lt = torch.from_numpy(tables), torch.from_numpy(lengths)
    dense_k = kt[tt.long()].reshape(3, -1, 2, 64)
    dense_v = vt[tt.long()].reshape(3, -1, 2, 64)
    torch.testing.assert_close(tda.paged_decode_attention(qt, kt, vt, tt, lt),
                               tda.decode_attention(qt, dense_k, dense_v, lt),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["bs", "tables_dtype", "g_layout", "dtype",
                                  "scale_shape", "noncontiguous"])
def test_paged_kernel_rejects_what_it_cannot_take(case):
    """The CUDA path validates before any launch (checkable on the CPU):
    a block size that is not a multiple of 16, int64 tables, H % Hkv != 0,
    f32 q, misshapen scale pools, a strided pool."""
    bf = torch.bfloat16
    q = torch.zeros(2, 8, 64, dtype=bf)
    pool = torch.zeros(5, 16, 4, 64, dtype=bf)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    scales = (None, None)
    if case == "bs":
        pool = torch.zeros(5, 8, 4, 64, dtype=bf)
    elif case == "tables_dtype":
        tables = tables.long()
    elif case == "g_layout":
        pool = torch.zeros(5, 16, 3, 64, dtype=bf)
    elif case == "dtype":
        q = q.float()
    elif case == "scale_shape":
        pool = pool.to(torch.int8)
        scales = (torch.zeros(5, 16, 2), torch.zeros(5, 16, 2))
    elif case == "noncontiguous":
        pool = torch.zeros(5, 4, 16, 64, dtype=bf).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tda._paged_cuda(q, pool, pool, tables, lens, *scales)


# ---- host side: allocator and radix cache ------------------------------

def test_allocator_and_radix_match_jax_over_a_script():
    """One scripted sequence of alloc, incref, decref, match, insert and
    evict on both implementations: every return value, refcount, free
    count, probe count and stat agrees."""
    def script(alloc_cls, radix_cls):
        log = []
        al = alloc_cls(13, 4)
        pc = radix_cls(al, block_size=4)
        a = al.alloc(3)
        b = al.alloc(5)
        log += [a, b, al.alloc(9), al.num_free]
        toks = list(range(10, 22))
        log.append(pc.insert(toks, a))
        log.append(pc.insert(toks + [1, 2, 3, 4], a + [b[0]]))
        log += [pc.match(toks), pc.match(toks + [99]), pc.match([7] * 12)]
        al.decref(a)
        al.incref([b[0]])
        log += [pc.evict(4), al.num_free, al.refcount(b[0])]
        al.decref([b[0], b[0]])
        log += [pc.evict(4), al.num_free, pc.match(toks + [5])]
        al.decref(b[1:])
        log += [pc.flush(), al.num_free, al.probes, len(pc), pc.stats,
                {k: v for k, v in pc.summary().items()
                 if k != "fingerprints"}]
        al.check_leak_free()
        with pytest.raises(RuntimeError, match="double free"):
            al.decref([a[0]])
        return log

    assert script(BlockAllocator, RadixPrefixCache) == \
        script(JaxAllocator, JaxRadix)


# ---- model ---------------------------------------------------------------

def valid_rows(pool, table, length, bs):
    """A slot's pool contents at positions < length, in order."""
    pool = np.asarray(pool)
    return np.concatenate([pool[:, table[t // bs], t % bs][:, None]
                           for t in range(length)], axis=1)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("pair_name", ["mha", "gqa"])
def test_prefill_paged_and_decode_match_jax(pair_name, kv_dtype, request):
    """Cold prefill of slot 0 (blocks 1, 2), a prefix hit of slot 1
    sharing slot 0's first block (8 cached tokens, suffix over blocks 3
    and 4), then 3 decode steps of both slots crossing into a new block:
    logits at 1e-4 and every valid pool position equal to JAX's (int8
    pools: codes and scales as ``test_torch_kvquant.assert_codes_match``
    holds them; the hit path's prefix is dequantized into f32 on both
    sides)."""
    jm, tm = request.getfixturevalue(pair_name)
    bs, mb, nb = 8, 4, 7
    rng = np.random.RandomState(3)
    p0 = rng.randint(1, 97, (13,)).astype(np.int32)
    p1 = np.concatenate([p0[:8], rng.randint(1, 97, (7,)).astype(np.int32)])
    rows = np.asarray([[1, 2, 0, 0], [1, 3, 4, 0]], np.int32)
    jc = jax_pool(jm, nb, bs, kv_dtype=kv_dtype)
    tc = init_paged_cache(tm, nb, bs, kv_dtype=kv_dtype)
    for slot, prompt, prefix in ((0, p0, 0), (1, p1, 8)):
        suffix = prompt[prefix:]
        ids = np.zeros((1, 16 if prefix == 0 else 8), np.int32)
        ids[0, :suffix.size] = suffix
        jl, jc = jit(jm, "prefill_paged", static_argnums=(3,))(
            jnp.asarray(ids), jc, jnp.asarray(rows[slot]), prefix,
            np.int32(suffix.size))
        tl, _ = tm.prefill_paged(torch.from_numpy(ids).long(), tc,
                                 torch.from_numpy(rows[slot]), prefix,
                                 suffix.size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    lengths = np.asarray([13, 15], np.int32)
    for step in range(3):
        toks = rng.randint(1, 97, (2,)).astype(np.int32)
        if step == 1:
            rows[0, 2] = 5                  # slot 0 reaches position 16
        jl, jc = jit(jm, "decode_step_paged")(
            jnp.asarray(toks), jc, jnp.asarray(rows), jnp.asarray(lengths))
        tl, _ = tm.decode_step_paged(torch.from_numpy(toks).long(), tc,
                                     torch.from_numpy(rows),
                                     torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        lengths += 1
    for slot in range(2):
        def rows_of(pool):
            return valid_rows(pool, rows[slot], lengths[slot], bs)
        for jp, tp, js, ts in ((jc.k, tc.k, jc.k_scale, tc.k_scale),
                               (jc.v, tc.v, jc.v_scale, tc.v_scale)):
            if kv_dtype is None:
                np.testing.assert_allclose(rows_of(tp.numpy()), rows_of(jp),
                                           rtol=1e-5, atol=1e-5)
                continue
            assert tp.dtype == torch.int8
            diff = np.abs(rows_of(tp.numpy()).astype(np.int32)
                          - rows_of(jp).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            np.testing.assert_allclose(rows_of(ts.numpy()), rows_of(js),
                                       rtol=1e-5, atol=0)


def test_prefill_paged_rejects_overflowing_extent(mha):
    _, tm = mha
    tc = init_paged_cache(tm, 3, 8)
    with pytest.raises(ValueError):
        tm.prefill_paged(torch.zeros(1, 16, dtype=torch.long), tc,
                         torch.tensor([1, 2], dtype=torch.int32), 8, 4)


# ---- engine --------------------------------------------------------------

@pytest.mark.parametrize("pair_name", ["mha", "gqa"])
def test_paged_engine_mixed_lengths_match_jax(pair_name, request):
    """Mixed prompt lengths through continuous batching over block
    boundaries (12 new tokens > one block of 8), 3 slots, 5 requests."""
    kw = dict(batch_slots=3, prefill_buckets=[8, 16], kv_layout="paged",
              kv_block_size=8)
    je, te = both(request.getfixturevalue(pair_name), **kw)
    ps = prompts_of(2, (3, 7, 12, 5, 16))
    got = serve(te, ps, 12)
    assert got == serve(je, ps, 12)
    assert all(len(g) == 12 for g in got)
    assert len({t for g in got for t in g}) > 5     # not one repeated id
    st = te.stats()
    assert st["kv_layout"] == "paged" and st["kv_dtype"] == "dense"
    assert st["decode_host_syncs"] == st["decode_steps"]
    assert 0 < st["block_occupancy"] <= 1
    te.check_leak_free()


def test_prefix_hits_match_jax_and_skip_prefill_work(gqa):
    """The same 13-token prompt twice: the second admission hits the
    cached first block and prefills only the 5-token suffix's bucket;
    tokens, prefill token counts and hit counters equal JAX's."""
    kw = dict(batch_slots=2, prefill_buckets=[8, 16], kv_layout="paged",
              kv_block_size=8)
    je, te = both(gqa, **kw)
    prompt = prompts_of(5, (13,))[0]
    for eng in (je, te):
        eng.out = [serve(eng, [prompt], 5)[0] for _ in range(2)]
    assert te.out == je.out and te.out[0] == te.out[1]
    st, jst = te.stats(), je.stats
    assert st["prefill_tokens"] == jst["prefill_tokens"] == 16 + 8
    for key in ("prefix_queries", "prefix_hit_queries", "prefix_hit_blocks",
                "prefix_cached_blocks"):
        assert st[key] == jst[key], key
    assert st["prefix_hit_queries"] == 1
    assert te.prefix_summary()["cached_blocks"] == 1
    assert te.flush_prefix_cache() == 1
    te._alloc.check_leak_free()


def test_pool_exhaustion_preempts_like_jax(mha):
    """6-block pool, 3 requests that each grow to 3 blocks: the pool runs
    dry mid-decode and the youngest request goes back to the queue; the
    same preemptions and tokens as JAX."""
    kw = dict(batch_slots=3, prefill_buckets=[8, 32], kv_layout="paged",
              kv_block_size=8, kv_num_blocks=6, prefix_cache=False)
    je, te = both(mha, **kw)
    ps = prompts_of(7, (7, 7, 7))
    got = serve(te, ps, 14)
    assert got == serve(je, ps, 14)
    assert all(len(g) == 14 for g in got)
    assert te.stats()["preemptions"] == je.stats["preemptions"] > 0
    te.check_leak_free()


def test_prefix_shed_on_shrunk_pool_like_jax(mha):
    """A 24-token prefix hit with a 32-token bucket needs 7 blocks in a
    6-block pool: admission sheds one cached block and completes."""
    kw = dict(batch_slots=2, prefill_buckets=[32], kv_layout="paged",
              kv_block_size=8, kv_num_blocks=6)
    je, te = both(mha, **kw)
    base = prompts_of(12, (30,))[0]
    p2 = np.concatenate([base[:24], prompts_of(13, (6,))[0]])
    for eng in (je, te):
        eng.out = [serve(eng, [base], 2)[0], serve(eng, [p2], 3)[0]]
    assert te.out == je.out
    st, jst = te.stats(), je.stats
    assert (st["prefix_hit_blocks"], st["prefix_hit_queries"]) == \
        (jst["prefix_hit_blocks"], jst["prefix_hit_queries"]) == (2, 1)
    te.check_leak_free()


def test_exhaustion_without_resumable_victim_like_jax(mha):
    """Coarse buckets: nobody can be preempted, so the requester retires
    with what it has (a memory-capped finish), as in JAX."""
    kw = dict(batch_slots=2, prefill_buckets=[8], kv_layout="paged",
              kv_block_size=8, kv_num_blocks=4, prefix_cache=False)
    je, te = both(mha, **kw)
    ps = prompts_of(13, (4, 4))
    got = serve(te, ps, 20)
    assert got == serve(je, ps, 20)
    assert sorted(len(g) for g in got)[1] == 20
    st = te.stats()
    assert st["memory_capped_retirements"] == \
        je.stats["memory_capped_retirements"] >= 1
    te.check_leak_free()


def test_head_of_line_memo_probes_like_jax(mha):
    """A queue head that does not fit is not re-probed every step: the
    allocator's probe count (attempts, successes and refusals) and the
    tokens equal JAX's, and the head was refused at least once."""
    kw = dict(batch_slots=3, prefill_buckets=[8, 16, 32], kv_layout="paged",
              kv_block_size=8, kv_num_blocks=7, prefix_cache=False)
    je, te = both(mha, **kw)
    ps = prompts_of(21, (20, 12, 25, 6))
    got = serve(te, ps, [10, 9, 6, 8])
    assert got == serve(je, ps, [10, 9, 6, 8])
    st = te.stats()
    assert te._alloc.probes == je._alloc.probes
    assert te._alloc.probes > st["prefills"] + st["preemptions"]
    assert te._alloc.probes < st["prefills"] + st["decode_steps"]
    te.check_leak_free()


def test_one_host_sync_per_paged_decode_step(gqa, monkeypatch):
    """Tables and lengths reach the device without a device-to-host
    read: one read per decode step (the sampled ids) plus one per
    admission (its first token)."""
    _, tm = gqa
    eng = InferenceEngine(tm, batch_slots=2, prefill_buckets=[8, 16],
                          kv_layout="paged", kv_block_size=8, device="cpu")
    ps = prompts_of(9, (5, 11, 14))
    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    serve(eng, ps, 9)
    monkeypatch.undo()
    st = eng.stats()
    assert st["decode_host_syncs"] == st["decode_steps"] > 0
    assert reads["n"] == st["host_syncs"] == st["decode_steps"] + len(ps)


def test_paged_engine_rejects_what_the_pool_cannot_hold(mha):
    _, tm = mha
    eng = InferenceEngine(tm, batch_slots=1, prefill_buckets=[8, 64],
                          kv_layout="paged", kv_block_size=8,
                          kv_num_blocks=3, device="cpu")
    with pytest.raises(ValueError, match="KV blocks"):
        eng.add_request(np.ones(12, np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="kv_layout"):
        InferenceEngine(tm, kv_layout="ring", device="cpu")
