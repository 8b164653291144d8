"""The port's fp8 (e4m3) serving and QAT against the JAX package's, on the
CPU.

Model: fp8-cache ``prefill``/``decode_step`` against JAX's in f32, logits
at 1e-4, the stored codes and scales at every valid position: the
models' k/v differ by f32 rounding, so a value on a rounding boundary of
its code may land one code away (at most one code in a thousand, each
within one e4m3 step of JAX's; scales at 1e-5).  Engines: greedy tokens
identical to the JAX fp8 engines, dense and paged, MHA and GQA; an fp8
prefix hit equal to the cold request and JAX's; the chunked and the
speculative fp8 engines (``PADDLE_TPU_KV_DTYPE=fp8``, which the draft's
cache follows) equal JAX's; a megakernel-enabled fp8 engine takes the
composed step (as JAX's ``_fused_supported`` does) and equals JAX's; an
fp8-cache MoE engine equals JAX's; the cache bytes and the HBM ledger's
KV line equal the int8 engine's (one byte a code).  Compute:
``GPTConfig(quantize='fp8')`` logits within 1e-3 of the logit scale
(an activation code may flip where the frameworks' f32 activations
differ in the last bit) and its engine's greedy tokens equal the JAX
model's own rollout; a ``strategy.qat`` fp8 ``SpmdTrainer`` tracks the
JAX trainer (SGD, 2 steps, losses at rtol 2e-4, parameters at 1e-5 of
their scale).  ``run_loadtest`` on an fp8 engine.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import create_mesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.inference import (InferenceEngine,
                                        SharedPrefixWorkload, run_loadtest)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.ops import decode_megakernel as tmk

LOGITS = dict(rtol=1e-4, atol=1e-4)
TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, initializer_range=0.2)
E4M3 = torch.float8_e4m3fn


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
    rids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


def assert_f8_codes_match(t_codes, j_codes, t_scale, j_scale):
    """Stored e4m3 caches of the two models: equal codes but for boundary
    cases (<= 1e-3 of them), each within one e4m3 step (2^-3 of the
    larger value, or the smallest subnormal) of JAX's; scales at 1e-5."""
    t8 = t_codes.view(torch.uint8).numpy()
    j8 = np.asarray(j_codes).view(np.uint8)
    tf = t_codes.float().numpy()
    jf = np.asarray(j_codes).astype(np.float32)
    differ = t8 != j8
    assert differ.mean() <= 1e-3, differ.sum()
    step = np.maximum(np.maximum(np.abs(tf), np.abs(jf)) / 8, 2.0 ** -9)
    assert (np.abs(tf - jf) <= step).all()
    np.testing.assert_allclose(t_scale, j_scale, rtol=1e-5, atol=0)


# ---- model -------------------------------------------------------------

@pytest.mark.parametrize("pair_name", ["mha", "gqa"])
def test_fp8_prefill_and_decode_match_jax(pair_name, request):
    """Two slots prefilled (bucket-padded) into an fp8 dense cache, then
    4 decode steps with one slot inactive for a step."""
    jm, tm = request.getfixturevalue(pair_name)
    # the JAX methods under jax.jit: one compile, not one per eager op
    prefill = jax.jit(jm.prefill, static_argnums=(2, 3))
    decode = jax.jit(jm.decode_step)
    jc = jm.init_kv_cache(2, kv_dtype="fp8")
    tc = tm.init_kv_cache(2, kv_dtype="fp8")
    assert tc.quantized and tc.k.dtype == E4M3
    assert tuple(tc.k_scale.shape) == tuple(jc.k_scale.shape)
    for slot, prompt in enumerate(prompts_of(8, (11, 5))):
        ids = np.zeros((1, 16), np.int32)
        ids[0, :prompt.size] = prompt
        jl, jc = prefill(jnp.asarray(ids), jc, slot, prompt.size)
        tl, _ = tm.prefill(torch.from_numpy(ids).long(), tc, slot,
                           prompt.size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    rng = np.random.RandomState(9)
    for step in range(4):
        toks = rng.randint(1, 97, (2,)).astype(np.int32)
        act = np.asarray([1, 0 if step == 1 else 1], np.int32)
        jl, jc = decode(jnp.asarray(toks), jc, jnp.asarray(act))
        tl, _ = tm.decode_step(torch.from_numpy(toks).long(), tc,
                               torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    lens = tc.lengths.numpy()
    np.testing.assert_array_equal(lens, np.asarray(jc.lengths))
    for slot in range(2):
        n = lens[slot]
        for tcd, jcd, tsc, jsc in ((tc.k, jc.k, tc.k_scale, jc.k_scale),
                                   (tc.v, jc.v, tc.v_scale, jc.v_scale)):
            assert_f8_codes_match(tcd[:, slot, :n],
                                  np.asarray(jcd)[:, slot, :n],
                                  tsc.numpy()[:, slot, :n],
                                  np.asarray(jsc)[:, slot, :n])


# ---- engines -----------------------------------------------------------

@pytest.mark.parametrize("pair_name,layout", [("mha", "dense"),
                                              ("gqa", "paged")])
def test_fp8_engine_tokens_identical_to_jax(pair_name, layout, request):
    """5 requests of mixed lengths through 2 slots over an fp8 cache:
    greedy tokens identical; one host sync per decode step and
    admission; the cache and the ledger's KV line one byte a code, as
    int8's."""
    jm, tm = request.getfixturevalue(pair_name)
    kw = dict(batch_slots=2, prefill_buckets=[8, 16], kv_dtype="fp8")
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_size=8)
    ps = prompts_of(11, (3, 13, 9, 16, 6))
    te = InferenceEngine(tm, device="cpu", **kw)
    got = serve(te, ps, 10)
    assert got == serve(JaxEngine(jm, **kw), ps, 10)
    assert all(len(g) == 10 for g in got)
    assert len({t for g in got for t in g}) > 5
    st = te.stats()
    assert st["kv_dtype"] == "fp8" and st["kv_layout"] == layout
    assert st["decode_host_syncs"] == st["decode_steps"]
    assert st["prefill_host_syncs"] == len(ps)
    int8 = InferenceEngine(tm, device="cpu", **{**kw, "kv_dtype": "int8"})
    nbytes = [sum(x.numel() * x.element_size() for x in
                  (e.cache.k, e.cache.v, e.cache.k_scale, e.cache.v_scale))
              for e in (te, int8)]
    assert nbytes[0] == nbytes[1]
    kv_line = [r["bytes"] for r in st["hbm"]["tracked"]
               if r["category"] == "kv_cache"
               and r["name"] == te.telemetry_label]
    assert kv_line == [nbytes[0]]
    if layout == "paged":
        te.check_leak_free()


def test_fp8_prefix_hit_equals_cold_and_jax(mha):
    """A 13-token prompt twice on an fp8 paged engine: the second
    admission reuses the cached e4m3 block (dequantized into f32 for the
    suffix's attention, the new positions written alone) and gives the
    cold request's tokens, as in JAX."""
    jm, tm = mha
    kw = dict(batch_slots=2, prefill_buckets=[8, 16], kv_layout="paged",
              kv_block_size=8, kv_dtype="fp8")
    prompt = prompts_of(7, (13,))[0]
    outs = {}
    for name, eng in (("jax", JaxEngine(jm, **kw)),
                      ("port", InferenceEngine(tm, device="cpu", **kw))):
        outs[name] = [serve(eng, [prompt], 5)[0] for _ in range(2)]
        st = eng.stats() if callable(eng.stats) else eng.stats
        assert st["prefix_hit_queries"] == 1
        assert st["prefill_tokens"] == 16 + 8
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == outs["port"][1]


@pytest.mark.parametrize("form", ["chunked", "spec"])
def test_fp8_chunked_and_spec_engines_match_jax(mha, form, monkeypatch):
    """``PADDLE_TPU_KV_DTYPE=fp8`` (no kv_dtype argument): the chunked
    (chunks of 4, paged) and the speculative (K = 2, dense, a one-layer
    draft whose own cache the variable makes e4m3 too) engines give the
    JAX engines' greedy streams."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "fp8")
    jm, tm = mha
    kw = dict(batch_slots=2, prefill_buckets=[16])
    jkw, tkw = dict(kw), dict(kw)
    if form == "chunked":
        for d in (jkw, tkw):
            d.update(prefill_chunk=4, kv_layout="paged", kv_block_size=8)
    else:
        jd, td = build_pair(num_layers=1)
        jkw.update(spec_k=2, draft_model=jd)
        tkw.update(spec_k=2, draft_model=td)
    ps = prompts_of(0, (5, 9, 3, 16))
    eng = InferenceEngine(tm, device="cpu", **tkw)
    assert eng.cache.k.dtype == E4M3
    got = serve(eng, ps, 10)
    assert got == serve(JaxEngine(jm, **jkw), ps, 10)
    st = eng.stats()
    assert st["kv_dtype"] == "fp8"
    if form == "spec":
        assert eng._spec.draft_cache.k.dtype == E4M3
        assert st["decode_host_syncs"] == st["spec_ticks"] > 0
    else:
        assert st["chunk_ticks"] > 0
        eng.check_leak_free()


def test_fp8_megakernel_engine_takes_the_composed_route(monkeypatch):
    """With the megakernel asked for, an fp8 cache keeps each decode
    layer on ``_composite`` (never ``_mega_plain``, the fused step's plain
    version), as JAX routes fp8 caches; tokens equal the JAX engine's
    with the megakernel asked for, and the port's composed engine's."""
    jm, tm = build_pair(num_kv_heads=2, decode_megakernel=True)
    assert tm.gpt._megakernel_active()
    calls = {"composite": 0}
    composite = tmk._composite

    def counted(*a, **k):
        calls["composite"] += 1
        return composite(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the fused step ran over an fp8 cache")
    monkeypatch.setattr(tmk, "_composite", counted)
    monkeypatch.setattr(tmk, "_mega_plain", refuse)
    kw = dict(batch_slots=2, prefill_buckets=[16, 32], kv_dtype="fp8")
    ps = prompts_of(5, (3, 17, 9, 30))
    eng = InferenceEngine(tm, device="cpu", **kw)
    got = serve(eng, ps, 8)
    st = eng.stats()
    assert calls["composite"] == st["decode_steps"] * tm.cfg.num_layers > 0
    assert got == serve(JaxEngine(jm, **kw), ps, 8)
    tm.enable_decode_megakernel(False)
    assert got == serve(InferenceEngine(tm, device="cpu", **kw), ps, 8)


def test_fp8_moe_engine_matches_jax():
    """A tiny GPT-MoE (every second block top-2 of 4 experts) over an fp8
    cache, dense: the JAX engine's greedy streams and expert loads."""
    jm, tm = build_pair(hidden_size=32, num_kv_heads=2, moe_num_experts=4,
                        moe_top_k=2, moe_capacity_factor=1.0,
                        moe_every_n_layers=2)
    kw = dict(batch_slots=2, kv_dtype="fp8")
    ps = prompts_of(5, (3, 20, 9, 17))
    eng = InferenceEngine(tm, device="cpu", **kw)
    jeng = JaxEngine(jm, **kw)
    assert serve(eng, ps, 6) == serve(jeng, ps, 6)
    st, jst = eng.stats(), jeng.stats
    assert st["moe_expert_load"] == jst["moe_expert_load"]


def test_fp8_loadtest(gqa):
    """``run_loadtest`` on an fp8 paged engine: every request served, a
    drained pool leak-free."""
    _, tm = gqa
    eng = InferenceEngine(tm, device="cpu", batch_slots=2,
                          prefill_buckets=[16], kv_layout="paged",
                          kv_block_size=4, kv_dtype="fp8")
    rep = run_loadtest(eng, 6, 200.0, workload=SharedPrefixWorkload(
        97, seed=0, shared_frac=0.5, prefix_len=8, tail_len=(3, 6),
        max_new=(2, 4)), deadline_s=30.0)
    assert rep["num_requests"] == 6 and rep["timed_out_requests"] == 0
    assert rep["tokens_generated"] > 0 and eng.stats()["kv_dtype"] == "fp8"
    assert eng.drain() == []
    eng.check_leak_free()


# ---- fp8 compute -------------------------------------------------------

def test_fp8_compute_model_and_engine_match_jax():
    """``GPTConfig(quantize='fp8')``: logits of a no-cache forward against
    JAX's, and the fp8-compute engine over an fp8 cache against the JAX
    model's own prefill + decode rollout over an fp8 cache."""
    jm, tm = build_pair(quantize="fp8")
    assert all(lin.quantize == "fp8" for blk in tm.gpt.blocks
               for lin in (blk.attn.qkv_proj, blk.mlp.down_proj))
    ids = np.random.RandomState(3).randint(0, 97, (2, 11)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda i: jm(paddle.Tensor(i)).data)(
        jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()
    prefill = jax.jit(lambda i, c, n: jm.prefill(i, c, 0, n),
                      static_argnums=2)
    step = jax.jit(lambda tok, c: jm.decode_step(
        tok, c, jnp.asarray([1], jnp.int32)))
    prompts = prompts_of(4, (3, 14))
    want = []
    for prompt in prompts:
        ids = np.zeros((1, 16), np.int32)
        ids[0, :len(prompt)] = prompt
        logits, cache = prefill(jnp.asarray(ids),
                                jm.init_kv_cache(1, kv_dtype="fp8"),
                                len(prompt))
        toks = [int(np.argmax(np.asarray(logits)[0]))]
        for _ in range(4):
            logits, cache = step(jnp.asarray([toks[-1]], jnp.int32), cache)
            toks.append(int(np.argmax(np.asarray(logits)[0])))
        want.append(toks)
    eng = InferenceEngine(tm, batch_slots=2, prefill_buckets=[16],
                          kv_dtype="fp8", device="cpu")
    assert serve(eng, prompts, 5) == want


def test_fp8_qat_trainer_matches_jax():
    """``strategy.qat`` with ``qat_configs={'quantize': 'fp8'}`` on a
    ``{"dp": 1}`` mesh, SGD, two steps of one batch."""
    cfg = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
               max_seq_len=64)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (2, 32)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**cfg))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    st = JaxStrategy()
    st.qat = True
    st.qat_configs = {"quantize": "fp8"}
    crit = JaxCriterion()
    jtr = JaxTrainer(jm, paddle.optimizer.SGD(learning_rate=0.1,
                                              parameters=jm.parameters()),
                     lambda o, lab: crit(o, lab),
                     mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                     strategy=st)
    ref = [float(jtr.train_step(ids, labels)) for _ in range(2)]

    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_paddle_tpu_params(tm, named)
    st2 = DistributedStrategy()
    st2.qat = True
    st2.qat_configs = {"quantize": "fp8"}
    tcrit = GPTPretrainingCriterion()
    tr = SpmdTrainer(tm, topt.SGD(learning_rate=0.1),
                     lambda o, lab: tcrit(o, lab), strategy=st2)
    assert tm.cfg.quantize == "fp8"
    got = [float(tr.train_step(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert got[-1] < got[0]
    for n, p in tr.params.items():
        want = np.asarray(jtr.params[n], np.float32)
        assert np.abs(p.float().numpy() - want).max() <= \
            1e-5 * max(np.abs(want).max(), 1.0), n
