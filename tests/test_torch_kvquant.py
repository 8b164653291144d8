"""The port's int8 KV cache against the JAX package's, on the CPU.

Ops: ``quantize_kv`` gives the JAX codes bitwise and its scales within 1
ulp on the same numpy inputs (ties included: both round half to even);
``_decode_plain`` over int8 caches matches the JAX composite
``_decode_composite`` and the Pallas int8 kernel run in interpret mode
(``_decode_gqa_q``) in f32, 2e-5 (f32 rounding, as tests/test_quantized.py
holds the kernel to the composite); the dense plain version at G = 16 as
well.  Model: int8 ``prefill``/``decode_step`` against JAX's in f32,
logits at 1e-4 and the stored cache equal: the model's k/v differ from
JAX's by f32 rounding, so a value that lies on a rounding boundary of its
code may land one code away; at most one code and one value in a
thousand may differ, scales at 1e-5.  Engine: greedy tokens identical to
the JAX int8 engines, dense and paged, and an int8 prefix hit equal to
the cold request.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

jda = importlib.import_module("paddle_tpu.ops.decode_attention")
jqm = importlib.import_module("paddle_tpu.ops.quantized_matmul")
tda = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
tqm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")

TOL = dict(rtol=2e-5, atol=2e-5)
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
    rids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


def assert_codes_match(t_codes, j_codes, t_scale, j_scale):
    """Stored int8 caches of the two models: codes at most one apart and
    equal but for boundary cases (<= 1e-3 of them); scales at 1e-5."""
    diff = np.abs(np.asarray(t_codes, np.int32) - np.asarray(j_codes,
                                                             np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
        (diff.max(), (diff > 0).sum())
    np.testing.assert_allclose(t_scale, j_scale, rtol=1e-5, atol=0)


# ---- quantization helpers ------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 3, 64), (2, 7, 4, 128), (16,)])
def test_quantize_kv_codes_bitwise_equal_to_jax(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 3).astype(np.float32)
    # ties: x / scale = k + 0.5 exactly for a few entries of each vector
    # (amax stays 127 * 2^-3, so the scale is a power of two)
    x[..., 0] = 127 * 0.125
    x[..., 1:4] = np.asarray([2.5, -3.5, 0.5], np.float32) * 0.125
    x[..., 4:] = np.clip(x[..., 4:], -127 * 0.125, 127 * 0.125)
    tq, ts = tqm.quantize_kv(torch.from_numpy(x))
    jq, js = jqm.quantize_kv(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    assert (tq.numpy()[..., 1:4] == np.asarray([2, -4, 0])).all()
    np.testing.assert_array_equal(
        tqm.dequantize_kv(tq, ts).numpy(),
        np.asarray(jqm.dequantize_kv(jq, js)))


def test_quantize_ties_round_half_to_even():
    x = torch.tensor([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5]])
    q, s = tqm.quantize_kv(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 2, -4, 0, 0, 2]]
    zero_q, zero_s = tqm.quantize_kv(torch.zeros(2, 8))
    assert zero_q.abs().max().item() == 0
    assert torch.all(zero_s == torch.tensor(1e-8) / 127)


def test_quantize_channel_matches_jax_on_any_axis():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 9, 5).astype(np.float32)
    for axis in (0, 1, 2):
        tq, ts = tqm.quantize_channel(torch.from_numpy(x), axis)
        jq, js = jqm.quantize_channel(jnp.asarray(x), axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)


def test_kv_mode_names_match_jax(monkeypatch):
    for name in (None, "", "none", "bf16", "float32", "INT8", " int8 "):
        assert tqm.resolve_kv_quant(name) == jqm.resolve_kv_quant(name)
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    assert tqm.resolve_kv_quant() == jqm.resolve_kv_quant() == "int8"
    assert tqm.kv_storage_dtype("int8") == torch.int8
    assert tqm.kv_quant_mode(torch.int8) == "int8"
    with pytest.raises(ValueError):
        tqm.kv_quant_mode(torch.bfloat16)
    with pytest.raises(ValueError):
        tqm.resolve_kv_quant("int4")


def test_fp8_raises_not_implemented(mha):
    """fp8 was refused before it was ported; now ``'fp8'`` resolves and
    allocates e4m3 storage with f32 scales, dense and paged."""
    _, tm = mha
    assert tqm.resolve_kv_quant("fp8") == "fp8"
    assert tqm.kv_storage_dtype("fp8") == torch.float8_e4m3fn
    cache = tm.init_kv_cache(2, kv_dtype="fp8")
    assert cache.quantized and cache.k.dtype == torch.float8_e4m3fn
    assert cache.k_scale.dtype == torch.float32
    eng = InferenceEngine(tm, kv_layout="paged", kv_dtype="fp8",
                          device="cpu")
    assert eng.cache.k.dtype == eng.cache.v.dtype == torch.float8_e4m3fn
    assert eng.stats()["kv_dtype"] == "fp8"


# ---- decode attention over int8 caches ---------------------------------

def int8_cache(rng, b, s, hkv, d):
    k = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, s, hkv, d) * 0.5).astype(np.float32)
    kq, ks = jqm.quantize_kv(jnp.asarray(k))
    vq, vs = jqm.quantize_kv(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


def run_jax_kernel(fn, *args):
    state = jda._STATE["interpret"]
    jda.set_interpret_mode(True)
    try:
        return np.asarray(fn(*args))
    finally:
        jda.set_interpret_mode(state)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (4, 1), (16, 1)])
def test_decode_plain_matches_jax(h, hkv, quantized):
    """Dense decode with and without int8 caches, G = H / Hkv up to 16:
    the port's plain version against the JAX composite and the Pallas
    kernel (``_decode_gqa`` / ``_decode_gqa_q``) in interpret mode."""
    b, s, d = 4, 256, 64
    rng = np.random.RandomState(h * 10 + hkv)
    q = (rng.randn(b, h, d) * 0.5).astype(np.float32)
    kq, vq, ks, vs = int8_cache(rng, b, s, hkv, d)
    if not quantized:
        kq, vq = (a.astype(np.float32) * sc[..., None]
                  for a, sc in ((kq, ks), (vq, vs)))
        ks = vs = None
    lengths = np.asarray([0, 1, 100, s], np.int32)
    args = (q, kq, vq, lengths, ks, vs)
    out = tda.decode_attention(*(None if a is None else torch.from_numpy(a)
                                 for a in args)).numpy()
    j = [None if a is None else jnp.asarray(a) for a in args]
    ref = np.asarray(jda._decode_composite(*j))
    # the composite averages uniformly over an empty slot; the kernels
    # (JAX's and the port's) give zeros there
    np.testing.assert_allclose(out[1:], ref[1:], **TOL)
    assert np.all(out[0] == 0.0)
    if not jda._fa._HAS_PLTPU:
        pytest.skip("pallas TPU backend unavailable: composite checked only")
    np.testing.assert_allclose(out, run_jax_kernel(jda.decode_attention, *j),
                               **TOL)


def test_int8_plain_rounds_dequantized_values_to_q_dtype():
    """In bf16 the plain version dequantizes to q's dtype before the dots,
    as the JAX int8 kernel does: equal to the fp plain version fed the
    bf16-rounded dequantized cache."""
    rng = np.random.RandomState(4)
    kq, vq, ks, vs = (torch.from_numpy(a) for a in int8_cache(rng, 2, 32, 2,
                                                               64))
    q = torch.from_numpy(rng.randn(2, 4, 64).astype(np.float32)).bfloat16()
    lens = torch.tensor([7, 32], dtype=torch.int32)
    got = tda.decode_attention(q, kq, vq, lens, ks, vs)
    want = tda.decode_attention(q, tqm.dequantize_kv(kq, ks, torch.bfloat16),
                                tqm.dequantize_kv(vq, vs, torch.bfloat16),
                                lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["codes_dtype", "scale_dtype", "one_scale",
                                  "scale_shape", "d", "g_layout"])
def test_int8_kernel_rejects_what_it_cannot_take(case):
    """The CUDA path of the dense int8 kernel validates before any launch
    (checkable on the CPU): bf16 codes with scales, f16 scales, only one
    scale tensor, misshapen scales, D=96, H % Hkv != 0."""
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    kc = torch.zeros(2, 32, 4, 64, dtype=torch.int8)
    ks = vs = torch.zeros(2, 32, 4)
    lens = torch.ones(2, dtype=torch.int32)
    if case == "codes_dtype":
        kc = kc.bfloat16()
    elif case == "scale_dtype":
        ks = vs = ks.half()
    elif case == "one_scale":
        vs = None
    elif case == "scale_shape":
        ks = vs = torch.zeros(2, 32, 2)
    elif case == "d":
        q = torch.zeros(2, 8, 96, dtype=torch.bfloat16)
        kc = torch.zeros(2, 32, 4, 96, dtype=torch.int8)
    elif case == "g_layout":
        kc = torch.zeros(2, 32, 3, 64, dtype=torch.int8)
        ks = vs = torch.zeros(2, 32, 3)
    with pytest.raises((ValueError, TypeError)):
        tda._decode_cuda(q, kc, kc, lens, ks, vs)


# ---- model ---------------------------------------------------------------

@pytest.mark.parametrize("pair_name", ["mha", "gqa"])
def test_int8_prefill_and_decode_match_jax(pair_name, request):
    """Two slots prefilled (bucket-padded) into an int8 dense cache, then
    4 decode steps with one slot inactive for a step: logits at 1e-4 and
    the stored codes and scales at every valid position as JAX's."""
    jm, tm = request.getfixturevalue(pair_name)
    jc = jm.init_kv_cache(2, kv_dtype="int8")
    tc = tm.init_kv_cache(2, kv_dtype="int8")
    assert tc.quantized and tc.k.dtype == torch.int8
    assert tuple(tc.k_scale.shape) == tuple(jc.k_scale.shape)
    p = prompts_of(8, (11, 5))
    for slot, prompt in enumerate(p):
        ids = np.zeros((1, 16), np.int32)
        ids[0, :prompt.size] = prompt
        jl, jc = jm.prefill(jnp.asarray(ids), jc, slot, prompt.size)
        tl, _ = tm.prefill(torch.from_numpy(ids).long(), tc, slot,
                           prompt.size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    rng = np.random.RandomState(9)
    for step in range(4):
        toks = rng.randint(1, 97, (2,)).astype(np.int32)
        act = np.asarray([1, 0 if step == 1 else 1], np.int32)
        jl, jc = jm.decode_step(jnp.asarray(toks), jc, jnp.asarray(act))
        tl, _ = tm.decode_step(torch.from_numpy(toks).long(), tc,
                               torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    lens = tc.lengths.numpy()
    np.testing.assert_array_equal(lens, np.asarray(jc.lengths))
    for slot in range(2):
        n = lens[slot]
        for t_codes, j_codes, t_sc, j_sc in ((tc.k, jc.k, tc.k_scale,
                                              jc.k_scale),
                                             (tc.v, jc.v, tc.v_scale,
                                              jc.v_scale)):
            assert_codes_match(t_codes.numpy()[:, slot, :n],
                               np.asarray(j_codes)[:, slot, :n],
                               t_sc.numpy()[:, slot, :n],
                               np.asarray(j_sc)[:, slot, :n])


# ---- engine --------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_engine_tokens_identical_to_jax(gqa, layout):
    """GQA, 5 requests of mixed lengths through 2 slots over an int8
    cache, dense and paged (blocks of 8): greedy tokens identical."""
    jm, tm = gqa
    kw = dict(batch_slots=2, prefill_buckets=[8, 16], kv_dtype="int8")
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_size=8)
    ps = prompts_of(11, (3, 13, 9, 16, 6))
    je = JaxEngine(jm, **kw)
    te = InferenceEngine(tm, device="cpu", **kw)
    got = serve(te, ps, 10)
    assert got == serve(je, ps, 10)
    assert all(len(g) == 10 for g in got)
    assert len({t for g in got for t in g}) > 5
    st = te.stats()
    assert st["kv_dtype"] == "int8" and st["kv_layout"] == layout
    assert st["decode_host_syncs"] == st["decode_steps"]
    assert st["prefill_host_syncs"] == len(ps)
    if layout == "paged":
        te.check_leak_free()


def test_int8_prefix_hit_equals_cold_and_jax(mha):
    """A 13-token prompt twice on an int8 paged engine: the second
    admission reuses the cached int8 block (dequantized into f32 for the
    suffix's attention) and gives the cold request's tokens, as in JAX."""
    jm, tm = mha
    kw = dict(batch_slots=2, prefill_buckets=[8, 16], kv_layout="paged",
              kv_block_size=8, kv_dtype="int8")
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
