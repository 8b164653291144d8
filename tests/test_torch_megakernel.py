"""The port's fused per-layer decode step against the JAX package's, on
the CPU.

Op: ``_mega_plain`` (what the CUDA kernel computes) against the JAX
``decode_layer_step`` / ``decode_layer_step_paged`` on the matrix of
tests/test_decode_megakernel.py (fp/int8 x dense/paged x Hkv in {2, 1};
B=5, H=128, F=256, capacity 256, lengths 0, 1, 127, 128, 255) in f32 at
1e-5: against the JAX composite in all eight cases and against the Pallas
kernel in interpret mode in two of them.  The ``quantize`` route (the
composed path with int8 projections, which the JAX package takes for
int8 compute) against JAX's at 1e-4 of the output's scale: both
quantize the same activations, whose f32 values may differ in the last
bit and flip a code.  Model: ``enable_decode_megakernel()`` against the
composed model on the same weights, prefill + decode logits at 1e-5 and
equal caches, dense and paged, full precision and int8; engines give
greedy tokens equal to the composed engines'; ``stats()`` reports the
knob.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import decode_megakernel as jmk
from paddle_tpu.ops.quantized_matmul import quantize_kv as jquantize_kv
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.inference.paged_kv import init_paged_cache
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

tmk = importlib.import_module("paddle_tpu_torch.ops.decode_megakernel")

TOL = 1e-5
TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, initializer_range=0.2)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def layer_case(paged, quantized, hkv, seed=0):
    """The JAX test's inputs: (jax args, torch args)."""
    rng = np.random.RandomState(seed)
    b, heads, d, f, cap = 5, 2, 64, 256, 256
    h = heads * d
    kvd = hkv * d

    def r(*s):
        return rng.randn(*s).astype(np.float32) * 0.05

    w = (r(h) + 1.0, r(h), r(h, h + 2 * kvd), r(h + 2 * kvd), r(h, h), r(h),
         r(h) + 1.0, r(h), r(h, f), r(f), r(f, h), r(h))
    x = rng.randn(b, h).astype(np.float32) * 0.1
    lengths = np.asarray([0, 1, 127, 128, 255], np.int32)
    if paged:
        bs = 128
        mb = cap // bs
        shape = (b * mb + 1, bs, hkv, d)
        tables = np.arange(1, b * mb + 1).reshape(b, mb).astype(np.int32)
    else:
        shape = (b, cap, hkv, d)
        tables = None
    k = rng.randn(*shape).astype(np.float32) * 0.1
    v = rng.randn(*shape).astype(np.float32) * 0.1
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = ([np.asarray(a) for a in jquantize_kv(
            jnp.asarray(c))] for c in (k, v))
    wj = tuple(jnp.asarray(a) for a in w)
    kv = (jnp.asarray(k), jnp.asarray(v))
    sc = () if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    if paged:
        jargs = (jnp.asarray(x), wj, *kv, jnp.asarray(tables),
                 jnp.asarray(lengths), *sc)
    else:
        jargs = (jnp.asarray(x), wj, *kv, jnp.asarray(lengths), *sc)
    targs = dict(x=t(x), w=tuple(t(a) for a in w), k=t(k), v=t(v),
                 tables=t(tables), lengths=t(lengths), ks=t(ks), vs=t(vs))
    return jargs, targs


def run_port(a, quantize=None):
    if a["tables"] is None:
        return tmk.decode_layer_step(a["x"], a["w"], a["k"], a["v"],
                                     a["lengths"], a["ks"], a["vs"],
                                     quantize=quantize)
    return tmk.decode_layer_step_paged(a["x"], a["w"], a["k"], a["v"],
                                       a["tables"], a["lengths"], a["ks"],
                                       a["vs"], quantize=quantize)


@pytest.mark.parametrize("hkv", [2, 1])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mega_plain_matches_jax(paged, quantized, hkv):
    jargs, targs = layer_case(paged, quantized, hkv)
    fn = jmk.decode_layer_step_paged if paged else jmk.decode_layer_step
    got = [o.numpy() for o in run_port(targs)]
    jmk.set_interpret_mode(False)          # the CPU's XLA composite
    try:
        ref = fn(*jargs)
    finally:
        jmk.set_interpret_mode(None)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=TOL, rtol=0)
    if paged != quantized or hkv != 2 - int(paged):
        return      # the interpret-mode kernel on two corners: wall time
    if not jmk._fa._HAS_PLTPU:
        pytest.skip("pallas TPU backend unavailable: composite checked only")
    jmk.set_interpret_mode(True)
    try:
        ref = jax.jit(lambda *a: fn(*a))(*jargs)
    finally:
        jmk.set_interpret_mode(None)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=TOL, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_quantize_route_matches_jax_composite(paged):
    jargs, targs = layer_case(paged, True, 2, seed=1)
    fn = jmk.decode_layer_step_paged if paged else jmk.decode_layer_step
    ref = [np.asarray(r) for r in fn(*jargs, quantize="int8")]
    got = [o.numpy() for o in run_port(targs, quantize="int8")]
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


def test_plain_reads_the_cache_and_writes_nothing():
    _, targs = layer_case(False, True, 1)
    before = [targs[n].clone() for n in ("k", "v", "ks", "vs")]
    run_port(targs)
    for a, n in zip(before, ("k", "v", "ks", "vs")):
        assert torch.equal(a, targs[n])


# ---- the model and the engines ------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """Two copies of one tiny model: composed, and with the megakernel."""
    torch.manual_seed(0)
    comp = GPTForCausalLM(GPTConfig(**TINY, num_kv_heads=2), device="cpu")
    mega = GPTForCausalLM(GPTConfig(**TINY, num_kv_heads=2), device="cpu")
    with torch.no_grad():
        for p in comp.parameters():          # nonzero biases and norms
            if p.dim() == 1:
                p.add_(torch.randn(p.shape) * 0.05)
    mega.load_state_dict(comp.state_dict())
    mega.enable_decode_megakernel()
    return comp, mega


def rollout(model, paged, kv_dtype, ids, plen, steps):
    """Prefill + teacher-forced decode steps; returns logits and cache."""
    if paged:
        cache = init_paged_cache(model, 5, 16, kv_dtype=kv_dtype)
        row = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
        out = [model.prefill_paged(ids[:, :plen], cache, row[0], 0, plen)[0]]
        for t_ in range(plen, plen + steps):
            out.append(model.decode_step_paged(
                ids[:, t_], cache, row,
                torch.tensor([t_], dtype=torch.int32))[0])
    else:
        cache = model.init_kv_cache(2, kv_dtype=kv_dtype)
        out = [model.prefill(ids[:, :plen], cache, 0, plen)[0]]
        for t_ in range(plen, plen + steps):
            tok = torch.stack([ids[0, t_], torch.tensor(0)])
            out.append(model.decode_step(
                tok, cache, torch.tensor([1, 0], dtype=torch.int32))[0][:1])
    return torch.cat(out), cache


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_megakernel_model_matches_composed(models, paged, kv_dtype):
    comp, mega = models
    assert mega.gpt._megakernel_active() and not comp.gpt._megakernel_active()
    ids = torch.randint(1, 97, (1, 16),
                        generator=torch.Generator().manual_seed(2))
    want, c1 = rollout(comp, paged, kv_dtype, ids, 9, 6)
    got, c2 = rollout(mega, paged, kv_dtype, ids, 9, 6)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    if kv_dtype is None:
        torch.testing.assert_close(c2.k, c1.k, atol=TOL, rtol=0)
        torch.testing.assert_close(c2.v, c1.v, atol=TOL, rtol=0)
    else:
        # the new k/v went into the cache through the same quantizer; a
        # value on a rounding boundary may land one code away
        for a, b in ((c2.k, c1.k), (c2.v, c1.v)):
            diff = (a.int() - b.int()).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
        torch.testing.assert_close(c2.k_scale, c1.k_scale, atol=1e-6,
                                   rtol=1e-5)


def serve(eng, prompts, new):
    rids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_megakernel_engine_tokens_equal_composed(models, layout, kv_dtype):
    comp, mega = models
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 97, (n,)).astype(np.int32)
               for n in (3, 17, 9, 30)]
    kw = dict(batch_slots=2, prefill_buckets=[16, 32], kv_layout=layout,
              kv_dtype=kv_dtype, device="cpu")
    if layout == "paged":
        kw["kv_block_size"] = 8
    want = serve(InferenceEngine(comp, **kw), prompts, 8)
    eng = InferenceEngine(mega, **kw)
    assert serve(eng, prompts, 8) == want
    st = eng.stats()
    assert st["decode_megakernel"] is True
    assert st["decode_host_syncs"] == st["decode_steps"]


def test_stats_report_the_knob_and_its_override(models, monkeypatch):
    comp, mega = models
    monkeypatch.delenv("PADDLE_TPU_DECODE_MEGAKERNEL", raising=False)
    assert InferenceEngine(comp, batch_slots=1, device="cpu").stats()[
        "decode_megakernel"] is False
    assert InferenceEngine(mega, batch_slots=1, device="cpu").stats()[
        "decode_megakernel"] is True
    monkeypatch.setenv("PADDLE_TPU_DECODE_MEGAKERNEL", "1")
    assert comp.gpt._megakernel_active()
    monkeypatch.setenv("PADDLE_TPU_DECODE_MEGAKERNEL", "0")
    assert not mega.gpt._megakernel_active()
    assert InferenceEngine(mega, batch_slots=1, device="cpu").stats()[
        "decode_megakernel"] is False


def test_megakernel_stands_down_under_dropout_in_training():
    m = GPTForCausalLM(GPTConfig(**TINY, dropout=0.1), device="cpu").eval()
    m.enable_decode_megakernel()
    assert m.gpt._megakernel_active()          # eval: dropout is inert
    m.train()
    assert not m.gpt._megakernel_active()
    m.enable_decode_megakernel(False)
    m.eval()
    assert not m.gpt._megakernel_active()


def test_quantized_megakernel_model_takes_the_composed_route(models):
    """With int8 compute the fused step is the composed path with int8
    projections (the JAX routing): its logits follow the quantized
    composed model's."""
    comp, _ = models
    qc = GPTForCausalLM(GPTConfig(**TINY, num_kv_heads=2), device="cpu")
    qm = GPTForCausalLM(GPTConfig(**TINY, num_kv_heads=2), device="cpu")
    for m in (qc, qm):
        m.load_state_dict(comp.state_dict())
        m.enable_quantize("int8")
    qm.enable_decode_megakernel()
    ids = torch.randint(1, 97, (1, 14),
                        generator=torch.Generator().manual_seed(3))
    want, _ = rollout(qc, False, None, ids, 8, 5)
    got, _ = rollout(qm, False, None, ids, 8, 5)
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()
