"""The port's window attention and window model steps against the JAX
package's, on the CPU.

Ops: ``_window_plain`` and ``_paged_window_plain`` (what a CPU tensor
runs) against the JAX composites ``_window_composite`` and
``_paged_window_composite`` over fp and int8 caches, MHA and GQA (H=4,
Hkv=2), D=64, W in {1, 3, 8} and lengths 0, mid and S - W, and against
the Pallas window kernels run in interpret mode: f32 on the same numpy
inputs, 2e-5 (as tests/test_spec_decode.py holds the kernels to the
composite).  W = 1 equals the single-token decode with lengths + 1, and
the paged version equals the dense one on the same contents.  Model:
``verify_step``, ``verify_step_paged``, ``prefill_chunk`` and
``prefill_chunk_paged`` against JAX's with converted weights in f32,
logits at 1e-4 and the caches at every valid position; chunks driven to
the end of a prompt equal the monolithic prefill.
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
from paddle_tpu.inference.paged_kv import init_paged_cache as jax_pool
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference.paged_kv import init_paged_cache
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)

jda = importlib.import_module("paddle_tpu.ops.decode_attention")
jqm = importlib.import_module("paddle_tpu.ops.quantized_matmul")
tda = importlib.import_module("paddle_tpu_torch.ops.decode_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
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
def gqa():
    return build_pair(num_kv_heads=2)


_JIT = {}


def jit(model, method):
    """The JAX model's method under ``jax.jit`` (one compile per shape
    instead of one per eager op)."""
    key = (id(model), method)
    if key not in _JIT:
        _JIT[key] = jax.jit(getattr(model, method))
    return _JIT[key]


def to_t(xs):
    return [None if x is None else torch.from_numpy(np.asarray(x))
            for x in xs]


def to_j(xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


# ---- ops -----------------------------------------------------------------

def window_case(seed, w, hkv, quantized, b=3, h=4, s=128, d=64):
    """q, dense caches and lengths 0, 37 and S - W; int8 caches with
    f32 scale planes (``quantize_kv``) when quantized."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, w, h, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, s, hkv, d) * 0.3).astype(np.float32)
    v = (rng.randn(b, s, hkv, d) * 0.3).astype(np.float32)
    lengths = np.asarray([0, 37, s - w], np.int32)[:b]
    scales = (None, None)
    if quantized:
        kq, ks = jqm.quantize_kv(jnp.asarray(k))
        vq, vs = jqm.quantize_kv(jnp.asarray(v))
        k, v = np.asarray(kq), np.asarray(vq)
        scales = (np.asarray(ks), np.asarray(vs))
    return q, k, v, lengths, scales


def paged_of(k, v, scales, bs=128, seed=0):
    """The dense caches' contents scattered over a shuffled block pool
    (block 0 the null block), with tables one entry wider than needed."""
    b, s = k.shape[0], k.shape[1]
    mb = s // bs
    rng = np.random.RandomState(seed)
    tables = np.zeros((b, mb + 1), np.int32)
    tables[:, :mb] = (1 + rng.permutation(b * mb)).reshape(b, mb)
    nb = b * mb + 1

    def scatter(x):
        pool = np.zeros((nb, bs) + x.shape[2:], x.dtype)
        for i in range(b):
            for j in range(mb):
                pool[tables[i, j]] = x[i, j * bs:(j + 1) * bs]
        return pool
    ps = tuple(None if x is None else scatter(x) for x in scales)
    return scatter(k), scatter(v), tables, ps


def run_interpret(fn, *args):
    jda.set_interpret_mode(True)
    try:
        return np.asarray(fn(*args))
    finally:
        jda.set_interpret_mode(None)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("w", [1, 3, 8])
def test_window_plain_matches_jax_composite(w, hkv, quantized):
    q, k, v, lengths, (ks, vs) = window_case(w * 10 + hkv, w, hkv, quantized)
    args = (q, k, v, lengths, ks, vs)
    out = tda.decode_attention_window(*to_t(args)).numpy()
    np.testing.assert_allclose(out, np.asarray(
        jda._window_composite(*to_j(args))), **TOL)
    pk, pv, tables, (pks, pvs) = paged_of(k, v, (ks, vs), seed=w)
    pargs = (q, pk, pv, tables, lengths, pks, pvs)
    pout = tda.paged_decode_attention_window(*to_t(pargs)).numpy()
    np.testing.assert_allclose(pout, np.asarray(
        jda._paged_window_composite(*to_j(pargs))), **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("w", [1, 3, 8])
def test_window_plain_matches_interpret_kernel(w, quantized):
    """The Pallas ``_window_kernel``/``_window_kernel_q`` (interpret
    mode) at GQA, the paged ``_paged_window_kernel(_q)`` at W = 1 and 8."""
    q, k, v, lengths, (ks, vs) = window_case(w, w, 2, quantized)
    args = (q, k, v, lengths, ks, vs)
    out = tda.decode_attention_window(*to_t(args)).numpy()
    kern = run_interpret(jda.decode_attention_window, *to_j(args))
    np.testing.assert_allclose(out, kern, **TOL)
    if w == 3:
        return
    pk, pv, tables, (pks, pvs) = paged_of(k, v, (ks, vs), seed=w)
    pargs = (q, pk, pv, tables, lengths, pks, pvs)
    pout = tda.paged_decode_attention_window(*to_t(pargs)).numpy()
    pkern = run_interpret(jda.paged_decode_attention_window, *to_j(pargs))
    np.testing.assert_allclose(pout, pkern, **TOL)


# the chunk regime of the Hopper window kernels (W * G > 16 rows a kv
# head, 128-row tiles): bf16 inputs against the JAX composite, which
# rounds the probabilities to bf16 before p.v where the plain version
# keeps f32 (relative 2^-8 of each row's scale), hence 1e-2
CHUNK_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("layout", [None, 16, 48], ids=["dense", "bs16",
                                                        "bs48"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_window_plain_matches_jax_at_chunk_regime(kind, g, layout):
    """W = 64 new tokens (64 or 256 rows a kv head: more than one w per
    128-row tile at G = 4) over S = 240 cached positions, lengths 0, 37
    and S - W, H = 8, D = 64; bf16 caches or int8 codes dequantized to
    bf16, dense and paged with blocks of 16 and 48 (key tiles of 128
    that straddle blocks unevenly)."""
    w, h, s = 64, 8, 240
    q, k, v, lengths, (ks, vs) = window_case(
        g * 7 + (layout or 0), w, h // g, kind == "int8", h=h, s=s)
    bf = jnp.bfloat16

    def run(args, ours, theirs):
        tq = torch.from_numpy(args[0]).bfloat16()
        rest = to_t(args[1:])
        if kind == "bf16":
            rest[0], rest[1] = rest[0].bfloat16(), rest[1].bfloat16()
        out = ours(tq, *rest).float().numpy()
        jargs = to_j(args)
        jargs[0] = jargs[0].astype(bf)
        if kind == "bf16":
            jargs[1], jargs[2] = jargs[1].astype(bf), jargs[2].astype(bf)
        ref = np.asarray(theirs(*jargs).astype(jnp.float32))
        np.testing.assert_allclose(out, ref, **CHUNK_TOL)

    if layout is None:
        run((q, k, v, lengths, ks, vs), tda.decode_attention_window,
            jda._window_composite)
    else:
        pk, pv, tables, (pks, pvs) = paged_of(k, v, (ks, vs), bs=layout,
                                              seed=g)
        run((q, pk, pv, tables, lengths, pks, pvs),
            tda.paged_decode_attention_window, jda._paged_window_composite)


@pytest.mark.parametrize("layout", [None, 16, 48], ids=["dense", "bs16",
                                                        "bs48"])
@pytest.mark.parametrize("shape", ["w5_g1", "w1_g16"])
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_window_plain_matches_jax_at_verify_edges(dtype, shape, layout):
    """The verify regime of the Hopper window kernels (W * G <= 16 rows a
    kv head): int8 codes dequantized to q's dtype (bf16 or fp16), W = 5
    at G = 1 and W = 1 at G = 16, lengths 0, 1, 63, 64, 65 (around a
    64-key tile) and S - W over S = 192, dense and paged with blocks of 16
    and 48 and a null-block tail entry, against the JAX composites at
    CHUNK_TOL (they round the probabilities to q's dtype)."""
    w, h, hkv = (5, 4, 4) if shape == "w5_g1" else (1, 16, 1)
    s, d = 192, 64
    rng = np.random.RandomState(len(shape) + (layout or 0))
    lengths = np.asarray([0, 1, 63, 64, 65, s - w], np.int32)
    b = len(lengths)
    q = (rng.randn(b, w, h, d) * 0.3).astype(np.float32)
    (kq, ks), (vq, vs) = (jqm.quantize_kv(jnp.asarray(
        (rng.randn(b, s, hkv, d) * 0.3).astype(np.float32))) for _ in "kv")
    k, v = np.asarray(kq), np.asarray(vq)
    scales = (np.asarray(ks), np.asarray(vs))
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float16, jnp.float16))

    def run(args, ours, theirs):
        out = ours(torch.from_numpy(args[0]).to(tdt),
                   *to_t(args[1:])).float().numpy()
        jargs = to_j(args)
        jargs[0] = jargs[0].astype(jdt)
        ref = np.asarray(theirs(*jargs).astype(jnp.float32))
        np.testing.assert_allclose(out, ref, **CHUNK_TOL)

    if layout is None:
        run((q, k, v, lengths) + scales, tda.decode_attention_window,
            jda._window_composite)
    else:
        pk, pv, tables, ps = paged_of(k, v, scales, bs=layout, seed=w)
        run((q, pk, pv, tables, lengths) + ps,
            tda.paged_decode_attention_window, jda._paged_window_composite)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_window_of_one_is_decode_and_rows_are_sequential(quantized):
    """Row i of a window equals the single-token decode over lengths +
    i + 1 (W = 1 is the decode step), and the paged window equals the
    dense one on the same contents, bitwise."""
    q, k, v, lengths, scales = window_case(5, 4, 2, quantized)
    qt, kt, vt, lt, kst, vst = to_t((q, k, v, lengths) + scales)
    out = tda.decode_attention_window(qt, kt, vt, lt, kst, vst)
    for i in range(4):
        ref = tda.decode_attention(qt[:, i].contiguous(), kt, vt, lt + i + 1,
                                   kst, vst)
        torch.testing.assert_close(out[:, i], ref, **TOL)
    pk, pv, tables, ps = paged_of(k, v, scales, seed=3)
    pout = tda.paged_decode_attention_window(qt, *to_t((pk, pv, tables)), lt,
                                             *to_t(ps))
    torch.testing.assert_close(pout, out, rtol=0, atol=0)
    assert tda.chunk_prefill_attention is tda.decode_attention_window
    assert tda.paged_chunk_prefill_attention is \
        tda.paged_decode_attention_window


@pytest.mark.parametrize("case", ["d96", "g_layout", "dtype", "lengths",
                                  "bs", "tables_dtype", "q_rank"])
def test_window_kernels_reject_what_they_cannot_take(case):
    """The CUDA paths validate before any launch (checkable here): D=96,
    H % Hkv != 0, f32 q, int64 lengths, a block size that is not a
    multiple of 16, int64 tables, a q without its window axis."""
    bf = torch.bfloat16
    d = 96 if case == "d96" else 64
    q = torch.zeros(2, 3, 8, d, dtype=bf)
    cache = torch.zeros(2, 32, 3 if case == "g_layout" else 4, d, dtype=bf)
    pool = torch.zeros(5, 8 if case == "bs" else 16, 4, d, dtype=bf)
    tables = torch.zeros(2, 2, dtype=torch.int64 if case == "tables_dtype"
                         else torch.int32)
    lens = torch.ones(2, dtype=torch.int64 if case == "lengths"
                      else torch.int32)
    if case == "dtype":
        q = q.float()
    if case == "q_rank":
        q = q[:, 0]
    with pytest.raises((ValueError, TypeError)):
        if case in ("bs", "tables_dtype"):
            tda._paged_window_cuda(q, pool, pool, tables, lens, None, None)
        else:
            tda._window_cuda(q, cache, cache, lens, None, None)


# ---- model ---------------------------------------------------------------

def prefill_both(jm, tm, prompts, kv_dtype, cap=64):
    """Dense caches of both packages with each prompt prefilled into its
    slot (bucket 16)."""
    jc = jm.init_kv_cache(len(prompts), cap, kv_dtype=kv_dtype)
    tc = tm.init_kv_cache(len(prompts), cap, kv_dtype=kv_dtype)
    for slot, p in enumerate(prompts):
        ids = np.zeros((1, 16), np.int32)
        ids[0, :p.size] = p
        _, jc = jit(jm, "prefill")(jnp.asarray(ids), jc, np.int32(slot),
                                   np.int32(p.size))
        tm.prefill(torch.from_numpy(ids).long(), tc, slot, p.size)
    return jc, tc


def assert_dense_cache(tc, jc, lengths, kv_dtype):
    """Both caches' contents at every slot's positions below its length
    (int8: codes within one step, on at most 1e-3 of the elements, and
    scales at 1e-5, as test_torch_kvquant holds them)."""
    for tp, jp, ts, js in ((tc.k, jc.k, tc.k_scale, jc.k_scale),
                           (tc.v, jc.v, tc.v_scale, jc.v_scale)):
        for slot, n in enumerate(lengths):
            got, want = tp.numpy()[:, slot, :n], np.asarray(jp)[:, slot, :n]
            if kv_dtype is None:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                continue
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            np.testing.assert_allclose(ts.numpy()[:, slot, :n],
                                       np.asarray(js)[:, slot, :n],
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("pair_name", ["mha", "gqa"])
def test_verify_step_matches_jax(pair_name, kv_dtype, request):
    """A 4-token window over prompts of 5 and 11 tokens: logits of every
    window row at 1e-4, the caches at every written position, lengths
    left unchanged; then the window again over the same cache."""
    jm, tm = request.getfixturevalue(pair_name)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 97, (n,)).astype(np.int32) for n in (5, 11)]
    jc, tc = prefill_both(jm, tm, prompts, kv_dtype)
    for _ in range(2):
        toks = rng.randint(1, 97, (2, 4)).astype(np.int32)
        jl, jc = jit(jm, "verify_step")(jnp.asarray(toks), jc)
        tl, _ = tm.verify_step(torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
    assert_dense_cache(tc, jc, [5 + 4, 11 + 4], kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("pair_name", ["mha", "gqa"])
def test_prefill_chunk_matches_jax_and_monolithic(pair_name, kv_dtype,
                                                  request):
    """Chunks of 8 over prompts of 19 and 6 tokens (slot 1 joins late;
    slot 2 stays outside every chunk): each tick's last-token logits at
    1e-4 against JAX, lengths advanced to min(lengths + advance, cap);
    driven to the end, an fp cache and the last logits equal the port's
    monolithic prefill (an int8 chunk attends the earlier chunks'
    quantized k/v where the monolithic prefill attends full precision,
    in JAX as here)."""
    jm, tm = request.getfixturevalue(pair_name)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 97, (n,)).astype(np.int32) for n in (19, 6)]
    jc = jm.init_kv_cache(3, 64, kv_dtype=kv_dtype)
    tc = tm.init_kv_cache(3, 64, kv_dtype=kv_dtype)
    pos = [0, 0, 0]
    last = {}
    for tick in range(3):
        toks = np.zeros((3, 8), np.int32)
        adv = np.zeros(3, np.int32)
        for slot, p in enumerate(prompts):
            if slot == 1 and tick == 0:
                continue
            n = min(8, p.size - pos[slot])
            toks[slot, :n] = p[pos[slot]:pos[slot] + n]
            adv[slot] = n
        lens = np.asarray(pos, np.int32)
        jl, jc = jit(jm, "prefill_chunk")(jnp.asarray(toks), jc,
                                          jnp.asarray(lens), jnp.asarray(adv))
        tl, _ = tm.prefill_chunk(torch.from_numpy(toks).long(), tc,
                                 torch.from_numpy(lens), torch.from_numpy(adv))
        for slot in range(2):
            if adv[slot]:
                np.testing.assert_allclose(tl[slot].numpy(),
                                           np.asarray(jl)[slot], **LOGITS)
                last[slot] = tl[slot]
        pos = [min(a + int(d), 64) for a, d in zip(pos, list(adv))]
        np.testing.assert_array_equal(tc.lengths.numpy(), pos)
        np.testing.assert_array_equal(np.asarray(jc.lengths), pos)
    assert pos[:2] == [19, 6]
    assert_dense_cache(tc, jc, [19, 6], kv_dtype)
    if kv_dtype is not None:
        return
    mono = tm.init_kv_cache(2, 64)
    for slot, p in enumerate(prompts):
        ids = np.zeros((1, 32), np.int64)
        ids[0, :p.size] = p
        lg, _ = tm.prefill(torch.from_numpy(ids), mono, slot, p.size)
        torch.testing.assert_close(last[slot], lg[0], **LOGITS)
        for a, b in ((tc.k, mono.k), (tc.v, mono.v)):
            torch.testing.assert_close(a[:, slot, :p.size],
                                       b[:, slot, :p.size], rtol=1e-5,
                                       atol=1e-5)


def valid_rows(pool, table, length, bs):
    pool = np.asarray(pool)
    return np.concatenate([pool[:, table[t // bs], t % bs][:, None]
                           for t in range(length)], axis=1)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("pair_name", ["mha", "gqa"])
def test_paged_verify_and_chunk_match_jax(pair_name, kv_dtype, request):
    """Over a block pool (bs 8): a chunk tick that prefills 10 and 5
    tokens into two slots (a third outside it, on the null block), then a
    3-token verify window of both crossing into a new block: logits at
    1e-4 and the pool at every valid position of each slot."""
    jm, tm = request.getfixturevalue(pair_name)
    bs, nb = 8, 8
    rng = np.random.RandomState(8)
    tables = np.asarray([[1, 2, 5, 0], [3, 4, 0, 0], [0, 0, 0, 0]],
                        np.int32)
    jc = jax_pool(jm, nb, bs, kv_dtype=kv_dtype)
    tc = init_paged_cache(tm, nb, bs, kv_dtype=kv_dtype)
    toks = rng.randint(1, 97, (3, 12)).astype(np.int32)
    adv = np.asarray([10, 5, 0], np.int32)
    lens = np.zeros(3, np.int32)
    jl, jc = jit(jm, "prefill_chunk_paged")(
        jnp.asarray(toks), jc, jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(adv))
    tl, _ = tm.prefill_chunk_paged(torch.from_numpy(toks).long(), tc,
                                   torch.from_numpy(tables),
                                   torch.from_numpy(lens),
                                   torch.from_numpy(adv))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGITS)
    lens = np.asarray([10, 5, 0], np.int32)
    win = rng.randint(1, 97, (3, 3)).astype(np.int32)
    jl, jc = jit(jm, "verify_step_paged")(
        jnp.asarray(win), jc, jnp.asarray(tables), jnp.asarray(lens))
    tl, _ = tm.verify_step_paged(torch.from_numpy(win).long(), tc,
                                 torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGITS)
    for slot, n in ((0, 13), (1, 8)):
        for tp, jp, ts, js in ((tc.k, jc.k, tc.k_scale, jc.k_scale),
                               (tc.v, jc.v, tc.v_scale, jc.v_scale)):
            got = valid_rows(tp.numpy(), tables[slot], n, bs)
            want = valid_rows(jp, tables[slot], n, bs)
            if kv_dtype is None:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                continue
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            np.testing.assert_allclose(
                valid_rows(ts.numpy(), tables[slot], n, bs),
                valid_rows(js, tables[slot], n, bs), rtol=1e-5, atol=0)


def test_draft_weights_load_from_jax():
    """A one-layer draft of the tiny width (the tests' stand-in for a
    gpt3-125m draft of a larger target) converted from the JAX package:
    the same logits of a no-cache forward and of a verify window."""
    jm, tm = build_pair(seed=1, num_layers=1)
    ids = np.random.RandomState(2).randint(1, 97, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids).long()).detach().numpy(),
        np.asarray(jm(paddle.to_tensor(ids)).data), **LOGITS)
    jc, tc = prefill_both(jm, tm, [ids[0, :4], ids[1, :7]], None)
    jl, _ = jit(jm, "verify_step")(jnp.asarray(ids[:, :3]), jc)
    tl, _ = tm.verify_step(torch.from_numpy(ids[:, :3]).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
