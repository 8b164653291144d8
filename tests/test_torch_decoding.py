"""The port's decoding API (``text.decoding``, ``nn.decode``, ``text.utils``)
against the JAX package's, on the CPU.

Tokens, beam parents, paths and lengths must be EQUAL.  Scores within
1e-5 relative (f32 log-softmax sums and Viterbi maxima in two libraries'
orders).  The toy LMs are table lookups whose logits depend on the state
leaves too (one with a leading ``[B*K]`` dim, one on axis 1), so a beam
that kept another beam's state decodes differently; the tables force
ties (equal logits, and the ``-1e9`` of finished beams) so that the
top-k's tie order shows.  The GPT searches run ``gpt_step_fn`` over a
2-layer, hidden-64 GPT whose weights the port loads from the JAX model
(``models.convert``), over a full-precision, an int8 and an fp8 cache:
their logits differ by f32 rounding only, so the sequences must be
equal and the scores within 1e-5 relative too.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import decode as jdecode
from paddle_tpu.text import decoding as jdec
from paddle_tpu.text import utils as jutils

from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.nn import decode as tdecode
from paddle_tpu_torch.text import decoding as tdec
from paddle_tpu_torch.text import utils as tutils

V, EOS, BOS = 7, 0, 1
SCORE = dict(rtol=1e-5, atol=1e-6)


def j2n(x):
    return np.asarray(getattr(x, "data", x))


def table_lm(seed, eos_bias=0.0, ties=False):
    """A next-token table plus a state-dependent term, and the same step
    in both packages.  State: ``{"sum": [N] int32, "hist": [2, N, 1]
    f32}``; the logits add ``bonus[sum % V]`` and ``0.5 * hist``."""
    rng = np.random.RandomState(seed)
    table = (rng.randn(V, V) * 1.5).astype(np.float32)
    table[:, EOS] += eos_bias
    if ties:
        # equal logits in every row: ties among live beams too
        table[:, 2] = table[:, 3] = table[:, 4]
    bonus = (rng.randn(V, V) * 0.5).astype(np.float32)

    def jstep(tokens, state):
        s = state["sum"] + tokens
        logits = jnp.asarray(table)[tokens] + jnp.asarray(bonus)[s % V] + \
            0.5 * state["hist"][0]
        hist = state["hist"].at[1].set(state["hist"][0]) \
            .at[0].add(tokens[:, None].astype(jnp.float32) * 0.1)
        return logits, {"sum": s, "hist": hist}

    def tstep(tokens, state):
        s = state["sum"] + tokens
        logits = torch.from_numpy(table)[tokens.long()] + \
            torch.from_numpy(bonus)[(s % V).long()] + 0.5 * state["hist"][0]
        hist = state["hist"].clone()
        hist[1] = state["hist"][0]
        hist[0] += tokens[:, None].float() * 0.1
        return logits, {"sum": s, "hist": hist}

    def init(n):
        return ({"sum": jnp.zeros((n,), jnp.int32),
                 "hist": jnp.zeros((2, n, 1), jnp.float32)},
                {"sum": torch.zeros(n, dtype=torch.int32),
                 "hist": torch.zeros(2, n, 1)})
    return jstep, tstep, init


def test_gather_tree_matches_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, (6, 3, 4)).astype(np.int32)
    parents = rng.randint(0, 4, (6, 3, 4)).astype(np.int32)
    got = tdec.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  j2n(jdec.gather_tree(ids, parents)))


@pytest.mark.parametrize("case", [
    dict(seed=0, B=2, K=3, T=6),
    dict(seed=1, B=2, K=4, T=8, eos_bias=2.5),             # early EOS
    dict(seed=2, B=3, K=3, T=7, ties=True),                # forced ties
    dict(seed=3, B=2, K=3, T=6, eos_bias=1.5, lp=0.8),     # GNMT penalty
    dict(seed=4, B=1, K=2, T=30, eos_bias=4.0, ties=True),  # exits early
])
def test_beam_search_matches_jax(case):
    B, K, T = case["B"], case["K"], case["T"]
    jstep, tstep, init = table_lm(case["seed"], case.get("eos_bias", 0.0),
                                  case.get("ties", False))
    js, ts = init(B * K)
    lp = case.get("lp", 0.0)
    jseq, jsc = jdec.beam_search(jstep, js, B, K, T, BOS, EOS,
                                 length_penalty=lp)
    tseq, tsc = tdec.beam_search(tstep, ts, B, K, T, BOS, EOS,
                                 length_penalty=lp)
    assert tseq.dtype == torch.int32 and tuple(tseq.shape) == (B, K, T)
    np.testing.assert_array_equal(tseq.numpy(), j2n(jseq))
    np.testing.assert_allclose(tsc.numpy(), j2n(jsc), **SCORE)


def test_top_k_tie_order_is_lax_order():
    """Two equal totals in one row: the lower flat index (beam 0's token
    before beam 1's, a lower token before a higher one) comes first, as
    in ``lax.top_k``.  At t = 0 beams 1..K-1 sit at -1e9 and in f32 their
    totals collapse to equal values, so beams 1 and 2 also tie."""
    table = np.full((V, V), -5.0, np.float32)
    table[BOS, 3] = table[BOS, 5] = 2.0           # a tie at t = 0
    table[3, EOS] = table[5, EOS] = 1.0

    def jstep(tokens, state):
        return jnp.asarray(table)[tokens], state

    def tstep(tokens, state):
        return torch.from_numpy(table)[tokens.long()], state
    jseq, jsc = jdec.beam_search(jstep, (), 1, 3, 4, BOS, EOS)
    tseq, tsc = tdec.beam_search(tstep, (), 1, 3, 4, BOS, EOS,
                                 device="cpu")
    np.testing.assert_array_equal(tseq.numpy(), j2n(jseq))
    np.testing.assert_allclose(tsc.numpy(), j2n(jsc), **SCORE)
    assert tseq[0, 0, 0] == 3 and tseq[0, 1, 0] == 5


def test_regather_by_cache_fields_and_shape_rule():
    """A StaticKVCache is regathered by its fields (axis 1, lengths axis
    0) even when its layer count equals B*K, where the shape rule would
    take axis 0; other leaves follow the shape rule; a leaf with no B*K
    dim raises."""
    from paddle_tpu_torch.models.gpt import StaticKVCache
    bk = 4
    k = torch.arange(bk * bk * 2, dtype=torch.float32).reshape(bk, bk, 2, 1, 1)
    cache = StaticKVCache(k.clone(), k.clone() + 1,
                          torch.arange(bk, dtype=torch.int32))
    parent = torch.tensor([1, 1, 3, 0])
    other = {"a": torch.arange(bk), "b": [torch.zeros(3, bk) + torch.arange(bk)]}
    out = tdec._regather((cache, other), parent, bk)
    assert out[0] is cache
    torch.testing.assert_close(cache.k, k[:, parent])
    torch.testing.assert_close(cache.lengths, parent.int())
    torch.testing.assert_close(out[1]["a"], parent)
    torch.testing.assert_close(out[1]["b"][0], torch.zeros(3, bk) + parent)
    with pytest.raises(ValueError):
        tdec._regather(torch.zeros(3, 5), parent, bk)


@pytest.mark.parametrize("seed,eos_bias", [(0, 0.0), (5, 3.0)])
def test_greedy_search_matches_jax_and_beam1(seed, eos_bias):
    B, T = 3, 9
    jstep, tstep, init = table_lm(seed, eos_bias)
    js, ts = init(B)
    got = tdec.greedy_search(tstep, ts, B, T, BOS, EOS)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    np.testing.assert_array_equal(
        got.numpy(), j2n(jdec.greedy_search(jstep, js, B, T, BOS, EOS)))
    beam, _ = tdec.beam_search(tstep, init(B)[1], B, 1, T, BOS, EOS)
    np.testing.assert_array_equal(beam[:, 0].numpy(), got.numpy())


def test_search_without_tensor_state_needs_a_device():
    """With no tensor in the state the search runs on ``device``: CUDA
    unless the caller asks for the CPU, so without a card it raises."""
    def step(tokens, state):
        return torch.zeros(tokens.shape[0], V), state
    out = tdec.greedy_search(step, (), 2, 3, BOS, EOS, device="cpu")
    assert out.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tdec.greedy_search(step, (), 2, 3, BOS, EOS)


@pytest.mark.parametrize("tags,ragged", [(True, True), (False, True),
                                         (True, False)])
def test_viterbi_decode_matches_jax(tags, ragged):
    rng = np.random.RandomState(int(tags) * 2 + int(ragged))
    b, t, n = 4, 9, 6
    em = rng.randn(b, t, n).astype(np.float32)
    tr = rng.randn(n, n).astype(np.float32)
    lengths = np.array([9, 4, 1, 6], np.int64) if ragged else None
    js, jp = jdec.viterbi_decode(em, tr, lengths, include_bos_eos_tag=tags)
    ts, tp = tdec.viterbi_decode(
        torch.from_numpy(em), torch.from_numpy(tr),
        None if lengths is None else torch.from_numpy(lengths),
        include_bos_eos_tag=tags)
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (b, t)
    np.testing.assert_array_equal(tp.numpy(), j2n(jp))
    np.testing.assert_allclose(ts.numpy(), j2n(js), **SCORE)


def rnn_cell_pair(seed, e=5, h=8):
    """A tanh RNN cell, embedding and output projection from one set of
    numpy weights, in both packages."""
    rng = np.random.RandomState(seed)
    emb = rng.randn(V, e).astype(np.float32)
    w = (rng.randn(e, h) * 0.5).astype(np.float32)
    u = (rng.randn(h, h) * 0.5).astype(np.float32)
    out = rng.randn(h, V).astype(np.float32)
    out[:, EOS] += 0.8

    def jcell(x, state):
        hn = jnp.tanh(x @ w + state[0] @ u)
        return hn, (hn, state[1] + 1)

    def tcell(x, state):
        hn = torch.tanh(x @ torch.from_numpy(w) + state[0] @ torch.from_numpy(u))
        return hn, (hn, state[1] + 1)
    jdecoder = jdecode.BeamSearchDecoder(
        jcell, BOS, EOS, 3, embedding_fn=lambda t: jnp.asarray(emb)[t],
        output_fn=lambda o: o @ out)
    tdecoder = tdecode.BeamSearchDecoder(
        tcell, BOS, EOS, 3,
        embedding_fn=lambda t: torch.from_numpy(emb)[t.long()],
        output_fn=lambda o: o @ torch.from_numpy(out))
    h0 = (rng.randn(2, h) * 0.3).astype(np.float32)
    return (jdecoder, (jnp.asarray(h0), jnp.zeros((2,), jnp.int32)),
            tdecoder, (torch.from_numpy(h0), torch.zeros(2, dtype=torch.int32)))


@pytest.mark.parametrize("time_major", [False, True])
def test_dynamic_decode_matches_jax(time_major):
    jd, jinit, td, tinit = rnn_cell_pair(int(time_major))
    jids, jsc, jlen = jdecode.dynamic_decode(
        jd, jinit, max_step_num=7, output_time_major=time_major,
        return_length=True)
    tids, tsc, tlen = tdecode.dynamic_decode(
        td, tinit, max_step_num=7, output_time_major=time_major,
        return_length=True)
    assert tuple(tids.shape) == ((7, 2, 3) if time_major else (2, 7, 3))
    assert tlen.dtype == torch.int64
    np.testing.assert_array_equal(tids.numpy(), j2n(jids))
    np.testing.assert_allclose(tsc.numpy(), j2n(jsc), **SCORE)
    np.testing.assert_array_equal(tlen.numpy(), j2n(jlen))
    ids, _ = tdecode.dynamic_decode(td, tinit, max_step_num=7)
    np.testing.assert_array_equal(
        ids.numpy(), tids.numpy().transpose(1, 0, 2) if time_major
        else tids.numpy())
    x = torch.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(
        tdecode.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2).numpy(),
        np.asarray(jdecode.BeamSearchDecoder.tile_beam_merge_with_batch(
            jnp.asarray(x.numpy()), 2)))


def test_text_utils_match_jax():
    lengths = np.array([3, 1, 5], np.int64)
    tl = torch.from_numpy(lengths)
    np.testing.assert_array_equal(tutils.sequence_mask(tl).numpy(),
                                  j2n(jutils.sequence_mask(lengths)))
    np.testing.assert_array_equal(
        tutils.sequence_mask(tl, maxlen=7, dtype="int32").numpy(),
        j2n(jutils.sequence_mask(lengths, maxlen=7, dtype="int32")))
    np.testing.assert_array_equal(
        tutils.padding_attn_mask(tl, 6).numpy(),
        j2n(jutils.padding_attn_mask(lengths, 6)))
    np.testing.assert_array_equal(
        tutils.causal_mask(5, device="cpu").numpy(),
        j2n(jutils.causal_mask(5)))
    ids = np.arange(12, dtype=np.int64).reshape(3, 4)
    np.testing.assert_array_equal(
        tutils.shift_tokens_right(torch.from_numpy(ids), pad_id=9).numpy(),
        j2n(jutils.shift_tokens_right(ids, pad_id=9)))
    seqs = [[1, 2, 3, 4], [5], [6, 7]]
    for kw in ({}, {"maxlen": 2, "truncate_from": "left"},
               {"maxlen": 3, "return_lengths": True, "pad_value": -1}):
        got, want = tutils.pad_sequences(seqs, **kw), \
            jutils.pad_sequences(seqs, **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)
    assert tutils.truncate_sequences(seqs, 2, "left") == \
        jutils.truncate_sequences(seqs, 2, "left")


# ---- gpt_step_fn over the port's KV cache ------------------------------

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, initializer_range=0.2)
PROMPTS = [[5, 17, 33, 8, 60, 2], [41, 9, 71, 2]]   # last token shared


@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_tpu_params(tm, named)
    tm.eval()
    return jm, tm


def prefilled(jm, tm, slots_per_prompt, kv_dtype):
    """Caches of ``len(PROMPTS) * slots_per_prompt`` slots, slot b*K + k
    holding prompt b without its last token, in both packages."""
    n = len(PROMPTS) * slots_per_prompt
    jc = jm.init_kv_cache(n, kv_dtype=kv_dtype)
    tc = tm.init_kv_cache(n, kv_dtype=kv_dtype)
    for b, p in enumerate(PROMPTS):
        ids = np.asarray(p[:-1], np.int32)[None]
        for k in range(slots_per_prompt):
            slot = b * slots_per_prompt + k
            _, jc = jm.prefill(jnp.asarray(ids), jc, slot, ids.shape[1])
            tm.prefill(torch.from_numpy(ids).long(), tc, slot, ids.shape[1])
    return jc, tc


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_gpt_step_fn_searches_match_jax(gpt_pair, kv_dtype):
    jm, tm = gpt_pair
    bos, K, T = PROMPTS[0][-1], 3, 8
    jc, tc = prefilled(jm, tm, K, kv_dtype)
    assert tc.num_layers != len(PROMPTS) * K
    jseq, jsc = jdec.beam_search(jdec.gpt_step_fn(jm), jc, len(PROMPTS), K,
                                 T, bos, EOS)
    tseq, tsc = tdec.beam_search(tdec.gpt_step_fn(tm), tc, len(PROMPTS), K,
                                 T, bos, EOS)
    np.testing.assert_array_equal(tseq.numpy(), j2n(jseq))
    np.testing.assert_allclose(tsc.numpy(), j2n(jsc), **SCORE)
    jc, tc = prefilled(jm, tm, 1, kv_dtype)
    jg = jdec.greedy_search(jdec.gpt_step_fn(jm), jc, len(PROMPTS), T,
                            bos, EOS)
    tg = tdec.greedy_search(tdec.gpt_step_fn(tm), tc, len(PROMPTS), T,
                            bos, EOS)
    np.testing.assert_array_equal(tg.numpy(), j2n(jg))
    assert (tc.lengths.numpy() == [len(p) - 1 + T for p in PROMPTS]).all()
