"""The port's GPT against the JAX package's, on the CPU in f32.

One JAX model per config (MHA and GQA) is built from a seed; its weights
go through the port's weight bridge into a port model on the CPU, and
both run on the same numpy token ids.  The JAX side runs with highest-
precision matmuls (tests/conftest.py) and its attention composites; the
port runs its plain attention versions.  Tolerance: 1e-4 relative and
absolute, the one tests/test_inference_engine.py uses for cache-vs-
forward parity in f32.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_params,
                                     params_from_paddle_tpu)

TOL = dict(rtol=1e-4, atol=1e-4)
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
    tm.eval()
    return jm, tm, named


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def pair(request):
    return build_pair(num_kv_heads=request.param)


def test_bridge_covers_every_name_once(pair):
    _, tm, named = pair
    tensors = params_from_paddle_tpu(named)
    port_names = [n for n, _ in tm.named_parameters()]
    assert sorted(tensors) == sorted(named) == sorted(port_names)
    assert len(set(port_names)) == len(port_names)
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), named[n])


def test_bridge_rejects_unknown_missing_and_misshapen(pair):
    _, tm, named = pair
    with pytest.raises(KeyError):
        params_from_paddle_tpu({**named, "gpt.blocks.0.attn.rotary": 0})
    missing = dict(named)
    missing.pop("gpt.blocks.1.mlp.up_proj.bias")
    with pytest.raises(KeyError):
        load_paddle_tpu_params(tm, missing)
    bad = dict(named)
    bad["gpt.wpe.weight"] = bad["gpt.wpe.weight"][:-1]
    with pytest.raises(ValueError):
        load_paddle_tpu_params(tm, bad)


def test_untied_head_round_trips():
    jm, tm, named = build_pair(tie_word_embeddings=False)
    assert "lm_head.weight" in named
    ids = np.random.RandomState(3).randint(0, 97, (1, 9)).astype(np.int32)
    ref = np.asarray(jm(paddle.to_tensor(ids)).data)
    got = tm(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_full_forward_logits_match(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(0).randint(0, 97, (2, 23)).astype(np.int32)
    ref = np.asarray(jm(paddle.to_tensor(ids)).data)
    got = tm(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_prefill_cache_and_decode_steps_match(pair):
    """A 7-token prompt padded to the 16-bucket prefills slot 1 of 3;
    logits, every cache entry and the lengths agree, then 5 decode steps
    (slot 1 active) agree logit for logit and entry for entry."""
    jm, tm, _ = pair
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 97, (1, 12)).astype(np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :7] = ids[0, :7]
    jc = jm.init_kv_cache(3)
    tc = tm.init_kv_cache(3)
    jl, jc = jm.prefill(jnp.asarray(padded), jc, 1, 7)
    tl, tc = tm.prefill(torch.from_numpy(padded).long(), tc, 1, 7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [0, 7, 0]
    active = np.asarray([0, 1, 0], np.int32)
    for t in range(7, 12):
        toks = np.zeros(3, np.int32)
        toks[1] = ids[0, t]
        jl, jc = jm.decode_step(jnp.asarray(toks), jc, jnp.asarray(active))
        tl, tc = tm.decode_step(torch.from_numpy(toks).long(), tc,
                                torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [0, 12, 0]


def test_prefill_plus_decode_reproduces_forward(pair):
    """Teacher-forced: bucket-padded prefill + decode steps give the
    logits of one forward over the whole sequence (the contract of
    tests/test_inference_engine.py, on the port alone)."""
    _, tm, _ = pair
    ids = np.random.RandomState(2).randint(0, 97, (1, 13)).astype(np.int32)
    full = tm(torch.from_numpy(ids).long()).detach().numpy()[0]
    padded = torch.zeros(1, 32, dtype=torch.long)
    padded[0, :9] = torch.from_numpy(ids[0, :9]).long()
    cache = tm.init_kv_cache(1)
    lg, cache = tm.prefill(padded, cache, 0, 9)
    np.testing.assert_allclose(lg.numpy()[0], full[8], **TOL)
    one = torch.ones(1, dtype=torch.int32)
    for t in range(9, 13):
        lg, cache = tm.decode_step(torch.tensor([int(ids[0, t])]), cache, one)
        np.testing.assert_allclose(lg.numpy()[0], full[t], **TOL)


def test_decode_clamps_at_capacity_like_jax(pair):
    """Write index clamps at cap-1, position ids at max_seq_len-1 and
    lengths at capacity, as the JAX cache does."""
    jm, tm, _ = pair
    cap = TINY["max_seq_len"]
    ids = np.random.RandomState(4).randint(0, 97, (1, cap)).astype(np.int32)
    jc = jm.init_kv_cache(1)
    tc = tm.init_kv_cache(1)
    jl, jc = jm.prefill(jnp.asarray(ids), jc, 0, cap - 1)
    tl, tc = tm.prefill(torch.from_numpy(ids).long(), tc, 0, cap - 1)
    one = np.ones(1, np.int32)
    for tok in (5, 6, 7):
        jl, jc = jm.decode_step(jnp.asarray([tok], jnp.int32), jc,
                                jnp.asarray(one))
        tl, tc = tm.decode_step(torch.tensor([tok]), tc,
                                torch.from_numpy(one))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [cap]
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)


def test_model_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(GPTConfig(**TINY))


def test_initializers_use_the_explicit_generator():
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.nn import initializer as I

    def draw(init, seed):
        return init(torch.empty(256, 128), prandom.seed(seed, "cpu"))

    a, b = draw(I.XavierUniform(), 3), draw(I.XavierUniform(), 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, draw(I.XavierUniform(), 4))
    limit = (6.0 / (256 + 128)) ** 0.5
    assert a.abs().max().item() <= limit
    assert a.abs().max().item() > 0.9 * limit
    n = draw(I.Normal(0.0, 0.02), 5)
    assert abs(n.std().item() - 0.02) < 0.002
    with pytest.raises(ValueError):
        I.XavierUniform()(torch.empty(2, 3, 4), prandom.seed(0, "cpu"))
