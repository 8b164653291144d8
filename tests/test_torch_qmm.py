"""The port's int8 quantized compute against the JAX package's, on the CPU.

Ops: ``_qmm_plain`` equals the JAX composite ``_qmm_composite`` and the
Pallas kernel run in interpret mode (``_qmm_pallas``) BITWISE in f32 on
the same int8 codes and scales: the integer sums are exact on both sides
and the rescale is ``(acc * sx) * sw`` in f32 on both; shapes that pass
the JAX kernel's gate (M % 32 == 0) and ragged M (which JAX sends to its
composite).  ``quantize_channel`` gives the JAX codes and scales bitwise
(no code was observed to round differently).  ``fake_quant_matmul``:
forward bitwise, gradients against the JAX custom VJP at 1e-6 of their
largest value (f32 products summed in another order).  Model: a tiny
``GPTConfig(quantize='int8')`` with the JAX weights: logits within 1e-3
of the logit scale in f32 (an activation code may flip where the two
frameworks' f32 activations differ in the last bit); greedy tokens of the
port's int8-compute engine equal the JAX model's own prefill + decode
rollout; three ``SpmdTrainer`` steps with ``strategy.qat`` track the JAX
trainer's losses at rtol 2e-4.
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
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import create_mesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.inference import InferenceEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_params)

jqm = importlib.import_module("paddle_tpu.ops.quantized_matmul")
tqm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")

TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, initializer_range=0.2)


def t(a):
    return torch.from_numpy(np.array(a))


def operands(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) * 0.3).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(32, 256, 128), (64, 128, 384),
                                   (8, 256, 128), (33, 128, 256),
                                   (1, 384, 128)])
def test_qmm_plain_bitwise_equal_to_jax(m, k, n):
    x, w = operands(m, k, n, m + k + n)
    jqx, jsx = jqm.quantize_channel(jnp.asarray(x), axis=1)
    jqw, jsw = jqm.quantize_channel(jnp.asarray(w), axis=0)
    got = tqm._qmm_plain(t(jqx), t(jqw), t(jsx), t(jsw),
                         torch.float32).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jqm._qmm_composite(jqx, jqw, jsx, jsw, jnp.float32)))
    # the public ops from the raw operands, quantization included
    np.testing.assert_array_equal(
        tqm.quantized_matmul(t(x), t(w)).numpy(),
        np.asarray(jqm.quantized_matmul(jnp.asarray(x), jnp.asarray(w))))
    if m % 32:
        return                       # the JAX gate sends it to the composite
    if not jqm._fa._HAS_PLTPU:
        pytest.skip("pallas TPU backend unavailable: composite checked only")
    jqm._fa.set_interpret_mode(True)
    try:
        kern = np.asarray(jqm._qmm_pallas(jqx, jqw, jsx, jsw, jnp.float32,
                                          "int8"))
    finally:
        jqm._fa.set_interpret_mode(False)
    np.testing.assert_array_equal(got, kern)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((7, 96), 1), ((96, 40), 0),
                                        ((3, 5, 64), -1)])
def test_quantize_channel_bitwise_equal_to_jax(shape, axis, dtype):
    rng = np.random.RandomState(len(shape) + axis)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = t(x).to(getattr(torch, dtype))
    jq, js = jqm.quantize_channel(jx, axis=axis)
    tq, ts = tqm.quantize_channel(tx, axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantized_matmul_keeps_lead_dims_and_out_dtype():
    x, w = operands(12, 128, 128, 5)
    y = tqm.quantized_matmul(t(x).reshape(3, 4, 128), t(w),
                             out_dtype=torch.bfloat16)
    assert y.shape == (3, 4, 128) and y.dtype == torch.bfloat16
    flat = tqm.quantized_matmul(t(x), t(w), out_dtype=torch.bfloat16)
    assert torch.equal(y.reshape(12, 128), flat)


def test_fake_quant_matmul_grads_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 96).astype(np.float32)
    w = (rng.randn(96, 40) * 0.3).astype(np.float32)
    g = rng.randn(2, 6, 40).astype(np.float32)

    def loss(a, b):
        return jnp.sum(jqm.fake_quant_matmul(a, b) * g)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    y = tqm.fake_quant_matmul(xt, wt)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(jqm.fake_quant_matmul(jnp.asarray(x), jnp.asarray(w))))
    (y * t(g)).sum().backward()
    for got, ref in ((xt.grad, gx), (wt.grad, gw)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_fp8_compute_raises_not_implemented():
    """fp8 compute was refused before it was ported; now it computes what
    the JAX composite computes, and an unknown mode still raises."""
    x, w = operands(4, 128, 128, 2)
    np.testing.assert_array_equal(
        tqm.quantized_matmul(t(x), t(w), dtype="fp8").numpy(),
        np.asarray(jqm.quantized_matmul(jnp.asarray(x), jnp.asarray(w),
                                        dtype="fp8")))
    assert GPTConfig(**TINY, quantize="fp8").quantize == "fp8"
    with pytest.raises(ValueError, match="quantize dtype"):
        GPTConfig(**TINY, quantize="int4")


# ---- the int8-compute model --------------------------------------------------

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
def quant_pair():
    return build_pair(quantize="int8")


def test_quantized_model_logits_match_jax(quant_pair):
    jm, tm = quant_pair
    ids = np.random.RandomState(3).randint(0, 97, (2, 11)).astype(np.int32)
    # jitted: one compile instead of one per primitive (test wall time)
    ref = np.asarray(jax.jit(lambda i: jm(paddle.Tensor(i)).data)(
        jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()
    # the linears run quantized, the head does not: unquantized logits
    # differ by the quantization noise
    plain = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    plain.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert not torch.allclose(plain(torch.from_numpy(ids).long()),
                                  torch.from_numpy(got), atol=1e-4)


def jax_rollout(jm, prompts, new):
    """Greedy prefill + decode steps of the JAX model itself (its methods
    under ``jax.jit``, as its engine runs them)."""
    prefill = jax.jit(lambda i, c, n: jm.prefill(i, c, 0, n),
                      static_argnums=2)
    step = jax.jit(lambda t, c: jm.decode_step(t, c, jnp.asarray([1],
                                                                jnp.int32)))
    out = []
    for prompt in prompts:
        ids = np.zeros((1, 16), np.int32)
        ids[0, :len(prompt)] = prompt
        logits, cache = prefill(jnp.asarray(ids), jm.init_kv_cache(1),
                                len(prompt))
        toks = [int(np.argmax(np.asarray(logits)[0]))]
        for _ in range(new - 1):
            logits, cache = step(jnp.asarray([toks[-1]], jnp.int32), cache)
            toks.append(int(np.argmax(np.asarray(logits)[0])))
        out.append(toks)
    return out


def test_quantized_engine_greedy_equals_jax_rollout(quant_pair):
    jm, tm = quant_pair
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 97, (n,)).astype(np.int32) for n in (3, 14)]
    eng = InferenceEngine(tm, batch_slots=2, prefill_buckets=[16],
                          device="cpu")
    rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
    out = eng.run()
    got = [np.asarray(out[r]).tolist() for r in rids]
    assert got == jax_rollout(jm, prompts, 5)


def test_enable_quantize_flips_the_linears_and_back(quant_pair):
    _, tm = quant_pair
    plain = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    plain.load_state_dict(tm.state_dict())
    ids = torch.randint(0, 97, (1, 9),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = tm(ids)
        base = plain(ids)
        plain.enable_quantize("int8")
        assert plain.cfg.quantize == "int8"
        assert torch.equal(plain(ids), want)
        plain.enable_quantize(None)
        assert plain.cfg.quantize is None
        assert torch.equal(plain(ids), base)


# ---- quantization-aware training ------------------------------------------------

TRAIN = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128)


def test_qat_trainer_tracks_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 64)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TRAIN))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    st = JaxStrategy()
    st.qat = True
    crit = JaxCriterion()
    jtr = JaxTrainer(jm, paddle.optimizer.Adam(learning_rate=1e-3,
                                               parameters=jm.parameters()),
                     lambda o, lab: crit(o, lab),
                     mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                     strategy=st)
    ref = [float(jtr.train_step(ids, labels)) for _ in range(3)]

    tm = GPTForCausalLM(GPTConfig(**TRAIN), device="cpu")
    load_paddle_tpu_params(tm, named)
    st2 = DistributedStrategy()
    st2.qat = True
    tcrit = GPTPretrainingCriterion()
    tr = SpmdTrainer(tm, topt.Adam(learning_rate=1e-3),
                     lambda o, lab: tcrit(o, lab), strategy=st2)
    assert tm.cfg.quantize == "int8"
    assert all(lin.quantize == "int8" for blk in tm.gpt.blocks
               for lin in (blk.attn.qkv_proj, blk.attn.out_proj,
                           blk.mlp.up_proj, blk.mlp.down_proj))
    got = [float(tr.train_step(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert got[-1] < got[0]
