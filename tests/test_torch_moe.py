"""The port's mixture of experts against the JAX package's, on the CPU.

Layer: ``distributed.moe`` (router, capacity dispatch, expert FFNs, aux
losses, expert stats) against the JAX package's ``top_k_gating`` and
``MoELayer._fn_dense`` on numpy inputs from a seed.  Model: a tiny
GPT-MoE (every second block MoE, E = 4, top-2) whose weights go through
the port's weight bridge: the no-cache forward, dense and paged prefill
+ decode, the verify window and a prefill chunk against the JAX model's
methods; the trainer against the JAX trainer on a ``{"dp": 1}`` mesh.

Tolerances, stated per check:
- routing (expert ids, capacity positions, keep flags): exactly JAX's;
  gates, aux and z-loss: 1e-6 (f32, differently ordered sums);
- the layer's forward: 1e-5 in f32, 2e-2 in bf16 (the experts run in
  bf16, rounding differs by product shape); gradients of x, the gate and
  the four expert tensors: 1e-4 of ``jax.grad``;
- the model's logits: 1e-4 (f32, tests/test_torch_gpt.py's);
- the trainer after 3 SGD steps: losses and parameters 1e-4 (SGD, since
  Adam's first steps amplify rounding).
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import create_mesh
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.inference.paged_kv import init_paged_cache as jax_pool
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import SpmdTrainer, async_dispatch
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.recompute import recompute
from paddle_tpu_torch.inference.paged_kv import init_paged_cache
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_params,
                                     params_from_paddle_tpu,
                                     trainer_state_from_paddle_tpu)

LOGITS = dict(rtol=1e-4, atol=1e-4)
MOE = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=64, initializer_range=0.2,
           moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
           moe_every_n_layers=2)
EXPERT_NAMES = ("gate", "experts.w_up", "experts.b_up", "experts.w_down",
                "experts.b_down")


# ---- the router ------------------------------------------------------------

def jax_routing(logits, top_k, cap):
    """JAX's routing in index form: expert ids by iterated argmax over
    JAX's softmax, and JAX's dispatch / combine tensors."""
    dispatch, combine, aux, zloss = jmoe.top_k_gating(
        jnp.asarray(logits), top_k, cap)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ids, rem = [], probs.copy()
    for _ in range(top_k):
        i = rem.argmax(-1)
        ids.append(i)
        np.put_along_axis(rem, i[..., None], 0.0, -1)
    return (np.stack(ids, -1), np.asarray(dispatch), np.asarray(combine),
            float(aux), float(zloss))


def dense_of(expert, pos, keep, gates, n_exp, cap):
    """``[B, S, E, C]`` dispatch / combine from the index form."""
    b, s, k = expert.shape
    d = np.zeros((b, s, n_exp, cap), np.float32)
    c = np.zeros_like(d)
    for bi, si, ki in zip(*np.nonzero(keep)):
        e, p = expert[bi, si, ki], pos[bi, si, ki]
        d[bi, si, e, p] += 1.0
        c[bi, si, e, p] += gates[bi, si, ki]
    return d, c


@pytest.mark.parametrize("top_k,cap", [(1, 16), (2, 16), (2, 3), (1, 2)],
                         ids=["top1", "top2", "top2-drops", "top1-drops"])
def test_top_k_gating_routing_equals_jax(top_k, cap):
    rng = np.random.RandomState(top_k * 10 + cap)
    logits = (rng.randn(3, 16, 4) * 2).astype(np.float32)
    ids, dispatch, combine, aux, zloss = jax_routing(logits, top_k, cap)
    expert, pos, keep, gates, taux, tz = tmoe.top_k_gating(
        torch.from_numpy(logits), top_k, cap)
    expert, pos, keep = expert.numpy(), pos.numpy(), keep.numpy()
    np.testing.assert_array_equal(expert, ids)
    np.testing.assert_array_equal(keep, pos < cap)
    d, c = dense_of(expert, pos, keep, gates.numpy(), 4, cap)
    np.testing.assert_array_equal(d, dispatch)
    np.testing.assert_allclose(c, combine, rtol=0, atol=1e-6)
    assert abs(taux.item() - aux) <= 1e-6 and abs(tz.item() - zloss) <= 1e-6
    if cap < 16:
        assert not keep.all()                    # the low capacity drops
    # each capacity slot of each (row, expert) taken at most once
    assert dispatch.sum(axis=1).max() <= 1.0


# ---- the layer ---------------------------------------------------------------

def layer_pair(e=4, h=16, f=32, top_k=2, cf=2.0, seed=0, dtype=torch.float32):
    """A JAX MoELayer and the port's with the same weights (random biases
    too, so the bias paths are checked), and the weights as numpy."""
    paddle.seed(seed)
    jl = jmoe.MoELayer(h, f, num_experts=e, top_k=top_k, capacity_factor=cf)
    tl = tmoe.MoELayer(h, f, e, top_k=top_k, capacity_factor=cf,
                       device="cpu", dtype=dtype)
    rng = np.random.RandomState(seed + 100)
    named = {}
    for n, p in jl.named_parameters():
        a = np.asarray(p.data) + (rng.randn(*p.shape) * 0.1).astype(np.float32)
        named[n] = a.astype(np.float32)
        p.set_value(jnp.asarray(named[n]))
    assert sorted(named) == sorted(n for n, _ in tl.named_parameters())
    with torch.no_grad():
        for n, p in tl.named_parameters():
            p.copy_(torch.from_numpy(named[n]))
    return jl, tl, named


def jax_dense(jl, x, named, dtype=jnp.float32):
    return jl._fn_dense(jnp.asarray(x, dtype),
                        *[jnp.asarray(named[n], dtype) for n in EXPERT_NAMES])


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["roomy", "drops"])
def test_moe_layer_forward_and_stats_match_jax_f32(cf):
    jl, tl, named = layer_pair(cf=cf)
    x = np.random.RandomState(1).randn(2, 12, 16).astype(np.float32)
    y, aux, zloss, load = jax_dense(jl, x, named)
    with tmoe.collect_aux_losses() as auxes, \
            tmoe.collect_expert_stats() as stats:
        ty = tl(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    assert len(auxes) == 1
    assert abs(auxes[0].item() - 0.01 * float(aux)) <= 1e-6
    assert tl.last_aux_loss.item() == auxes[0].item()
    # the expert stats equal JAX's fold of the record its forward makes
    # (the _fn_dense load and top_k * B * S)
    want = jmoe.fold_expert_stats([{"load": load, "assigned": 2 * 2 * 12}])
    got = tmoe.fold_expert_stats(stats)
    np.testing.assert_array_equal(got["load"].numpy(), np.asarray(want["load"]))
    assert got["assigned"] == float(want["assigned"]) == 2 * 2 * 12
    if cf < 1:
        assert got["load"].sum().item() < got["assigned"]


def test_moe_layer_forward_matches_jax_bf16():
    jl, tl, named = layer_pair(seed=2, dtype=torch.bfloat16)
    x = np.random.RandomState(2).randn(2, 12, 16).astype(np.float32)
    y = jax_dense(jl, x, named, jnp.bfloat16)[0]
    ty = tl(torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    ref = np.asarray(y.astype(jnp.float32))
    err = np.abs(ty.float().detach().numpy() - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), err


def test_moe_layer_gradients_match_jax_grad():
    jl, tl, named = layer_pair(seed=3, cf=1.0)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, 16).astype(np.float32)
    cot = rng.randn(2, 12, 16).astype(np.float32)

    def jloss(x, *w):
        y, aux, zloss, _ = jl._fn_dense(x, *w)
        return jnp.sum(y * cot) + aux + 0.1 * zloss

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        jnp.asarray(x), *[jnp.asarray(named[n]) for n in EXPERT_NAMES])
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, zloss, _ = tl._fn_dense(xt)
    ((y * torch.from_numpy(cot)).sum() + aux + 0.1 * zloss).backward()
    params = dict(tl.named_parameters())
    got = [xt.grad] + [params[n].grad for n in EXPERT_NAMES]
    for name, g, want in zip(("x",) + EXPERT_NAMES, got, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=name)
        assert np.abs(want).max() > 0, name


def test_moe_layer_a2a_chunks_raise_on_one_device():
    tl = tmoe.MoELayer(8, 16, 4, a2a_chunks=2, device="cpu")
    with pytest.raises(NotImplementedError, match="a2a_chunks"):
        tl(torch.zeros(1, 4, 8))
    assert tmoe.moe_capacity(12, 4, 2, 8.0) == jmoe.moe_capacity(12, 4, 2, 8.0)


def test_recompute_hands_the_aux_loss_out_once_with_its_gradient():
    """An aux loss made inside a checkpointed region reaches the open
    collector once, keeps its gradient into the gate, and the backward's
    re-run appends nothing."""
    _, tl, _ = layer_pair(seed=4)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 16)
                         .astype(np.float32))
    with tmoe.collect_aux_losses() as plain:
        y0 = tl(x)
    (y0.sum() + plain[0]).backward()
    g0 = tl.gate.grad.clone()
    tl.zero_grad()
    with tmoe.collect_aux_losses() as aux:
        y = recompute(tl, x)
        assert len(aux) == 1
        (y.sum() + aux[0]).backward()
        assert len(aux) == 1
    assert aux[0].item() == plain[0].item()
    torch.testing.assert_close(tl.gate.grad, g0, rtol=1e-6, atol=1e-7)
    assert tl.gate.grad.abs().max() > 0


# ---- the model -------------------------------------------------------------

def moe_pair(**over):
    kw = {**MOE, **over}
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**kw))
    jm.eval()
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    load_paddle_tpu_params(tm, named)
    tm.eval()
    return jm, tm, named


@pytest.fixture(scope="module")
def pair():
    return moe_pair()


_JIT = {}


def jit(model, method, static=()):
    """The JAX model's method under ``jax.jit`` (one compile per shape
    instead of one per eager op)."""
    key = (id(model), method)
    if key not in _JIT:
        fn = (lambda ids: model(Tensor(ids)).data) if method == "forward" \
            else getattr(model, method)
        _JIT[key] = jax.jit(fn, static_argnums=static)
    return _JIT[key]


def test_moe_config_blocks_and_bridge(pair):
    jm, tm, named = pair
    cfg = tm.cfg
    assert [cfg.is_moe_layer(i) for i in range(4)] == \
        [jm.cfg.is_moe_layer(i) for i in range(4)] == [False, True] * 2
    assert isinstance(tm.gpt.blocks[1].mlp, tmoe.MoELayer)
    assert not tm.gpt.blocks[0].is_moe
    assert sorted(params_from_paddle_tpu(named)) == sorted(
        n for n, _ in tm.named_parameters())
    assert "gpt.blocks.1.mlp.experts.w_up" in named
    # the port's own init: JAX's scales, the down weight depth-scaled
    m = GPTForCausalLM(GPTConfig(**{**MOE, "hidden_size": 64,
                                    "initializer_range": 0.02}),
                       device="cpu").gpt.blocks[1].mlp
    assert abs(m.experts.w_up.std().item() - 0.02) < 2e-3
    assert abs(m.experts.w_down.std().item() - 0.01) < 1e-3
    assert abs(m.gate.std().item() - 0.02) < 3e-3
    assert m.experts.b_up.abs().max() == 0


def test_quantize_and_enable_quantize_raise_on_moe(pair):
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTConfig(**MOE, quantize="int8")
    with pytest.raises(NotImplementedError, match="MoE"):
        JaxConfig(**MOE, quantize="int8")
    tm = GPTForCausalLM(GPTConfig(**MOE), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tm.enable_quantize("int8")
    tm.enable_quantize(None)                     # restoring is harmless
    assert tm.cfg.quantize is None


def test_megakernel_stands_down_on_moe(pair, monkeypatch):
    jm, tm, _ = pair
    monkeypatch.delenv("PADDLE_TPU_DECODE_MEGAKERNEL", raising=False)
    tm.enable_decode_megakernel()
    jm.enable_decode_megakernel()
    try:
        assert tm.cfg.decode_megakernel
        assert not tm.gpt._megakernel_active()
        assert not jm.gpt._megakernel_active()
        dense = GPTForCausalLM(GPTConfig(**{**MOE, "moe_num_experts": 0}),
                               device="cpu").enable_decode_megakernel()
        assert dense.gpt._megakernel_active()
    finally:
        tm.enable_decode_megakernel(False)
        jm.enable_decode_megakernel(False)


def test_forward_logits_match_jax(pair):
    jm, tm, _ = pair
    ids = np.random.RandomState(0).randint(0, 97, (2, 23)).astype(np.int32)
    ref = np.asarray(jit(jm, "forward")(jnp.asarray(ids)))
    got = tm(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, ref, **LOGITS)


def test_dense_prefill_decode_verify_chunk_match_jax(pair):
    """Dense cache: two prompts prefilled (bucket 16), 3 decode steps, a
    4-token verify window, then a chunk tick of 8 over a third slot:
    logits at 1e-4 on every call."""
    jm, tm, _ = pair
    rng = np.random.RandomState(1)
    jc, tc = jm.init_kv_cache(3, 64), tm.init_kv_cache(3, 64)
    for slot, n in ((0, 7), (1, 13)):
        ids = np.zeros((1, 16), np.int32)
        ids[0, :n] = rng.randint(1, 97, (n,))
        jl, jc = jit(jm, "prefill")(jnp.asarray(ids), jc, np.int32(slot),
                                    np.int32(n))
        tl, _ = tm.prefill(torch.from_numpy(ids).long(), tc, slot, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    active = np.asarray([1, 1, 0], np.int32)
    for _ in range(3):
        toks = rng.randint(1, 97, (3,)).astype(np.int32)
        jl, jc = jit(jm, "decode_step")(jnp.asarray(toks), jc,
                                        jnp.asarray(active))
        tl, _ = tm.decode_step(torch.from_numpy(toks).long(), tc,
                               torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    win = rng.randint(1, 97, (3, 4)).astype(np.int32)
    jl, jc = jit(jm, "verify_step")(jnp.asarray(win), jc)
    tl, _ = tm.verify_step(torch.from_numpy(win).long(), tc)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGITS)
    lens = np.asarray([10, 16, 0], np.int32)
    adv = np.asarray([0, 0, 8], np.int32)
    toks = np.zeros((3, 8), np.int32)
    toks[2] = rng.randint(1, 97, (8,))
    jl, jc = jit(jm, "prefill_chunk")(jnp.asarray(toks), jc,
                                      jnp.asarray(lens), jnp.asarray(adv))
    tl, _ = tm.prefill_chunk(torch.from_numpy(toks).long(), tc,
                             torch.from_numpy(lens), torch.from_numpy(adv))
    np.testing.assert_allclose(tl.numpy()[2], np.asarray(jl)[2], **LOGITS)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_paged_prefill_decode_verify_chunk_match_jax(pair, kv_dtype):
    """A block pool of 8-token blocks: a cold prefill, a prefix hit over
    its first block, 2 decode steps, a 3-token verify window and a chunk
    tick: logits at 1e-4."""
    jm, tm, _ = pair
    bs, nb = 8, 12
    rng = np.random.RandomState(2)
    p0 = rng.randint(1, 97, (13,)).astype(np.int32)
    p1 = np.concatenate([p0[:8], rng.randint(1, 97, (7,)).astype(np.int32)])
    rows = np.asarray([[1, 2, 5, 0], [1, 3, 4, 0], [6, 7, 0, 0]], np.int32)
    jc = jax_pool(jm, nb, bs, kv_dtype=kv_dtype)
    tc = init_paged_cache(tm, nb, bs, kv_dtype=kv_dtype)
    for slot, prompt, prefix in ((0, p0, 0), (1, p1, 8)):
        suffix = prompt[prefix:]
        ids = np.zeros((1, 16 if prefix == 0 else 8), np.int32)
        ids[0, :suffix.size] = suffix
        jl, jc = jit(jm, "prefill_paged", static=(3,))(
            jnp.asarray(ids), jc, jnp.asarray(rows[slot]), prefix,
            np.int32(suffix.size))
        tl, _ = tm.prefill_paged(torch.from_numpy(ids).long(), tc,
                                 torch.from_numpy(rows[slot]), prefix,
                                 suffix.size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    lengths = np.asarray([13, 15, 0], np.int32)
    for _ in range(2):
        toks = rng.randint(1, 97, (3,)).astype(np.int32)
        jl, jc = jit(jm, "decode_step_paged")(
            jnp.asarray(toks), jc, jnp.asarray(rows), jnp.asarray(lengths))
        tl, _ = tm.decode_step_paged(torch.from_numpy(toks).long(), tc,
                                     torch.from_numpy(rows),
                                     torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **LOGITS)
        lengths[:2] += 1
    win = rng.randint(1, 97, (3, 3)).astype(np.int32)
    jl, jc = jit(jm, "verify_step_paged")(
        jnp.asarray(win), jc, jnp.asarray(rows), jnp.asarray(lengths))
    tl, _ = tm.verify_step_paged(torch.from_numpy(win).long(), tc,
                                 torch.from_numpy(rows),
                                 torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGITS)
    toks = np.zeros((3, 8), np.int32)
    toks[2] = rng.randint(1, 97, (8,))
    adv = np.asarray([0, 0, 8], np.int32)
    jl, jc = jit(jm, "prefill_chunk_paged")(
        jnp.asarray(toks), jc, jnp.asarray(rows), jnp.asarray(lengths),
        jnp.asarray(adv))
    tl, _ = tm.prefill_chunk_paged(torch.from_numpy(toks).long(), tc,
                                   torch.from_numpy(rows),
                                   torch.from_numpy(lengths),
                                   torch.from_numpy(adv))
    np.testing.assert_allclose(tl.numpy()[2], np.asarray(jl)[2], **LOGITS)


def test_paged_prefix_hit_at_8_layers_matches_jax_and_forward():
    """At 8 layers (4 expert layers) and capacity factor E / k (no
    drop: routing per token), a prefix hit over 3 cached blocks with a
    suffix padded to its bucket: logits equal the JAX model's hit path
    and the port's own no-cache forward at 1e-4, and so does the cold
    prefill of the whole prompt (the hit path has no fault of its own;
    the gap seen on the card at 8 layers in bf16 is not this path's
    logic)."""
    jm, tm, _ = moe_pair(num_layers=8)
    assert MOE["moe_capacity_factor"] == (MOE["moe_num_experts"]
                                          / MOE["moe_top_k"])
    bs, nb, prefix = 8, 10, 24
    rng = np.random.RandomState(8)
    prompt = rng.randint(1, 97, (31,)).astype(np.int32)
    ref = tm(torch.from_numpy(prompt[None]).long()).detach().numpy()[0]
    row = np.asarray([1, 2, 3, 4, 0], np.int32)
    jc = jax_pool(jm, nb, bs, kv_dtype=None)
    tc = init_paged_cache(tm, nb, bs)
    ids = np.zeros((1, 32), np.int32)
    ids[0, :prompt.size] = prompt
    jl, _ = jit(jm, "prefill_paged", static=(3,))(
        jnp.asarray(ids), jc, jnp.asarray(row), 0, np.int32(prompt.size))
    tl, _ = tm.prefill_paged(torch.from_numpy(ids).long(), tc,
                             torch.from_numpy(row), 0, prompt.size)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **LOGITS)
    np.testing.assert_allclose(tl.numpy()[0], ref[-1], **LOGITS)
    # the hit: the first 3 blocks cached, the 7-token suffix in bucket 8
    jc = jax_pool(jm, nb, bs, kv_dtype=None)
    tc = init_paged_cache(tm, nb, bs)
    head = np.zeros((1, 32), np.int32)       # the cold prefill's shape
    head[0, :prefix] = prompt[:prefix]
    jc = jit(jm, "prefill_paged", static=(3,))(
        jnp.asarray(head), jc, jnp.asarray(row), 0, np.int32(prefix))[1]
    tm.prefill_paged(torch.from_numpy(head).long(), tc,
                     torch.from_numpy(row), 0, prefix)
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :prompt.size - prefix] = prompt[prefix:]
    jl, _ = jit(jm, "prefill_paged", static=(3,))(
        jnp.asarray(suffix), jc, jnp.asarray(row), prefix,
        np.int32(prompt.size - prefix))
    tl, _ = tm.prefill_paged(torch.from_numpy(suffix).long(), tc,
                             torch.from_numpy(row), prefix,
                             prompt.size - prefix)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **LOGITS)
    np.testing.assert_allclose(tl.numpy()[0], ref[-1], **LOGITS)


# ---- the trainer -----------------------------------------------------------

TRAIN = dict(MOE, vocab_size=64, max_seq_len=16, initializer_range=0.02,
             moe_capacity_factor=1.0)


def train_batches(n=3):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 64, (4, 16)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, axis=1).astype(np.int64)))
    return out


def jax_trainer(named_seed=7, policy=None):
    paddle.seed(named_seed)
    jm = JaxGPT(JaxConfig(**TRAIN))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    st = JaxStrategy()
    if policy is not None:
        jm.enable_recompute()
        st.recompute = True
    crit = JaxCriterion()
    tr = JaxTrainer(jm, paddle.optimizer.SGD(learning_rate=0.5,
                                             parameters=jm.parameters()),
                    lambda o, l: crit(o, l),
                    mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    strategy=st)
    return named, tr


def port_trainer(named, policy=None, amp=False, fp16=False, k_steps=1,
                 anomaly=None, optim=None):
    tm = GPTForCausalLM(GPTConfig(**TRAIN), device="cpu")
    load_paddle_tpu_params(tm, named)
    st = DistributedStrategy()
    if policy is not None:
        st.recompute = True
        st.recompute_configs = {"policy": policy}
    if amp:
        st.amp = True
        if fp16:
            st.amp_configs = {"use_bf16": False, "init_loss_scaling": 1024.0}
    if k_steps > 1:
        st.gradient_merge = True
        st.gradient_merge_configs = {"k_steps": k_steps}
    crit = GPTPretrainingCriterion()
    return SpmdTrainer(tm, optim or topt.SGD(learning_rate=0.5),
                       lambda o, l: crit(o, l), strategy=st,
                       anomaly_policy=anomaly)


@pytest.fixture(scope="module")
def jax_sgd_run():
    named, tr = jax_trainer()
    losses = [float(tr.train_step(x, y)) for x, y in train_batches()]
    tr.sync_to_model()
    return named, losses, {n: np.asarray(a) for n, a in tr.params.items()}


@pytest.mark.parametrize("policy", [None, "full"], ids=["plain", "recompute"])
def test_trainer_sgd_tracks_jax_trainer(jax_sgd_run, policy):
    """3 SGD steps: losses (the router's aux term in them) and every
    parameter within 1e-4 of the JAX trainer's; full recompute gives the
    same; the gate's gradient is not zero."""
    named, ref, trained = jax_sgd_run
    tr = port_trainer(named, policy=policy)
    if policy is not None:
        assert tr.model.gpt._recompute
    got = [float(tr.train_step(x, y)) for x, y in train_batches()]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    for n, p in tr.params.items():
        np.testing.assert_allclose(p.numpy(), trained[n], rtol=1e-4,
                                   atol=1e-4, err_msg=n)
    gate = "gpt.blocks.1.mlp.gate"
    assert np.abs(tr.params[gate].numpy() - named[gate]).max() > 0
    assert np.abs(tr.model.gpt.blocks[1].mlp.gate.grad.numpy()).max() > 0


def test_trainer_loss_carries_the_aux_term():
    """A zero criterion still gives a positive loss: the aux term, equal
    to the JAX trainer's (tests/test_moe.py's check)."""
    named, jtr = jax_trainer(named_seed=1)
    jtr.loss_fn = lambda o, l: o.sum() * 0.0
    ids = train_batches(1)[0][0]
    want = float(jtr.train_step(ids, ids.astype(np.int64)))
    tm = GPTForCausalLM(GPTConfig(**TRAIN), device="cpu")
    load_paddle_tpu_params(tm, named)
    tr = SpmdTrainer(tm, topt.SGD(learning_rate=0.0),
                     lambda o, l: o.sum() * 0.0)
    got = float(tr.train_step(ids, ids.astype(np.int64)))
    assert want > 0 and abs(got - want) <= 1e-6


@pytest.mark.parametrize("case", ["bf16", "fp16", "skip", "rollback",
                                  "merge", "dots"])
def test_trainer_variants_run_moe_without_host_sync(jax_sgd_run, case):
    """Every step variant trains the MoE model: finite losses with the
    aux term in them, falling, and no host read before the losses are
    read (rollback reads its one flag vector a step)."""
    named = jax_sgd_run[0]
    kw = {"bf16": dict(amp=True), "fp16": dict(amp=True, fp16=True),
          "skip": dict(anomaly="skip"), "rollback": dict(anomaly="rollback"),
          "merge": dict(k_steps=2), "dots": dict(policy="dots")}[case]
    tr = port_trainer(named, optim=topt.Adam(learning_rate=1e-2), **kw)
    async_dispatch.reset_host_sync_count()
    batch = train_batches(1)[0]
    res = [tr.train_step(*batch) for _ in range(4)]
    assert async_dispatch.host_sync_count() == (4 if case == "rollback"
                                                else 0)
    losses = [float(r) for r in res]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_moe_trainer_checkpoint_reads_both_ways(tmp_path, jax_sgd_run):
    """A JAX MoE trainer's checkpoint restores in the port bitwise (gate
    and expert tensors included) and the port's restores in JAX; both
    continue alike."""
    named, jtr = jax_trainer(named_seed=9)
    batches = train_batches(4)
    for x, y in batches[:2]:
        jtr.train_step(x, y)
    jdir = str(tmp_path / "jax")
    jtr.save(jdir, manifest=True)
    state = trainer_state_from_paddle_tpu(tckpt.read_checkpoint(jdir))
    assert "gpt.blocks.1.mlp.experts.w_down" in state["params"]
    ttr = port_trainer(jax_sgd_run[0])
    ttr.load(jdir)
    for n, a in jtr.params.items():
        np.testing.assert_array_equal(ttr.params[n].numpy(), np.asarray(a),
                                      err_msg=n)
    pdir = str(tmp_path / "port")
    ttr.save(pdir, manifest=True)
    _, back = jax_trainer(named_seed=10)
    back.load(pdir)
    for n, p in ttr.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[n]), p.numpy(),
                                      err_msg=n)
    got = [float(ttr.train_step(x, y)) for x, y in batches[2:]]
    want = [float(back.train_step(x, y)) for x, y in batches[2:]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
