"""The port's training path against the JAX package's, on the CPU.

Same numpy inputs and weights on both sides (JAX weights go into the
port model through ``models.convert``); the JAX side runs with highest-
precision matmuls (tests/conftest.py) and its attention composite, the
port its plain attention versions under the same autograd functions the
card uses.  Tolerances, stated per check:
- fused cross-entropy in f32: 2e-5 relative to each output's scale
  (loss, d(hidden), d(weight): f32 rounding over vocab chunks);
- GPT loss and every parameter gradient in f32: 1e-4 of each tensor's
  max |JAX| (the tolerance tests/test_torch_gpt.py holds logits to);
- ``SpmdTrainer`` losses over 3 Adam steps on one repeated batch in
  f32: rtol 2e-4 (as tests/test_spmd_trainer.py::test_adam_parity_dp);
- with bf16 AMP: rtol 2e-2 on the loss.  Both sides round weights and
  activations to bf16 (8 significant bits, 2^-8 = 3.9e-3), but at
  different points: the JAX composite rounds the attention
  probabilities to bf16, the port's attention keeps them in f32 and
  rounds its output; over two layers that leaves differences of a few
  2^-8 in the loss.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import async_dispatch as jax_async
from paddle_tpu.distributed import create_mesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import fused_cross_entropy as jce

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import SpmdTrainer, async_dispatch
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_params)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_cross_entropy as tce

TINY = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
            max_seq_len=128)


def _close(got, ref, rel, name=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{name}: max err {err:.3e} > {rel} x {scale:.3e}"


# ---- fused cross-entropy ---------------------------------------------------
def _ce_inputs(n, h, v, seed, ignore=True):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(n, h).astype(np.float32)
    weight = (rng.randn(v, h) * 0.3).astype(np.float32)
    labels = rng.randint(0, v, size=n).astype(np.int32)
    if ignore:
        labels[::5] = -100
    g = rng.rand(n).astype(np.float32)
    return hidden, weight, labels, g


@pytest.mark.parametrize("v,block", [(300, 128), (512, None), (97, 32),
                                     (1000, 256)])
def test_fused_ce_matches_jax(v, block):
    """Loss and d(hidden), d(weight) of the blocked loss (vocab not a
    multiple of the chunk, ignore_index rows) against the JAX op."""
    hidden, weight, labels, g = _ce_inputs(40, 32, v, seed=v)
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(weight).requires_grad_()
    loss = tce.fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                          reduction="none", block_size=block)
    (loss * torch.from_numpy(g)).sum().backward()
    ref, vjp = jax.vjp(
        lambda a, b: jce.fused_linear_cross_entropy(
            a, b, jnp.asarray(labels), reduction="none", block_size=block),
        jnp.asarray(hidden), jnp.asarray(weight))
    dh, dw = vjp(jnp.asarray(g))
    _close(loss.detach().numpy(), ref, 2e-5, "loss")
    _close(th.grad.numpy(), dh, 2e-5, "d(hidden)")
    _close(tw.grad.numpy(), dw, 2e-5, "d(weight)")
    assert np.all(loss.detach().numpy()[labels == -100] == 0.0)
    assert np.all(th.grad.numpy()[labels == -100] == 0.0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_fused_ce_matches_unfused_cross_entropy(reduction):
    """Blocked loss == cross_entropy of the full logits (both sides of
    the port), and the port's cross_entropy == the JAX one."""
    hidden, weight, labels, _ = _ce_inputs(24, 16, 200, seed=1)
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(weight).requires_grad_()
    fused = F.fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                         reduction=reduction, block_size=64)
    th2 = torch.from_numpy(hidden).requires_grad_()
    tw2 = torch.from_numpy(weight).requires_grad_()
    logits = th2 @ tw2.t()
    plain = F.cross_entropy(logits, torch.from_numpy(labels),
                            reduction=reduction)
    torch.testing.assert_close(fused, plain, rtol=2e-5, atol=2e-6)
    fused.sum().backward()
    plain.sum().backward()
    torch.testing.assert_close(th.grad, th2.grad, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(tw.grad, tw2.grad, rtol=2e-5, atol=2e-6)
    ref = JF.cross_entropy(paddle.to_tensor(hidden @ weight.T),
                           paddle.to_tensor(labels), reduction=reduction)
    _close(plain.detach().numpy(), np.asarray(ref.data), 2e-5, "loss")


# ---- GPT training surface --------------------------------------------------
def build_pair(**over):
    kw = {**TINY, **over}
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**kw))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    load_paddle_tpu_params(tm, named)
    return jm, tm


def batch(seed, b=2, s=128, v=512):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, v, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def port_grads(tm, ids, labels, mask=None):
    tm.train()
    tm.zero_grad(set_to_none=True)
    out = tm(torch.from_numpy(ids).long())
    m = None if mask is None else torch.from_numpy(mask)
    loss = GPTPretrainingCriterion()(out, torch.from_numpy(labels), m)
    loss.backward()
    return float(loss), {n: p.grad.numpy() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("kv,fused", [(None, True), (2, True), (None, False)],
                         ids=["mha-fused_ce", "gqa-fused_ce", "mha-logits"])
def test_gpt_loss_and_grads_match_jax(kv, fused):
    jm, tm = build_pair(num_kv_heads=kv, fused_ce=fused)
    ids, labels = batch(0)
    mask = (np.random.RandomState(1).rand(*ids.shape) > 0.2
            ).astype(np.float32)
    jm.train()

    def jax_run(i, l, m):
        # the JAX tape, backward() included, staged under one jax.jit
        out = jm(paddle.Tensor(i))
        assert isinstance(out, tuple) == fused
        jloss = JaxCriterion()(out, paddle.Tensor(l), paddle.Tensor(m))
        jloss.backward()
        return jloss.data, {n: p.grad.data for n, p in jm.named_parameters()}

    jloss, jgrads = jax.jit(jax_run)(ids, labels, mask)
    jm.clear_gradients()
    loss, grads = port_grads(tm, ids, labels, mask)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4, atol=1e-4)
    jgrads = {n: np.asarray(g) for n, g in jgrads.items()}
    assert sorted(grads) == sorted(jgrads)
    for n, g in grads.items():
        _close(g, jgrads[n], 1e-4, n)


def test_recompute_gives_equal_grads():
    _, tm = build_pair(fused_ce=True, num_kv_heads=2)
    ids, labels = batch(2)
    loss0, g0 = port_grads(tm, ids, labels)
    tm.enable_recompute()
    loss1, g1 = port_grads(tm, ids, labels)
    assert loss0 == loss1
    for n in g0:
        np.testing.assert_array_equal(g1[n], g0[n], err_msg=n)


def test_unknown_recompute_policy_raises():
    """Every JAX policy name is accepted (tests/test_torch_train_state.py
    runs each); an unknown one raises ``ValueError`` as in JAX."""
    _, tm = build_pair()
    with pytest.raises(ValueError, match="unknown recompute policy"):
        tm.enable_recompute("no-such-policy")
    assert not tm.gpt._recompute


def test_num_params_and_flops_match_jax():
    for name in ("gpt3-125m", "gpt3-1.3b"):
        from paddle_tpu.models.gpt import gpt_configs as jcfgs
        from paddle_tpu_torch.models import gpt_configs as tcfgs
        j, t = jcfgs()[name], tcfgs()[name]
        assert t.num_params() == j.num_params()
        assert t.num_params(False) == j.num_params(False)
        assert t.flops_per_token(2048) == j.flops_per_token(2048)


# ---- SpmdTrainer -------------------------------------------------------------
def jax_trainer_losses(amp, steps, kv=None):
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**TINY, num_kv_heads=kv, fused_ce=True))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=jm.parameters())
    st = JaxStrategy()
    st.amp = amp
    crit = JaxCriterion()
    tr = JaxTrainer(jm, opt, lambda o, l: crit(o, l),
                    mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    strategy=st)
    losses = [float(tr.train_step(*batch(0))) for _ in range(steps)]
    tr.sync_to_model()
    trained = {n: np.asarray(a) for n, a in tr.params.items()}
    return named, losses, trained


def port_trainer(named, amp, kv=None):
    tm = GPTForCausalLM(GPTConfig(**TINY, num_kv_heads=kv, fused_ce=True),
                        device="cpu")
    load_paddle_tpu_params(tm, named)
    st = DistributedStrategy()
    st.amp = amp
    crit = GPTPretrainingCriterion()
    return tm, SpmdTrainer(tm, topt.Adam(learning_rate=1e-3),
                           lambda o, l: crit(o, l), strategy=st)


@pytest.fixture(scope="module")
def jax_f32_run():
    return jax_trainer_losses(amp=False, steps=3, kv=2)


def test_trainer_tracks_jax_adam_f32(jax_f32_run):
    named, ref, trained = jax_f32_run
    tm, tr = port_trainer(named, amp=False, kv=2)
    got = [float(tr.train_step(*batch(0))) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert got[-1] < got[0]
    # the JAX trainer's parameter names load through the weight bridge
    back = GPTForCausalLM(GPTConfig(**TINY, num_kv_heads=2, fused_ce=True),
                          device="cpu")
    load_paddle_tpu_params(back, trained)
    for n, p in back.named_parameters():
        _close(p.detach().numpy(), trained[n], 1e-6, n)
        _close(tr.params[n].numpy(), trained[n], 2e-3, n)


def test_trainer_tracks_jax_adam_bf16_amp():
    named, ref, _ = jax_trainer_losses(amp=True, steps=3)
    tm, tr = port_trainer(named, amp=True)
    got = [float(tr.train_step(*batch(0))) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=2e-2)
    assert got[-1] < got[0]
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_train_step_has_no_host_sync_until_read(jax_f32_run):
    named = jax_f32_run[0]
    _, tr = port_trainer(named, amp=True, kv=2)
    async_dispatch.reset_host_sync_count()
    results = [tr.train_step(*batch(i)) for i in range(3)]
    assert async_dispatch.host_sync_count() == 0
    assert repr(results[0]) == "StepResult(<pending>)"
    first = float(results[0])
    assert async_dispatch.host_sync_count() == 1
    assert float(results[0]) == first          # cached: no second sync
    assert async_dispatch.host_sync_count() == 1
    st = tr.stats
    assert st["steps_timed"] == 3 and st["dispatch_ms"] > 0
    assert set(st) >= {"data_wait_ms", "h2d_ms", "dispatch_ms", "sync_ms"}
    assert jax_async.host_sync_count() >= 0     # the packages count apart


@pytest.mark.parametrize("amp", [False, True])
def test_trainer_with_recompute_strategy_matches_plain_step(amp):
    """Full recompute through the trainer gives the step without it,
    also under AMP, where the recomputed blocks must run on the bf16
    copies the forward used, not on the f32 masters."""
    named = {n: np.asarray(p.data) for n, p in
             JaxGPT(JaxConfig(**TINY)).named_parameters()}
    _, tr = port_trainer(named, amp=amp)
    ref = float(tr.train_step(*batch(0)))
    tm = GPTForCausalLM(GPTConfig(**TINY, fused_ce=True), device="cpu")
    load_paddle_tpu_params(tm, named)
    st = DistributedStrategy()
    st.amp = amp
    st.recompute = True
    st.recompute_configs = {"policy": "full"}
    crit = GPTPretrainingCriterion()
    tr2 = SpmdTrainer(tm, topt.Adam(learning_rate=1e-3),
                      lambda o, l: crit(o, l), strategy=st)
    assert tm.gpt._recompute
    assert float(tr2.train_step(*batch(0))) == ref
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32
        torch.testing.assert_close(p, tr.params[n], rtol=0, atol=0)


@pytest.mark.parametrize("flag", ["sharding", "tensor_parallel",
                                  "pipeline", "lamb"])
def test_unsupported_strategy_flags_raise(flag):
    _, tm = build_pair()
    st = DistributedStrategy()
    setattr(st, flag, True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SpmdTrainer(tm, topt.Adam(), lambda o, l: o, strategy=st)


@pytest.mark.parametrize("policy", ["bogus"])
def test_anomaly_policies_other_than_raise_refuse(policy):
    """'skip' and 'rollback' are ported (tests/test_torch_train_state.py);
    any other name raises."""
    _, tm = build_pair()
    with pytest.raises(ValueError):
        SpmdTrainer(tm, topt.Adam(), lambda o, l: o, anomaly_policy=policy)


def test_device_prefetcher_on_cpu_feeds_the_trainer():
    named = {n: np.asarray(p.data) for n, p in
             JaxGPT(JaxConfig(**TINY)).named_parameters()}
    _, tr = port_trainer(named, amp=False)
    batches = [batch(i) for i in range(3)]
    got = []
    for ids, labels in DevicePrefetcher(iter(batches), device="cpu",
                                        timings=tr._timings):
        assert ids.dtype == torch.int32 and ids.device.type == "cpu"
        got.append(float(tr.train_step(ids, labels)))
    _, tr2 = port_trainer(named, amp=False)
    ref = [float(tr2.train_step(*b)) for b in batches]
    assert got == ref
    assert tr.stats["data_wait_ms"] >= 0 and tr.stats["h2d_ms"] >= 0


def test_device_prefetcher_surfaces_worker_errors():
    def bad():
        yield batch(0)
        raise RuntimeError("reader failed")
    pf = DevicePrefetcher(bad(), device="cpu")
    it = iter(pf)
    next(it)
    with pytest.raises(RuntimeError, match="reader failed"):
        next(it)
    assert not pf._thread.is_alive()


def test_use_flash_attention_false_runs_plain_on_cpu():
    jm, tm = build_pair(use_flash_attention=False)
    ids, _ = batch(3)
    jm.eval()
    tm.eval()
    ref = np.asarray(jm(paddle.to_tensor(ids)).data)
    got = tm(torch.from_numpy(ids).long()).detach().numpy()
    _close(got, ref, 1e-4, "logits")


def test_attention_dropout_raises_in_training_only():
    """Attention dropout trains through the flash path
    (``test_attention_dropout_trains``); what still raises, in training
    only, is dropout over a cached prefix, whose composite applies none
    (a serving path, which runs in eval).  In eval the JAX composite
    applies no dropout either: the logits agree."""
    jm, tm = build_pair(attn_dropout=0.1)
    ids, labels = batch(4)
    attn = tm.gpt.blocks[0].attn
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 8, TINY["hidden_size"])
                         .astype(np.float32))
    kp, vp = (torch.from_numpy(rng.randn(5, TINY["num_heads"], 32)
                               .astype(np.float32)) for _ in range(2))
    tm.train()
    with pytest.raises(NotImplementedError, match="cached prefix"):
        attn.forward_prefill_paged(x, kp, vp)
    jm.eval()
    tm.eval()
    assert attn.forward_prefill_paged(x, kp, vp)[0].shape == x.shape
    ref = np.asarray(jm(paddle.to_tensor(ids)).data)
    _close(tm(torch.from_numpy(ids).long()).detach().numpy(), ref, 1e-4,
           "logits")


def test_attention_dropout_trains():
    """Training with ``attn_dropout``: the loss and every gradient are
    finite, another forward draws another mask (another loss), the
    loss is the JAX model's training loss to within dropout's effect,
    and with ``attn_dropout`` set back to 0 loss and gradients equal the
    dropout-free model's."""
    jm, tm = build_pair(attn_dropout=0.1)
    _, ref = build_pair()
    ids, labels = batch(6)
    torch.manual_seed(0)
    loss0, g0 = port_grads(tm, ids, labels)
    loss1, _ = port_grads(tm, ids, labels)
    assert np.isfinite(loss0) and loss0 != loss1
    assert all(np.isfinite(g).all() for g in g0.values())
    jm.train()
    jloss = float(JaxCriterion()(jm(paddle.to_tensor(ids)),
                                 paddle.to_tensor(labels)))
    assert abs(loss0 - jloss) < 0.05 * abs(jloss)
    loss_ref, g_ref = port_grads(ref, ids, labels)
    assert loss_ref != loss0
    for blk in tm.gpt.blocks:
        blk.attn.cfg = dataclasses.replace(blk.attn.cfg, attn_dropout=0.0)
    loss2, g2 = port_grads(tm, ids, labels)
    assert loss2 == loss_ref
    for n in g_ref:
        np.testing.assert_array_equal(g2[n], g_ref[n], err_msg=n)


@pytest.mark.parametrize("amp", [False, True])
def test_eval_step_gives_the_models_logits(amp):
    """``eval_step`` runs the eval-mode forward (full logits, no fused
    CE pair) on the masters, or on their bf16 copies under AMP."""
    named = {n: np.asarray(p.data) for n, p in
             JaxGPT(JaxConfig(**TINY)).named_parameters()}
    tm, tr = port_trainer(named, amp=amp)
    ids, _ = batch(5)
    got = tr.eval_step(ids)
    assert got.dtype == (torch.bfloat16 if amp else torch.float32)
    assert tm.training
    with torch.no_grad():
        ref = tm.eval()(torch.from_numpy(ids).long())
    _close(got.float().numpy(), ref.numpy(), 3e-2 if amp else 0.0, "logits")
