"""The training step's variants, port against the JAX package, on the CPU:
gradient merge, fp16 AMP with dynamic loss scaling, the ``skip`` and
``rollback`` anomaly policies, ``FLAGS_check_nan_inf`` and the selective
recompute policies.

The same numpy weights (``load_paddle_tpu_params``) and seeded batches
go through the JAX ``SpmdTrainer`` on a ``{"dp": 1}`` mesh and through
the port's.  Tolerances, stated per check:
- f32 parameters and losses: rtol 1e-5, atol 1e-6 (SGD, so a gradient
  difference moves a parameter by the learning rate times itself);
- fp16 parameters after 3 steps: rtol 2e-2, atol 2e-3 (both sides round
  weights and activations to fp16, at different points);
- the loss scaler's ``(scale, good, bad, t)``: exact, step by step;
- a policy against the same package's clean run: rtol 1e-6, atol 1e-7
  (as ``tests/test_resilience.py``), and recompute against no recompute
  in the port: bitwise.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib

import numpy as np
import pytest

import jax
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.errors import PreconditionNotMetError as JaxNanError
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import create_mesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.errors import PreconditionNotMetError
from paddle_tpu_torch.distributed import SpmdTrainer, async_dispatch
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.parallel_layers import ColumnParallelLinear
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_params)

recompute_mod = importlib.import_module("paddle_tpu_torch.distributed.recompute")

SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=32, fused_ce=True)
F32 = dict(rtol=1e-5, atol=1e-6)
FP16 = dict(rtol=2e-2, atol=2e-3)
SAME_PACKAGE = dict(rtol=1e-6, atol=1e-7)


def gpt_batch(seed, b=2, s=32, v=256):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, v, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _mesh():
    return create_mesh({"dp": 1}, devices=jax.devices()[:1])


def _strategies(amp=None, k=1, avg=True, recompute=None):
    """The same settings as a JAX and a port strategy."""
    out = []
    for cls in (JaxStrategy, DistributedStrategy):
        st = cls()
        if amp is not None:
            st.amp = True
            st.amp_configs = dict(amp)
        if k > 1:
            st.gradient_merge = True
            st.gradient_merge_configs = {"k_steps": k, "avg": avg}
        if recompute is not None:
            st.recompute = True
            if recompute != "default":
                st.recompute_configs = {"policy": recompute}
        out.append(st)
    return out


def gpt_pair(opt="sgd", lr=0.1, amp=None, k=1, avg=True, policy=None,
             recompute=None, seed=0):
    """A JAX and a port trainer over one tiny GPT's weights."""
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(**SMALL))
    named = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    load_paddle_tpu_params(tm, named)
    jst, tst = _strategies(amp, k, avg, recompute)
    if opt == "sgd":
        jopt = paddle.optimizer.SGD(learning_rate=lr,
                                    parameters=jm.parameters())
        topt_ = topt.SGD(learning_rate=lr)
    else:
        jopt = paddle.optimizer.Adam(learning_rate=lr,
                                     parameters=jm.parameters())
        topt_ = topt.Adam(learning_rate=lr)
    jcrit, tcrit = JaxCriterion(), GPTPretrainingCriterion()
    jtr = JaxTrainer(jm, jopt, lambda o, l: jcrit(o, l), mesh=_mesh(),
                     strategy=jst, anomaly_policy=policy)
    ttr = SpmdTrainer(tm, topt_, lambda o, l: tcrit(o, l), strategy=tst,
                      anomaly_policy=policy)
    return jtr, ttr


def port_params(tr):
    return {n: p.float().numpy() for n, p in tr.params.items()}


def jax_params(tr):
    return {n: np.asarray(a, np.float32) for n, a in tr.params.items()}


def assert_params(got, ref, tol):
    assert sorted(got) == sorted(ref)
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], err_msg=n, **tol)


# ---- gradient merge -----------------------------------------------------
@pytest.mark.parametrize("k,avg", [(2, True), (2, False), (4, True),
                                   (4, False)])
def test_gradient_merge_matches_jax(k, avg):
    jtr, ttr = gpt_pair(k=k, avg=avg)
    batches = [gpt_batch(i) for i in range(2 * k)]
    jl = [float(jtr.train_step(*b)) for b in batches]
    tl = [float(ttr.train_step(*b)) for b in batches]
    np.testing.assert_allclose(tl, jl, **F32)
    assert ttr.optimizer._step_count == 2 == jtr.optimizer._step_count
    assert_params(port_params(ttr), jax_params(jtr), F32)


@pytest.mark.parametrize("k,avg", [(2, True), (4, True), (4, False)])
def test_gradient_merge_matches_large_batch(k, avg):
    """k micro-steps over the k parts of one batch equal one step on the
    whole batch (at k times the learning rate without ``avg``: the sum
    of k micro-batch means is k times the whole batch's mean)."""
    ids, labels = gpt_batch(7, b=2 * k)
    _, merged = gpt_pair(k=k, avg=avg)
    for i in range(k):
        merged.train_step(ids[2 * i:2 * i + 2], labels[2 * i:2 * i + 2])
    _, big = gpt_pair(lr=0.1 if avg else 0.1 * k)
    big.train_step(ids, labels)
    assert_params(port_params(merged), port_params(big), F32)


def test_gradient_merge_buffers_hold_until_the_kth_step():
    _, tr = gpt_pair(k=2)
    before = port_params(tr)
    tr.train_step(*gpt_batch(0))
    assert_params(port_params(tr), before, dict(rtol=0, atol=0))
    assert any(float(b.abs().max()) > 0 for b in tr._grad_buf.values())
    tr.train_step(*gpt_batch(1))
    assert all(float(b.abs().max()) == 0 for b in tr._grad_buf.values())
    assert tr.optimizer._step_count == 1 and tr._step_count == 2


# ---- fp16 dynamic loss scaling -------------------------------------------
def scaler_of(tr):
    s = tr._scaler_state
    return (float(np.asarray(s["scale"])), int(np.asarray(s["good"])),
            int(np.asarray(s["bad"])), int(np.asarray(s["t"])))


@pytest.mark.parametrize("cfg,nan_step,steps", [
    # poisoned step 2, incr after 2 good steps, halve after 2 bad
    ({"init_loss_scaling": 1024.0, "incr_every_n_steps": 2}, 2, 6),
    # one overflow halves, the floor holds (test_resilience.py:429)
    ({"init_loss_scaling": 8.0, "decr_every_n_nan_or_inf": 1,
      "min_loss_scaling": 4.0, "incr_every_n_steps": 3}, 1, 5),
], ids=["streaks", "floor"])
def test_fp16_scaler_trajectory_equals_jax(monkeypatch, cfg, nan_step,
                                           steps):
    monkeypatch.setenv("PADDLE_FAULT_NAN_STEP", str(nan_step))
    amp = dict(cfg, use_bf16=False)
    jtr, ttr = gpt_pair(opt="adam", lr=1e-3, amp=amp)
    seen = []
    for i in range(steps):
        b = gpt_batch(i)
        jl, tl = float(jtr.train_step(*b)), float(ttr.train_step(*b))
        assert scaler_of(ttr) == scaler_of(jtr), f"step {i + 1}"
        assert bool(ttr._scaler_state["found_inf"]) == \
            bool(jtr._scaler_state["found_inf"]) == (i + 1 == nan_step)
        np.testing.assert_allclose(tl, jl, **FP16)
        seen.append(scaler_of(ttr))
    assert len(set(s[0] for s in seen)) > 1     # the scale moved
    assert ttr.stats["skipped_steps"] == 1 == jtr.stats["skipped_steps"]


def test_fp16_params_after_3_steps_match_jax():
    """SGD: Adam's first steps move a parameter by about the learning
    rate whatever its gradient's size, so a gradient near zero whose
    sign differs between the packages' fp16 roundings would flip it."""
    amp = {"use_bf16": False, "init_loss_scaling": 1024.0}
    jtr, ttr = gpt_pair(amp=amp)
    for i in range(3):
        jtr.train_step(*gpt_batch(i))
        ttr.train_step(*gpt_batch(i))
    assert ttr.loss_scale == jtr.loss_scale == 1024.0
    assert not ttr.last_step_skipped
    assert all(p.dtype == torch.float32 for p in ttr.params.values())
    assert_params(port_params(ttr), jax_params(jtr), FP16)


class Bomb(torch.nn.Module):
    """A linear layer whose output explodes when an input row carries the
    sentinel value (the JAX tests' ``BombLayer``)."""

    def __init__(self, n_in=8, n_out=4, big=1.0e30, seed=0):
        super().__init__()
        self.fc = ColumnParallelLinear(
            n_in, n_out, device="cpu", dtype=torch.float32,
            generator=torch.Generator().manual_seed(seed))
        self.big = big

    def forward(self, x):
        mask = (x > 900.0).to(x.dtype).amax()
        return self.fc(x) * (1.0 + mask * self.big)


def mse(out, y):
    return torch.nn.functional.mse_loss(out.float(), y.float())


def bomb_batch(sentinel=False, seed=0, n_in=8, n_out=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, n_in).astype(np.float32)
    if sentinel:
        x[0, 0] = 1000.0
    return x, rng.randn(4, n_out).astype(np.float32)


def fp16_bomb(opt=None, **cfg):
    st = DistributedStrategy()
    st.amp = True
    st.amp_configs = dict({"use_bf16": False}, **cfg)
    model = Bomb()
    return model, SpmdTrainer(model, opt or topt.Adam(learning_rate=1e-3),
                              mse, strategy=st)


def test_fp16_trains_and_scale_initialized():
    _, tr = fp16_bomb()
    assert tr.fp16_scaling and tr.amp_dtype == torch.float16
    assert tr.loss_scale == 2.0 ** 15
    assert np.isfinite(float(tr.train_step(*bomb_batch())))
    assert not tr.last_step_skipped
    assert tr.loss_scale == 2.0 ** 15


def test_fp16_overflow_skips_update_and_halves_scale():
    _, tr = fp16_bomb(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1)
    tr.train_step(*bomb_batch())
    before = port_params(tr)
    m1 = tr.optimizer._accumulators["fc.weight"]["moment1"].clone()
    tr.train_step(*bomb_batch(sentinel=True))
    assert tr.last_step_skipped and tr.loss_scale == 512.0
    assert_params(port_params(tr), before, dict(rtol=0, atol=0))
    assert torch.equal(tr.optimizer._accumulators["fc.weight"]["moment1"],
                       m1)
    assert np.isfinite(float(tr.train_step(*bomb_batch())))
    assert not tr.last_step_skipped and tr.loss_scale == 512.0


def test_fp16_two_consecutive_overflows_needed_by_default():
    _, tr = fp16_bomb(init_loss_scaling=1024.0)
    bad = bomb_batch(sentinel=True)
    tr.train_step(*bad)
    assert tr.loss_scale == 1024.0
    tr.train_step(*bad)
    assert tr.loss_scale == 512.0
    tr.train_step(*bomb_batch())
    tr.train_step(*bad)
    assert tr.loss_scale == 512.0


def test_fp16_good_streak_doubles_scale():
    _, tr = fp16_bomb(init_loss_scaling=8.0, incr_every_n_steps=3)
    for want in (8.0, 8.0, 16.0, 16.0):
        tr.train_step(*bomb_batch())
        assert tr.loss_scale == want


def test_fp16_skipped_step_does_not_advance_t():
    _, tr = fp16_bomb(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1)
    tr.train_step(*bomb_batch())
    t = int(tr._scaler_state["t"])
    tr.train_step(*bomb_batch(sentinel=True))
    assert int(tr._scaler_state["t"]) == t
    tr.train_step(*bomb_batch())
    assert int(tr._scaler_state["t"]) == t + 1
    assert tr.stats["skipped_steps"] == 1


def test_fp16_growth_keeps_a_finite_scale():
    """Growing past the f32 range keeps the old scale (JAX
    ``spmd.py:1004``): the state machine alone, on a crafted state."""
    _, tr = fp16_bomb(incr_every_n_steps=1)
    big = torch.tensor(2.0 ** 127)
    tr._scaler_state["scale"] = big
    nxt = tr._next_scale(torch.tensor(False), torch.tensor(1))
    assert float(nxt["scale"]) == 2.0 ** 127 and int(nxt["good"]) == 0


def test_fp16_parity_with_unscaled_reference():
    """A power-of-two scale is numerically transparent: fp16 at scale
    256 equals fp16 at scale 1."""
    trainers = [fp16_bomb(topt.SGD(learning_rate=0.1),
                          init_loss_scaling=s)[1] for s in (256.0, 1.0)]
    for _ in range(3):
        l1, l2 = (float(t.train_step(*bomb_batch())) for t in trainers)
        assert l1 == pytest.approx(l2, rel=2e-3)
    assert_params(port_params(trainers[0]), port_params(trainers[1]),
                  dict(rtol=2e-3, atol=2e-3))


def test_fp16_with_gradient_merge_raises():
    st = DistributedStrategy()
    st.amp = True
    st.amp_configs = {"use_bf16": False}
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2}
    with pytest.raises(NotImplementedError, match="gradient_merge"):
        SpmdTrainer(Bomb(), topt.SGD(learning_rate=0.1), mse, strategy=st)


# ---- anomaly policies ----------------------------------------------------
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_skip_matches_clean_run_and_jax(monkeypatch, opt):
    """Adam: the skipped step holds ``t``, so the run equals one that
    never saw the batch; SGD: the same run against the JAX trainer's
    (Adam's first steps would amplify the packages' gradient rounding,
    see ``test_fp16_params_after_3_steps_match_jax``)."""
    lr = 1e-3 if opt == "adam" else 0.1
    batches = [gpt_batch(i) for i in range(6)]
    _, clean = gpt_pair(opt=opt, lr=lr)
    for i, b in enumerate(batches):
        if i != 2:
            clean.train_step(*b)
    monkeypatch.setenv("PADDLE_FAULT_NAN_STEP", "3")
    jtr, ttr = gpt_pair(opt=opt, lr=lr, policy="skip")
    for b in batches:
        jtr.train_step(*b)
        ttr.train_step(*b)
    st = ttr.stats
    assert st["anomaly_policy"] == "skip" and st["skipped_steps"] == 1
    assert jtr.stats["skipped_steps"] == 1
    assert ttr._step_count == 6 == jtr._step_count
    assert int(ttr._anomaly_state["t"]) == 5 == \
        int(jtr._anomaly_state["t"])
    assert_params(port_params(ttr), port_params(clean), SAME_PACKAGE)
    if opt == "sgd":
        assert_params(port_params(ttr), jax_params(jtr), F32)


def test_skip_under_gradient_merge_drops_the_micro_batch():
    """A non-finite micro-batch never enters the buffers; the window's
    update still divides by k (JAX ``spmd.py:1056``): here the update of
    the one clean micro-batch at half the learning rate."""
    st = DistributedStrategy()
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2}
    tr = SpmdTrainer(NanAt(), topt.SGD(learning_rate=0.1), mse, strategy=st,
                     anomaly_policy="skip")
    ref = SpmdTrainer(NanAt(), topt.SGD(learning_rate=0.05), mse)
    tr.train_step(*nan_batch())
    tr.train_step(*nan_batch(True))
    ref.train_step(*nan_batch())
    assert tr.stats["skipped_steps"] == 1
    assert_params(port_params(tr), port_params(ref), SAME_PACKAGE)


class BombNet(torch.nn.Module):
    """The JAX rollback test's ``_BombNet``: the squared error overflows
    to inf only on a batch carrying the sentinel."""

    def __init__(self):
        super().__init__()
        self.fc = ColumnParallelLinear(4, 2, device="cpu",
                                       dtype=torch.float32,
                                       generator=torch.Generator())

    def forward(self, x):
        mask = (x > 900.0).to(x.dtype).amax()
        return self.fc(x) * (1.0 + mask * 3.0e38)


class JaxBombNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 2)

    def forward(self, x):
        mask = (x > 900.0).astype("float32").max()
        return self.fc(x) * (1.0 + mask * 3.0e38)


def bomb_pair(policy=None, seed=13):
    paddle.seed(seed)
    jm = JaxBombNet()
    jtr = JaxTrainer(jm, paddle.optimizer.Adam(learning_rate=1e-2,
                                               parameters=jm.parameters()),
                     lambda o, y: JF.mse_loss(o, y), mesh=_mesh(),
                     anomaly_policy=policy)
    tm = BombNet()
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(jtr.params[n])))
    ttr = SpmdTrainer(tm, topt.Adam(learning_rate=1e-2),
                      lambda o, y: torch.nn.functional.mse_loss(o, y),
                      anomaly_policy=policy)
    return jtr, ttr


def small_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4, 4).astype(np.float32),
             rng.randn(4, 2).astype(np.float32)) for _ in range(n)]


def test_rollback_matches_clean_run_and_jax():
    batches = small_batches(6, seed=9)
    bomb = np.full((4, 4), 1000.0, np.float32)
    _, clean = bomb_pair()
    for i, (x, y) in enumerate(batches):
        if i != 2:
            clean.train_step(x, y)
    jtr, ttr = bomb_pair("rollback")
    async_dispatch.reset_host_sync_count()
    for i, (x, y) in enumerate(batches):
        jtr.train_step(bomb if i == 2 else x, y)
        ttr.train_step(bomb if i == 2 else x, y)
    assert async_dispatch.host_sync_count() == 6     # one a step
    assert ttr.stats["rollback_steps"] == 1 == jtr.stats["rollback_steps"]
    assert ttr._step_count == 5 == jtr._step_count
    assert_params(port_params(ttr), port_params(clean), SAME_PACKAGE)
    assert_params(port_params(ttr), jax_params(jtr), F32)
    assert ttr.snapshot_bytes == 4 * (4 * 2 + 2) * 3


@pytest.mark.parametrize("fp16,k", [(True, 1), (False, 2)],
                         ids=["fp16", "gradient_merge"])
def test_rollback_refuses_fp16_and_merge(fp16, k):
    st = DistributedStrategy()
    if fp16:
        st.amp = True
        st.amp_configs = {"use_bf16": False}
    if k > 1:
        st.gradient_merge = True
        st.gradient_merge_configs = {"k_steps": k}
    with pytest.raises(NotImplementedError, match="rollback"):
        SpmdTrainer(Bomb(), topt.SGD(learning_rate=0.1), mse, strategy=st,
                    anomaly_policy="rollback")


def test_anomaly_policy_validated():
    with pytest.raises(ValueError, match="raise|skip|rollback"):
        SpmdTrainer(Bomb(), topt.SGD(), mse, anomaly_policy="explode")


# ---- FLAGS_check_nan_inf --------------------------------------------------
class NanAt(torch.nn.Module):
    """Emits -inf when an input row carries the sentinel value (the JAX
    test's ``NanAt``)."""

    def __init__(self):
        super().__init__()
        self.fc = ColumnParallelLinear(4, 2, device="cpu",
                                       dtype=torch.float32,
                                       generator=torch.Generator())

    def forward(self, x):
        mask = (x > 900.0).to(x.dtype).amax()
        return self.fc(x) + torch.log(1.0 - mask)


def nan_batch(sentinel=False):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 4).astype(np.float32)
    if sentinel:
        x[0, 0] = 1000.0
    return x, rng.randn(4, 2).astype(np.float32)


@pytest.fixture
def nan_flag():
    tflags.set_flags({"FLAGS_check_nan_inf": True})
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    yield
    tflags.set_flags({"FLAGS_check_nan_inf": False})
    paddle.set_flags({"FLAGS_check_nan_inf": False})


def test_nan_guard_off_by_default_trains_through_nan():
    tr = SpmdTrainer(NanAt(), topt.SGD(learning_rate=0.1), mse)
    assert not tr._check_nan_inf
    assert not np.isfinite(float(tr.train_step(*nan_batch(True))))


def test_nan_guard_catches_injected_nan_with_names(nan_flag):
    tr = SpmdTrainer(NanAt(), topt.SGD(learning_rate=0.1), mse)
    assert tr._check_nan_inf
    assert np.isfinite(float(tr.train_step(*nan_batch())))
    with pytest.raises(PreconditionNotMetError) as ei:
        tr.train_step(*nan_batch(True))
    assert "loss" in str(ei.value)


def test_nan_guard_names_the_poisoned_gradients_as_jax(nan_flag,
                                                        monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_NAN_STEP", "2")
    jtr, ttr = gpt_pair()
    async_dispatch.reset_host_sync_count()
    ttr.train_step(*gpt_batch(0))
    jtr.train_step(*gpt_batch(0))
    assert async_dispatch.host_sync_count() == 1     # the flags, once
    with pytest.raises(PreconditionNotMetError) as got:
        ttr.train_step(*gpt_batch(1))
    with pytest.raises(JaxNanError) as want:
        jtr.train_step(*gpt_batch(1))
    names = str(got.value).split(": ", 2)[-1]
    assert names == str(want.value).split(": ", 2)[-1]
    assert "loss" not in names and "gpt.wte.weight@GRAD" in names


def test_nan_guard_fp16_catches_nan_loss_but_not_grad_overflow(nan_flag):
    st = DistributedStrategy()
    st.amp = True
    st.amp_configs = {"use_bf16": False, "init_loss_scaling": 2.0 ** 14}
    tr = SpmdTrainer(NanAt(), topt.SGD(learning_rate=0.1), mse, strategy=st)
    assert np.isfinite(float(tr.train_step(*nan_batch())))
    with pytest.raises(PreconditionNotMetError, match="loss"):
        tr.train_step(*nan_batch(True))
    # gradients overflowing fp16 under a huge scale: a skip, not an error
    _, tr2 = fp16_bomb(init_loss_scaling=2.0 ** 100)
    assert np.isfinite(float(tr2.train_step(*bomb_batch())))
    assert tr2.last_step_skipped


def test_nan_guard_covers_gradient_merge_accum_path(nan_flag):
    st = DistributedStrategy()
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2}
    tr = SpmdTrainer(NanAt(), topt.SGD(learning_rate=0.1), mse, strategy=st)
    tr.train_step(*nan_batch())
    with pytest.raises(PreconditionNotMetError, match="loss"):
        tr.train_step(*nan_batch(True))


def test_anomaly_policy_turns_the_nan_guard_off(nan_flag):
    tr = SpmdTrainer(NanAt(), topt.SGD(learning_rate=0.1), mse,
                     anomaly_policy="skip")
    assert not tr._check_nan_inf
    tr.train_step(*nan_batch(True))
    assert tr.stats["skipped_steps"] == 1


# ---- no host sync per step -------------------------------------------------
@pytest.mark.parametrize("mode", ["merge", "fp16", "skip", "skip-merge"])
def test_no_host_sync_per_step(mode, monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_NAN_STEP", "2")
    amp = {"use_bf16": False} if mode == "fp16" else None
    k = 2 if "merge" in mode else 1
    _, tr = gpt_pair(amp=amp, k=k,
                     policy="skip" if "skip" in mode else None)
    async_dispatch.reset_host_sync_count()
    results = [tr.train_step(*gpt_batch(i)) for i in range(4)]
    assert async_dispatch.host_sync_count() == 0
    float(results[-1])
    assert async_dispatch.host_sync_count() == 1
    tr.stats
    assert async_dispatch.host_sync_count() == (1 if mode == "merge" else 2)


# ---- selective recompute ---------------------------------------------------
def _port_grads(policy, ids, labels):
    paddle.seed(0)
    named = {n: np.asarray(p.data) for n, p in
             JaxGPT(JaxConfig(**SMALL)).named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    load_paddle_tpu_params(tm, named)
    if policy != "none":
        tm.enable_recompute(policy)
    tm.train()
    out = tm(torch.from_numpy(ids).long())
    loss = GPTPretrainingCriterion()(out, torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in tm.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch",
                                    "nothing", "everything"])
def test_recompute_policy_grads_bitwise_and_match_jax(policy):
    ids, labels = gpt_batch(5)
    loss0, g0 = _port_grads("none", ids, labels)
    loss, g = _port_grads(policy, ids, labels)
    assert loss == loss0
    for n in g0:
        assert torch.equal(g[n], g0[n]), n
    # the JAX package's eager backward under the same policy
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**SMALL))
    jm.enable_recompute(policy=policy)
    jm.train()
    jloss = JaxCriterion()(jm(paddle.to_tensor(ids)),
                           paddle.to_tensor(labels))
    jloss.backward()
    np.testing.assert_allclose(loss, float(jloss), **F32)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(g[n].numpy(), p.grad.numpy(),
                                   err_msg=n, rtol=1e-5, atol=1e-6)


def test_recompute_policies_keep_what_they_name():
    """Count the tensors the blocks keep in the forward: under a dots
    policy the op outputs it keeps (its policy function's MUST_SAVE
    answers); under full recompute ('full', 'nothing') and 'everything',
    which runs the blocks without recompute, the tensors autograd saves
    for them (saved-tensor hooks: all saves of the forward, less those a
    fully recomputed run makes outside its checkpointed blocks).  full
    keeps none of a block's, dots_no_batch the linears' mm outputs, and
    so does dots: the attention is one custom op
    (``paddle_tpu::flash_fwd``) on the CPU as on the card, recomputed
    under both, as the JAX policies recompute the TPU kernel.  dots also
    keeps a batched product's output where one runs in the region
    (``torch.bmm`` under ``recompute``), dots_no_batch does not."""
    ids, labels = gpt_batch(6)
    kept = {}
    real = recompute_mod._policy_fn

    def spy(name, ctx, op, *a, **k):
        out = real(name, ctx, op, *a, **k)
        if not ctx.is_recompute and out.name == "MUST_SAVE":
            kept.setdefault(name, []).append(str(op))
        return out

    def saves(policy):
        packed = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(t) or t, lambda t: t):
            _port_grads(policy, ids, labels)
        return len(packed)

    recompute_mod._policy_fn = spy
    try:
        for policy in ("nothing", "dots_no_batch", "dots"):
            _port_grads(policy, ids, labels)
        outside = saves("full")
        n = {p: len(kept.get(p, [])) for p in ("dots_no_batch", "dots")}
        for policy in ("full", "nothing", "everything"):
            n[policy] = saves(policy) - outside
    finally:
        recompute_mod._policy_fn = real
    assert set(kept) == {"dots_no_batch", "dots"}  # no selective policy
    layers = SMALL["num_layers"]
    # four block linears a layer, each one aten.mm
    assert kept["dots_no_batch"] == ["aten.mm.default"] * 4 * layers
    assert kept["dots"] == kept["dots_no_batch"]
    assert n["full"] == n["nothing"] == 0
    assert n["full"] < n["dots_no_batch"] <= n["dots"] < n["everything"]
    assert saves("everything") == saves("none")
    # a batched product in the region: dots keeps it, dots_no_batch not
    a = torch.randn(2, 3, 4, requires_grad=True)
    b = torch.randn(2, 4, 5, requires_grad=True)
    kept.clear()
    recompute_mod._policy_fn = spy
    try:
        for policy in ("dots", "dots_no_batch"):
            recompute_mod.recompute(lambda x, y: torch.bmm(x, y).tanh(), a,
                                    b, policy=policy).sum().backward()
    finally:
        recompute_mod._policy_fn = real
    assert kept["dots"] == ["aten.bmm.default"]
    assert "dots_no_batch" not in kept


def test_checkpoint_policy_maps_the_jax_names():
    assert recompute_mod.checkpoint_policy("full") is None
    assert recompute_mod.checkpoint_policy(None) is None
    assert recompute_mod.checkpoint_policy("nothing") is None
    assert recompute_mod.checkpoint_policy("everything") is None
    for name in ("dots", "dots_no_batch"):
        assert callable(recompute_mod.checkpoint_policy(name))
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute_mod.checkpoint_policy("checkpoint_dots")


def test_trainer_recompute_policy_default_dots_matches_jax():
    """``strategy.recompute = True`` with the default policy ('dots') runs
    and gives the JAX trainer's step."""
    jtr, ttr = gpt_pair(recompute="default")
    assert ttr.model.gpt._recompute_policy == "dots"
    assert jtr.model.gpt._recompute_policy == "dots"
    b = gpt_batch(8)
    np.testing.assert_allclose(float(ttr.train_step(*b)),
                               float(jtr.train_step(*b)), **F32)
    assert_params(port_params(ttr), jax_params(jtr), F32)
