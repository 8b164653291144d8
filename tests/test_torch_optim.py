"""The port's optimizers, gradient clipping and LR schedules against the
JAX package's, on the CPU.

The same numpy parameters and per-step gradients go through the JAX
``Optimizer.apply_gradients`` (pure, returns new arrays) and the port's
(in place).  f32 on both sides with the same formulas, so the tolerance
is f32 rounding carried over 5 steps: rtol 1e-5, atol 1e-6 (Adam divides
by sqrt(m2) + eps, which amplifies one-ulp differences of tiny moments).
Clipping: rtol 1e-6.  Schedules are host floats: equal to 1e-12.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import clip as jclip

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import clip as tclip

SHAPES = {"w": (16, 8), "b": (8,), "emb": (32, 8)}
STEPS = 5


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _clip_pair(kind):
    if kind is None:
        return None, None
    if kind == "global":
        return jclip.ClipGradByGlobalNorm(1.0), tclip.ClipGradByGlobalNorm(1.0)
    if kind == "norm":
        return jclip.ClipGradByNorm(0.5), tclip.ClipGradByNorm(0.5)
    return jclip.ClipGradByValue(0.3), tclip.ClipGradByValue(0.3)


def _decay_names(name):
    return name != "b"


CASES = {
    "sgd": lambda m, kw: m.SGD(learning_rate=0.1, **kw),
    "sgd-l2": lambda m, kw: m.SGD(learning_rate=0.1, weight_decay=0.01, **kw),
    "momentum": lambda m, kw: m.Momentum(learning_rate=0.05, momentum=0.9,
                                         **kw),
    "nesterov-l2": lambda m, kw: m.Momentum(learning_rate=0.05, momentum=0.9,
                                            use_nesterov=True,
                                            weight_decay=0.02, **kw),
    "adam": lambda m, kw: m.Adam(learning_rate=1e-2, **kw),
    "adam-l2": lambda m, kw: m.Adam(learning_rate=1e-2, beta1=0.8,
                                    beta2=0.95, epsilon=1e-6,
                                    weight_decay=0.01, **kw),
    "adamw": lambda m, kw: m.AdamW(learning_rate=1e-2, weight_decay=0.1,
                                   **kw),
    "adamw-fn": lambda m, kw: m.AdamW(learning_rate=1e-2, weight_decay=0.1,
                                      apply_decay_param_fun=_decay_names,
                                      **kw),
}


@pytest.mark.parametrize("clip", [None, "global", "norm", "value"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax_apply_gradients(case, clip):
    jc, tc = _clip_pair(clip)
    jopt = CASES[case](paddle.optimizer, {"grad_clip": jc})
    t_opt = CASES[case](topt, {"grad_clip": tc})
    init = _arrays(0)
    jp = {n: jnp.asarray(a) for n, a in init.items()}
    jstate = jopt.init_state(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in init.items()}
    for step in range(1, STEPS + 1):
        grads = _arrays(step, scale=0.5)
        jp, jstate = jopt.apply_gradients(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, jstate,
            lr=jopt.get_lr(), step=step)
        t_opt.apply_gradients(tp, {n: torch.from_numpy(g)
                                   for n, g in grads.items()},
                              lr=t_opt.get_lr(), step=step)
    for n in SHAPES:
        assert tp[n].dtype == torch.float32
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for n, accs in t_opt._accumulators.items():
        for a, t in accs.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jstate[n][a]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n}@{a}")


def test_adam_is_not_torch_adam():
    """The JAX formula puts eps outside the bias correction; after a few
    steps with small second moments the two differ measurably."""
    p = torch.full((4,), 1.0)
    q = p.clone().requires_grad_()
    ours = topt.Adam(learning_rate=0.1, epsilon=1e-3)
    ref = torch.optim.Adam([q], lr=0.1, eps=1e-3)
    for _ in range(3):
        g = torch.full((4,), 1e-3)
        ours.apply_gradients({"p": p}, {"p": g})
        ours._step_count += 1
        q.grad = g.clone()
        ref.step()
    assert not torch.allclose(p, q.detach(), rtol=1e-4, atol=0)


def test_eager_step_equals_apply_gradients_and_keeps_dtype():
    """``step()`` over ``.grad`` runs the same rule; a bf16 parameter
    stays bf16 with f32 moments."""
    init = _arrays(1)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in init.values()]
    half = torch.nn.Parameter(torch.ones(8, dtype=torch.bfloat16))
    eager = topt.Adam(learning_rate=1e-2, parameters=params + [half])
    ref = {n: torch.from_numpy(a.copy()) for n, a in init.items()}
    funct = topt.Adam(learning_rate=1e-2)
    for step in range(1, 4):
        grads = _arrays(10 + step)
        for p, g in zip(params, grads.values()):
            p.grad = torch.from_numpy(g)
        half.grad = torch.full((8,), 0.5, dtype=torch.bfloat16)
        eager.step()
        eager.clear_grad()
        funct.apply_gradients(ref, {n: torch.from_numpy(g)
                                    for n, g in grads.items()}, step=step)
    for p, r in zip(params, ref.values()):
        torch.testing.assert_close(p.detach(), r, rtol=0, atol=0)
        assert p.grad is None
    assert half.dtype == torch.bfloat16
    assert eager._accumulators["3"]["moment1"].dtype == torch.float32
    assert float(half[0]) < 1.0


def test_state_dict_round_trip_and_lr():
    opt = topt.Momentum(learning_rate=0.1)
    p = {"w": torch.ones(3)}
    opt.apply_gradients(p, {"w": torch.ones(3)})
    opt._step_count = 1
    sd = opt.state_dict()
    assert set(sd) == {"w@velocity", "@step"}
    other = topt.Momentum(learning_rate=0.1)
    other.set_state_dict(sd)
    assert other._step_count == 1
    torch.testing.assert_close(other._accumulators["w"]["velocity"],
                               torch.ones(3))
    other.set_lr(0.5)
    assert other.get_lr() == 0.5
    sched = topt.lr.CosineAnnealingDecay(0.1, T_max=10)
    with pytest.raises(RuntimeError):
        topt.SGD(learning_rate=sched).set_lr(0.2)
    with pytest.raises(TypeError):
        topt.SGD(weight_decay="l2")


@pytest.mark.parametrize("kind", ["global", "norm", "value"])
@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_clip_matches_jax(kind, scale):
    """``clip_arrays`` (the trainer's form) and the eager (param, grad)
    form against the JAX clippers, below and above the threshold."""
    jc, tc = _clip_pair(kind)
    grads = _arrays(5, scale=scale)
    ref = jc.clip_arrays({n: jnp.asarray(g) for n, g in grads.items()})
    got = tc.clip_arrays({n: torch.from_numpy(g) for n, g in grads.items()})
    for n in grads:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(ref[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    params = [torch.zeros(1) for _ in grads]
    params[1].need_clip = False
    eager = tc(list(zip(params, (torch.from_numpy(g)
                                 for g in grads.values()))))
    assert eager[1][1] is not None
    np.testing.assert_array_equal(eager[1][1].numpy(), grads["b"])
    if kind != "global":      # the global norm differs once "b" is left out
        np.testing.assert_allclose(eager[0][1].numpy(), np.asarray(ref["w"]),
                                   rtol=1e-6, atol=1e-7)


def _schedules(m):
    return {
        "cosine": m.lr.CosineAnnealingDecay(0.1, T_max=20, eta_min=1e-3),
        "warmup-float": m.lr.LinearWarmup(0.1, warmup_steps=5, start_lr=0.0,
                                          end_lr=0.1),
        "warmup-cosine": m.lr.LinearWarmup(
            m.lr.CosineAnnealingDecay(0.1, T_max=15), warmup_steps=5,
            start_lr=1e-4, end_lr=0.1),
    }


@pytest.mark.parametrize("name", ["cosine", "warmup-float", "warmup-cosine"])
def test_lr_schedules_match_jax(name):
    js, ts = _schedules(paddle.optimizer)[name], _schedules(topt)[name]
    jopt = paddle.optimizer.SGD(learning_rate=js)
    t_opt = topt.SGD(learning_rate=ts)
    for _ in range(20):
        assert abs(t_opt.get_lr() - jopt.get_lr()) <= 1e-12
        js.step()
        ts.step()
    state = ts.state_dict()
    fresh = _schedules(topt)[name]
    fresh.set_state_dict(state)
    assert fresh() == ts()
