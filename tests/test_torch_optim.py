"""The port's optimizers, gradient clipping and LR schedules against the
JAX package's, on the CPU.

The same numpy parameters and per-step gradients go through the JAX
``Optimizer.apply_gradients`` (pure, returns new arrays) and the port's
(in place).  f32 on both sides with the same formulas, so the tolerance
is f32 rounding carried over 5 steps: rtol 1e-5, atol 1e-6 (Adam divides
by sqrt(m2) + eps, which amplifies one-ulp differences of tiny moments).
Clipping: rtol 1e-6.  Schedules are host floats: equal to 1e-12.
The update rules added later (Adagrad, RMSProp, Adadelta, Adamax, Lamb,
Lars, with L1 / L2 regularizers) are held to the same rtol 1e-5 / atol
1e-6 over 5 steps, also with the step count as a device int32 tensor
(the trainer's form under fp16 AMP and ``skip``): the port then takes
``beta ** t`` in f32 on the device where JAX, given a Python int, takes
it in double.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
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


def _exclude_bias(param):
    return param.name == "b"


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
# the rules added with the regularizers (``reg`` is the package's
# ``regularizer`` module)
NEW_CASES = {
    "adagrad-l1": lambda m, reg, kw: m.Adagrad(
        learning_rate=0.1, initial_accumulator_value=0.1,
        weight_decay=reg.L1Decay(0.01), **kw),
    "rmsprop-l2": lambda m, reg, kw: m.RMSProp(
        learning_rate=1e-2, momentum=0.9, weight_decay=reg.L2Decay(0.02),
        **kw),
    "rmsprop-centered-l1": lambda m, reg, kw: m.RMSProp(
        learning_rate=1e-2, rho=0.9, centered=True,
        weight_decay=reg.L1Decay(0.01), **kw),
    "adadelta-l2": lambda m, reg, kw: m.Adadelta(
        learning_rate=1.0, epsilon=1e-6, rho=0.9, weight_decay=0.01, **kw),
    "adamax-l1": lambda m, reg, kw: m.Adamax(
        learning_rate=1e-2, weight_decay=reg.L1Decay(0.005), **kw),
    "lamb": lambda m, reg, kw: m.Lamb(learning_rate=1e-2,
                                      lamb_weight_decay=0.05, **kw),
    "lamb-exclude": lambda m, reg, kw: m.Lamb(
        learning_rate=1e-2, lamb_weight_decay=0.05,
        exclude_from_weight_decay_fn=_exclude_bias, **kw),
    "lars": lambda m, reg, kw: m.Lars(learning_rate=0.1, momentum=0.9,
                                      lars_coeff=0.01, **kw),
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


@pytest.mark.parametrize("device_step", [False, True])
@pytest.mark.parametrize("clip", [None, "global", "norm", "value"])
@pytest.mark.parametrize("case", sorted(NEW_CASES))
def test_new_rules_match_jax_apply_gradients(case, clip, device_step):
    """Each rule with its regularizer and clip, the step a host int or a
    device int32 tensor, 5 steps against the JAX rule."""
    import paddle_tpu.regularizer as jreg
    import paddle_tpu_torch.regularizer as treg
    jc, tc = _clip_pair(clip)
    jopt = NEW_CASES[case](paddle.optimizer, jreg, {"grad_clip": jc})
    t_opt = NEW_CASES[case](topt, treg, {"grad_clip": tc})
    init = _arrays(0)
    jp = {n: jnp.asarray(a) for n, a in init.items()}
    jstate = jopt.init_state(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in init.items()}
    for step in range(1, STEPS + 1):
        grads = _arrays(step, scale=0.5)
        jp, jstate = jopt.apply_gradients(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, jstate,
            lr=jopt.get_lr(), step=step)
        t_step = torch.tensor(step, dtype=torch.int32) if device_step \
            else step
        t_opt.apply_gradients(tp, {n: torch.from_numpy(g)
                                   for n, g in grads.items()},
                              lr=t_opt.get_lr(), step=t_step)
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for n, accs in t_opt._accumulators.items():
        assert sorted(accs) == sorted(jstate[n])
        for a, t in accs.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jstate[n][a]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n}@{a}")


def test_regularizers_and_per_parameter_override():
    """``weight_decay`` takes a float (L2), an L1Decay or an L2Decay; in
    the eager path a parameter's own ``regularizer`` overrides it, as in
    the JAX package's ``_apply_decay``."""
    import paddle_tpu.regularizer as jreg
    import paddle_tpu_torch.regularizer as treg
    p = _arrays(3)["w"]
    g = _arrays(4)["w"]
    for jr, tr in ((jreg.L1Decay(0.3), treg.L1Decay(0.3)),
                   (jreg.L2Decay(0.3), treg.L2Decay(0.3))):
        np.testing.assert_allclose(
            tr.apply(torch.from_numpy(p), torch.from_numpy(g)).numpy(),
            np.asarray(jr.apply(jnp.asarray(p), jnp.asarray(g))),
            rtol=1e-6, atol=1e-7)
        assert repr(tr) == repr(jr) and tr.coeff == jr.coeff
    assert isinstance(topt.SGD(weight_decay=0.1)._weight_decay, treg.L2Decay)
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(3))
    b.regularizer = treg.L1Decay(1.0)
    opt = topt.SGD(learning_rate=0.5, parameters=[a, b],
                   weight_decay=treg.L2Decay(0.2))
    a.grad, b.grad = torch.zeros(3), torch.zeros(3)
    opt.step()
    torch.testing.assert_close(a.detach(), torch.full((3,), 1 - 0.5 * 0.2))
    torch.testing.assert_close(b.detach(), torch.full((3,), 1 - 0.5 * 1.0))
    assert topt.AdamW(weight_decay=treg.L2Decay(0.3))._wd_coeff == 0.3


def test_lamb_exclude_fn_sees_named_objects_on_both_paths():
    """The hook gets an object carrying ``.name``: the parameter's
    position in the eager path, its structured name in the trainer's."""
    seen = []

    def hook(obj):
        seen.append(obj.name)
        return obj.name == "1"
    params = [torch.nn.Parameter(torch.ones(2)) for _ in range(2)]
    opt = topt.Lamb(learning_rate=0.1, lamb_weight_decay=0.5,
                    parameters=params, exclude_from_weight_decay_fn=hook)
    for q in params:
        q.grad = torch.zeros(2)
    opt.step()
    topt.Lamb(exclude_from_weight_decay_fn=hook).apply_gradients(
        {"w": torch.ones(2)}, {"w": torch.ones(2)})
    assert seen == ["0", "1", "w"]
    # a zero gradient: only the decayed parameter moves
    assert (params[0] < 1).all() and (params[1] == 1).all()


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
    lr = m.lr
    return {
        "cosine": lr.CosineAnnealingDecay(0.1, T_max=20, eta_min=1e-3),
        "warmup-float": lr.LinearWarmup(0.1, warmup_steps=5, start_lr=0.0,
                                        end_lr=0.1),
        "warmup-cosine": lr.LinearWarmup(
            lr.CosineAnnealingDecay(0.1, T_max=15), warmup_steps=5,
            start_lr=1e-4, end_lr=0.1),
        "noam": lr.NoamDecay(d_model=64, warmup_steps=8, learning_rate=2.0),
        "piecewise": lr.PiecewiseDecay([5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
        "natural-exp": lr.NaturalExpDecay(0.1, gamma=0.1),
        "inverse-time": lr.InverseTimeDecay(0.1, gamma=0.3),
        "polynomial": lr.PolynomialDecay(0.1, decay_steps=12, end_lr=1e-3,
                                         power=2.0),
        "polynomial-cycle": lr.PolynomialDecay(0.1, decay_steps=7, power=1.5,
                                               cycle=True),
        "exponential": lr.ExponentialDecay(0.1, gamma=0.9),
        "multistep": lr.MultiStepDecay(0.1, milestones=[4, 9, 17], gamma=0.5),
        "step": lr.StepDecay(0.1, step_size=6, gamma=0.3),
        "lambda": lr.LambdaDecay(0.1, lambda e: 0.95 ** e + 0.01 * (e % 3)),
        "multiplicative": lr.MultiplicativeDecay(0.1, lambda e: 0.9),
        "plateau": lr.ReduceOnPlateau(0.1, factor=0.5, patience=2,
                                      cooldown=1, min_lr=1e-3),
        "plateau-max-abs": lr.ReduceOnPlateau(
            0.1, mode="max", threshold_mode="abs", threshold=0.05,
            patience=1),
        "one-cycle": lr.OneCycleLR(0.1, total_steps=25, phase_pct=0.4),
        "one-cycle-linear": lr.OneCycleLR(0.1, total_steps=20,
                                          anneal_strategy="linear"),
        "cyclic": lr.CyclicLR(1e-3, 0.1, step_size_up=4, step_size_down=6),
        "cyclic-triangular2": lr.CyclicLR(1e-3, 0.1, step_size_up=3,
                                          mode="triangular2"),
        "cyclic-exp": lr.CyclicLR(1e-3, 0.1, step_size_up=5,
                                  mode="exp_range", exp_gamma=0.9),
        "cyclic-scale-fn": lr.CyclicLR(1e-3, 0.1, step_size_up=4,
                                       scale_fn=lambda x: 1.0 / (1.0 + x),
                                       scale_mode="iterations"),
    }


# a loss that falls, stalls and rises: ReduceOnPlateau cuts the rate
METRICS = [1.0, 0.9, 0.85, 0.86, 0.87, 0.85, 0.8, 0.81, 0.82, 0.83] * 3


@pytest.mark.parametrize("name", sorted(_schedules(topt)))
def test_lr_schedules_match_jax(name):
    js, ts = _schedules(paddle.optimizer)[name], _schedules(topt)[name]
    jopt = paddle.optimizer.SGD(learning_rate=js)
    t_opt = topt.SGD(learning_rate=ts)
    for i in range(30):
        assert abs(t_opt.get_lr() - jopt.get_lr()) <= 1e-12, i
        if name.startswith("plateau"):
            js.step(METRICS[i])
            ts.step(METRICS[i])
        else:
            js.step()
            ts.step()
    if name.startswith("plateau"):
        assert ts() < 0.1
        if torch.cuda.is_available():
            with pytest.raises(TypeError):
                ts.step(torch.tensor(1.0, device="cuda"))
    state = ts.state_dict()
    fresh = _schedules(topt)[name]
    fresh.set_state_dict(state)
    assert fresh() == ts()
