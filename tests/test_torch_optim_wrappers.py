"""The port's parameter EMA, LookAhead and ModelAverage against the JAX
package's, on the CPU, and the new optimizers' state names and
checkpoints.

The same numpy parameters go through both packages.  Tolerances: the
EMA's shadows and averages rtol 1e-6, atol 1e-7 (f32, the same formula;
the functional form with a device step takes the ``thres_steps``
schedule in f32 where the eager form takes it in double, one f32
rounding apart); LookAhead and ModelAverage rtol 1e-5, atol 1e-6 as
``test_torch_optim.py``; ModelAverage's int32 counters exactly.  A
trainer against the port's own eager loop, and a restored trainer
against the one it was saved from: rtol 1e-6, atol 1e-7.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import importlib
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.regularizer as jreg
from paddle_tpu.incubate import LookAhead as JaxLookAhead
from paddle_tpu.incubate import ModelAverage as JaxModelAverage
from paddle_tpu.optimizer import ExponentialMovingAverage as JaxEMA

import paddle_tpu_torch.regularizer as treg
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.incubate import LookAhead, ModelAverage
from paddle_tpu_torch.optimizer import ExponentialMovingAverage

jma = importlib.import_module("paddle_tpu.incubate.optimizer.modelaverage")
tma = importlib.import_module("paddle_tpu_torch.incubate.optimizer.modelaverage")

SHAPES = {"w": (6, 4), "b": (4,)}
EXACT = dict(rtol=1e-6, atol=1e-7)
F32 = dict(rtol=1e-5, atol=1e-6)


def arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def both(a):
    return ({n: jnp.asarray(x) for n, x in a.items()},
            {n: torch.from_numpy(x.copy()) for n, x in a.items()})


# ---- EMA ---------------------------------------------------------------

@pytest.mark.parametrize("thres", [False, True])
def test_ema_functional_matches_jax_and_eager(thres):
    jema, tema = JaxEMA(0.9, thres_steps=thres), \
        ExponentialMovingAverage(0.9, thres_steps=thres)
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    eager = ExponentialMovingAverage(0.9, thres_steps=thres,
                                     parameters=params)
    jp, tp = both(arrays(0))
    jstate, tstate = jema.init_state(jp), tema.init_state(tp)
    for step in range(1, 6):
        jp, tp = both(arrays(step))
        jstate = jema.update_state(jp, jstate)
        tstate = tema.update_state(tp, tstate)
        with torch.no_grad():
            for q, x in zip(params, tp.values()):
                q.copy_(x)
        eager.update()
    assert int(tstate["t"]) == 5 and tstate["t"].dtype == torch.int32
    np.testing.assert_allclose(float(tstate["decay_prod"]),
                               float(jstate["decay_prod"]), **EXACT)
    javg, tavg = jema.averaged(jp, jstate), tema.averaged(tp, tstate)
    for i, n in enumerate(SHAPES):
        np.testing.assert_allclose(tstate["shadow"][n].numpy(),
                                   np.asarray(jstate["shadow"][n]), **EXACT)
        np.testing.assert_allclose(tavg[n].numpy(), np.asarray(javg[n]),
                                   **EXACT)
        np.testing.assert_allclose(eager._shadow[str(i)].numpy(),
                                   tstate["shadow"][n].numpy(), **EXACT)
    # bias correction: the average of a constant is the constant
    const = {"w": torch.full((6, 4), 3.0), "b": torch.full((4,), -2.0)}
    st = tema.init_state(const)
    for _ in range(3):
        tema.update_state(const, st)
    for n, a in tema.averaged(const, st).items():
        torch.testing.assert_close(a, const[n])


def test_ema_eager_apply_restore_and_state_keys():
    params = [torch.nn.Parameter(torch.ones(3)),
              torch.nn.Parameter(torch.zeros(2))]
    ema = ExponentialMovingAverage(0.5, parameters=params)
    ema.update()
    with torch.no_grad():
        params[0].fill_(3.0)
    ema.update()
    # shadows 0.5 * (0.5 * 1) + 0.5 * 3 = 1.75 over 1 - 0.25: 2.333...
    with ema.apply():
        torch.testing.assert_close(params[0].detach(),
                                   torch.full((3,), 1.75 / 0.75))
        with pytest.raises(RuntimeError):
            with ema.apply():
                pass
    torch.testing.assert_close(params[0].detach(), torch.full((3,), 3.0))
    jparams = [paddle.create_parameter([3], "float32"),
               paddle.create_parameter([2], "float32")]
    jema = JaxEMA(0.5, parameters=jparams)
    jema.update()
    jema.update()
    suffixes = sorted(k.split("@", 1)[1] for k in jema.state_dict())
    assert sorted(k.split("@", 1)[1] for k in ema.state_dict()) == suffixes
    other = ExponentialMovingAverage(0.5, parameters=params)
    other.set_state_dict(ema.state_dict())
    assert other._t == 2 and set(other._shadow) == {"0", "1"}


# ---- LookAhead -----------------------------------------------------------

@pytest.mark.parametrize("device_step", [False, True])
@pytest.mark.parametrize("inner", ["sgd", "adam-l2"])
def test_lookahead_matches_jax(inner, device_step):
    def make(m, reg):
        if inner == "sgd":
            opt = m.SGD(learning_rate=0.1)
        else:
            opt = m.Adam(learning_rate=1e-2, weight_decay=reg.L2Decay(0.01))
        return opt
    jla = JaxLookAhead(make(paddle.optimizer, jreg), alpha=0.4, k=3)
    tla = LookAhead(make(topt, treg), alpha=0.4, k=3)
    jp, tp = both(arrays(0))
    jstate = jla.init_state(jp)
    for step in range(1, 8):
        jg, tg = both(arrays(10 + step, 0.5))
        jp, jstate = jla.apply_gradients(jp, jg, jstate, step=step)
        tla.apply_gradients(tp, tg, step=torch.tensor(step, dtype=torch.int32)
                            if device_step else step)
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), **F32)
        assert sorted(tla._accumulators[n]) == sorted(jstate[n])
        np.testing.assert_allclose(tla._accumulators[n]["slow"].numpy(),
                                   np.asarray(jstate[n]["slow"]), **F32)
    # the slow copy is a copy, not the parameter
    assert tla._accumulators["w"]["slow"].data_ptr() != tp["w"].data_ptr()


class Lin(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.weight = torch.nn.Parameter(torch.randn(4, 2, generator=g))
        self.bias = torch.nn.Parameter(torch.zeros(2))

    def forward(self, x):
        return x @ self.weight + self.bias


def mse(out, y):
    return torch.nn.functional.mse_loss(out, y)


def data(seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
            torch.from_numpy(rng.randn(8, 2).astype(np.float32)))


@pytest.mark.parametrize("policy", [None, "skip"])
def test_lookahead_inside_trainer_matches_eager(policy):
    """LookAhead(SGD) in ``SpmdTrainer`` (``skip``: the step count a
    device tensor, so the ``step % k`` choice runs on the device) against
    the eager ``step()`` loop over the same batches."""
    k, alpha, lr, steps = 3, 0.4, 0.1, 7
    x, y = data()
    model = Lin()
    tr = SpmdTrainer(model, LookAhead(topt.SGD(learning_rate=lr),
                                      alpha=alpha, k=k), mse,
                     anomaly_policy=policy)
    for _ in range(steps):
        tr.train_step(x, y)
    ref = Lin()
    opt = LookAhead(topt.SGD(learning_rate=lr, parameters=ref.parameters()),
                    alpha=alpha, k=k)
    for _ in range(steps):
        mse(ref(x), y).backward()
        opt.step()
        opt.clear_grad()
    for (n, p), q in zip(tr.params.items(), ref.parameters()):
        np.testing.assert_allclose(p.numpy(), q.detach().numpy(), **EXACT,
                                   err_msg=n)


# ---- ModelAverage ----------------------------------------------------------

@pytest.mark.parametrize("fold", [16384, 3])
def test_model_average_matches_jax(monkeypatch, fold):
    """The window rule over 11 steps (min window 2, max 4, rate 0.5) and,
    with the fold interval cut to 3 in both packages, the fold."""
    monkeypatch.setattr(jma, "_FOLD_EVERY", fold)
    monkeypatch.setattr(tma, "_FOLD_EVERY", fold)
    jm = JaxModelAverage(0.5, min_average_window=2, max_average_window=4)
    tm = ModelAverage(0.5, min_average_window=2, max_average_window=4)
    jp, tp = both(arrays(0))
    jstate = jm.init_state(jp)
    for step in range(1, 12):
        jp, tp = both(arrays(step))
        jp, jstate = jm.apply_gradients(jp, jp, jstate, step=step)
        tm.apply_gradients(tp, tp, step=step)
    for n in SHAPES:
        accs = tm._accumulators[n]
        assert sorted(accs) == sorted(jstate[n])
        for a, t in accs.items():
            if t.dtype == torch.int32:
                assert int(t) == int(jstate[n][a]), (n, a)
            else:
                np.testing.assert_allclose(t.numpy(),
                                           np.asarray(jstate[n][a]), **F32)
        np.testing.assert_array_equal(tp[n].numpy(), arrays(11)[n])


def test_model_average_eager_apply_restore():
    params = [torch.nn.Parameter(torch.zeros(3))]
    ma = ModelAverage(1.0, parameters=params, min_average_window=100,
                      max_average_window=100)
    for v in (1.0, 2.0, 6.0):
        with torch.no_grad():
            params[0].fill_(v)
        ma.step()
    assert ma._accumulators["0"]["num_updates"].dtype == torch.int32
    with ma.apply():
        torch.testing.assert_close(params[0].detach(), torch.full((3,), 3.0))
    torch.testing.assert_close(params[0].detach(), torch.full((3,), 6.0))
    with ma.apply(need_restore=False):
        pass
    torch.testing.assert_close(params[0].detach(), torch.full((3,), 3.0))
    ma.restore()
    torch.testing.assert_close(params[0].detach(), torch.full((3,), 6.0))
    assert set(ma.state_dict()) == {f"0@{a}" for a in ma._accum_names} | \
        {"@step_count"}


# ---- state names and checkpoints ---------------------------------------

def new_optimizers(m, reg, inc):
    """Every optimizer this slice adds, built the same way in both
    packages (``m`` the optimizer module, ``inc`` the incubate one)."""
    return {
        "adagrad": lambda: m.Adagrad(0.1, weight_decay=reg.L1Decay(0.01)),
        "rmsprop": lambda: m.RMSProp(0.01, centered=True,
                                     weight_decay=reg.L2Decay(0.01)),
        "adadelta": lambda: m.Adadelta(1.0),
        "adamax": lambda: m.Adamax(0.01),
        "lamb": lambda: m.Lamb(0.01),
        "lars": lambda: m.Lars(0.1),
        "lookahead-adam": lambda: inc.LookAhead(
            m.Adam(learning_rate=m.lr.StepDecay(0.01, 2)), k=2),
        "modelaverage": lambda: inc.ModelAverage(0.5, min_average_window=1,
                                                 max_average_window=3),
    }


NAMES = sorted(new_optimizers(topt, treg, importlib.import_module(
    "paddle_tpu_torch.incubate")))


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_keys_equal_jax(name):
    jopt = new_optimizers(paddle.optimizer, jreg,
                          importlib.import_module("paddle_tpu.incubate"))[name]()
    t_opt = new_optimizers(topt, treg, importlib.import_module(
        "paddle_tpu_torch.incubate"))[name]()
    jp, tp = both(arrays(0))
    jopt._accumulators = jopt.init_state(jp)
    t_opt.init_state(tp)
    jopt._step_count = t_opt._step_count = 2
    assert sorted(t_opt.state_dict()) == sorted(jopt.state_dict())


@pytest.mark.parametrize("name", NAMES)
def test_trainer_checkpoint_round_trip(name, tmp_path):
    """Two steps, ``save``, a fresh trainer ``load``s it, and one more
    step on each: equal parameters.  The checkpoint's accumulator names
    are the JAX optimizer's."""
    build = new_optimizers(topt, treg, importlib.import_module(
        "paddle_tpu_torch.incubate"))[name]
    x, y = data(1)
    tr = SpmdTrainer(Lin(), build(), mse)
    for _ in range(2):
        tr.train_step(x, y)
    path = tr.save(os.path.join(tmp_path, "ckpt"))
    other = SpmdTrainer(Lin(seed=5), build(), mse)
    other.load(path)
    for t in (tr, other):
        t.train_step(x, y)
    for (n, p), (_, q) in zip(tr.params.items(), other.params.items()):
        np.testing.assert_allclose(q.numpy(), p.numpy(), **EXACT, err_msg=n)
    jopt = new_optimizers(paddle.optimizer, jreg, importlib.import_module(
        "paddle_tpu.incubate"))[name]()
    want = sorted(jopt.init_state({"w": jnp.zeros(2)})["w"])
    from paddle_tpu_torch.distributed.checkpoint import snapshot_trainer
    got = snapshot_trainer(other)["opt_state"]
    assert all(sorted(accs) == want for accs in got.values())
