"""The port's recurrent layers against the JAX package's on the CPU.

Every class of ``paddle_tpu.nn.layer.rnn`` (the three cells, ``RNN``,
``BiRNN``, ``SimpleRNN`` / ``LSTM`` / ``GRU``) at small widths (H <= 16,
T <= 8, 1-2 layers, both directions, with and without initial states,
batch-major and time-major): the JAX layer is built, its ``state_dict``
loads into the port's twin by name, the same numpy inputs go through
both, and the outputs, final states and the gradients of ``sum(leaf *
cot)`` over every output leaf (inputs, initial states and parameters)
must agree within ``TOL`` (f32 on both sides; 1e-5 of each tensor's max
|value|, or absolute below 1).  The JAX references of the whole table
come from one ``jax.jit``.  Also: the ``state_dict`` names and shapes
equal JAX's, the ``auto_cast`` dtype rule (the multi-layer RNN casts to
bf16 as an op on the white list; the cells do not, except at level O2),
and the dropout between layers (training only, inverted scale).
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import zlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn

TOL = 1e-5
B, T, IN, H = 3, 5, 6, 8


def _x(time_major=False):
    return ("x", (T, B, IN) if time_major else (B, T, IN))


def _s(*shape):
    return ("s", shape)


def lstm_states(layers, dirs):
    return (_s(layers * dirs, B, H), _s(layers * dirs, B, H))


# name: (build(nn), inputs, call(layer, *inputs) or None)
CASES = {
    "lstm-1l": (lambda nn: nn.LSTM(IN, H), [_x()], None),
    "lstm-2l-bidirect-init": (
        lambda nn: nn.LSTM(IN, H, num_layers=2, direction="bidirect"),
        [_x(), *lstm_states(2, 2)],
        lambda l, x, h, c: l(x, (h, c))),
    "lstm-2l-time-major": (
        lambda nn: nn.LSTM(IN, H, num_layers=2, time_major=True),
        [_x(True)], None),
    "gru-2l-bidirect-init": (
        lambda nn: nn.GRU(IN, H, num_layers=2, direction="bidirectional"),
        [_x(), _s(4, B, H)], None),
    "gru-1l-time-major-init": (
        lambda nn: nn.GRU(IN, H, time_major=True),
        [_x(True), _s(1, B, H)], None),
    "simplernn-tanh-2l-bidirect": (
        lambda nn: nn.SimpleRNN(IN, H, num_layers=2, direction="bidirect"),
        [_x()], None),
    "simplernn-relu-1l-init": (
        lambda nn: nn.SimpleRNN(IN, H, activation="relu"),
        [_x(), _s(1, B, H)], None),
    "lstmcell": (lambda nn: nn.LSTMCell(IN, H), [_s(B, IN)], None),
    "lstmcell-states": (lambda nn: nn.LSTMCell(IN, H),
                        [_s(B, IN), _s(B, H), _s(B, H)],
                        lambda l, x, h, c: l(x, (h, c))),
    "grucell-states": (lambda nn: nn.GRUCell(IN, H),
                       [_s(B, IN), _s(B, H)], None),
    "simplernncell": (lambda nn: nn.SimpleRNNCell(IN, H), [_s(B, IN)],
                      None),
    "simplernncell-relu-states": (
        lambda nn: nn.SimpleRNNCell(IN, H, activation="relu"),
        [_s(B, IN), _s(B, H)], None),
    "rnn-lstmcell": (lambda nn: nn.RNN(nn.LSTMCell(IN, H)), [_x()], None),
    "rnn-grucell-reverse-time-major-init": (
        lambda nn: nn.RNN(nn.GRUCell(IN, H), is_reverse=True,
                          time_major=True),
        [_x(True), _s(B, H)], None),
    "birnn-lstmcells-init": (
        lambda nn: nn.BiRNN(nn.LSTMCell(IN, H), nn.LSTMCell(IN, H)),
        [_x(), _s(B, H), _s(B, H), _s(B, H), _s(B, H)],
        lambda l, x, h1, c1, h2, c2: l(x, ((h1, c1), (h2, c2)))),
    "birnn-simplecells": (
        lambda nn: nn.BiRNN(nn.SimpleRNNCell(IN, H),
                            nn.SimpleRNNCell(IN, H)), [_x()], None),
}


def _arrays(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    _, specs, _ = CASES[name]
    arrays = [(rng.randn(*shape) * (1.0 if kind == "x" else 0.5))
              .astype(np.float32) for kind, shape in specs]
    return arrays, rng


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _call(case, layer, xs):
    _, _, call = case
    return call(layer, *xs) if call else layer(*xs)


@pytest.fixture(scope="module")
def jax_table():
    """Every case's JAX layer state, forward leaves, cotangents and
    gradients, from one ``jax.jit``."""
    jp.seed(11)
    layers, states, raws, cots = {}, {}, {}, {}

    def _forward(name, layer, st, arrs):
        layer.set_state_dict({n: jp.Tensor(v) for n, v in st.items()})
        xs = [jp.Tensor(a, stop_gradient=False) for a in arrs]
        return xs, _call(CASES[name], layer, xs)

    for name, case in CASES.items():
        layers[name] = case[0](jnn)
        states[name] = {n: np.asarray(v.data)
                        for n, v in layers[name].state_dict().items()}
        raws[name], rng = _arrays(name)
        shapes = jax.eval_shape(
            lambda st, *a: [leaf.data for leaf in _leaves(
                _forward(name, layers[name], st, a)[1])],
            states[name], *raws[name])
        cots[name] = [rng.randn(*s.shape).astype(np.float32)
                      for s in shapes]

    def all_cases(sts, rs):
        res = {}
        for name in CASES:
            layer = layers[name]
            xs, out = _forward(name, layer, sts[name], rs[name])
            leaves = _leaves(out)
            loss = None
            for leaf, cot in zip(leaves, cots[name]):
                term = (leaf * jp.Tensor(cot)).sum()
                loss = term if loss is None else loss + term
            loss.backward()
            grads = {f"in{i}": x.grad.data for i, x in enumerate(xs)}
            grads.update({n: p.grad.data
                          for n, p in layer.named_parameters()})
            res[name] = ([leaf.data for leaf in leaves], grads)
        return res

    out = jax.jit(all_cases)(states, raws)
    for layer in layers.values():
        layer.clear_gradients()
    return {name: dict(state=states[name], raw=raws[name], cot=cots[name],
                       out=[np.asarray(a) for a in out[name][0]],
                       grads={k: np.asarray(v)
                              for k, v in out[name][1].items()},
                       names=[(n, tuple(v.shape)) for n, v in
                              layers[name].state_dict().items()])
            for name in CASES}


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of {scale:.3e} > {TOL}"


@pytest.mark.parametrize("name", list(CASES))
def test_rnn_matches_jax(name, jax_table):
    """Outputs, final states and gradients against the JAX layer with
    the same weights, f32."""
    ref = jax_table[name]
    tp.set_device("cpu")
    tp.seed(3)
    layer = CASES[name][0](tnn)
    assert [(n, tuple(v.shape)) for n, v in layer.state_dict().items()] \
        == ref["names"]
    layer.set_state_dict(ref["state"])
    xs = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in ref["raw"]]
    leaves = _leaves(_call(CASES[name], layer, xs))
    assert len(leaves) == len(ref["out"])
    loss = sum((leaf * torch.from_numpy(c)).sum()
               for leaf, c in zip(leaves, ref["cot"]))
    loss.backward()
    for i, (leaf, want) in enumerate(zip(leaves, ref["out"])):
        _close(leaf, want, f"{name} output leaf {i}")
    grads = {f"in{i}": x.grad for i, x in enumerate(xs)}
    grads.update({n: p.grad for n, p in layer.named_parameters()})
    assert set(grads) == set(ref["grads"])
    for k, want in ref["grads"].items():
        _close(grads[k], want, f"{name} gradient {k}")


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_dtype_rule(level):
    """The multi-layer RNN runs in bf16 under auto_cast (its mode is on
    the white list, as in JAX); a cell keeps f32 at O1 and casts at O2;
    initial states take the input's dtype."""
    tp.set_device("cpu")
    jp.seed(1)
    tp.seed(1)
    x = np.random.RandomState(0).randn(B, T, IN).astype(np.float32)
    h0 = np.zeros((2, B, H), np.float32)
    for build, args in (
            (lambda nn: nn.LSTM(IN, H, num_layers=2), (x,)),
            (lambda nn: nn.GRU(IN, H, num_layers=2), (x, h0)),
            (lambda nn: nn.LSTMCell(IN, H), (x[:, 0],)),
            (lambda nn: nn.GRUCell(IN, H), (x[:, 0],))):
        jl, tl = build(jnn), build(tnn)
        with jp.amp.auto_cast(level=level, dtype="bfloat16"):
            jout = jl(*[jp.Tensor(a) for a in args])[0]
        with tp.amp.auto_cast(level=level, dtype="bfloat16"):
            tout = tl(*[torch.from_numpy(a) for a in args])[0]
        want = str(jout.data.dtype)
        assert str(tout.dtype).replace("torch.", "") == want, \
            (type(tl).__name__, level, tout.dtype, want)


def test_dropout_between_layers():
    """Dropout > 0 acts in training only, between layers only, inverted:
    a kept value is scaled by 1 / (1 - p).  A 2-layer relu SimpleRNN whose
    second layer is the identity on positive inputs shows the mask."""
    tp.set_device("cpu")
    tp.seed(5)
    p = 0.5
    n = 16
    layer = tnn.SimpleRNN(n, n, num_layers=2, activation="relu",
                          dropout=p)
    with torch.no_grad():
        layer.weight_ih_l1.copy_(torch.eye(n))
        layer.weight_hh_l1.zero_()
        layer.bias_ih_l1.zero_()
        layer.bias_hh_l1.zero_()
        for name in ("weight_ih_l0", "weight_hh_l0"):
            getattr(layer, name).abs_()
        layer.bias_ih_l0.fill_(0.5)
    x = torch.rand(4, 8, n)
    layer.eval()
    ev, _ = layer(x)
    zero = tnn.SimpleRNN(n, n, num_layers=2, activation="relu")
    zero.set_state_dict(layer.state_dict())
    zero.eval()
    assert torch.equal(ev, zero(x)[0])
    layer.train()
    tr, _ = layer(x)
    kept = tr != 0
    assert torch.allclose(tr[kept], ev[kept] / (1 - p), rtol=1e-6)
    share = float(kept.float().mean())
    assert 0.35 < share < 0.65, share
    tr2, _ = layer(x)
    assert not torch.equal(tr, tr2)
    zero.train()
    assert torch.equal(zero(x)[0], ev)


def test_sequence_length_is_ignored():
    """``sequence_length`` is accepted and ignored, as in the JAX
    package."""
    tp.set_device("cpu")
    layer = tnn.GRU(IN, H)
    x = torch.randn(B, T, IN)
    a, _ = layer(x)
    b, _ = layer(x, sequence_length=torch.tensor([1, 2, 3]))
    assert torch.equal(a, b)
