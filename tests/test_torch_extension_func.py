"""The port's ``func``, ``extension`` and ``onnx`` against the JAX
package's, on the CPU, on the same seeded inputs and weights.

- ``functional_call`` of an MLP with a batch norm in training: outputs
  and new buffers equal JAX's within 1e-5 of their scale, and the
  caller's buffers untouched; ``functional_apply`` of a named method;
- ``register_op`` with a backward (a deliberately scaled gradient, so
  the custom rule shows) and without one: forward and gradients within
  1e-5; ``get_op`` / ``list_ops``;
- ``py_func`` eagerly (forward, and the gradient through
  ``backward_func``), in static mode (one node, run by the Executor) and
  inside ``jit.to_static``, against JAX's eager / static results;
- ``onnx.export`` raises ``ImportError`` without the ``onnx`` package,
  as JAX's does.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu import extension as jext
from paddle_tpu import func as jfunc

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import extension as text
from paddle_tpu_torch import func as tfunc
from paddle_tpu_torch import static as tstatic

TOL = 1e-5
_names = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tp.set_device("cpu")
    yield


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t.data if isinstance(t, jp.Tensor) else t, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _mlps():
    jp.seed(3)
    j = jnn.Sequential(jnn.Linear(4, 8), jnn.BatchNorm1D(8), jnn.ReLU(),
                       jnn.Linear(8, 3))
    t = tnn.Sequential(tnn.Linear(4, 8), tnn.BatchNorm1D(8), tnn.ReLU(),
                       tnn.Linear(8, 3))
    t.set_state_dict({k: _np(v) for k, v in j.state_dict().items()})
    return j, t


def test_functional_call_matches_jax_and_leaves_buffers():
    j, t = _mlps()
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    jparams, jbufs = jfunc.functional_state(j)
    jout, jnew = jfunc.functional_call(j, jparams, jbufs, x, training=True)
    tparams, tbufs = tfunc.functional_state(t)
    before = {k: v.clone() for k, v in tbufs.items()}
    tout, tnew = tfunc.functional_call(t, tparams, tbufs,
                                       torch.from_numpy(x), training=True)
    _close(tout, jout)
    assert set(tnew) == set(jnew)
    for k in jnew:
        _close(tnew[k], jnew[k])
    for k, v in before.items():
        assert torch.equal(tbufs[k], v)
    assert t.training  # the mode comes back
    out = tfunc.functional_forward(t, tparams, torch.from_numpy(x),
                                   training=False)
    _close(out, jfunc.functional_forward(j, jparams, x, training=False))
    # a named method with other weights bound
    zeros = {k: torch.zeros_like(v) for k, v in tparams.items()}
    y = tfunc.functional_apply(t[0], "forward",
                               {k[2:]: v for k, v in zeros.items()
                                if k.startswith("0.")}, torch.ones(2, 4))
    assert torch.equal(y, torch.zeros(2, 8))


def _scaled_backward(inputs, outputs, cots):
    x, w = inputs
    return 3.0 * cots * w, None


def test_register_op_with_backward_matches_jax():
    name = f"scaled_mul_{next(_names)}"
    jop = jext.register_op(name, lambda x, w: x * w,
                           backward=_scaled_backward)
    top = text.register_op(name, lambda x, w: x * w,
                           backward=_scaled_backward)
    assert text.get_op(name) is top and name in text.list_ops()
    with pytest.raises(ValueError, match="already registered"):
        text.register_op(name, lambda x: x)
    rng = np.random.RandomState(1)
    x, w, cot = (rng.randn(3, 4).astype(np.float32) for _ in range(3))
    jx = jp.to_tensor(x, stop_gradient=False)
    jy = jop(jx, jp.to_tensor(w))
    (jy * jp.to_tensor(cot)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = top(tx, torch.from_numpy(w))
    (ty * torch.from_numpy(cot)).sum().backward()
    _close(ty, jy)
    _close(tx.grad, jx.grad)
    np.testing.assert_allclose(_np(tx.grad), 3.0 * cot * w, rtol=1e-6)


def test_register_op_without_backward_differentiates_its_forward():
    name = f"softsign_{next(_names)}"
    jop = jext.register_op(name)(lambda x: x / (1 + abs(x)))
    top = text.register_op(name)(lambda x: x / (1 + x.abs()))
    x = np.random.RandomState(2).randn(6).astype(np.float32)
    jx = jp.to_tensor(x, stop_gradient=False)
    jop(jx).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    top(tx).sum().backward()
    _close(tx.grad, jx.grad)
    with pytest.raises(KeyError, match="no custom op"):
        text.get_op("no_such_op")


def _host_tanh(a):
    return np.tanh(a)


def _host_tanh_grad(inputs, outputs, grads):
    return grads[0] * (1.0 - outputs[0] ** 2)


def test_py_func_eager_matches_jax():
    x = np.random.RandomState(3).randn(2, 5).astype(np.float32)
    jx = jp.to_tensor(x, stop_gradient=False)
    jy = jext.py_func(_host_tanh, jx, ((2, 5), "float32"),
                      backward_func=_host_tanh_grad)
    jy.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = text.py_func(_host_tanh, tx, ((2, 5), "float32"),
                      backward_func=_host_tanh_grad)
    ty.sum().backward()
    _close(ty, jy)
    _close(tx.grad, jx.grad)
    # two outputs, declared by a template tensor
    outs = text.py_func(lambda a: (a + 1, a * 2), torch.from_numpy(x),
                        [torch.empty(2, 5), torch.empty(2, 5)])
    _close(outs[1], 2 * x)


def test_py_func_static_and_to_static_match_jax():
    from paddle_tpu import static as jstatic
    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    jp.enable_static()
    try:
        jprog = jstatic.Program()
        with jstatic.program_guard(jprog):
            jv = jstatic.data("x", [3, 4])
            jy = jext.py_func(_host_tanh, jv, ((3, 4), "float32")) * 2.0
        (want,) = jstatic.Executor().run(jprog, feed={"x": x},
                                         fetch_list=[jy])
    finally:
        jp.disable_static()
    tstatic.enable_static()
    try:
        tprog = tstatic.Program()
        with tstatic.program_guard(tprog):
            tv = tstatic.data("x", [3, 4])
            ty = text.py_func(_host_tanh, tv, ((3, 4), "float32")) * 2.0
        (got,) = tstatic.Executor(tstatic.CPUPlace()).run(
            tprog, feed={"x": x}, fetch_list=[ty])
    finally:
        tstatic.disable_static()
    assert len(tprog.ops) == 2
    _close(got, want)

    class Host(tnn.Layer):
        def forward(self, a):
            return text.py_func(_host_tanh, a, ((3, 4), "float32")) + 1.0

    st = tp.jit.to_static(Host())
    _close(st(torch.from_numpy(x)), np.tanh(x) + 1.0)
    assert st.captures == 1


def test_onnx_export_raises_as_jax_does():
    layer = tnn.Linear(2, 2)
    with pytest.raises(ImportError) as tinfo:
        tp.onnx.export(layer, "/nonexistent/x")
    with pytest.raises(ImportError) as jinfo:
        jp.onnx.export(jnn.Linear(2, 2), "/nonexistent/x")
    assert "onnx" in str(tinfo.value) and "onnx" in str(jinfo.value)
    assert "jit.save" in str(tinfo.value)
