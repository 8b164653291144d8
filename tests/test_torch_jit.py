"""The port's ``jit`` (``to_static``, ``save``, ``load``) and
``inference.load_predictor`` against the JAX package's, on the CPU, at
small size.

- ``to_static`` forward and every gradient of a 2-layer (encoder and
  decoder), d_model 64 ``nn.Transformer`` with the causal target mask
  and of an MLP, against JAX's ``to_static`` on the same weights: f32
  forward within 1e-5 of the output's scale, gradients within 1e-4 of
  each one's scale (FWD_TOL, GRAD_TOL);
- one capture per key, a new one when ``auto_cast`` or the mode or a
  shape changes; the captured graph calls ``paddle_tpu::flash_fwd`` and
  no library attention;
- dropout (the ``Dropout`` layer and the attention's Philox pair) draws
  fresh bits on every call of the captured program;
- batch-norm buffers written back after a training call, equal to JAX's
  within 1e-5;
- ``save`` -> ``load`` / ``load_predictor`` equal to the live layer
  within 1e-6 of scale at batch 1 and 3 from a ``None`` spec, and the
  ``.pdiparams`` layout is the JAX file's: JAX's own ``.pdiparams`` read
  into the port's layer gives JAX's outputs within 1e-5;
- ``enable_to_static(False)`` runs the eager layer; a capture that
  fails raises; a CUDA tensor in a shape the kernels refuse raises under
  fake tensors; an entry point on a machine without a card raises.

The Transformer captures sit in module-scope fixtures (each side
compiles once) and the JAX side runs its ``to_static``.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu.static import InputSpec as JSpec

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.static import InputSpec

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# a gradient that is zero up to rounding (the key projection's bias) is
# held to GRAD_TOL * GRAD_FLOOR of the call's largest gradient
GRAD_FLOOR = 1e-2
D, HEADS, B, S = 64, 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tp.set_device("cpu")
    tp.seed(7)
    yield
    tp.jit.enable_to_static(True)


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t.data if isinstance(t, jp.Tensor) else t, np.float32)


def _err(got, want, floor=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 floor, 1e-30)


def _sync(jlayer, tlayer):
    tlayer.set_state_dict({k: _np(v) for k, v in
                           jlayer.state_dict().items()})


class _JTrans(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.tr = jnn.Transformer(d_model=D, nhead=HEADS,
                                  num_encoder_layers=2, num_decoder_layers=2,
                                  dim_feedforward=2 * D, dropout=0.0)

    def forward(self, src, tgt):
        mask = self.tr.generate_square_subsequent_mask(tgt.shape[1])
        return self.tr(src, tgt, tgt_mask=mask)


class _TTrans(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.tr = tnn.Transformer(d_model=D, nhead=HEADS,
                                  num_encoder_layers=2, num_decoder_layers=2,
                                  dim_feedforward=2 * D, dropout=0.0)

    def forward(self, src, tgt):
        mask = self.tr.generate_square_subsequent_mask(tgt.shape[1])
        return self.tr(src, tgt, tgt_mask=mask)


def _grads_pair(jlayer, tlayer, jfn, tfn, inputs, cot):
    """Forward and gradients of ``sum(out * cot)`` on both sides."""
    jout = jfn(*[jp.to_tensor(a) for a in inputs])
    (jout * jp.to_tensor(cot)).sum().backward()
    tout = tfn(*[torch.from_numpy(a) for a in inputs])
    (tout * torch.from_numpy(cot)).sum().backward()
    jg = {k: p.grad for k, p in jlayer.named_parameters()}
    tg = {k: p.grad for k, p in tlayer.named_parameters()}
    return jout, tout, jg, tg


@pytest.fixture(scope="module")
def transformer_pair():
    jp.seed(11)
    j = _JTrans()
    t = _TTrans()
    _sync(j, t)
    rng = np.random.RandomState(0)
    src, tgt, cot = (rng.randn(B, S, D).astype(np.float32)
                     for _ in range(3))
    jst, tst = jp.jit.to_static(j), tp.jit.to_static(t)
    res = _grads_pair(j, t, jst, tst, (src, tgt), cot)
    return j, t, tst, res, (src, tgt)


def test_to_static_transformer_matches_jax(transformer_pair):
    _, _, tst, (jout, tout, jg, tg), _ = transformer_pair
    assert _err(tout, jout) <= FWD_TOL
    assert set(jg) == set(tg)
    top = max(float(np.abs(_np(g)).max()) for g in jg.values())
    worst = max(_err(tg[k], jg[k], GRAD_FLOOR * top) for k in jg)
    assert worst <= GRAD_TOL
    assert tst.captures == 1


def test_captured_graph_calls_the_flash_op(transformer_pair):
    _, _, tst, _, _ = transformer_pair
    targets = {str(n.target) for n in next(iter(tst._cache.values()))
               .graph.nodes if n.op == "call_function"}
    assert any("paddle_tpu.flash_fwd" in t for t in targets)
    assert not any("scaled_dot_product" in t for t in targets)


def test_to_static_mlp_matches_jax():
    jp.seed(12)
    j = jnn.Sequential(jnn.Linear(6, 16), jnn.GELU(), jnn.Linear(16, 3))
    t = tnn.Sequential(tnn.Linear(6, 16), tnn.GELU(), tnn.Linear(16, 3))
    _sync(j, t)
    rng = np.random.RandomState(1)
    x, cot = rng.randn(5, 6).astype(np.float32), \
        rng.randn(5, 3).astype(np.float32)
    jout, tout, jg, tg = _grads_pair(j, t, jp.jit.to_static(j),
                                     tp.jit.to_static(t), (x,), cot)
    assert _err(tout, jout) <= FWD_TOL
    for k in jg:
        assert _err(tg[k], jg[k]) <= GRAD_TOL


def test_one_capture_per_key():
    from paddle_tpu_torch.amp import auto_cast
    net = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    st = tp.jit.to_static(net)
    x = torch.randn(3, 4)
    st(x)
    st(torch.randn(3, 4))
    assert st.captures == 1
    with auto_cast(dtype="bfloat16"):
        y = st(x)
    assert st.captures == 2 and y.dtype == torch.bfloat16
    net.eval()
    st(x)
    assert st.captures == 3
    st(torch.randn(5, 4))
    assert st.captures == 4
    net.train()
    st(x)
    assert st.captures == 4


def test_dropout_is_fresh_on_every_call():
    net = tnn.Sequential(tnn.Linear(8, 8), tnn.Dropout(0.5))
    st = tp.jit.to_static(net)
    x = torch.randn(4, 8)
    assert not torch.equal(st(x), st(x))
    # the attention's dropout form: its Philox pair is an op of the graph
    mha = tnn.MultiHeadAttention(64, 1, dropout=0.5)
    sm = tp.jit.to_static(mha)
    q = torch.randn(2, 8, 64)
    a, b = sm(q, q, q), sm(q, q, q)
    assert not torch.equal(a, b) and sm.captures == 1


def test_batch_norm_buffers_written_back_as_jax():
    jp.seed(13)
    j = jnn.Sequential(jnn.Linear(3, 4), jnn.BatchNorm1D(4))
    t = tnn.Sequential(tnn.Linear(3, 4), tnn.BatchNorm1D(4))
    _sync(j, t)
    jst, tst = jp.jit.to_static(j), tp.jit.to_static(t)
    rng = np.random.RandomState(2)
    for _ in range(2):
        x = rng.randn(6, 3).astype(np.float32)
        jst(jp.to_tensor(x))
        tst(torch.from_numpy(x))
    jb, tb = dict(j.named_buffers()), dict(t.named_buffers())
    for k in jb:
        assert _err(tb[k], jb[k]) <= FWD_TOL
    assert float(tb["1._mean"].abs().sum()) > 0


@pytest.fixture(scope="module")
def saved(tmp_path_factory, transformer_pair):
    _, t, _, _, _ = transformer_pair
    t.eval()
    path = str(tmp_path_factory.mktemp("jit") / "tr")
    tp.jit.save(t, path, input_spec=[InputSpec([None, S, D], "float32")] * 2)
    return t, path


@pytest.fixture(scope="module")
def loaded(saved):
    _, path = saved
    return (tp.jit.load(path, device="cpu"),
            tp.inference.load_predictor(path, device="cpu"))


@pytest.mark.parametrize("batch", [1, 3])
def test_save_load_equals_live_layer(saved, loaded, batch):
    t, _ = saved
    loaded, pred = loaded
    rng = np.random.RandomState(batch)
    src, tgt = (torch.from_numpy(rng.randn(batch, S, D).astype(np.float32))
                for _ in range(2))
    with torch.no_grad():
        want = t(src, tgt)
    assert _err(loaded(src, tgt), want) <= 1e-6
    assert _err(pred(src.numpy(), tgt.numpy()), want) <= 1e-6


def test_pdiparams_has_the_jax_layout(saved, tmp_path):
    t, path = saved
    with open(path + ".pdiparams", "rb") as f:
        ours = pickle.load(f)
    assert set(ours) == {"params", "buffers"}
    assert set(ours["params"]) == {k for k, _ in t.named_parameters()}
    # the JAX package's own file, read into the port's twin layer
    jp.seed(14)
    j = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    jpath = str(tmp_path / "jax" / "mlp")
    jp.jit.save(j, jpath, input_spec=[JSpec([2, 4], "float32")])
    with open(jpath + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    twin = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    twin.set_state_dict({**state["params"], **state["buffers"]})
    x = np.random.RandomState(5).randn(2, 4).astype(np.float32)
    assert _err(twin(torch.from_numpy(x)), j(jp.to_tensor(x))) <= FWD_TOL


def test_enable_to_static_false_runs_eager():
    net = tnn.Linear(3, 2)
    st = tp.jit.to_static(net)
    tp.jit.enable_to_static(False)
    try:
        x = torch.randn(2, 3)
        assert torch.equal(st(x), net(x))
        assert st.captures == 0
    finally:
        tp.jit.enable_to_static(True)


def test_capture_failure_raises():
    class HostBranch(tnn.Layer):
        def forward(self, x):
            if float(x.sum()) > 0:      # a value read on the host
                return x + 1
            return x - 1

    st = tp.jit.to_static(HostBranch())
    with pytest.raises(RuntimeError, match="enable_to_static"):
        st(torch.randn(3))
    assert st.captures == 0


def test_cuda_tensor_in_an_unsupported_shape_raises():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(1, 16, 2, 32, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="D in"):
            torch.ops.paddle_tpu.flash_fwd(q, q, q, None, False, 0.0, None)
        q64 = torch.empty(1, 16, 2, 64, device="cuda", dtype=torch.float32)
        with pytest.raises(TypeError, match="bf16/fp16"):
            torch.ops.paddle_tpu.flash_fwd(q64, q64, q64, None, False, 0.0,
                                           None)
        o, lse = torch.ops.paddle_tpu.flash_fwd(
            q64.to(torch.bfloat16), q64.to(torch.bfloat16),
            q64.to(torch.bfloat16), None, True, 0.0, None)
        assert tuple(lse.shape) == (1, 2, 16) and lse.dtype == torch.float32


def test_entry_points_without_a_card_raise(saved, monkeypatch):
    _, path = saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.jit.load(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.inference.load_predictor(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.static.Executor()
    from paddle_tpu_torch.inference import capi_bridge
    monkeypatch.delenv("PD_INFERENCE_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capi_bridge.create(path)
    assert os.path.exists(path + ".pdmodel")
