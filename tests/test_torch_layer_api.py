"""The port's layer API against the JAX package's, on the CPU: structured
state-dict names, ``.pdparams`` files exchanged both ways, ``grad`` and
``PyLayer`` against the JAX tape, the README Quick start, the ``Layer``
surface (parameters, hooks, modes, dtype moves, strict loading),
per-parameter learning rates, and the classes that wait for a later
slice.

Tolerances (f32 on both sides): gradients and parameters after a step
within 1e-5 relative (RTOL) and 1e-6 absolute (ATOL).  Worst measured:
0.63 of that (Adam's per-parameter case: Adam's first steps amplify f32
rounding) and 0.43 (the double gradient); SGD, the Quick start and
PyLayer under 0.03.  Saved files must round-trip exactly.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.autograd import PyLayer as JPyLayer

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.autograd import PyLayer as TPyLayer

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU.  The JAX reference runs op by op on its tape
    and compiles each op once per shape: these compiles skip XLA's
    optimization passes and the persistent cache (none is reused)."""
    import jax
    tp.set_device("cpu")
    tp.seed(11)
    keys = ("jax_disable_most_optimizations", "jax_enable_compilation_cache")
    was = {k: jax.config.values[k] for k in keys}
    jax.config.update("jax_disable_most_optimizations", True)
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    for k, v in was.items():
        jax.config.update(k, v)


def _np(t):
    return np.asarray(t.data) if not torch.is_tensor(t) \
        else t.detach().numpy()


def _sync(jlayer, tlayer):
    """The JAX layer's weights into the port's, by structured name."""
    tlayer.set_state_dict({k: _np(v) for k, v in
                           jlayer.state_dict().items()})


class _Block:
    """A custom layer with a sublayer, a parameter of its own and a
    persistable and a non-persistable buffer, built in either package."""

    @staticmethod
    def build(nn, zeros):
        class Block(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 3)
                self.scale = self.create_parameter(
                    [3], default_initializer=nn.initializer.Constant(2.0))
                self.register_buffer("steps", zeros([1]))
                self.register_buffer("tmp", zeros([2]), persistable=False)

            def forward(self, x):
                return self.fc(x) * self.scale
        return Block()


BUILDS = {
    "transformer": lambda nn, z: nn.Transformer(16, 2, 1, 1, 32,
                                                dropout=0.0),
    "containers": lambda nn, z: nn.Sequential(
        nn.Linear(4, 4), nn.LayerList([nn.LayerNorm(4), nn.ReLU()]),
        nn.LayerDict({"out": nn.Linear(4, 2)}),
        nn.ParameterList([nn.Linear(2, 2).weight])),
    "mha": lambda nn, z: nn.MultiHeadAttention(8, 2, kdim=6, vdim=5),
    "hsigmoid": lambda nn, z: nn.HSigmoidLoss(4, 6),
    "custom": lambda nn, z: _Block.build(nn, z),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_state_dict_names_match_jax(name):
    j = BUILDS[name](jnn, lambda s: jp.to_tensor(np.zeros(s, np.float32)))
    t = BUILDS[name](tnn, lambda s: torch.zeros(s))
    assert list(t.state_dict()) == list(j.state_dict())
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    for (k, jv), tv in zip(j.state_dict().items(), t.state_dict().values()):
        assert tuple(tv.shape) == tuple(_np(jv).shape), k


def _payload(rng):
    return {"w": rng.randn(3, 4).astype(np.float32),
            "ids": np.arange(5, dtype=np.int32),
            "nested": [rng.randn(2).astype(np.float32),
                       {"b": rng.randn(2, 2).astype(np.float32)}],
            "meta": {"epoch": 3, "tag": "x"}}


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_pdparams_exchange_both_ways(direction, tmp_path):
    rng = np.random.RandomState(0)
    data = _payload(rng)
    path = str(tmp_path / "m.pdparams")
    jlayer = jnn.Linear(4, 3)
    if direction == "jax-to-port":
        jp.save({"model": jlayer.state_dict(), "w": jp.to_tensor(data["w"]),
                 "ids": jp.to_tensor(data["ids"]),
                 "nested": [jp.to_tensor(data["nested"][0]),
                            {"b": jp.to_tensor(data["nested"][1]["b"])}],
                 "meta": data["meta"]}, path)
        got = tp.load(path)
        tlayer = tnn.Linear(4, 3)
        tlayer.set_state_dict(got["model"])
        for k, v in jlayer.state_dict().items():
            assert np.array_equal(_np(tlayer.state_dict()[k]), _np(v))
        assert isinstance(got["model"]["weight"], tp.Parameter)
        assert np.array_equal(got["w"].numpy(), data["w"])
        assert np.array_equal(got["ids"].numpy(), data["ids"])
        assert np.array_equal(got["nested"][1]["b"].numpy(),
                              data["nested"][1]["b"])
        assert got["meta"] == data["meta"]
        arrays = tp.load(path, return_numpy=True)
        assert np.array_equal(arrays["w"], data["w"])
    else:
        tlayer = tnn.Linear(4, 3)
        tp.save({"model": tlayer.state_dict(),
                 "w": torch.from_numpy(data["w"]),
                 "ids": torch.from_numpy(data["ids"]),
                 "nested": [torch.from_numpy(data["nested"][0]),
                            {"b": torch.from_numpy(data["nested"][1]["b"])}],
                 "meta": data["meta"]}, path)
        got = jp.load(path)
        jlayer.set_state_dict(got["model"])
        for k, v in tlayer.state_dict().items():
            assert np.array_equal(_np(jlayer.state_dict()[k]), _np(v))
        assert type(got["model"]["weight"]).__name__ == "Parameter"
        assert np.array_equal(_np(got["w"]), data["w"])
        assert np.array_equal(_np(got["nested"][0]), data["nested"][0])
        assert got["meta"] == data["meta"]


def _grad_inputs(rng):
    return (rng.randn(3, 4).astype(np.float32),
            rng.randn(4, 2).astype(np.float32))


def _jgrad(kind, x_np, w_np):
    x = jp.to_tensor(x_np, stop_gradient=False)
    w = jp.to_tensor(w_np, stop_gradient=False)
    u = jp.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    y = (JF.tanh(x.matmul(w)) ** 2).sum()
    if kind == "plain":
        return [_np(g) for g in jp.grad(y, [x, w])]
    if kind == "unused":
        gs = jp.grad(y, [x, u], allow_unused=True)
        return [_np(gs[0]), gs[1]]
    if kind == "double":
        (gx,) = jp.grad(y, [x], create_graph=True)
        (ggw,) = jp.grad((gx * gx).sum(), [w])
        return [_np(gx), _np(ggw)]
    if kind == "grad_outputs":
        z = JF.sigmoid(x.matmul(w))
        cot = jp.to_tensor(np.linspace(-1, 1, 6, dtype=np.float32)
                           .reshape(3, 2))
        return [_np(g) for g in jp.grad(z, [x, w], grad_outputs=[cot])]


def _tgrad(kind, x_np, w_np):
    x = tp.to_tensor(x_np, stop_gradient=False)
    w = tp.to_tensor(w_np, stop_gradient=False)
    u = tp.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    y = (TF.tanh(x @ w) ** 2).sum()
    if kind == "plain":
        return [_np(g) for g in tp.grad(y, [x, w])]
    if kind == "unused":
        gs = tp.grad(y, [x, u], allow_unused=True)
        return [_np(gs[0]), gs[1]]
    if kind == "double":
        (gx,) = tp.grad(y, [x], create_graph=True)
        (ggw,) = tp.grad((gx * gx).sum(), [w])
        return [_np(gx), _np(ggw)]
    if kind == "grad_outputs":
        z = TF.sigmoid(x @ w)
        cot = torch.linspace(-1, 1, 6).reshape(3, 2)
        return [_np(g) for g in tp.grad(z, [x, w], grad_outputs=[cot])]


@pytest.mark.parametrize("kind", ["plain", "unused", "double",
                                  "grad_outputs"])
def test_grad_matches_jax_tape(kind):
    x_np, w_np = _grad_inputs(np.random.RandomState(1))
    want = _jgrad(kind, x_np, w_np)
    got = _tgrad(kind, x_np, w_np)
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
    assert not torch.is_tensor(got[0]) or not got[0].requires_grad


def test_grad_semantics():
    x = tp.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    u = tp.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    y = (x * 3).sum()
    with pytest.raises(ValueError):
        tp.grad(y, [x, u])
    # no gradient flows through a no_grad_vars tensor
    h = x * 2
    z = (h * x).sum()
    (g,) = tp.grad(z, [x], no_grad_vars=[h])
    np.testing.assert_allclose(g.numpy(), 2 * np.ones(3))
    assert x.grad is None
    with tp.no_grad():
        assert not (x * 2).requires_grad
    assert tp.is_grad_enabled()


def _pylayers():
    class JCube(JPyLayer):
        @staticmethod
        def forward(ctx, x, k=3.0):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * x * x * ctx.k * 3.0

    class TCube(TPyLayer):
        @staticmethod
        def forward(ctx, x, k=3.0):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * x * x * ctx.k * 3.0
    return JCube, TCube


def test_pylayer_matches_jax_tape():
    JCube, TCube = _pylayers()
    x_np = np.random.RandomState(2).randn(5).astype(np.float32)
    jx = jp.to_tensor(x_np, stop_gradient=False)
    jy = JCube.apply(jx, k=0.5)
    (JF.sigmoid(jy)).sum().backward()
    tx = tp.to_tensor(x_np, stop_gradient=False)
    ty = TCube.apply(tx, k=0.5)
    (TF.sigmoid(ty)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=RTOL,
                               atol=ATOL)


def test_readme_quick_start_on_the_port():
    """README's eager Quick start: Linear, Adam(parameters=...),
    mse_loss, backward / step / clear_grad, three steps, against the JAX
    package from the same weights."""
    rng = np.random.RandomState(3)
    x_np = rng.randn(8, 4).astype(np.float32)
    y_np = rng.randn(8, 2).astype(np.float32)
    jnet = jnn.Linear(4, 2)
    jopt = jp.optimizer.Adam(parameters=jnet.parameters())
    net = tp.nn.Linear(4, 2)
    _sync(jnet, net)
    opt = tp.optimizer.Adam(parameters=net.parameters())
    x, y = tp.to_tensor(x_np), tp.to_tensor(y_np)
    jx, jy = jp.to_tensor(x_np), jp.to_tensor(y_np)
    for _ in range(3):
        loss = tp.nn.functional.mse_loss(net(x), y)
        loss.backward(); opt.step(); opt.clear_grad()
        jloss = JF.mse_loss(jnet(jx), jy)
        jloss.backward(); jopt.step(); jopt.clear_grad()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(_np(net.state_dict()[k]), _np(v),
                                   rtol=RTOL, atol=ATOL)
    assert all(p.grad is None for p in net.parameters())


def test_layer_surface():
    attr = tp.ParamAttr(name="my_w", learning_rate=0.5, trainable=False,
                        initializer=tnn.initializer.Constant(0.25))
    lin = tnn.Linear(3, 2, weight_attr=attr, bias_attr=False)
    assert lin.bias is None and lin.weight.name == "my_w"
    assert not lin.weight.trainable and lin.weight.stop_gradient
    assert lin.weight.optimize_attr == {"learning_rate": 0.5}
    assert torch.all(lin.weight == 0.25)
    lin.weight.trainable = True
    assert lin.weight.requires_grad
    assert lin.full_name().startswith("linear_")
    assert isinstance(lin.parameters(), list)

    seq = tnn.Sequential(tnn.Linear(3, 3), tnn.Dropout(0.5))
    seq.eval()
    assert all(not m.training for m in seq.sublayers())
    seq.train()
    assert all(m.training for m in seq.sublayers(include_self=True))
    calls = []
    pre = seq.register_forward_pre_hook(lambda l, ins: (ins[0] * 0,))
    post = seq[0].register_forward_post_hook(
        lambda l, ins, out: calls.append(out.shape) or out + 1)
    out = seq.eval()(torch.ones(2, 3))
    assert torch.allclose(out, seq[0].bias + 1)
    assert calls == [torch.Size([2, 3])]
    pre.remove(); post.remove()
    assert not torch.allclose(seq(torch.ones(2, 3)), seq[0].bias + 1)

    blk = _Block.build(tnn, lambda s: torch.zeros(s))
    assert "tmp" not in blk.state_dict() and "steps" in blk.state_dict()
    blk.add_sublayer("extra", tnn.Linear(2, 2))
    blk.add_parameter("p2", tp.Parameter(torch.ones(2)))
    assert "extra.weight" in blk.state_dict() and "p2" in blk.state_dict()
    blk.to(dtype="float64")
    assert blk.fc.weight.dtype == torch.float64 and blk._dtype == \
        torch.float64
    blk.to("cpu")
    w = blk.fc.weight
    blk.astype("float32")
    assert blk.fc.weight is w and w.dtype == torch.float32

    state = {k: v.detach().clone() for k, v in blk.state_dict().items()}
    with pytest.raises(ValueError, match="unexpected"):
        blk.set_state_dict({**state, "nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="missing"):
        blk.set_state_dict({k: v for k, v in state.items() if k != "p2"})
    with pytest.raises(ValueError, match="mismatch"):
        blk.set_state_dict({**state, "p2": torch.zeros(3)})
    missing, unexpected = blk.set_state_dict(
        {"p2": np.full(2, 7.0), "nope": 1}, strict=False)
    assert "fc.weight" in missing and unexpected == ["nope"]
    assert torch.all(blk.p2 == 7.0)


def test_parameter_survives_copy_and_pickle():
    import copy
    import pickle
    lin = tnn.Linear(2, 2, weight_attr=tp.ParamAttr(learning_rate=0.3))
    c = copy.deepcopy(lin)
    assert isinstance(c.weight, tp.Parameter) and c.weight is not lin.weight
    assert c.weight.name == lin.weight.name
    assert c.weight.optimize_attr == {"learning_rate": 0.3}
    p = pickle.loads(pickle.dumps(lin.weight))
    assert isinstance(p, tp.Parameter) and p.name == lin.weight.name
    assert torch.equal(p, lin.weight)


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_per_parameter_learning_rates_match_jax(opt):
    """Two layers at ParamAttr learning rates 1.0 and 0.1: three eager
    steps of the port against the JAX package; the trainer path
    (``apply_gradients`` over the same parameter objects) too."""
    rng = np.random.RandomState(4)
    x_np = rng.randn(6, 3).astype(np.float32)

    def net(nn, pa):
        return nn.Sequential(
            nn.Linear(3, 4, weight_attr=pa(learning_rate=1.0),
                      bias_attr=pa(learning_rate=1.0)),
            nn.Linear(4, 2, weight_attr=pa(learning_rate=0.1),
                      bias_attr=pa(learning_rate=0.1)))

    jnet = net(jnn, jp.ParamAttr)
    tnet = net(tnn, tp.ParamAttr)
    _sync(jnet, tnet)
    tcopy = net(tnn, tp.ParamAttr)
    _sync(jnet, tcopy)
    mk = {"SGD": lambda m, ps: m.SGD(learning_rate=0.5, parameters=ps),
          "Adam": lambda m, ps: m.Adam(learning_rate=0.05, parameters=ps)}
    jopt = mk[opt](jp.optimizer, jnet.parameters())
    topt = mk[opt](tp.optimizer, tnet.parameters())
    tr_opt = mk[opt](tp.optimizer, None)
    jx, tx = jp.to_tensor(x_np), tp.to_tensor(x_np)
    for step in range(1, 4):
        (jnet(jx) ** 2).mean().backward()
        jopt.step(); jopt.clear_grad()
        (tnet(tx) ** 2).mean().backward()
        topt.step(); topt.clear_grad()
        (tcopy(tx) ** 2).mean().backward()
        params = dict(tcopy.named_parameters())
        tr_opt.apply_gradients(params, {n: p.grad for n, p in
                                        params.items()}, step=step)
        for p in params.values():
            p.grad = None
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(_np(tnet.state_dict()[k]), _np(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(_np(tcopy.state_dict()[k]), _np(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_to_tensor_dtypes_and_device():
    t = tp.to_tensor([[1.5, 2.0]])
    assert t.dtype == torch.float32 and not t.requires_grad
    assert tp.to_tensor([1, 2]).dtype == torch.int64
    assert tp.to_tensor(np.zeros(2), dtype="bfloat16").dtype == \
        torch.bfloat16
    assert tp.to_tensor(1.0, stop_gradient=False).requires_grad
    assert tp.get_device() == "cpu"
    assert tp.get_default_dtype() == "float32"
    tp.set_default_dtype("float64")
    try:
        assert tnn.Linear(2, 2).weight.dtype == torch.float64
        assert tp.to_tensor([0.5]).dtype == torch.float64
    finally:
        tp.set_default_dtype("float32")
    from paddle_tpu_torch.core import dtype as D
    assert D.convert_dtype("paddle.int32") == torch.int32
    assert D.convert_dtype(np.float16) == torch.float16
    assert D.dtype_name(torch.bfloat16) == "bfloat16"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.set_device("gpu")
        assert tp.get_device() == "cpu"


def test_seed_restarts_the_layer_generator():
    tp.seed(5)
    a = tnn.Linear(3, 3).weight.detach().clone()
    b = tnn.Linear(3, 3).weight.detach().clone()
    tp.seed(5)
    assert torch.equal(tnn.Linear(3, 3).weight, a)
    assert not torch.equal(a, b)


# the norms and Model.summary waited for the vision slice, the DataLoader
# workers and the detection ops for the next one, the sparse embedding for
# the op library's, remote paths for the file systems; they now build
PORTED_SINCE = {"BatchNorm2D", "GroupNorm", "InstanceNorm1D", "RMSNorm",
                "Model-summary", "DataLoader-workers", "vision-ops",
                "Embedding-sparse", "save-remote"}
WAITING = {
    "BatchNorm2D": lambda: tnn.BatchNorm2D(4),
    "GroupNorm": lambda: tnn.GroupNorm(2, 4),
    "InstanceNorm1D": lambda: tnn.InstanceNorm1D(4),
    "RMSNorm": lambda: tnn.RMSNorm(4),
    "Embedding-sparse": lambda: tnn.Embedding(4, 2, sparse=True),
    "DataLoader-workers": lambda: tp.io.DataLoader([1, 2], num_workers=2),
    "Model-mesh": lambda: tp.Model(tnn.Linear(2, 2)).prepare(
        mesh={"dp": 2}),
    "Model-summary": lambda: tp.Model(tnn.Linear(2, 2)).summary((1, 2)),
    "save-remote": lambda: tp.framework.fs.get_fs("hdfs://host/ck.pdparams"),
    "vision-ops": lambda: tp.vision.ops.roi_align(
        torch.zeros(1, 1, 4, 4), torch.tensor([[0., 0., 2., 2.]])),
    "vision-dataset-files": lambda: tp.vision.datasets.Cifar100(),
}


@pytest.mark.parametrize("name", list(WAITING))
def test_waiting_classes_name_their_roadmap_item(name):
    """What waits for a later slice raises, naming its ROADMAP item;
    what a slice has since ported builds."""
    if name in PORTED_SINCE:
        assert WAITING[name]() is not None
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1"):
        WAITING[name]()
