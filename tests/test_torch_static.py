"""The port's ``static`` (Program, Executor, control flow, ``static.nn``,
the helpers, save / load of the inference program) against the JAX
package's, on the CPU, at small size.

- The 12 cases of ``tests/test_static_program.py``, each built in both
  packages with the same weights and held to JAX: the recorded inputs
  and op counts, the forward at two feed shapes, SGD and Adam training
  losses step by step within 1e-5 of their scale (TRAIN_TOL), the
  dygraph twin, ``clone(for_test=True)``, ``minimize`` after the guard
  exits, ``save`` / ``load_inference_model`` across batch sizes, feed
  validation.
- Batch norm: ``static.nn.batch_norm``'s riders and its test clone
  against JAX's; ``nn.BatchNorm1D`` in static mode against the eager
  layer (the in-place update recorded as a rider).
- ``cond`` / ``while_loop`` / ``case`` / ``switch_case``: eagerly on
  tensors and inside ``jit.to_static`` against JAX's; on static
  Variables against the eager results.
- ``static.nn`` and the helpers' ops as one table: every case's weights
  from ``Assign`` initializers, the port eager against JAX, whose
  references come from one ``jax.jit`` over the whole table; f32 within
  1e-4 of scale (OP_TOL), integers equal.
- Wide & Deep's static program at a 1000-row table: 3 steps' losses
  against JAX's within TRAIN_TOL, the port's sparse table under SGD and
  its dense table under Adam against JAX's dense one.
- The helpers' program state (``save`` / ``load``, ``save_vars`` /
  ``load_vars``, the ``serialize_*`` pairs), scopes, places,
  ``CompiledProgram`` and ``ParallelExecutor``, ``gradients`` and
  ``append_backward`` against JAX.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
from paddle_tpu import static as jstatic

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.nn.initializer as TI
from paddle_tpu_torch import static as tstatic

TRAIN_TOL = 1e-5
OP_TOL = 1e-4
JAX = (jp, jstatic, jnn, JF, JI)
PORT = (tp, tstatic, tnn, TF, TI)


@pytest.fixture(autouse=True)
def fresh_programs():
    """Fresh default programs in both packages; eager mode after."""
    from paddle_tpu.static import program as jprog
    from paddle_tpu_torch.static import program as tprog
    tp.set_device("cpu")

    def reset():
        for mod, st in ((jprog, jstatic), (tprog, tstatic)):
            mod._state.mode = False
            mod._state.main = st.Program()
            mod._state.startup = st.Program()
    reset()
    yield
    reset()


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy() if t.is_floating_point() \
            else t.detach().numpy()
    return np.asarray(t.data if isinstance(t, jp.Tensor) else t)


def _err(got, want):
    got, want = np.asarray(_np(got), np.float64), \
        np.asarray(_np(want), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _exe(pkg):
    return pkg[1].Executor() if pkg is JAX else \
        tstatic.Executor(tstatic.CPUPlace())


def _static(pkg, build):
    """``build(*pkg)`` in static mode of ``pkg``."""
    pkg[0].enable_static()
    try:
        return build(*pkg)
    finally:
        pkg[0].disable_static()


def _sync(jlayers, tlayers):
    for j, t in zip(jlayers, tlayers):
        t.set_state_dict({k: _np(v) for k, v in j.state_dict().items()})


# ---------------------------------------------------------------------------
# the cases of test_static_program.py
# ---------------------------------------------------------------------------
def test_data_records_inputs_and_ops():
    def build(P, S, nn, F, I):
        x = S.data("x", [None, 4])
        y = P.add(x, x)
        return x, y, S.default_main_program()
    jx, jy, jmain = _static(JAX, build)
    tx, ty, tmain = _static(PORT, build)
    assert isinstance(tx, tstatic.Variable) and isinstance(ty,
                                                           tstatic.Variable)
    assert list(tmain.inputs) == list(jmain.inputs) == ["x"]
    assert len(tmain.ops) == len(jmain.ops) == 1
    assert tx.decl_shape == (None, 4)
    assert not isinstance(tstatic.data("z", [2]), tstatic.Variable)


def test_executor_runs_forward_graph():
    def build(P, S, nn, F, I):
        x = S.data("x", [None, 3])
        return (x * 2.0 + 1.0).sum(axis=1)
    jy, ty = _static(JAX, build), _static(PORT, build)
    for a in (np.arange(6, dtype=np.float32).reshape(2, 3),
              np.ones((5, 3), np.float32)):
        (want,) = _exe(JAX).run(feed={"x": a}, fetch_list=[jy])
        (got,) = _exe(PORT).run(feed={"x": a}, fetch_list=[ty])
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_executor_missing_feed_raises():
    def build(P, S, nn, F, I):
        return S.data("x", [None, 2]) + 1.0
    y = _static(PORT, build)
    with pytest.raises(ValueError, match="missing graph inputs"):
        _exe(PORT).run(feed={}, fetch_list=[y])


def test_layers_capture_parameters_not_constants():
    def build(P, S, nn, F, I):
        lin = nn.Linear(2, 1, bias_attr=False)
        return lin, lin(S.data("x", [None, 2]))
    jl, jy = _static(JAX, build)
    tl, ty = _static(PORT, build)
    _sync([jl], [tl])
    a = np.ones((1, 2), np.float32)
    (o1,) = _exe(PORT).run(feed={"x": a}, fetch_list=[ty])
    (w1,) = _exe(JAX).run(feed={"x": a}, fetch_list=[jy])
    with torch.no_grad():
        tl.weight.mul_(2)
    (o2,) = _exe(PORT).run(feed={"x": a}, fetch_list=[ty])
    np.testing.assert_allclose(o1, w1, rtol=1e-6)
    np.testing.assert_allclose(o2, 2 * o1, rtol=1e-6)


def test_program_guard_isolation():
    def build(P, S, nn, F, I):
        main2 = S.Program()
        with S.program_guard(main2):
            _ = S.data("x", [None, 2]) + 1.0
        return main2, S.default_main_program()
    jm2, jdef = _static(JAX, build)
    tm2, tdef = _static(PORT, build)
    assert len(tm2.ops) == len(jm2.ops) == 1
    assert len(tdef.ops) == len(jdef.ops) == 0


def _train_build(opt_name, lr, sizes=(4, 2), seed=0):
    def build(P, S, nn, F, I):
        P.seed(seed)
        layers = [nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])]
        x = S.data("x", [None, sizes[0]])
        y = S.data("y", [None, sizes[-1]])
        h = x
        for i, layer in enumerate(layers):
            h = layer(h)
            if i < len(layers) - 1:
                h = F.relu(h)
        loss = F.mse_loss(h, y)
        params = [p for layer in layers for p in layer.parameters()]
        opt = getattr(P.optimizer, opt_name)(learning_rate=lr,
                                             parameters=params)
        return layers, loss, opt
    return build


def _train_pair(opt_name, lr, steps, sizes=(4, 2), seed=0):
    """The same program trained in both packages from the same weights:
    losses and final parameters of each."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(16, sizes[0]).astype(np.float32)
    ys = rng.randn(16, sizes[-1]).astype(np.float32)
    out = {}
    jl, jloss, jopt = _static(JAX, _train_build(opt_name, lr, sizes, seed))
    tl, tloss, topt = _static(PORT, _train_build(opt_name, lr, sizes, seed))
    _sync(jl, tl)
    for pkg, layers, loss, opt in ((JAX, jl, jloss, jopt),
                                   (PORT, tl, tloss, topt)):
        opt.minimize(loss)
        exe = _exe(pkg)
        exe.run(pkg[1].default_startup_program())
        losses = [float(exe.run(feed={"x": xs, "y": ys},
                                fetch_list=[loss])[0]) for _ in range(steps)]
        out[pkg[0].__name__] = (losses, [_np(p) for layer in layers
                                         for p in layer.parameters()])
    return out["paddle_tpu"], out["paddle_tpu_torch"], (xs, ys)


def test_static_training_converges_like_dygraph_and_jax():
    (jl, jp_), (tl, tp_), (xs, ys) = _train_pair("SGD", 0.1, 10)
    assert _err(tl, jl) <= TRAIN_TOL
    for a, b in zip(tp_, jp_):
        assert _err(a, b) <= TRAIN_TOL
    # the port's dygraph twin from the same start
    tp.seed(0)
    net = tnn.Linear(4, 2)
    jp.seed(0)
    _sync([jnn.Linear(4, 2)], [net])
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    dy = []
    for _ in range(10):
        loss = TF.mse_loss(net(torch.from_numpy(xs)), torch.from_numpy(ys))
        opt.minimize(loss)
        opt.clear_grad()
        dy.append(float(loss))
    assert _err(tl, dy) <= TRAIN_TOL


def test_static_adam_training_matches_jax():
    (jl, jp_), (tl, tp_), _ = _train_pair("Adam", 0.05, 30, (4, 8, 1), 1)
    assert _err(tl, jl) <= TRAIN_TOL
    assert tl[-1] < tl[0] * 0.5


def test_clone_for_test_drops_train_hook():
    def build(P, S, nn, F, I):
        net = nn.Linear(2, 1)
        loss = net(S.data("x", [None, 2])).sum()
        P.optimizer.SGD(learning_rate=0.1,
                        parameters=net.parameters()).minimize(loss)
        return S.default_main_program(), loss
    main, loss = _static(PORT, build)
    assert main._train is not None
    test_prog = main.clone(for_test=True)
    assert test_prog._train is None and test_prog._for_test
    w0 = _np(main._train[1][0][0]).copy()
    (out,) = _exe(PORT).run(test_prog, feed={"x": np.ones((2, 2),
                                                          np.float32)},
                            fetch_list=[loss])
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(_np(main._train[1][0][0]), w0)


def test_minimize_after_guard_exit_lands_on_owning_program():
    def build(P, S, nn, F, I):
        prog = S.Program()
        with S.program_guard(prog):
            net = nn.Linear(2, 1)
            loss = net(S.data("x", [None, 2])).sum()
        P.optimizer.SGD(learning_rate=0.1,
                        parameters=net.parameters()).minimize(loss)
        return prog, net, loss
    prog, net, loss = _static(PORT, build)
    assert prog._train is not None
    assert tstatic.default_main_program()._train is None
    w0 = _np(net.weight).copy()
    _exe(PORT).run(prog, feed={"x": np.ones((2, 2), np.float32)},
                   fetch_list=[loss])
    assert not np.allclose(_np(net.weight), w0)


def test_static_adam_bias_correction_advances():
    (jl, jp_), (tl, tp_), (xs, ys) = _train_pair("Adam", 0.05, 6, (3, 2), 3)
    assert _err(tl, jl) <= TRAIN_TOL
    for a, b in zip(tp_, jp_):
        assert _err(a, b) <= TRAIN_TOL


def test_save_load_inference_model(tmp_path):
    def build(P, S, nn, F, I):
        P.seed(0)
        net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
        x = S.data("x", [None, 4])
        return net, x, net(x)
    jn, jx, jy = _static(JAX, build)
    tn, tx, ty = _static(PORT, build)
    _sync([jn], [tn])
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    (want,) = _exe(JAX).run(feed={"x": a}, fetch_list=[jy])
    (live,) = _exe(PORT).run(feed={"x": a}, fetch_list=[ty])
    prefix = str(tmp_path / "infer" / "net")
    tstatic.save_inference_model(prefix, [tx], [ty], _exe(PORT))
    prog, feed_names, n_out = tstatic.load_inference_model(prefix)
    assert feed_names == ["x"] and n_out == 1
    (got,) = _exe(PORT).run(prog, feed={"x": a})
    assert _err(got, want) <= 1e-6 and _err(live, want) <= 1e-6
    with torch.no_grad():               # frozen at save time
        for p in tn.parameters():
            p.zero_()
    (again,) = _exe(PORT).run(prog, feed={"x": a})
    np.testing.assert_array_equal(again, got)
    (got7,) = _exe(PORT).run(prog, feed={"x": np.ones((7, 4), np.float32)})
    assert got7.shape == (7, 2)


def test_save_inference_model_validates_feeds(tmp_path):
    def build(P, S, nn, F, I):
        x, z = S.data("x", [None, 2]), S.data("z", [None, 2])
        return x, x + z
    x, out = _static(PORT, build)
    with pytest.raises(ValueError, match="not in feed_vars"):
        tstatic.save_inference_model(str(tmp_path / "m"), [x], [out])


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------
def test_static_nn_batch_norm_riders_match_jax():
    rng = np.random.RandomState(4)
    w = rng.rand(3).astype(np.float32) + 0.5
    b = rng.randn(3).astype(np.float32)

    def build(P, S, nn, F, I):
        x = S.data("x", [None, 3, 2])
        out = S.nn.batch_norm(
            x, param_attr=P.ParamAttr(initializer=I.Assign(w)),
            bias_attr=P.ParamAttr(initializer=I.Assign(b)), momentum=0.8)
        return out, S.default_main_program()
    jo, jmain = _static(JAX, build)
    to, tmain = _static(PORT, build)
    for _ in range(2):
        a = rng.randn(4, 3, 2).astype(np.float32)
        (want,) = _exe(JAX).run(jmain, feed={"x": a}, fetch_list=[jo])
        (got,) = _exe(PORT).run(tmain, feed={"x": a}, fetch_list=[to])
        assert _err(got, want) <= OP_TOL
    assert len(tmain._updates) == len(jmain._updates) == 2
    for (tt, _), (jt, _) in zip(tmain._updates, jmain._updates):
        assert _err(tt, jt.data) <= OP_TOL
    # the test clone normalizes with the moving statistics
    a = rng.randn(4, 3, 2).astype(np.float32)
    (want,) = _exe(JAX).run(jmain.clone(for_test=True), feed={"x": a},
                            fetch_list=[jo])
    (got,) = _exe(PORT).run(tmain.clone(for_test=True), feed={"x": a},
                            fetch_list=[to])
    assert _err(got, want) <= OP_TOL


def test_layer_batch_norm_in_static_mode_writes_back():
    def build(P, S, nn, F, I):
        bn = nn.BatchNorm1D(4, momentum=0.7)
        return bn, bn(S.data("x", [None, 4]))
    bn, y = _static(PORT, build)
    eager = tnn.BatchNorm1D(4, momentum=0.7)
    rng = np.random.RandomState(5)
    for _ in range(2):
        a = rng.randn(6, 4).astype(np.float32)
        (got,) = _exe(PORT).run(feed={"x": a}, fetch_list=[y])
        want = eager(torch.from_numpy(a))
        assert _err(got, want) <= 1e-6
    assert _err(bn._mean, eager._mean) <= 1e-6
    assert _err(bn._variance, eager._variance) <= 1e-6


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------
def _flow(P, S, x, i):
    """Every control-flow op on ``x`` (a [3] tensor) and ``i`` (an int
    scalar tensor)."""
    a = S.cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0)
    b = S.while_loop(lambda v, n: n < 3, lambda v, n: [v * 1.5, n + 1],
                     [x, P.zeros([1], "int64")])[0]
    c = S.case([(i == 0, lambda: x + 10.0), (i == 1, lambda: x + 20.0)],
               default=lambda: x * 0.0)
    d = S.switch_case(i, {0: lambda: x - 5.0, 2: lambda: x * 3.0},
                      default=lambda: x + 0.5)
    return a, b, c, d


@pytest.mark.parametrize("xs,i", [([1.0, 2.0, -0.5], 0),
                                  ([-3.0, 0.5, 1.0], 1),
                                  ([0.25, -1.0, 0.5], 2)])
def test_control_flow_matches_jax(xs, i):
    x = np.asarray(xs, np.float32)
    want = _flow(jp, jstatic, jp.to_tensor(x),
                 jp.to_tensor(np.asarray(i, np.int64)))
    got = _flow(tp, tstatic, torch.from_numpy(x), torch.tensor(i))
    for g, w in zip(got, want):
        assert _err(g, w) <= 1e-6

    # inside a capture: JAX's lax control flow against the port's
    class Flow(tnn.Layer):
        def forward(self, a, n):
            return _flow(tp, tstatic, a, n)

    class JFlow(jnn.Layer):
        def forward(self, a, n):
            return _flow(jp, jstatic, a, n)

    jt = jp.jit.to_static(JFlow())(jp.to_tensor(x),
                                   jp.to_tensor(np.asarray(i, np.int64)))
    tt = tp.jit.to_static(Flow())(torch.from_numpy(x), torch.tensor(i))
    for g, w in zip(tt, jt):
        assert _err(g, w) <= 1e-6
    # on static Variables: the eager results
    xv, iv = _static(PORT, lambda P, S, *_: (S.data("x", [3]),
                                             S.data("i", [], "int64")))
    outs = _static(PORT, lambda P, S, *_: _flow(P, S, xv, iv))
    vals = _exe(PORT).run(feed={"x": x, "i": np.asarray(i)},
                          fetch_list=list(outs))
    for v, w in zip(vals, want):
        assert _err(v, w) <= 1e-6


# ---------------------------------------------------------------------------
# static.nn and the helpers' ops: one table, one jax.jit
# ---------------------------------------------------------------------------
def _inputs():
    rng = np.random.RandomState(6)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "x": f(4, 6), "x3": f(2, 3, 4), "img": f(2, 3, 6, 6),
        "small": f(2, 3, 5, 5), "seq": f(2, 5, 4), "y": f(4, 5),
        "ids": rng.randint(0, 10, (4, 3)).astype(np.int64),
        "emis": f(2, 5, 4), "lens": np.asarray([5, 3], np.int64),
        "prob": rng.uniform(0.05, 0.95, (8, 2)).astype(np.float32),
        "lab": rng.randint(0, 2, (8, 1)).astype(np.int64),
        "w": {k: f(*s) for k, s in {
            "fc": (6, 5), "fcb": (5,), "fc3": (12, 3), "emb": (10, 5),
            "conv": (4, 3, 3, 3), "convb": (4,), "convt": (3, 2, 3, 3),
            "g": (3,), "bt": (3,), "ln": (4,), "lnb": (4,), "gn": (3,),
            "prelu_c": (3,), "prelu_e": (3, 6, 6), "row": (3, 4),
            "spec": (4, 6), "bil": (2, 6, 5), "bilb": (1, 2),
            "crf": (6, 4), "dcn": (2, 3, 3, 3)}.items()},
    }


def _table(P, S, I, ins, w):
    """Every case's output(s) from ``ins`` (tensors of one package) with
    the weights ``w`` (numpy, the ``Assign`` initializers' values)."""

    def pa(k):
        return P.ParamAttr(initializer=I.Assign(w[k]))

    nn_ = S.nn
    out = {
        "fc": nn_.fc(ins["x"], 5, weight_attr=pa("fc"),
                     bias_attr=pa("fcb"), activation="relu"),
        "fc_flatten": nn_.fc(ins["x3"], 3, num_flatten_dims=1,
                             weight_attr=pa("fc3"), bias_attr=False),
        "embedding": nn_.embedding(ins["ids"], [10, 5],
                                   param_attr=pa("emb")),
        "conv2d": nn_.conv2d(ins["img"], 4, 3, padding=1,
                             param_attr=pa("conv"), bias_attr=pa("convb"),
                             act="relu"),
        "conv2d_transpose": nn_.conv2d_transpose(
            ins["small"], 2, filter_size=3, param_attr=pa("convt"),
            bias_attr=False),
        "batch_norm": nn_.batch_norm(ins["img"], param_attr=pa("g"),
                                     bias_attr=pa("bt")),
        "batch_norm_test": nn_.batch_norm(ins["img"], is_test=True,
                                          param_attr=pa("g"),
                                          bias_attr=pa("bt")),
        "layer_norm": nn_.layer_norm(ins["seq"], begin_norm_axis=2,
                                     param_attr=pa("ln"),
                                     bias_attr=pa("lnb")),
        "group_norm": nn_.group_norm(ins["img"], 3, param_attr=pa("gn"),
                                     bias_attr=False),
        "instance_norm": nn_.instance_norm(ins["img"], param_attr=pa("g"),
                                           bias_attr=pa("bt")),
        "data_norm": nn_.data_norm(ins["x"]),
        "prelu_all": nn_.prelu(ins["img"], "all"),
        "prelu_channel": nn_.prelu(ins["img"], "channel",
                                   param_attr=pa("prelu_c")),
        "prelu_element": nn_.prelu(ins["img"], "element",
                                   param_attr=pa("prelu_e")),
        "row_conv": nn_.row_conv(ins["seq"], 2, param_attr=pa("row")),
        "spectral_norm": nn_.spectral_norm(
            S.create_parameter([4, 6], "float32",
                               attr=pa("spec")), power_iters=3),
        "bilinear": nn_.bilinear_tensor_product(
            ins["x"], ins["y"], 2, param_attr=pa("bil"),
            bias_attr=pa("bilb")),
        "crf_decoding": nn_.crf_decoding(
            ins["emis"], length=ins["lens"],
            transition=S.create_parameter([6, 4], "float32",
                                          attr=pa("crf"))),
        "accuracy": S.accuracy(ins["prob"], ins["lab"]),
        "auc": S.auc(ins["prob"], ins["lab"], num_thresholds=200),
        "global_var": S.create_global_var([2, 2], 1.5, "float32") + 0.0,
    }
    return out


@pytest.fixture(scope="module")
def jax_table():
    """The JAX side of the whole table under one ``jax.jit``."""
    ins = _inputs()
    w = ins.pop("w")

    def run(arrs):
        tins = jax.tree_util.tree_map(jp.to_tensor, arrs)
        out = _table(jp, jstatic, JI, tins, w)
        return {k: v.data if isinstance(v, jp.Tensor) else v
                for k, v in out.items()}

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(ins))


def test_static_nn_table_matches_jax(jax_table):
    ins = _inputs()
    w = ins.pop("w")
    got = _table(tp, tstatic, TI,
                 {k: torch.from_numpy(v) for k, v in ins.items()}, w)
    assert set(got) == set(jax_table)
    for name, want in jax_table.items():
        g = _np(got[name])
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(g, want, err_msg=name)
        else:
            assert _err(g, want) <= OP_TOL, name


def test_nce_and_print_shapes():
    x = torch.randn(5, 4)
    lab = torch.randint(0, 7, (5, 1))
    loss = tstatic.nn.nce(x, lab, 7, num_neg_samples=3, seed=2)
    assert loss.shape == (5, 1) and bool(torch.isfinite(loss).all())
    assert torch.equal(tstatic.Print(x, message="x"), x)


# ---------------------------------------------------------------------------
# Wide & Deep's static program
# ---------------------------------------------------------------------------
WD_VOCAB, WD_SLOTS, WD_EMB, WD_DENSE, WD_FC, WD_B = 1000, 4, 3, 5, (8, 4), 16


def _wide_deep(weights, sparse_table, opt):
    def build(P, S, nn, F, I):
        def pa(k):
            return P.ParamAttr(initializer=I.Assign(weights[k]))
        dense = S.data("dense", [None, WD_DENSE])
        sparse = S.data("sparse", [None, WD_SLOTS], "int64")
        label = S.data("label", [None, 1])
        emb = S.nn.embedding(sparse, [WD_VOCAB, WD_EMB],
                             is_sparse=sparse_table, param_attr=pa("emb"))
        # concat([emb, dense]) @ w0 as two products (the JAX package's
        # static concat does not take Variables)
        deep = F.relu(
            S.nn.fc(P.reshape(emb, [-1, WD_SLOTS * WD_EMB]), WD_FC[0],
                    weight_attr=pa("w0e"), bias_attr=pa("b0"))
            + S.nn.fc(dense, WD_FC[0], weight_attr=pa("w0d"),
                      bias_attr=False))
        for i, size in enumerate(WD_FC[1:], start=1):
            deep = S.nn.fc(deep, size, weight_attr=pa(f"w{i}"),
                           bias_attr=pa(f"b{i}"), activation="relu")
        logit = S.nn.fc(deep, 1, weight_attr=pa("wo"), bias_attr=pa("bo")) \
            + S.nn.fc(dense, 1, weight_attr=pa("ww"), bias_attr=pa("bw"))
        loss = P.mean(F.binary_cross_entropy_with_logits(logit, label))
        getattr(P.optimizer, opt)(learning_rate=0.01).minimize(loss)
        return loss, F.sigmoid(logit)
    return build


@pytest.mark.parametrize("opt,sparse_table", [("SGD", True),
                                               ("Adam", False)])
def test_wide_deep_static_program_matches_jax(opt, sparse_table):
    """The port's table is row-sparse under SGD: its update equals the
    dense one to rounding.  Under Adam an element whose summed gradient
    is 0 in one order of summation and a rounding residue in another
    moves by the whole learning rate in one of them (measured: 1.3e-5 of
    the second loss), so Adam is held to JAX with the dense table."""
    rng = np.random.RandomState(7)
    sizes = (WD_SLOTS * WD_EMB + WD_DENSE,) + WD_FC
    weights = {"emb": rng.randn(WD_VOCAB, WD_EMB).astype(np.float32) * 0.3}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        weights[f"w{i}"] = rng.randn(a, b).astype(np.float32) * 0.3
        weights[f"b{i}"] = np.zeros(b, np.float32)
    weights["w0e"] = weights["w0"][:WD_SLOTS * WD_EMB]
    weights["w0d"] = weights["w0"][WD_SLOTS * WD_EMB:]
    weights.update(wo=rng.randn(WD_FC[-1], 1).astype(np.float32) * 0.3,
                   bo=np.zeros(1, np.float32),
                   ww=rng.randn(WD_DENSE, 1).astype(np.float32) * 0.3,
                   bw=np.zeros(1, np.float32))
    batches = [(rng.lognormal(0, 1, (WD_B, WD_DENSE)).astype(np.float32),
                rng.randint(0, WD_VOCAB, (WD_B, WD_SLOTS)).astype(np.int64),
                (rng.rand(WD_B, 1) < 0.3).astype(np.float32))
               for _ in range(3)]
    losses = {}
    # the JAX package's static sparse_embedding reads its ids on the host
    # (jnp.asarray of a Variable raises), so its reference is the dense
    # table
    for pkg in (JAX, PORT):
        loss, _ = _static(pkg, _wide_deep(weights, sparse_table and
                                          pkg is PORT, opt))
        exe = _exe(pkg)
        losses[pkg[0].__name__] = [
            float(exe.run(feed={"dense": d, "sparse": s, "label": y},
                          fetch_list=[loss])[0]) for d, s, y in batches]
    assert _err(losses["paddle_tpu_torch"], losses["paddle_tpu"]) \
        <= TRAIN_TOL


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------
def test_gradients_and_append_backward_match_jax():
    w = np.random.RandomState(8).randn(3, 2).astype(np.float32)

    def build(P, S, nn, F, I):
        lin = nn.Linear(3, 2, weight_attr=P.ParamAttr(
            initializer=I.Assign(w)), bias_attr=False)
        x = S.data("x", [None, 3])
        h = lin(x)
        y = (h * h).sum()
        (gx,) = S.gradients([y], [x])
        (gh,) = S.gradients([y], [h])
        pairs = S.append_backward(y)
        return gx, gh, pairs[0][1]
    a = np.random.RandomState(9).randn(4, 3).astype(np.float32)
    want = _exe(JAX).run(feed={"x": a}, fetch_list=list(_static(JAX,
                                                                build)))
    tvars = _static(PORT, build)
    got = _exe(PORT).run(feed={"x": a}, fetch_list=list(tvars))
    assert tvars[2].name.endswith("@GRAD")
    for g, wnt in zip(got, want):
        assert _err(g, wnt) <= OP_TOL


def test_program_state_save_load_and_serialize(tmp_path):
    def build(P, S, nn, F, I):
        P.seed(3)
        net = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
        x = S.data("x", [None, 3])
        return net, x, net(x), S.default_main_program()
    net, x, y, main = _static(PORT, build)
    a = np.ones((2, 3), np.float32)
    (want,) = _exe(PORT).run(main, feed={"x": a}, fetch_list=[y])
    path = str(tmp_path / "state" / "m")
    tstatic.save(main, path)
    blob = tstatic.serialize_persistables([x], [y])
    tstatic.save_vars(None, str(tmp_path / "vars"), main)
    tstatic.save_vars(None, str(tmp_path / "one"), main, filename="all")
    for restore in (lambda: tstatic.load(main, path),
                    lambda: tstatic.load_vars(None, str(tmp_path / "vars"),
                                              main),
                    lambda: tstatic.load_vars(None, str(tmp_path / "one"),
                                              main, filename="all"),
                    lambda: tstatic.deserialize_persistables(main, blob)):
        with torch.no_grad():
            for p in net.parameters():
                p.zero_()
        restore()
        (got,) = _exe(PORT).run(main, feed={"x": a}, fetch_list=[y])
        np.testing.assert_array_equal(got, want)
    state = tstatic.load_program_state(path)
    assert sorted(state) == sorted(p.name for p in net.parameters())
    prog = tstatic.deserialize_program(tstatic.serialize_program([x], [y]))
    (got,) = _exe(PORT).run(prog, feed={"x": a})
    np.testing.assert_array_equal(got, want)
    tstatic.save_to_file(str(tmp_path / "b"), b"abc")
    assert tstatic.load_from_file(str(tmp_path / "b")) == b"abc"


def test_scopes_places_and_compiled_programs():
    scope = tstatic.Scope()
    scope.var("a").get_tensor().set(np.arange(3))
    kid = scope.new_scope()
    assert np.asarray(kid.find_var("a")).tolist() == [0, 1, 2]
    with tstatic.scope_guard(kid):
        assert tstatic.global_scope() is kid
    assert len(tstatic.cpu_places(2)) == 2
    assert tstatic.cuda_places() == [] or torch.cuda.is_available()
    with tstatic.name_scope("block"), tstatic.device_guard("cpu"):
        pass
    y = _static(PORT, lambda P, S, *_: S.data("x", [None, 2]) * 3.0)
    compiled = tstatic.CompiledProgram(tstatic.default_main_program()) \
        .with_data_parallel(loss_name=None)
    a = np.ones((2, 2), np.float32)
    (got,) = _exe(PORT).run(compiled, feed={"x": a}, fetch_list=[y])
    (again,) = tstatic.ParallelExecutor(
        use_cuda=False, main_program=tstatic.default_main_program()).run(
            [y], feed={"x": a})
    np.testing.assert_array_equal(got, 3 * a)
    np.testing.assert_array_equal(again, 3 * a)
    bs = tstatic.BuildStrategy()
    assert bs.reduce_strategy == tstatic.BuildStrategy.ReduceStrategy.AllReduce
    assert tstatic.ExecutionStrategy().num_iteration_per_run == 1
    assert tstatic.WeightNormParamAttr(dim=0).dim == 0


def test_a_host_read_in_static_mode_raises():
    x = _static(PORT, lambda P, S, *_: S.data("x", [None, 2]))
    tstatic.enable_static()
    try:
        with pytest.raises(RuntimeError, match="static mode"):
            float(x.sum())
    finally:
        tstatic.disable_static()


def test_in_place_updates_of_variables_record_their_values():
    """``y.add_`` and ``y[...] = v`` on a Variable: later reads see the
    update, earlier ones the value before it, as eagerly."""
    def build(P, S, *_):
        x = S.data("x", [None, 3])
        y = x * 2.0
        before = y + 0.0
        y.add_(1.0)
        y[:, 0] = 5.0
        return before, y.sum(1), y
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = _exe(PORT).run(feed={"x": a}, fetch_list=list(_static(PORT,
                                                               build)))
    eager = torch.from_numpy(a) * 2.0
    before = eager + 0.0
    eager.add_(1.0)
    eager[:, 0] = 5.0
    for g, w in zip(got, (before, eager.sum(1), eager)):
        np.testing.assert_array_equal(g, w.numpy())


def test_dropout_draws_afresh_on_every_run():
    """Dropout masks (whole, along an axis) and the attention dropout's
    Philox pair are recorded ops: two runs of a program draw other bits
    (JAX's rng_guard contract, not a key fixed when the program was
    built)."""
    def build(P, S, nn, F, I):
        # a fixed batch: the attention reshapes by the batch it reads at
        # record time, in both packages
        x = S.data("x", [2, 8, 64])
        mha = nn.MultiHeadAttention(64, 1, dropout=0.5)
        return (F.dropout(x, 0.5), F.dropout(x, 0.5, axis=1),
                mha(x, x, x))
    outs = list(_static(PORT, build))
    a = np.random.RandomState(10).randn(2, 8, 64).astype(np.float32)
    first = _exe(PORT).run(feed={"x": a}, fetch_list=outs)
    second = _exe(PORT).run(feed={"x": a}, fetch_list=outs)
    for f, s in zip(first, second):
        assert f.shape == s.shape and not np.array_equal(f, s)


def test_static_auto_cast_trains_every_parameter():
    """Under ``auto_cast`` a linear layer casts its f32 weight to bf16.
    In static mode that cast is a recorded op on the live Parameter, so
    every Parameter trains (the linear weights as well as the layer
    norm's), and the SGD losses step by step equal the dygraph twin's
    under the same ``auto_cast`` within TRAIN_TOL."""
    def build(P, S, nn, F, I):
        net = nn.Sequential(nn.Linear(4, 8), nn.LayerNorm(8), nn.ReLU(),
                            nn.Linear(8, 1))
        x, y = S.data("x", [None, 4]), S.data("y", [None, 1])
        with P.amp.auto_cast(dtype="bfloat16"):
            pred = net(x)
        loss = F.mse_loss(pred.float(), y)
        opt = P.optimizer.SGD(learning_rate=0.1,
                              parameters=net.parameters())
        opt.minimize(loss)
        return net, loss
    tp.seed(3)
    net, loss = _static(PORT, build)
    twin = tnn.Sequential(tnn.Linear(4, 8), tnn.LayerNorm(8), tnn.ReLU(),
                          tnn.Linear(8, 1))
    twin.set_state_dict({k: v.detach().clone()
                         for k, v in net.state_dict().items()})
    before = [_np(p).copy() for p in net.parameters()]
    rs = np.random.RandomState(4)
    xs = rs.randn(16, 4).astype(np.float32)
    ys = rs.randn(16, 1).astype(np.float32)
    exe = _exe(PORT)
    got = [float(exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])[0])
           for _ in range(5)]
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=twin.parameters())
    want = []
    for _ in range(5):
        with tp.amp.auto_cast(dtype="bfloat16"):
            pred = twin(torch.from_numpy(xs))
        dy = TF.mse_loss(pred.float(), torch.from_numpy(ys))
        opt.minimize(dy)
        opt.clear_grad()
        want.append(float(dy.detach()))
    assert _err(got, want) <= TRAIN_TOL
    for p, b in zip(net.parameters(), before):
        assert not np.array_equal(_np(p), b), p.name
    for p, q in zip(net.parameters(), twin.parameters()):
        assert _err(p, q) <= TRAIN_TOL


def test_minimize_refuses_a_value_computed_from_parameters_when_recorded():
    """An op on Parameters alone (no Variable among its inputs) runs while
    the program is recorded, so the program would read a copy no update
    reaches: ``minimize`` raises and names it."""
    def build(P, S, nn, F, I):
        net = nn.Linear(4, 1)
        w2 = net.weight * 2.0
        loss = S.data("x", [None, 4]).matmul(w2).sum()
        with pytest.raises(ValueError, match="computed from Parameters"):
            P.optimizer.SGD(learning_rate=0.1,
                            parameters=net.parameters()).minimize(loss)
    _static(PORT, build)
