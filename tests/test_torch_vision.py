"""The port's vision path against the JAX package's, on the CPU.

- batch-norm running statistics after three ``Model.train_batch`` steps
  (Momentum) of a small conv / batch-norm net, and the losses;
- ``resnet18``'s forward in train mode (2 x 3 x 64 x 64) and eval mode
  (2 x 3 x 32 x 32) and its parameter gradients, weights carried from
  JAX through
  ``set_state_dict`` (the JAX side staged under one ``jax.jit`` a mode);
- ``resnet50``'s state-dict names and shapes;
- ``summary`` / ``flops`` on ``LeNet`` and ``resnet18``;
- ``FakeData`` and ``MNIST(mode='synthetic')`` draws;
- three ``Model.train_batch`` steps of ``LeNet`` under Momentum;
- a recomputed block's running statistics against the plain run's, the
  names that raised before this slice, and the ones that still raise.

Tolerances (f32 on both sides): running statistics within 1e-6
relative (STATS_RTOL; a running mean, a cancelling sum near 0, also
within 1e-6 of its layer's standard deviation), the losses within 1e-5
relative (LOSS_RTOL), resnet18's output and every gradient within 1e-4
of its own largest magnitude (NET_TOL; worst measured 1.9e-5, train
mode).  Summaries, flops and ``FakeData`` are equal.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.vision as jv

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.vision as tv
from paddle_tpu_torch.distributed import recompute

STATS_RTOL = 1e-6
LOSS_RTOL = 1e-5
NET_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU.  JAX compiles each op (or each staged
    program) once: these compiles skip XLA's optimization passes and the
    persistent cache (none is reused)."""
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
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t.data)


def _state(jnet):
    return {n: np.asarray(v.data) for n, v in jnet.state_dict().items()}


def _within(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"{what}: {err} vs {tol} x {scale}"


def _conv_bn(nn):
    """LeNet's feature shapes with a batch norm after each convolution
    (the JAX tape compiles each op once per shape: LeNet's test reuses
    these)."""
    return nn.Sequential(
        nn.Conv2D(1, 6, 3, padding=1, bias_attr=False), nn.BatchNorm2D(6),
        nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Conv2D(6, 16, 5, bias_attr=False), nn.BatchNorm2D(16),
        nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(), nn.Linear(400, 10))


def _train_three(jnet, tnet, shape, classes, lr):
    """Three ``train_batch`` steps of both Models under Momentum on the
    same batches -> the per-step losses of each."""
    tnet.set_state_dict(_state(jnet))
    jm, tm = jp.Model(jnet), tp.Model(tnet)
    jm.prepare(jp.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                     parameters=jnet.parameters()),
               jnn.CrossEntropyLoss())
    tm.prepare(tp.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                     parameters=tnet.parameters()),
               tnn.CrossEntropyLoss())
    rng = np.random.RandomState(4)
    jl, tl = [], []
    for _ in range(3):
        x = rng.randn(*shape).astype(np.float32)
        y = rng.randint(0, classes, (shape[0], 1)).astype(np.int64)
        jl.append(jm.train_batch([x], [y])[0])
        tl.append(tm.train_batch([x], [y])[0])
    return np.asarray(jl, np.float64).ravel(), np.asarray(tl).ravel()


def test_running_statistics_after_three_steps_match_jax():
    """Paddle's rule: momentum 0.9 on the running side, the biased batch
    variance, the update outside the differentiated function."""
    jnet, tnet = _conv_bn(jnn), _conv_bn(tnn)
    jl, tl = _train_three(jnet, tnet, (4, 1, 28, 28), 10, 0.05)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jstate = _state(jnet)
    names = [n for n in jstate if n.endswith(("_mean", "_variance"))]
    assert len(names) == 4
    for n in names:
        got = _np(tnet.state_dict()[n])
        assert not np.allclose(got, 0.0 if "mean" in n else 1.0), n
        # a mean near 0 is a cancelling sum: held to the layer's spread
        spread = np.sqrt(jstate[n.replace("_mean", "_variance")].max())
        np.testing.assert_allclose(got, jstate[n], rtol=STATS_RTOL,
                                   atol=STATS_RTOL * spread, err_msg=n)


def _jax_resnet_run(jnet, x, cot, training):
    """JAX resnet18's output and parameter gradients of ``sum(out *
    cot)``, staged under one ``jax.jit`` with the built state as its
    argument."""
    state = _state(jnet)
    jnet.train() if training else jnet.eval()

    def run(xa, st):
        # the weights enter as arguments, not as constants of the program
        jnet.set_state_dict({n: jp.Tensor(v) for n, v in st.items()})
        out = jnet(jp.Tensor(xa))
        (out * jp.Tensor(cot)).sum().backward()
        grads = {n: p.grad.data for n, p in jnet.named_parameters()
                 if p.grad is not None}
        return out.data, grads

    out, grads = jax.jit(run)(x, state)
    jnet.clear_gradients()
    jnet.set_state_dict(state)
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("training,side", [(True, 64), (False, 32)],
                         ids=["train", "eval"])
def test_resnet18_forward_and_grads_match_jax(training, side):
    """Train mode runs at 64 x 64: at 32 x 32 the last stage's batch
    norms see two values a channel (batch 2, 1 x 1), whose normalized
    difference amplifies f32 rounding (each package 1e-3 from an f64
    run on the output, 1e-2 apart on gradients); at 64 x 64 they see
    eight."""
    jp.seed(5)
    jnet = jv.resnet18(num_classes=10)
    tnet = tv.resnet18(num_classes=10)
    rng = np.random.RandomState(6)
    state = _state(jnet)
    if not training:
        # non-trivial running statistics for eval mode
        for n in state:
            if n.endswith("_mean"):
                state[n] = rng.uniform(-0.2, 0.2, state[n].shape).astype(
                    np.float32)
            elif n.endswith("_variance"):
                state[n] = rng.uniform(0.5, 1.5, state[n].shape).astype(
                    np.float32)
        jnet.set_state_dict(state)
    tnet.set_state_dict(state)
    x = rng.randn(2, 3, side, side).astype(np.float32)
    cot = rng.randn(2, 10).astype(np.float32)
    jout, jgrads = _jax_resnet_run(jnet, x, cot, training)
    tnet.train() if training else tnet.eval()
    out = tnet(torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()
    _within(out.detach().numpy(), jout, NET_TOL, "output")
    tgrads = {n: p.grad.numpy() for n, p in tnet.named_parameters()
              if p.grad is not None}
    assert sorted(tgrads) == sorted(jgrads) and len(tgrads) == 62
    for n, g in jgrads.items():
        _within(tgrads[n], g, NET_TOL, n)


def test_resnet50_state_dict_names_and_shapes_match_jax():
    jshapes = []

    def build():
        # shapes only: the JAX initializers are traced, not run
        jshapes.extend((n, tuple(v.shape))
                       for n, v in jv.resnet50().state_dict().items())
        return jax.numpy.zeros(())

    jax.eval_shape(build)
    tstate = tv.resnet50().state_dict()
    assert [(n, tuple(v.shape)) for n, v in tstate.items()] == jshapes
    assert sum(v.numel() for n, v in tstate.items()
               if not n.endswith(("_mean", "_variance"))) == 25557032


@pytest.mark.parametrize("model,size", [("LeNet", (1, 1, 28, 28)),
                                        ("resnet18", (1, 3, 32, 32))])
def test_summary_and_flops_match_jax(model, size):
    jnet, tnet = getattr(jv, model)(), getattr(tv, model)()
    printed, jflops = [], []

    def jax_side():
        # shapes only: traced abstractly, nothing compiled
        printed.append(jp.summary(jnet, size))
        jflops.append(jp.flops(jnet, list(size)))
        return jax.numpy.zeros(())

    for run in (lambda: jax.eval_shape(jax_side),
                lambda: printed.append(tp.summary(tnet, size))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        printed.append(buf.getvalue())
    assert printed[2:] == printed[:2]
    assert tp.flops(tnet, list(size)) == jflops[0]
    model_obj = tp.Model(tnet)
    with contextlib.redirect_stdout(io.StringIO()):
        assert model_obj.summary(size) == printed[0]


def test_fake_data_and_synthetic_mnist_draw_as_jax():
    for kw in ({}, {"size": 7, "image_shape": (3, 8, 8), "num_classes": 4,
                    "seed": 3, "class_seed": 9}):
        jd, td = jv.datasets.FakeData(**kw), tv.datasets.FakeData(**kw)
        assert len(td) == len(jd)
        for i in (0, 1, len(jd) - 1):
            (ji, jl), (ti, tl) = jd[i], td[i]
            assert ti.dtype == ji.dtype and np.array_equal(ti, ji)
            assert tl == jl
    jm = jv.datasets.MNIST(mode="synthetic")
    tm = tv.datasets.MNIST(mode="synthetic")
    assert len(tm) == len(jm) == 256
    assert np.array_equal(tm.images, jm.images)
    assert np.array_equal(tm.labels, jm.labels)


def test_lenet_train_batch_losses_match_jax():
    jnet, tnet = jv.LeNet(), tv.LeNet()
    jl, tl = _train_three(jnet, tnet, (4, 1, 28, 28), 10, 0.01)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def test_recomputed_block_updates_running_statistics_once():
    """``distributed.recompute`` replays the block in the backward; the
    batch norm's running statistics equal the plain run's."""
    torch.manual_seed(0)
    plain = _conv_bn(tnn)
    again = _conv_bn(tnn)
    again.set_state_dict(plain.state_dict())
    x = torch.randn(4, 1, 28, 28)
    plain(x).sum().backward()
    recompute(again, x).sum().backward()
    for (n, a), b in zip(plain.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
        if n.endswith("weight"):
            p = dict(plain.named_parameters())[n]
            q = dict(again.named_parameters())[n]
            torch.testing.assert_close(q.grad, p.grad)


def test_vision_layers_that_raised_now_build_and_run():
    x = torch.randn(2, 4, 6, 6)
    for layer in (tnn.BatchNorm(4), tnn.BatchNorm1D(4), tnn.BatchNorm2D(4),
                  tnn.BatchNorm3D(4), tnn.SyncBatchNorm(4),
                  tnn.GroupNorm(2, 4), tnn.InstanceNorm1D(4),
                  tnn.InstanceNorm2D(4), tnn.InstanceNorm3D(4),
                  tnn.LocalResponseNorm(3), tnn.RMSNorm(6)):
        inp = {1: x[:, :, 0], 3: x.unsqueeze(2)}.get(
            {"BatchNorm1D": 1, "InstanceNorm1D": 1, "BatchNorm3D": 3,
             "InstanceNorm3D": 3}.get(type(layer).__name__), x)
        assert layer(inp).shape == inp.shape, type(layer).__name__
    assert tnn.SpectralNorm([4, 6])(torch.randn(4, 6)).shape == (4, 6)
    net = tnn.SyncBatchNorm.convert_sync_batchnorm(tv.resnet18())
    assert isinstance(net.bn1, tnn.SyncBatchNorm)
    assert isinstance(net.layer1[0].bn2, tnn.SyncBatchNorm)


def test_detection_ops_and_dataset_files_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 3\.5\.1"):
        tv.ops.nms(torch.zeros(1, 4), torch.zeros(1))
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 3\.5\)"):
        tv.datasets.MNIST(mode="train")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 3\.5\)"):
        tv.datasets.Cifar10()
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 3\.5\)"):
        tv.datasets.DatasetFolder("x")
    with pytest.raises(RuntimeError, match="pretrained"):
        tv.resnet50(pretrained=True)
