"""The port's small modules against the JAX package's on the CPU:
``distribution``, ``nn.utils.weight_norm``, ``utils.unique_name``,
``framework.fs`` and ``callbacks``.

- distribution: ``log_prob``, ``entropy``, ``probs`` and
  ``kl_divergence`` on given values equal JAX's within 1e-6 (relative,
  f32); samples are drawn from another generator than JAX's key, so
  they are held to the distribution's moments and to themselves (one
  seed, one sample);
- weight_norm: the same ``weight_g`` / ``weight_v`` values and names as
  JAX's from the same weight, the layer's output and the gradients of
  ``g`` and ``v`` within 1e-5, and ``remove_weight_norm`` restoring the
  weight;
- unique_name: the same names as JAX's for the same calls, layers' full
  names under a guard's prefix included;
- fs: both packages over one fake ``hadoop`` CLI (a script on a local
  directory, as ``tests/test_fs_backend.py`` uses): what one writes the
  other reads, the listings agree, ``paddle.save`` / ``load`` round-trip
  over ``hdfs://``, injected faults are retried, a missing binary
  raises, and the observability writers go through ``open_for_write``;
- callbacks: the same names as JAX's re-export.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import math
import os
import stat

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu import distribution as JD
from paddle_tpu.framework import fs as jfs
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import distribution as TD
from paddle_tpu_torch.framework import fs as tfs
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.utils import unique_name as tun

from test_fs_backend import FAKE_HADOOP


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x.data)


# ---- distribution --------------------------------------------------------
LOC = np.array([0.5, -1.0, 2.0], np.float32)
SCALE = np.array([1.5, 0.3, 2.0], np.float32)
LOGITS = np.array([[0.1, -0.7, 1.2, 0.0], [2.0, 0.5, -1.0, 0.3]],
                  np.float32)


def _pairs():
    """(name, build(D), values, other build(D) or None)."""
    return [
        ("normal", lambda D: D.Normal(LOC, SCALE),
         np.array([0.0, -0.8, 5.0], np.float32),
         lambda D: D.Normal(np.float32(0.2), np.float32(1.1))),
        ("uniform", lambda D: D.Uniform(np.float32(-1.0), np.float32(3.0)),
         np.array([-2.0, -1.0, 0.5, 2.999, 3.0], np.float32), None),
        ("categorical", lambda D: D.Categorical(LOGITS),
         np.array([2, 3], np.int64),
         lambda D: D.Categorical(LOGITS[::-1].copy())),
    ]


@pytest.mark.parametrize("case", _pairs(), ids=lambda c: c[0])
def test_distribution_matches_jax(case):
    _, build, values, other = case
    jd, td = build(JD), build(TD)
    np.testing.assert_allclose(_np(td.entropy()), _np(jd.entropy()),
                               rtol=1e-6)
    jv = jp.to_tensor(values)
    tv = torch.from_numpy(values)
    for fn in ("log_prob", "probs"):
        np.testing.assert_allclose(_np(getattr(td, fn)(tv)),
                                   _np(getattr(jd, fn)(jv)), rtol=1e-6)
    if other is not None:
        np.testing.assert_allclose(
            _np(TD.kl_divergence(td, other(TD))),
            _np(JD.kl_divergence(jd, other(JD))), rtol=1e-6)


def test_distribution_samples():
    """Moments of the port's samples; one seed gives one sample."""
    d = TD.Normal(1.5, 2.0)
    s = d.sample((20000,), seed=3)
    assert abs(float(s.mean()) - 1.5) < 0.1
    assert abs(float(s.std()) - 2.0) < 0.1
    assert torch.equal(s, d.sample((20000,), seed=3))
    assert not torch.equal(s, d.sample((20000,), seed=4))
    u = TD.Uniform(-1.0, 3.0).sample((10000,), seed=1)
    assert float(u.min()) >= -1.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 1.0) < 0.05
    c = TD.Categorical(np.log(np.array([0.2, 0.3, 0.5], np.float32)))
    draws = c.sample((20000,), seed=2)
    assert tuple(draws.shape) == (20000,)
    freq = np.bincount(draws.numpy(), minlength=3) / 20000
    np.testing.assert_allclose(freq, [0.2, 0.3, 0.5], atol=0.02)
    batch = TD.Categorical(LOGITS).sample((5, 7), seed=0)
    assert tuple(batch.shape) == (5, 7, 2)
    nb = TD.Normal(LOC, SCALE).sample((4,), seed=0)
    assert tuple(nb.shape) == (4, 3)
    kl = float(TD.kl_divergence(TD.Normal(0.0, 1.0), TD.Normal(1.0, 2.0)))
    np.testing.assert_allclose(kl, math.log(2.0) + 2 / 8 - 0.5, rtol=1e-6)


@pytest.mark.parametrize("build", [lambda: TD.Normal(0.0, 1.0),
                                   lambda: TD.Uniform(-1.0, 3.0),
                                   lambda: TD.Categorical(LOGITS)],
                         ids=["normal", "uniform", "categorical"])
def test_distribution_default_seed_draws_afresh(build):
    """At seed 0 (the default) every call draws anew from the port's
    generator, as JAX's ``next_key`` does; ``paddle.seed`` replays the
    sequence."""
    d = build()
    tp.seed(11)
    a, b = d.sample((64,)), d.sample((64,))
    assert a.device.type == "cpu"
    assert not torch.equal(a, b)
    tp.seed(11)
    assert torch.equal(a, d.sample((64,)))


# ---- weight_norm ---------------------------------------------------------
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    rng = np.random.RandomState(dim or 7)
    w = rng.randn(5, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    x = rng.randn(4, 5).astype(np.float32)
    cot = rng.randn(4, 3).astype(np.float32)
    jl, tl = jnn.Linear(5, 3), tnn.Linear(5, 3)
    jl.set_state_dict({"weight": jp.to_tensor(w), "bias": jp.to_tensor(b)})
    tl.set_state_dict({"weight": w, "bias": b})
    jnn.utils.weight_norm(jl, "weight", dim=dim)
    tnn.utils.weight_norm(tl, "weight", dim=dim)
    jnames = [n for n, _ in jl.named_parameters()]
    assert [n for n, _ in tl.named_parameters()] == jnames
    for n, p in jl.named_parameters():
        np.testing.assert_allclose(_np(dict(tl.named_parameters())[n]),
                                   _np(p), rtol=1e-6, atol=1e-7)
    out_j = jl(jp.to_tensor(x))
    (out_j * jp.to_tensor(cot)).sum().backward()
    out_t = tl(torch.from_numpy(x))
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=1e-5)
    for n, p in jl.named_parameters():
        np.testing.assert_allclose(
            dict(tl.named_parameters())[n].grad.numpy(), _np(p.grad),
            atol=1e-5)
    with pytest.raises(ValueError):
        tnn.utils.weight_norm(tl, "weight", dim=dim)
    tnn.utils.remove_weight_norm(tl, "weight")
    names = [n for n, _ in tl.named_parameters()]
    assert "weight" in names and "weight_g" not in names
    np.testing.assert_allclose(tl.weight.detach().numpy(), w, atol=1e-6)
    with pytest.raises(ValueError):
        tnn.utils.remove_weight_norm(tl, "weight")


# ---- unique_name ---------------------------------------------------------
def test_unique_name_matches_jax():
    def names(un, nn):
        out = []
        with un.guard():
            out += [un.generate("fc"), un.generate("fc"),
                    un.generate("conv"), nn.Linear(2, 2).full_name(),
                    nn.Linear(2, 2).full_name()]
        with un.guard("ns1_"):
            out += [un.generate("fc"), nn.Linear(2, 2).full_name(),
                    nn.LSTM(2, 2).full_name()]
        with un.guard("ns2_"):
            out += [un.generate("fc"), nn.Linear(2, 2).full_name()]
        return out

    before = tnn.Linear(2, 2).full_name()
    got, want = names(tun, tnn), names(jun, jnn)
    assert got == want
    assert got[5:8] == ["ns1_fc_0", "ns1_linear_0", "ns1_lstm_0"]
    # the counters outside the guards continue where they were
    after = tnn.Linear(2, 2).full_name()
    assert int(after.rsplit("_", 1)[1]) == int(before.rsplit("_", 1)[1]) + 1
    with pytest.raises(TypeError):
        with tun.guard(3):
            pass


# ---- fs ------------------------------------------------------------------
@pytest.fixture
def fake_hdfs(tmp_path, monkeypatch):
    bin_path = tmp_path / "hadoop"
    bin_path.write_text(FAKE_HADOOP)
    bin_path.chmod(bin_path.stat().st_mode | stat.S_IEXEC)
    root = tmp_path / "hdfs_root"
    root.mkdir()
    monkeypatch.setenv("PADDLE_HADOOP_BIN", str(bin_path))
    monkeypatch.setenv("FAKE_HDFS_ROOT", str(root))
    return root


def test_fs_dispatch_and_local_write(tmp_path):
    for path in ("/tmp/x", "hdfs://ns/a", "afs://x/y", "rel/p"):
        assert type(tfs.get_fs(path)).__name__ == \
            type(jfs.get_fs(path)).__name__
    p = str(tmp_path / "sub" / "f.bin")
    with tfs.open_for_write(p) as f:
        f.write(b"hello")
    assert open(p, "rb").read() == b"hello"
    assert not os.path.exists(p + ".tmp")
    with pytest.raises(RuntimeError):
        with tfs.open_for_write(p) as f:
            f.write(b"partial")
            raise RuntimeError("crash")
    assert open(p, "rb").read() == b"hello"
    assert not os.path.exists(p + ".tmp")
    with tfs.open_for_read(p) as f:
        assert f.read() == b"hello"


def test_fs_over_fake_hdfs_against_jax(fake_hdfs):
    """Each package reads what the other wrote; listings, exists and
    remove agree."""
    with jfs.open_for_write("hdfs://ns/d/from_jax.bin") as f:
        f.write(b"jax bytes")
    with tfs.open_for_write("hdfs://ns/d/from_port.bin") as f:
        f.write(b"port bytes")
    with tfs.open_for_read("hdfs://ns/d/from_jax.bin") as f:
        assert f.read() == b"jax bytes"
    with jfs.open_for_read("hdfs://ns/d/from_port.bin") as f:
        assert f.read() == b"port bytes"
    t, j = tfs.get_fs("hdfs://ns/d"), jfs.get_fs("hdfs://ns/d")
    assert t.list_dir("hdfs://ns/d") == j.list_dir("hdfs://ns/d") == \
        ["from_jax.bin", "from_port.bin"]
    assert t.exists("hdfs://ns/d/from_jax.bin")
    t.remove("hdfs://ns/d/from_jax.bin")
    assert not j.exists("hdfs://ns/d/from_jax.bin")
    sd = {"w": torch.arange(6, dtype=torch.float32)}
    tp.save(sd, "hdfs://ns/models/lin.pdparams")
    back = tp.load("hdfs://ns/models/lin.pdparams")
    assert torch.equal(back["w"], sd["w"])
    jback = jp.load("hdfs://ns/models/lin.pdparams")
    np.testing.assert_array_equal(np.asarray(jback["w"].data),
                                  np.arange(6, dtype=np.float32))


def test_fs_faults_are_retried(fake_hdfs, monkeypatch):
    """An injected fault on the first ``run`` is retried (the command
    then succeeds); more faults than tries raise ``InjectedFault``; a
    delay only slows the op."""
    tfaults.reset()
    monkeypatch.setenv("PADDLE_FAULT_FS", "run:1")
    with tfs.open_for_write("hdfs://ns/r/a.bin") as f:
        f.write(b"x")
    monkeypatch.setenv("PADDLE_FAULT_FS", "run:1:5")
    monkeypatch.setenv("PADDLE_TPU_FS_RETRIES", "2")
    tfaults.reset()
    with pytest.raises(tfaults.InjectedFault):
        tfs.HadoopFS().exists("hdfs://ns/r/a.bin")
    monkeypatch.delenv("PADDLE_FAULT_FS")
    monkeypatch.setenv("PADDLE_FAULT_FS_DELAY_MS", "exists:1")
    assert tfs.LocalFS().exists(str(fake_hdfs))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return len(calls)

    assert tfs.retry_with_backoff(flaky, tries=3, sleep=lambda s: None) == 3
    tfaults.reset()


def test_fs_missing_hadoop_binary_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_HADOOP_BIN", "/nonexistent/hadoop")
    with pytest.raises(RuntimeError, match="hadoop CLI"):
        tfs.HadoopFS().exists("hdfs://x/y")


def test_writers_go_through_fs(tmp_path, monkeypatch):
    """The span trace, the metrics snapshot and static.save write through
    ``open_for_write``: an injected ``open_write`` fault reaches them."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.observability import metrics, spans
    tfaults.reset()
    monkeypatch.setenv("PADDLE_FAULT_FS", "open_write:1:3")
    with pytest.raises(tfaults.InjectedFault):
        spans.SpanTracer().export(str(tmp_path / "t.json"))
    with pytest.raises(tfaults.InjectedFault):
        metrics.Registry().write_snapshot(str(tmp_path / "m.jsonl"))
    with pytest.raises(tfaults.InjectedFault):
        static.save(static.Program(), str(tmp_path / "p"))
    monkeypatch.delenv("PADDLE_FAULT_FS")
    tfaults.reset()
    assert spans.SpanTracer().export(str(tmp_path / "t.json"))
    assert not os.path.exists(str(tmp_path / "t.json.tmp"))


# ---- callbacks -----------------------------------------------------------
def test_callbacks_reexport():
    import paddle_tpu.callbacks as jcb
    names = [n for n in dir(jcb) if not n.startswith("_") and
             isinstance(getattr(jcb, n), type)]
    for n in names:
        assert getattr(tp.callbacks, n) is getattr(tp.hapi.callbacks, n)
    assert set(tp.callbacks.__all__) == set(names)
