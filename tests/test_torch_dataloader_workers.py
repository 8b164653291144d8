"""The port's DataLoader workers (``paddle_tpu_torch.io``) against the JAX
package's, on the CPU: the shared-memory ring, fork workers, the thread
prefetcher, restarts and the worker-kill fault.

Every loader that forks is given a ``timeout``, so a hang fails the test
instead of the run; W = 2 workers and frames of a few KB.  Batches are
compared bitwise (``np.array_equal``): both packages collate the same
numpy samples.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)

import multiprocessing as mp
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp

import paddle_tpu_torch as tp
from paddle_tpu_torch.io import dataloader as tdl
from paddle_tpu_torch.io import shm_ring
from paddle_tpu_torch.io.shm_ring import (RingClosed, RingTimeout, ShmRing,
                                          available)
from paddle_tpu_torch.ops._build import BUILD_DIR

from torch_cpu import unoptimized_jax_compiles  # noqa: F401

TIMEOUT = 60


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tp.set_device("cpu")


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch, tmp_path):
    """No fault armed unless a test arms one; bundles of the worker-kill
    fault land in the test's own directory."""
    monkeypatch.delenv("PADDLE_FAULT_WORKER_KILL", raising=False)
    monkeypatch.delenv("PADDLE_TPU_WORKER_RESTARTS", raising=False)
    monkeypatch.setenv("PADDLE_TPU_FLIGHTREC_DIR", str(tmp_path / "fr"))


class SquareDS:
    def __len__(self):
        return 37

    def __getitem__(self, i):
        return (np.full((3, 4), i, np.float32), np.array([i * i], np.int64))


class ArangeDS:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.full(2, i, np.float32)


def _port(loader):
    return [[t.numpy() for t in b] if isinstance(b, list) else [b.numpy()]
            for b in loader]


def _jax(loader):
    return [[np.asarray(t.data) for t in b] if isinstance(b, list)
            else [np.asarray(b.data)] for b in loader]


def _same(a, b, jax_side=False):
    """Equal batches; against the JAX package, whose int64 arrays become
    int32 (64-bit types off), the port's dtype canonicalized first."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            dt = jax.dtypes.canonicalize_dtype(u.dtype) if jax_side \
                else u.dtype
            assert dt == v.dtype and np.array_equal(u, v)


def test_ring_library_builds_into_the_build_dir():
    assert available()
    so = shm_ring.library_path(shm_ring._compiler())
    assert os.path.dirname(so) == str(BUILD_DIR) and os.path.exists(so)
    assert os.path.basename(so).startswith("shm_ring-")
    assert shm_ring._SRC.endswith(os.path.join("paddle_tpu_torch", "io",
                                               "native", "shm_ring.c"))


def test_no_compiler_means_not_available(monkeypatch):
    monkeypatch.setattr(shm_ring, "_lib", None)
    monkeypatch.setattr(shm_ring, "_lib_err", None)
    monkeypatch.setenv("CC", "/nonexistent/cc")
    assert not available()
    loader = tp.io.DataLoader(ArangeDS(), batch_size=2, num_workers=2)
    assert not loader._can_multiprocess()
    # the thread prefetcher takes over, as in the JAX package
    got = _port(loader)
    assert loader.worker_stats["mode"] == "threads" and len(got) == 4


def test_ring_round_trip_and_order():
    r = ShmRing.create(1 << 16)
    try:
        msgs = [os.urandom(n) for n in (1, 7, 8, 100, 4096)]
        for m in msgs:
            r.push(m)
        assert [r.pop() for _ in msgs] == msgs
    finally:
        r.destroy()


def test_ring_wraps_around_a_small_capacity():
    r = ShmRing.create(1 << 10)
    try:
        rng = np.random.RandomState(0)
        produced = [bytes(rng.bytes(int(rng.randint(1, 200))))
                    for _ in range(200)]
        got = []
        for m in produced:
            r.push(m, timeout_ms=2000)
            if len(produced) - len(got) > 3:
                got.append(r.pop(timeout_ms=2000))
        while len(got) < len(produced):
            got.append(r.pop(timeout_ms=2000))
        assert got == produced
    finally:
        r.destroy()


def test_ring_close_timeout_and_oversize():
    r = ShmRing.create(1 << 10)
    try:
        with pytest.raises(RingTimeout):
            r.pop(timeout_ms=50)
        with pytest.raises(ValueError, match="half the ring"):
            r.push(b"x" * 600)
        r.push(b"last")
        r.close_writer()
        assert r.pop() == b"last"
        with pytest.raises(RingClosed):
            r.pop()
        with pytest.raises(RingClosed):
            r.push(b"nope")
    finally:
        r.destroy()
    assert not os.path.exists(f"/dev/shm/{r.name}")


def test_ring_across_processes():
    r = ShmRing.create(1 << 20)

    def produce(name):
        w = ShmRing.attach(name)
        for i in range(50):
            w.push(bytes([i]) * (i + 1))
        w.close_writer()

    p = mp.get_context("fork").Process(target=produce, args=(r.name,))
    p.start()
    try:
        for i in range(50):
            assert r.pop(timeout_ms=10000) == bytes([i]) * (i + 1)
        with pytest.raises(RingClosed):
            r.pop(timeout_ms=10000)
    finally:
        p.join(10)
        r.destroy()
    assert p.exitcode == 0


@pytest.mark.parametrize("shuffle", [False, True])
def test_worker_batches_equal_the_jax_loader(shuffle):
    """W = 2 fork workers against the JAX package's fork workers over the
    same dataset and sampler (the shuffle drawn from numpy's global
    generator, seeded alike)."""
    np.random.seed(3)
    want = _jax(jp.io.DataLoader(SquareDS(), batch_size=5, shuffle=shuffle,
                                 num_workers=2, timeout=TIMEOUT))
    np.random.seed(3)
    loader = tp.io.DataLoader(SquareDS(), batch_size=5, shuffle=shuffle,
                              num_workers=2, timeout=TIMEOUT)
    got = _port(loader)
    _same(got, want, jax_side=True)
    st = loader.worker_stats
    assert st["mode"] == "processes" and st["popped"] == len(got) == 8
    assert len(set(st["pids"])) == 2 and os.getpid() not in st["pids"]
    assert st["producers"] == set(st["pids"])
    assert len(st["fork_ms"]) == 2 and st["restarts"] == 0
    assert len(st["pop_ms"]) == len(st["unpickle_ms"]) == 8
    np.random.seed(3)
    _same(got, _port(tp.io.DataLoader(SquareDS(), batch_size=5,
                                      shuffle=shuffle)))


def test_tensor_samples_through_workers():
    """torch CPU tensors collate in the workers and pickle across."""
    x = torch.arange(60, dtype=torch.float32).reshape(20, 3)
    y = torch.arange(20)
    ds = tp.io.TensorDataset([x, y])
    loader = tp.io.DataLoader(ds, batch_size=6, num_workers=2,
                              timeout=TIMEOUT)
    got = _port(loader)
    assert loader.worker_stats["mode"] == "processes"
    _same(got, _port(tp.io.DataLoader(ds, batch_size=6)))


class WhoDS:
    """Each sample records the worker that made it and what its init
    function set."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        info = tdl.get_worker_info()
        return np.array([i, info.id, info.num_workers, INIT_SEEN.get("w", -1)],
                        np.int64)


INIT_SEEN = {}


def _init(w):
    INIT_SEEN["w"] = 100 + w


def test_worker_init_fn_and_get_worker_info_inside_workers():
    assert tdl.get_worker_info() is None
    loader = tp.io.DataLoader(WhoDS(), batch_size=1, num_workers=2,
                              worker_init_fn=_init, timeout=TIMEOUT)
    rows = [b[0] for (b,) in _port(loader)]
    assert [r.tolist() for r in rows] == [
        [i, i % 2, 2, 100 + i % 2] for i in range(6)]
    assert tdl.get_worker_info() is None and "w" not in INIT_SEEN
    info = tp.io.WorkerInfo(1, 4, None)
    assert info.id == 1 and info.num_workers == 4
    assert repr(info) == "WorkerInfo(id=1, num_workers=4)"


class BadDS:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 corrupt")
        return np.zeros(2, np.float32)


def test_dataset_error_comes_back_with_its_traceback():
    loader = tp.io.DataLoader(BadDS(), batch_size=2, num_workers=2,
                              worker_restarts=3, timeout=TIMEOUT)
    with pytest.raises(RuntimeError) as err:
        _port(loader)
    msg = str(err.value)
    assert "dataloader worker 0 failed" in msg
    assert "Traceback" in msg and "__getitem__" in msg
    assert "ValueError: sample 5 corrupt" in msg
    # a dataset error is deterministic: no restart is spent on it
    assert loader.worker_stats["restarts"] == 0


def test_frame_over_half_the_ring_raises():
    class Big:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.zeros(4096, np.float32)

    loader = tp.io.DataLoader(Big(), batch_size=2, num_workers=2,
                              shm_ring_capacity=1 << 14, timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="half the ring"):
        _port(loader)


@pytest.mark.parametrize("via_env", [False, True])
def test_killed_worker_restarts_to_identical_batches(monkeypatch, via_env):
    """Worker 1 exits 137 after its first batch (PADDLE_FAULT_WORKER_KILL
    "1:1"), without closing its ring; it is forked again from the first
    batch the consumer has not received (and dies again after it, its
    last).  The restart budget comes from the argument or from
    PADDLE_TPU_WORKER_RESTARTS."""
    monkeypatch.setenv("PADDLE_FAULT_WORKER_KILL", "1:1")
    if via_env:
        monkeypatch.setenv("PADDLE_TPU_WORKER_RESTARTS", "1")
        loader = tp.io.DataLoader(ArangeDS(), batch_size=2, num_workers=2,
                                  timeout=TIMEOUT)
    else:
        loader = tp.io.DataLoader(ArangeDS(), batch_size=2, num_workers=2,
                                  worker_restarts=1, timeout=TIMEOUT)
    assert loader.worker_restarts == 1
    got = _port(loader)
    monkeypatch.delenv("PADDLE_FAULT_WORKER_KILL")
    _same(got, _jax(jp.io.DataLoader(ArangeDS(), batch_size=2,
                                     num_workers=2, timeout=TIMEOUT)),
          jax_side=True)
    st = loader.worker_stats
    assert st["restarts"] == 1 and len(st["pids"]) == 3
    assert st["producers"] == set(st["pids"]) and len(st["rings"]) == 3
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in st["rings"])
    # the killed worker left a flight-recorder bundle first
    bundles = [d for d in os.listdir(os.environ["PADDLE_TPU_FLIGHTREC_DIR"])
               if d.endswith("-worker_kill")]
    assert bundles and all(
        tp.observability.flightrec.load_bundle(os.path.join(
            os.environ["PADDLE_TPU_FLIGHTREC_DIR"], d))["bundle"]["reason"]
        == "worker_kill" for d in bundles)


def test_killed_worker_without_restarts_raises_naming_it(monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_WORKER_KILL", "1:1")
    loader = tp.io.DataLoader(ArangeDS(), batch_size=2, num_workers=2,
                              worker_restarts=0, timeout=TIMEOUT)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"worker 1 died before producing "
                                           r"batch 3 \(exitcode 137"):
        _port(loader)
    assert time.monotonic() - t0 < TIMEOUT


def test_a_stalled_worker_times_out():
    class Slow:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            time.sleep(3.0)
            return np.zeros(1, np.float32)

    loader = tp.io.DataLoader(Slow(), batch_size=1, num_workers=2,
                              timeout=0.6)
    with pytest.raises(RuntimeError, match="worker 0 timed out"):
        _port(loader)


def test_early_break_leaves_no_child_and_no_shared_memory():
    loader = tp.io.DataLoader(SquareDS(), batch_size=2, num_workers=2,
                              timeout=TIMEOUT)
    for _ in loader:
        break
    names = loader.worker_stats["rings"]
    assert len(names) == 2
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)
    assert mp.active_children() == []


class StreamDS(tp.io.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.full(3, i, np.float32)


class JStreamDS(jp.io.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.full(3, i, np.float32)


@pytest.mark.parametrize("drop_last", [False, True])
def test_thread_prefetcher_serves_an_iterable_dataset(drop_last):
    loader = tp.io.DataLoader(StreamDS(), batch_size=3, num_workers=2,
                              drop_last=drop_last)
    assert not loader._can_multiprocess()
    got = _port(loader)
    assert loader.worker_stats["mode"] == "threads"
    _same(got, _jax(jp.io.DataLoader(JStreamDS(), batch_size=3,
                                     num_workers=2, drop_last=drop_last)),
          jax_side=True)
    assert len(got) == (3 if drop_last else 4)


def test_prefetcher_delivers_iterator_errors_and_joins_on_break():
    def make():
        def gen():
            yield lambda: 1
            raise KeyError("the iterator broke")
        return gen()

    with pytest.raises(KeyError, match="the iterator broke"):
        list(tdl._Prefetcher(make, 2, 4))

    before = {t.name for t in threading.enumerate()}
    it = iter(tdl._Prefetcher(lambda: (lambda i=i: i for i in range(100)),
                              3, 2))
    assert next(it) == 0
    it.close()
    left = {t.name for t in threading.enumerate()} - before
    assert not [n for n in left if n.startswith("pd-prefetch")]


def test_single_process_modes():
    """``use_shared_memory=False`` or ``use_buffer_reader=False`` keep the
    batches in the threads or this process, as in the JAX package."""
    want = _port(tp.io.DataLoader(SquareDS(), batch_size=4))
    a = tp.io.DataLoader(SquareDS(), batch_size=4, num_workers=2,
                         use_shared_memory=False)
    _same(_port(a), want)
    assert a.worker_stats["mode"] == "threads"
    b = tp.io.DataLoader(SquareDS(), batch_size=4, num_workers=2,
                         use_shared_memory=False, use_buffer_reader=False)
    _same(_port(b), want)
    assert b.worker_stats["mode"] == "main"
    assert len(b.worker_stats["h2d_ms"]) == len(want) == 10


def test_model_fit_forks_its_workers():
    """``Model.fit(num_workers=2)`` builds a loader that forks, as the JAX
    package's does, and trains as with ``num_workers=0``."""
    class Pairs:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            r = np.random.RandomState(i)
            return (r.randn(4).astype(np.float32),
                    np.array([i % 2], np.int64))

    weights = []
    for workers in (0, 2):
        tp.seed(4)
        net = tp.nn.Linear(4, 2)
        m = tp.Model(net)
        m.prepare(tp.optimizer.SGD(learning_rate=0.1,
                                   parameters=net.parameters()),
                  tp.nn.CrossEntropyLoss())
        loader = m._as_loader(Pairs(), 4, False, False, workers)
        assert loader._can_multiprocess() == (workers > 0)
        np.random.seed(5)  # the fit's shuffle
        m.fit(Pairs(), batch_size=4, epochs=1, verbose=0,
              num_workers=workers)
        weights.append(net.weight.detach().clone())
    assert torch.equal(weights[0], weights[1])
    assert not torch.equal(weights[0], tp.nn.Linear(4, 2).weight)
