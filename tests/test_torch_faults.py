"""The port's single-device fault injectors, the trainer's anomaly knobs
and single-file checkpoints through ``framework.fs``, against the JAX
package on the CPU.

- ``maybe_sigterm``, ``ckpt_truncate_commit`` and ``maybe_hang`` fire
  once a process, at the armed step or the nth call, as JAX's do for
  the same environment (the same call sequence gives the same firings);
- ``PADDLE_TPU_ANOMALY_POLICY`` / ``PADDLE_TPU_ROLLBACK_EVERY`` parse
  as the JAX trainer parses them, and rollback goes back to the snapshot
  of every n good steps;
- a truncated commit is rejected by ``validate_checkpoint`` (in both
  packages), and ``latest_checkpoint`` and ``restore_latest`` walk back
  to the newest valid checkpoint;
- a trainer's single-file checkpoint goes through a fake ``hadoop`` CLI
  on ``hdfs://`` and loads back bitwise, in the port and in the JAX
  package's reader.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import os
import pickle
import signal
import stat
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.testing import faults as jfaults

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.resilience import CheckpointManager
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.testing import faults as tfaults

from test_fs_backend import FAKE_HADOOP


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for var in ("PADDLE_FAULT_SIGTERM_STEP", "PADDLE_FAULT_CKPT_TRUNCATE",
                "PADDLE_FAULT_HANG", "PADDLE_TPU_ANOMALY_POLICY",
                "PADDLE_TPU_ROLLBACK_EVERY", "PADDLE_FAULT_NAN_STEP"):
        monkeypatch.delenv(var, raising=False)
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


def test_sigterm_fires_once_at_the_armed_step(monkeypatch):
    got = []
    old = signal.signal(signal.SIGTERM, lambda *a: got.append(a[0]))
    try:
        monkeypatch.setenv("PADDLE_FAULT_SIGTERM_STEP", "3")
        fired = {}
        for name, mod in (("port", tfaults), ("jax", jfaults)):
            got.clear()
            for step in range(1, 7):
                mod.maybe_sigterm(step)
            fired[name] = list(got)
        assert fired["port"] == fired["jax"] == [signal.SIGTERM]
        monkeypatch.setenv("PADDLE_FAULT_SIGTERM_STEP", "x")
        tfaults.reset()
        got.clear()
        tfaults.maybe_sigterm(5)
        assert got == []
    finally:
        signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("spec", ["1", "3", "", "bad"])
def test_ckpt_truncate_fires_on_the_nth_commit(monkeypatch, spec):
    monkeypatch.setenv("PADDLE_FAULT_CKPT_TRUNCATE", spec)
    got = [tfaults.ckpt_truncate_commit() for _ in range(5)]
    want = [jfaults.ckpt_truncate_commit() for _ in range(5)]
    assert got == want
    assert sum(got) == (1 if spec in ("1", "3") else 0)


def test_hang_sleeps_once_after_the_armed_step(monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_HANG", "2:0.2")
    times = []
    for step in range(1, 5):
        t0 = time.perf_counter()
        tfaults.maybe_hang(step)
        times.append(time.perf_counter() - t0)
    assert times[1] >= 0.2 and max(times[0], *times[2:]) < 0.1
    tfaults.reset()
    monkeypatch.setenv("PADDLE_FAULT_HANG", "2")     # no seconds: off
    t0 = time.perf_counter()
    tfaults.maybe_hang(5)
    assert time.perf_counter() - t0 < 0.1


def _trainer(policy=None, seed=7):
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_heads=2, max_seq_len=16)
    model = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=prandom.seed(seed, "cpu"))
    crit = GPTPretrainingCriterion()
    return SpmdTrainer(model, topt.SGD(learning_rate=0.1),
                       lambda o, lab: crit(o, lab),
                       strategy=DistributedStrategy(),
                       anomaly_policy=policy)


def _batch(i):
    ids = np.random.RandomState(i).randint(0, 64, (2, 16))
    return ids, np.roll(ids, -1, 1)


def test_anomaly_knobs_parse_as_jax(monkeypatch):
    from paddle_tpu.distributed.spmd import SpmdTrainer as JTrainer
    from paddle_tpu import optimizer as jopt
    import paddle_tpu as jp
    jmodel = jp.nn.Linear(4, 4)

    def jtrainer(policy=None):
        return JTrainer(jmodel, jopt.SGD(learning_rate=0.1,
                                         parameters=jmodel.parameters()),
                        lambda o, lab: ((o - lab) ** 2).mean(),
                        anomaly_policy=policy)
    for env, arg, every in ((None, None, None), ("skip", None, None),
                            ("rollback", None, "4"), ("skip", "raise", "2"),
                            ("bogus", None, None)):
        if env is None:
            monkeypatch.delenv("PADDLE_TPU_ANOMALY_POLICY", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_ANOMALY_POLICY", env)
        if every is None:
            monkeypatch.delenv("PADDLE_TPU_ROLLBACK_EVERY", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_ROLLBACK_EVERY", every)
        if env == "bogus":
            with pytest.raises(ValueError):
                _trainer(arg)
            with pytest.raises(ValueError):
                jtrainer(arg)
            continue
        t, j = _trainer(arg), jtrainer(arg)
        assert t.anomaly_policy == j.anomaly_policy
        assert t._rollback_every == j._rollback_every


def test_rollback_every_goes_back_to_the_last_snapshot(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ANOMALY_POLICY", "rollback")
    monkeypatch.setenv("PADDLE_TPU_ROLLBACK_EVERY", "3")
    monkeypatch.setenv("PADDLE_FAULT_NAN_STEP", "5")
    tr = _trainer()
    ref = _trainer()                       # the same weights, no fault
    for i in range(1, 4):                  # good steps 1-3: snapshot at 3
        ref.train_step(*_batch(i))
    want = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    for i in range(1, 6):                  # step 5's gradients are NaN
        tr.train_step(*_batch(i))
    assert tr.stats["rollback_steps"] == 1 and tr._step_count == 3
    for n, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n


class _Died(BaseException):
    pass


def test_truncated_commit_is_rejected_and_resume_walks_back(tmp_path,
                                                            monkeypatch):
    d = str(tmp_path / "ckpts")
    tr = _trainer()
    mgr = CheckpointManager(d, keep_last=5, async_save=False)
    tr.train_step(*_batch(1))
    mgr.save(tr, 1)
    tr.train_step(*_batch(2))
    want = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    mgr.save(tr, 2)
    tr.train_step(*_batch(3))
    monkeypatch.setenv("PADDLE_FAULT_CKPT_TRUNCATE", "3")

    def die(code):
        raise _Died(code)
    monkeypatch.setattr(os, "_exit", die)
    tfaults.reset()
    for _ in range(2):                     # two earlier commits counted
        tfaults.ckpt_truncate_commit()
    with pytest.raises(_Died) as e:
        mgr.save(tr, 3)
    assert e.value.args == (137,)
    bad = os.path.join(d, "ckpt-3")
    assert os.path.isdir(bad)              # committed-looking ...
    assert not tckpt.validate_checkpoint(bad)      # ... but cut
    assert not jckpt.validate_checkpoint(bad)
    assert tckpt.latest_checkpoint(d) == os.path.join(d, "ckpt-2")
    fresh = _trainer(seed=99)
    mgr.restore_latest(fresh)
    assert fresh._step_count == 2
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n


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


def test_single_file_checkpoint_over_fake_hdfs(fake_hdfs):
    tr = _trainer()
    tr.train_step(*_batch(1))
    path = "hdfs://ns/ckpt/step1.pdtrainer"
    tckpt.save_trainer(tr, path, extra={"epoch": 3})
    assert (fake_hdfs / "ns" / "ckpt" / "step1.pdtrainer").exists() or \
        any(p.name == "step1.pdtrainer" for p in fake_hdfs.rglob("*"))
    fresh = _trainer(seed=99)
    assert tckpt.load_trainer(fresh, path) == {"epoch": 3}
    for (n, p), q in zip(tr.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p.detach(), q.detach()), n
    # the JAX package's reader takes the same file off the same store
    state = jckpt.read_checkpoint(path)
    assert state["step_count"] == 1 and state["extra"] == {"epoch": 3}
    local = tckpt.read_checkpoint(path)
    assert pickle.dumps(local["params"]) == pickle.dumps(state["params"])
