"""The port's flight recorder and stall watchdog, on the CPU.

Bundles are the JAX package's format, so each package's ``load_bundle``
reads a bundle the other dumped; a rollback leaves a bundle in both
trainers with the same event kinds; ``PreemptionGuard`` dumps a
``sigterm`` bundle before the drain (the one test here that spawns a
process); the watchdog is driven with an injectable clock, and its
monitor thread is polled with a generous deadline, so nothing asserts
a wall time.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import create_mesh
from paddle_tpu.observability import flightrec as jflightrec

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.distributed.parallel_layers import ColumnParallelLinear
from paddle_tpu_torch.observability import flightrec as tflightrec
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import spans as tspans
from paddle_tpu_torch.observability import watchdog as twatchdog

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def dump_dir(tmp_path, monkeypatch):
    """Bundles of both packages land in a fresh directory, and the
    process recorders' per-process dump caps start over."""
    monkeypatch.setenv("PADDLE_TPU_FLIGHTREC_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_FLIGHTREC", raising=False)
    for fr in (jflightrec, tflightrec):
        monkeypatch.setattr(fr.recorder(), "dumps", 0)
        fr.recorder().ring.clear()
        fr.recorder().events.clear()
    return str(tmp_path)


def fill(fr, seed=0):
    """The same ring records and events, from a seed, into a recorder."""
    rng = np.random.RandomState(seed)
    for i in range(300):
        fr.record("decode_tick", dur_ms=float(rng.rand() * 10), tick=i,
                  active=int(rng.randint(1, 9)))
    fr.note_event("checkpoint_save", path="/x", ms=1.5)
    fr.note_event("anomaly_rollback", step=3, rollback_count=1)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_bundle(writer, dump_dir):
    w, r = (jflightrec, tflightrec) if writer == "jax" \
        else (tflightrec, jflightrec)
    rec = w.FlightRecorder(ring=256)
    fill(rec)
    path = rec.dump("smoke", directory=dump_dir, extra={"note": "x"})
    assert path is not None and path.endswith("-smoke")
    got = r.load_bundle(path)
    mine = w.load_bundle(path)
    assert got == mine
    b = got["bundle"]
    assert b["format"] == "paddle_tpu.flightrec.v1" and b["reason"] == "smoke"
    assert b["note"] == "x" and len(b["ring"]) == 256
    assert [e["tick"] for e in b["ring"]] == list(range(44, 300))
    assert [e["kind"] for e in b["events"]] == ["checkpoint_save",
                                               "anomaly_rollback"]
    assert {"stacks", "metrics", "executables", "hbm"} <= set(b)
    ring_spans = [e for e in got["trace"]["traceEvents"]
                  if e.get("pid") == tflightrec.PID_FLIGHTREC
                  and e["ph"] == "X"]
    assert len(ring_spans) == 256
    assert r.find_bundles(dump_dir, reason="smoke") == [path]


def test_bundle_documents_equal_jax(dump_dir):
    """The same records give the same ring, events and trace events in
    both packages' bundles (times aside: each package has its own
    clock)."""
    docs = []
    for fr in (jflightrec, tflightrec):
        rec = fr.FlightRecorder(ring=8, events=4)
        fill(rec, seed=4)
        docs.append((rec.bundle("x"), rec.chrome_trace()))

    def strip(entries):
        return [{k: v for k, v in e.items() if k not in ("ts_us", "wall")}
                for e in entries]
    (jb, jt), (tb, tt) = docs
    assert strip(tb["ring"]) == strip(jb["ring"])
    assert strip(tb["events"]) == strip(jb["events"])
    assert set(tb) == set(jb)
    ring = [[{k: v for k, v in e.items() if k != "ts"}
             for e in t["traceEvents"] if e.get("cat") == "flightrec"]
            for t in (jt, tt)]
    assert ring[1] == ring[0]


def test_dump_cap_gc_and_disabled(dump_dir, monkeypatch):
    rec = tflightrec.FlightRecorder()
    monkeypatch.setenv("PADDLE_TPU_FLIGHTREC_KEEP", "3")
    paths = [rec.dump(f"r{i}", directory=dump_dir) for i in range(5)]
    assert all(paths)
    assert tflightrec.find_bundles(dump_dir) == sorted(paths[-3:])
    os.makedirs(os.path.join(dump_dir, "flightrec-1-001-x.tmp"))
    assert len(tflightrec.find_bundles(dump_dir)) == 3
    rec.dumps = 16
    assert rec.dump("over", directory=dump_dir) is None
    monkeypatch.setenv("PADDLE_TPU_FLIGHTREC", "0")
    assert tflightrec.FlightRecorder().dump("off", directory=dump_dir) is None
    before = len(tflightrec.recorder().ring)
    tflightrec.record("decode_tick", dur_ms=1.0)
    assert len(tflightrec.recorder().ring) == before
    c = tmetrics.counter("flightrec_dumps_total", labels=("reason",))
    assert c.labels(reason="r4").value >= 1


def test_install_chains_the_excepthooks(dump_dir, monkeypatch):
    """The hooks observe and defer: a bundle, then the previous hook."""
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_type))
    monkeypatch.setattr(tflightrec, "_INSTALLED", {"done": False})
    tflightrec.install()
    tflightrec.install()                 # idempotent
    try:
        raise KeyError("boom")
    except KeyError:
        sys.excepthook(*sys.exc_info())
    t = threading.Thread(target=lambda: 1 / 0)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [KeyError, ZeroDivisionError]
    [path] = tflightrec.find_bundles(dump_dir, reason="exception")
    b = tflightrec.load_bundle(path)["bundle"]
    assert "KeyError" in b["exception"]
    assert [e["kind"] for e in b["events"]] == ["unhandled_exception"]
    assert tflightrec.recorder().events[-1]["kind"] == "thread_exception"


# ---- watchdog --------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_watchdog_fires_once_per_episode_on_an_injected_clock(dump_dir):
    clock = Clock()
    got = []
    wd = twatchdog.Watchdog(2.0, label="unit", on_stall=got.append,
                            clock=clock)
    clock.t += 50
    assert not wd.poll()                 # not a stall before the first beat
    wd.beat()
    clock.t += 1.5
    assert not wd.poll()
    clock.t += 1.0
    assert wd.poll() and wd.stalled and wd.stalls == 1
    assert not wd.poll()                 # once per episode
    wd.beat()
    wd.idle()
    clock.t += 10
    assert not wd.poll()                 # parked: an idle loop is no stall
    wd.beat()
    clock.t += 3
    assert wd.poll() and wd.stalls == 2
    assert [g["label"] for g in got] == ["unit", "unit"]
    assert got[0]["age_s"] == 2.5 and got[0]["timeout_s"] == 2.0
    assert any("test_watchdog_fires" in "".join(frames)
               for frames in got[0]["stacks"].values())
    b = tflightrec.load_bundle(got[0]["bundle"])["bundle"]
    assert b["reason"] == "stall" and b["stall"]["label"] == "unit"
    assert b["events"][-1]["kind"] == "watchdog_stall"
    c = tmetrics.counter("watchdog_stalls_total", labels=("label",))
    assert c.labels(label="unit").value == 2


def test_watchdog_monitor_thread_sees_a_stall(dump_dir):
    """The monitor thread itself, polled with a generous deadline."""
    clock = Clock()
    fired = threading.Event()
    wd = twatchdog.Watchdog(1.0, label="thread", poll_s=0.01, clock=clock,
                            on_stall=lambda info: fired.set()).arm()
    try:
        wd.beat()
        clock.t += 5
        assert fired.wait(timeout=60)
    finally:
        wd.disarm()
    assert wd._thread is None and wd.stalls == 1


def test_watchdog_arguments_and_env(monkeypatch):
    for v, want in (("", None), ("0", None), ("x", None), ("2.5", 2.5)):
        monkeypatch.setenv("PADDLE_TPU_WATCHDOG_S", v)
        assert twatchdog.watchdog_seconds() == want
    with pytest.raises(ValueError):
        twatchdog.Watchdog(0)
    with pytest.raises(ValueError):
        twatchdog.Watchdog(1, on_stall="explode")
    monkeypatch.setenv("PADDLE_TPU_WATCHDOG_ACTION", "raise")
    assert twatchdog.Watchdog(1).on_stall == "raise"


# ---- rollback bundles --------------------------------------------------------

class BombNet(torch.nn.Module):
    """A linear layer whose output overflows to inf on a batch carrying
    the sentinel (the JAX resilience tests' ``_BombNet``)."""

    def __init__(self):
        super().__init__()
        self.fc = ColumnParallelLinear(4, 2, device="cpu",
                                       dtype=torch.float32,
                                       generator=torch.Generator())

    def forward(self, x):
        mask = (x > 900.0).to(x.dtype).amax()
        return self.fc(x) * (1.0 + mask * 3.0e38)


class JaxBombNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 2)

    def forward(self, x):
        mask = (x > 900.0).astype("float32").max()
        return self.fc(x) * (1.0 + mask * 3.0e38)


def test_rollback_leaves_the_same_bundle_in_both_trainers(dump_dir,
                                                          monkeypatch):
    """A batch that overflows the loss on step 3 of 4: both trainers roll
    back once and dump a ``rollback`` bundle whose events end in
    ``anomaly_rollback`` at step 3; both packages' readers load both."""
    paddle.seed(13)
    jm = JaxBombNet()
    jtr = JaxTrainer(jm, paddle.optimizer.SGD(learning_rate=0.1,
                                              parameters=jm.parameters()),
                     lambda o, y: JF.mse_loss(o, y),
                     mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                     anomaly_policy="rollback")
    ttr = SpmdTrainer(BombNet(), topt.SGD(learning_rate=0.1),
                      lambda o, y: torch.nn.functional.mse_loss(o, y),
                      anomaly_policy="rollback")
    rng = np.random.RandomState(0)
    batches = [(rng.randn(4, 4).astype(np.float32),
                rng.randn(4, 2).astype(np.float32)) for _ in range(4)]
    batches[2] = (np.full((4, 4), 1000.0, np.float32), batches[2][1])
    bundles = []
    for name, tr in (("jax", jtr), ("port", ttr)):
        d = os.path.join(dump_dir, name)
        monkeypatch.setenv("PADDLE_TPU_FLIGHTREC_DIR", d)
        for x, y in batches:
            tr.train_step(x, y)
        [path] = tflightrec.find_bundles(d)
        assert path.endswith("-rollback")
        got = [fr.load_bundle(path)["bundle"] for fr in (jflightrec,
                                                        tflightrec)]
        assert got[0] == got[1]
        bundles.append(got[1])
    # each package also logs its compiles (JAX its XLA compiles, the port
    # the compiles utils.compile_counter counts)
    kinds = [[e["kind"] for e in b["events"]
              if e["kind"] not in ("xla_compile", "compile")]
             for b in bundles]
    assert kinds[1] == kinds[0] == ["anomaly_rollback"]
    assert [b["events"][-1]["step"] for b in bundles] == [3, 3]
    assert [e["kind"] for e in bundles[1]["ring"]] == ["train_step"] * 2
    assert ttr.stats["rollback_steps"] == 1 == jtr.stats["rollback_steps"]


# ---- SIGTERM ---------------------------------------------------------------

CHILD = r"""
import os, signal, sys
from paddle_tpu_torch.distributed import PreemptionGuard
from paddle_tpu_torch.observability import flightrec
flightrec.record("decode_tick", dur_ms=1.0, tick=1)
with PreemptionGuard() as guard:
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.preempted
print(flightrec.recorder().last_dump_path)
"""


def test_sigterm_under_the_guard_leaves_a_bundle(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_TPU_")}
    env.update(PYTHONPATH=str(ROOT), PADDLE_TPU_FLIGHTREC_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    path = out.stdout.strip().splitlines()[-1]
    assert path.endswith("-sigterm") and os.path.dirname(path) == \
        str(tmp_path)
    for fr in (tflightrec, jflightrec):
        b = fr.load_bundle(path)["bundle"]
        assert [e["kind"] for e in b["events"]] == ["preemption"]
        assert b["events"][0]["signum"] == 15
        assert [e["kind"] for e in b["ring"]] == ["decode_tick"]


def test_checkpoint_events_and_metrics(tmp_path, dump_dir):
    from paddle_tpu_torch.distributed import checkpoint
    tr = SpmdTrainer(BombNet(), topt.SGD(learning_rate=0.1),
                     lambda o, y: torch.nn.functional.mse_loss(o, y))
    saves = tmetrics.counter("checkpoint_saves_total", labels=("format",))
    s0 = saves.labels(format="manifest").value
    r0 = tmetrics.counter("checkpoint_restores_total").value
    path = checkpoint.save_trainer(tr, str(tmp_path / "ck"), manifest=True)
    checkpoint.load_trainer(tr, path)
    assert saves.labels(format="manifest").value == s0 + 1
    assert tmetrics.counter("checkpoint_restores_total").value == r0 + 1
    assert tmetrics.gauge("checkpoint_save_ms").value >= 0
    kinds = [e["kind"] for e in tflightrec.recorder().events]
    assert kinds[-2:] == ["checkpoint_save", "checkpoint_restore"]
    assert tflightrec.recorder().events[-1]["resharded"] is False
    assert tspans.tracer() is not None
