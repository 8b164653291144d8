"""Trainer checkpoints in the port, and across the two packages, on the
CPU: ``SpmdTrainer.save/load``, ``distributed.checkpoint`` (the single
file and the manifest directory), ``resilience.CheckpointManager`` and
``models.convert.trainer_state_from_paddle_tpu``.

Each test mirrors a JAX oracle (``tests/test_checkpoint_resume.py``,
``tests/test_resilience.py``).  Tolerances, stated per check:
- a resumed port run against the uninterrupted one: equal (the same
  package on the same inputs is deterministic on the CPU);
- a run resumed in the other package against the writer's own
  continuation, in f32: rtol 1e-5, atol 1e-6 (losses and parameters),
  the restored state itself bitwise.
"""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import os
import threading

import numpy as np
import pytest

import jax
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import SpmdTrainer as JaxTrainer
from paddle_tpu.distributed import create_mesh
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import (CheckpointManager, SpmdTrainer,
                                          latest_checkpoint)
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     load_paddle_tpu_params,
                                     trainer_state_from_paddle_tpu)

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=16)
F32 = dict(rtol=1e-5, atol=1e-6)
CRIT = GPTPretrainingCriterion()


def gpt_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 128, (4, 16)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, 1).astype(np.int32)))
    return out


def jax_weights(seed):
    paddle.seed(seed)
    return {n: np.asarray(p.data) for n, p in
            JaxGPT(JaxConfig(**SMALL)).named_parameters()}


def port_trainer(seed, k_steps=1, scheduler=False, fp16=False, policy=None):
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    load_paddle_tpu_params(model, jax_weights(seed))
    lr = topt.lr.CosineAnnealingDecay(1e-3, T_max=4) if scheduler else 1e-3
    optim = topt.Adam(learning_rate=lr)
    st = DistributedStrategy()
    if k_steps > 1:
        st.gradient_merge = True
        st.gradient_merge_configs = {"k_steps": k_steps}
    if fp16:
        st.amp = True
        st.amp_configs = {"use_bf16": False, "init_loss_scaling": 1024.0,
                          "incr_every_n_steps": 2}
    return SpmdTrainer(model, optim, lambda o, l: CRIT(o, l), strategy=st,
                       anomaly_policy=policy)


def run(tr, batches, scheduler=False):
    out = []
    for x, y in batches:
        out.append(float(tr.train_step(x, y)))
        if scheduler:
            tr.optimizer._lr.step()
    return out


# ---- save / load (tests/test_checkpoint_resume.py) ------------------------
@pytest.mark.parametrize("manifest", [False, True],
                         ids=["single-file", "manifest"])
def test_save_load_resumes_exactly(tmp_path, manifest):
    batches = gpt_batches(6)
    full = run(port_trainer(1, scheduler=True), batches, scheduler=True)
    a = port_trainer(1, scheduler=True)
    run(a, batches[:3], scheduler=True)
    p = str(tmp_path / "ck")
    assert a.save(p, extra={"note": "mid"}, manifest=manifest) == p
    assert os.path.isdir(p) == manifest and tckpt.validate_checkpoint(p)
    b = port_trainer(99, scheduler=True)       # other weights, adopts p
    assert b.load(p) == {"note": "mid"}
    assert b._step_count == 3 == b.optimizer._step_count
    assert b.optimizer._lr.last_epoch == 3
    assert run(b, batches[3:], scheduler=True) == full[3:]


def test_gradient_merge_buffer_checkpointed(tmp_path):
    """Saved mid-window, the merge buffers ride along and the window
    continues rather than restarts."""
    batches = gpt_batches(8, seed=7)
    full = run(port_trainer(2, k_steps=4), batches)
    a = port_trainer(2, k_steps=4)
    run(a, batches[:2])
    p = str(tmp_path / "ckgm")
    a.save(p)
    b = port_trainer(55, k_steps=4)
    b.load(p)
    assert b.optimizer._step_count == 0 and b._step_count == 2
    assert run(b, batches[2:]) == full[2:]


def test_load_rejects_mismatched_model(tmp_path):
    a = port_trainer(1)
    p = str(tmp_path / "ckbad")
    a.save(p)
    other = torch.nn.Sequential(torch.nn.Linear(8, 8))
    tr = SpmdTrainer(other, topt.SGD(learning_rate=0.1),
                     lambda o, l: (o - l).square().mean())
    with pytest.raises(ValueError):
        tr.load(p)


def test_fp16_scaler_state_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_NAN_STEP", "1")
    a = port_trainer(3, fp16=True)
    run(a, gpt_batches(3))
    p = str(tmp_path / "ckfp16")
    a.save(p, manifest=True)
    monkeypatch.delenv("PADDLE_FAULT_NAN_STEP")
    b = port_trainer(4, fp16=True)
    b.load(p)
    for k in ("scale", "good", "bad", "t", "found_inf"):
        assert torch.equal(b._scaler_state[k], a._scaler_state[k]), k
    assert b.loss_scale == 2048.0 and b.stats["skipped_steps"] == 1


def test_skip_state_survives_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_NAN_STEP", "2")
    a = port_trainer(15, policy="skip")
    run(a, gpt_batches(3, seed=5))
    assert a.stats["skipped_steps"] == 1
    p = str(tmp_path / "ck")
    a.save(p, manifest=True)
    monkeypatch.delenv("PADDLE_FAULT_NAN_STEP")
    b = port_trainer(16, policy="skip")
    b.load(p)
    assert b.stats["skipped_steps"] == 1 and int(b._anomaly_state["t"]) == 2


def test_skip_policy_adopts_legacy_checkpoint_step(tmp_path):
    """A checkpoint without skip counters (written under 'raise') seeds
    the optimizer's count from the step count: t = 0 would rewind Adam's
    bias correction to step 1."""
    a = port_trainer(21)
    run(a, gpt_batches(4))
    p = str(tmp_path / "legacy")
    a.save(p)
    b = port_trainer(22, policy="skip")
    b.load(p)
    assert int(b._anomaly_state["t"]) == 4
    assert b.stats["skipped_steps"] == 0


# ---- manifest checkpoints + CheckpointManager (tests/test_resilience.py) ---
def test_truncated_and_corrupt_checkpoints_fail_validation(tmp_path):
    tr = port_trainer(1)
    run(tr, gpt_batches(1))
    p = str(tmp_path / "ck")
    tr.save(p, manifest=True)
    entry = os.path.join(p, "state.pdtrainer")
    good = open(entry, "rb").read()
    with open(entry, "wb") as f:               # truncation
        f.write(good[:10])
    assert not tckpt.validate_checkpoint(p)
    with pytest.raises(ValueError, match="validation"):
        tckpt.read_checkpoint(p)
    flipped = bytearray(good)                  # one flipped byte
    flipped[len(flipped) // 2] ^= 0xFF
    with open(entry, "wb") as f:
        f.write(bytes(flipped))
    assert not tckpt.validate_checkpoint(p)
    with open(entry, "wb") as f:
        f.write(good)
    assert tckpt.validate_checkpoint(p)
    assert tckpt.read_manifest(p)["step"] == 1


def test_manager_falls_back_past_truncated_newest(tmp_path):
    batches = gpt_batches(4, seed=3)
    tr = port_trainer(2)
    mgr = CheckpointManager(str(tmp_path), keep_last=4, async_save=False)
    for x, y in batches[:3]:
        tr.train_step(x, y)
        mgr.save(tr)
    with open(os.path.join(str(tmp_path), "ckpt-3", "state.pdtrainer"),
              "r+b") as f:
        f.truncate(16)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt-2")
    tr2 = port_trainer(77)
    mgr2 = CheckpointManager(str(tmp_path), keep_last=4)
    assert mgr2.restore_latest(tr2) is not None
    assert tr2._step_count == 2 and mgr2.stats["fallbacks"] >= 1
    ref = port_trainer(2)
    run(ref, batches[:2])
    assert run(tr2, batches[2:]) == run(ref, batches[2:])


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_keeps_last_k_and_gcs_tmps(tmp_path, async_save):
    tr = port_trainer(3)
    stale = tmp_path / "ckpt-99.tmp"
    stale.mkdir()
    (stale / "state.pdtrainer").write_bytes(b"junk")
    mgr = CheckpointManager(str(tmp_path), keep_last=2,
                            async_save=async_save)
    for x, y in gpt_batches(3):
        tr.train_step(x, y)
        mgr.save(tr)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-2", "ckpt-3"]
    assert mgr.stats["saves"] == 3 and mgr.last_commit_ms is not None


def test_async_save_does_not_block_training_thread(tmp_path, monkeypatch):
    tr = port_trainer(4)
    run(tr, gpt_batches(1))
    gate = threading.Event()
    real_write = tckpt.write_checkpoint

    def delayed_write(state, path):
        gate.wait(10)
        return real_write(state, path)

    monkeypatch.setattr(tckpt, "write_checkpoint", delayed_write)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    p = mgr.save(tr, extra={"k": 1})
    assert not os.path.exists(p)               # the commit is still gated
    assert mgr.last_snapshot_ms is not None
    gate.set()
    mgr.wait()
    assert tckpt.validate_checkpoint(p)
    assert tckpt.read_checkpoint(p)["extra"] == {"k": 1}


def test_async_save_failure_surfaces_on_wait(tmp_path, monkeypatch):
    tr = port_trainer(5)
    run(tr, gpt_batches(1))

    def exploding_write(state, path):
        raise IOError("disk on fire")

    monkeypatch.setattr(tckpt, "write_checkpoint", exploding_write)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(tr)
    with pytest.raises(IOError, match="disk on fire"):
        mgr.wait()
    assert mgr.stats["commit_failures"] == 1
    seen = []
    mgr2 = CheckpointManager(str(tmp_path), async_save=True,
                             on_error=seen.append)
    mgr2.save(tr)
    mgr2.wait()
    assert len(seen) == 1 and "disk on fire" in str(seen[0])
    assert tres.CheckpointManager is CheckpointManager


def test_latest_checkpoint_gcs_stale_tmps(tmp_path):
    (tmp_path / "ckpt-1").write_bytes(b"\x80junkpickle")
    (tmp_path / "ckpt-2.tmp").write_bytes(b"half")
    staging = tmp_path / "ckpt-3.tmp"
    staging.mkdir()
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt-1")
    assert not (tmp_path / "ckpt-2.tmp").exists() and not staging.exists()
    assert [s for s, _ in tckpt.checkpoint_candidates(str(tmp_path))] == [1]


# ---- across the packages ---------------------------------------------------
def jax_trainer(seed, fp16=False):
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(**SMALL))
    optim = paddle.optimizer.Adam(learning_rate=1e-3,
                                  parameters=jm.parameters())
    st = JaxStrategy()
    if fp16:
        st.amp = True
        st.amp_configs = {"use_bf16": False, "init_loss_scaling": 1024.0,
                          "incr_every_n_steps": 2}
    crit = JaxCriterion()
    return JaxTrainer(jm, optim, lambda o, l: crit(o, l),
                      mesh=create_mesh({"dp": 1}, devices=jax.devices()[:1]),
                      strategy=st)


def _jax_state(tr):
    return {n: np.asarray(a) for n, a in tr.params.items()}


@pytest.mark.parametrize("fp16", [False, True], ids=["f32-adam",
                                                     "fp16-adam"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, fp16):
    batches = gpt_batches(4, seed=11)
    jtr = jax_trainer(31, fp16=fp16)
    run(jtr, batches[:2])
    jdir = str(tmp_path / "jax-ck")
    jtr.save(jdir, manifest=True)
    assert tckpt.validate_checkpoint(jdir)
    state = trainer_state_from_paddle_tpu(tckpt.read_checkpoint(jdir))
    assert "mesh_axes" not in state and state["version"] == 1
    pdir = str(tmp_path / "port-ck")
    tckpt.write_checkpoint(state, pdir)
    ttr = port_trainer(0, fp16=fp16)
    ttr.load(pdir)
    # the restored state is the JAX trainer's, bitwise
    for n, a in _jax_state(jtr).items():
        np.testing.assert_array_equal(ttr.params[n].numpy(), a, err_msg=n)
        for acc in ("moment1", "moment2"):
            np.testing.assert_array_equal(
                ttr.optimizer._accumulators[n][acc].numpy(),
                np.asarray(jtr.opt_state[n][acc]), err_msg=n)
    assert ttr._step_count == 2 == ttr.optimizer._step_count
    if fp16:
        assert ttr.loss_scale == jtr.loss_scale
        assert int(ttr._scaler_state["t"]) == int(jtr._scaler_state["t"])
    # direct too: the port reads the JAX directory as it is
    direct = port_trainer(5, fp16=fp16)
    direct.load(jdir)
    for n, p in direct.params.items():
        assert torch.equal(p, ttr.params[n])
    # two more steps in each package
    np.testing.assert_allclose(run(ttr, batches[2:]), run(jtr, batches[2:]),
                               **F32)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    batches = gpt_batches(4, seed=13)
    ttr = port_trainer(41)
    run(ttr, batches[:2])
    pdir = str(tmp_path / "port-ck")
    ttr.save(pdir, manifest=True)
    assert jckpt.validate_checkpoint(pdir)
    jtr = jax_trainer(42)
    jtr.load(pdir)
    assert jtr._step_count == 2
    for n, p in ttr.params.items():
        np.testing.assert_array_equal(np.asarray(jtr.params[n]), p.numpy(),
                                      err_msg=n)
        np.testing.assert_array_equal(
            np.asarray(jtr.opt_state[n]["moment1"]),
            ttr.optimizer._accumulators[n]["moment1"].numpy(), err_msg=n)
    np.testing.assert_allclose(run(jtr, batches[2:4]),
                               run(ttr, batches[2:4]), **F32)
    jp = _jax_state(jtr)
    for n, p in ttr.params.items():
        np.testing.assert_allclose(p.numpy(), jp[n], err_msg=n, **F32)


def test_each_package_validates_the_others_directories(tmp_path):
    jtr = jax_trainer(51)
    run(jtr, gpt_batches(1))
    jdir = str(tmp_path / "jax")
    jtr.save(jdir, manifest=True)
    ttr = port_trainer(51)
    run(ttr, gpt_batches(1))
    pdir = str(tmp_path / "port")
    ttr.save(pdir, manifest=True)
    assert tckpt.validate_checkpoint(jdir) and jckpt.validate_checkpoint(pdir)
    assert tckpt.read_manifest(jdir)["step"] == 1 == \
        jckpt.read_manifest(pdir)["step"]
    # single files too
    jfile, pfile = str(tmp_path / "j.pdtrainer"), str(tmp_path / "p.pdtrainer")
    jtr.save(jfile)
    ttr.save(pfile)
    assert tckpt.validate_checkpoint(jfile) and jckpt.validate_checkpoint(pfile)
    entry = os.path.join(pdir, "state.pdtrainer")
    with open(entry, "r+b") as f:
        f.truncate(32)
    assert not jckpt.validate_checkpoint(pdir)


def test_trainer_state_from_paddle_tpu_checks_names():
    state = {"format": "paddle_tpu_trainer_ckpt_v1", "version": 2,
             "step_count": 1, "params": {"encoder.weight": np.zeros(2)},
             "opt_state": {}, "mesh_axes": {"dp": 1}}
    with pytest.raises(KeyError, match="encoder.weight"):
        trainer_state_from_paddle_tpu(state)
    with pytest.raises(ValueError):
        trainer_state_from_paddle_tpu({"format": "other"})
    state["params"] = {"gpt.wte.weight": np.ones((2, 2), np.float32)}
    out = trainer_state_from_paddle_tpu(state)
    assert "mesh_axes" not in out and out["version"] == 1
    out["params"]["gpt.wte.weight"][0, 0] = 5.0
    assert state["params"]["gpt.wte.weight"][0, 0] == 1.0
