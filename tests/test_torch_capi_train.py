"""The port's C training entry on the CPU: ``SpmdTrainer.export_train_step``
-> ``capi_bridge.create_trainer`` / ``trainer_step`` (and the same through
``libpd_inference.so``'s ``PD_NewTrainer`` / ``PD_TrainerStep`` and the
standalone ``pd_capi_train_demo``) on the JAX package's regression net
(``tests/test_capi_train.py``).

- The exported step's losses equal the live port trainer's within rel
  1e-4 over the same batches (as the JAX test holds its own), f32 and
  under bf16 AMP on an attention layer that takes rows 1-3's custom op;
- the ``.pdtrainstate`` file has the JAX file's keys, names and shapes,
  and from the JAX net's weights the exported step's losses equal the
  JAX export's, stepped by the JAX ``capi_bridge``, within rel 1e-4;
- dropout draws fresh bits every step (at lr 0 the steps' losses
  differ);
- fp16 scaling, the nan guard and the anomaly policies are refused, as
  in JAX.
The embedded interpreter runs the trainer on ``PD_INFERENCE_DEVICE``'s
device, here ``cpu``."""
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_cpu import unoptimized_jax_compiles  # noqa: F401
import ctypes
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import SpmdTrainer as JTrainer
from paddle_tpu.distributed import create_mesh

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.distributed import SpmdTrainer
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.inference import capi_bridge as B
from paddle_tpu_torch.inference.capi import build as capi_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4


def make_trainer(strategy=None, state=None):
    tp.set_device("cpu")
    tp.seed(0)
    model = tnn.Sequential(tnn.Linear(6, 16), tnn.ReLU(), tnn.Linear(16, 1))
    if state is not None:
        model.set_state_dict(state)
    opt = tp.optimizer.Adam(learning_rate=0.02,
                            parameters=model.parameters())
    return SpmdTrainer(model, opt, lambda o, y: TF.mse_loss(o, y),
                       strategy=strategy)


def example_batch(bs=8, nf=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(bs, nf).astype(np.float32)
    return x, x.sum(axis=1, keepdims=True).astype(np.float32)


def triples(*arrays):
    return [(a.tobytes(), a.shape, a.dtype.name) for a in arrays]


def loss_of(res):
    raw, shape, dtype = res
    assert shape == () and dtype == "float32"
    return float(np.frombuffer(raw, np.float32)[0])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tr = make_trainer()
    x, y = example_batch()
    path = str(tmp_path_factory.mktemp("train") / "reg")
    assert tr.export_train_step(path, x, y) == path
    return path


def test_exported_step_matches_live_trainer(exported):
    h = B.create_trainer(exported, device="cpu")
    live = make_trainer()
    for i in range(5):
        x, y = example_batch(seed=i % 2)
        got = loss_of(B.trainer_step(h, triples(x, y)))
        want = float(live.train_step(x, y))
        assert got == pytest.approx(want, rel=REL), f"step {i}"
    B.destroy_trainer(h)
    with pytest.raises(KeyError):
        B.trainer_step(h, triples(x, y))


@pytest.fixture(scope="module")
def jax_exported(tmp_path_factory):
    """The JAX package's export of its regression net, and the net."""
    jp.seed(0)
    jmodel = jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(),
                            jnn.Linear(16, 1))
    jopt = jp.optimizer.Adam(learning_rate=0.02,
                             parameters=jmodel.parameters())
    jtr = JTrainer(jmodel, jopt, lambda o, y: JF.mse_loss(o, y),
                   mesh=create_mesh({"dp": 1}))
    x, y = example_batch()
    path = str(tmp_path_factory.mktemp("jtrain") / "jreg")
    jtr.export_train_step(path, x, y)
    return path, jmodel


def test_state_file_has_the_jax_layout(exported, jax_exported):
    with open(jax_exported[0] + ".pdtrainstate", "rb") as f:
        want = pickle.load(f)
    with open(exported + ".pdtrainstate", "rb") as f:
        got = pickle.load(f)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, np.ndarray):
            return (tree.shape, tree.dtype.name)
        return type(tree).__name__

    assert layout(got) == layout(want)
    assert got["lr"] == want["lr"] and got["step_count"] == 0


def test_exported_step_matches_the_jax_exported_step(jax_exported,
                                                     tmp_path):
    """The port's export of the JAX net's weights, stepped by the port's
    ``trainer_step``, against the JAX export stepped by the JAX
    ``capi_bridge.trainer_step`` over the same batches: losses within
    rel 1e-4."""
    from paddle_tpu.inference import capi_bridge as JB
    jpath, jmodel = jax_exported
    tr = make_trainer(state={k: np.asarray(v.data)
                             for k, v in jmodel.state_dict().items()})
    x, y = example_batch()
    path = str(tmp_path / "reg_jax_weights")
    tr.export_train_step(path, x, y)
    h, jh = B.create_trainer(path, device="cpu"), JB.create_trainer(jpath)
    for i in range(5):
        x, y = example_batch(seed=i % 2)
        got = loss_of(B.trainer_step(h, triples(x, y)))
        raw, _, dtype = JB.trainer_step(jh, triples(x, y))
        want = float(np.frombuffer(raw, np.dtype(dtype))[0])
        assert got == pytest.approx(want, rel=REL), f"step {i}"
    B.destroy_trainer(h)
    JB.destroy_trainer(jh)


def test_amp_attention_step_matches_live_trainer(tmp_path):
    """bf16 AMP on a multi-head attention layer (its attention through
    rows 1-3's custom op on the CPU): the exported step holds to the live
    trainer over 3 steps."""
    def build():
        tp.set_device("cpu")
        tp.seed(1)
        net = tnn.MultiHeadAttention(16, 2)
        opt = tp.optimizer.Adam(learning_rate=1e-3,
                                parameters=net.parameters())
        st = DistributedStrategy()
        st.amp = True
        return SpmdTrainer(net, opt, lambda o, y: TF.mse_loss(
            o.float(), y), strategy=st)

    rng = np.random.RandomState(3)
    x, lab = (rng.randn(2, 8, 16).astype(np.float32) for _ in range(2))
    path = str(tmp_path / "mha")
    build().export_train_step(path, (x, x, x), lab)
    h = B.create_trainer(path, device="cpu")
    live = build()
    for i in range(3):
        got = loss_of(B.trainer_step(h, triples(x, x, x, lab)))
        want = float(live.train_step((x, x, x), lab))
        assert got == pytest.approx(want, rel=REL), f"step {i}"
    B.destroy_trainer(h)


def test_dropout_draws_fresh_bits(tmp_path):
    """Dropout's mask is an op of the program: two trainers stepping
    from one state on one batch get other losses, and a trainer's two
    steps use other masks."""
    tp.set_device("cpu")
    tp.seed(0)
    model = tnn.Sequential(tnn.Linear(6, 64), tnn.Dropout(0.5),
                           tnn.Linear(64, 1))
    opt = tp.optimizer.SGD(learning_rate=0.0,
                           parameters=model.parameters())
    tr = SpmdTrainer(model, opt, lambda o, y: TF.mse_loss(o, y))
    x, y = example_batch()
    path = str(tmp_path / "drop")
    tr.export_train_step(path, x, y)
    a, b = (B.create_trainer(path, device="cpu") for _ in range(2))
    la = [loss_of(B.trainer_step(a, triples(x, y))) for _ in range(2)]
    lb = loss_of(B.trainer_step(b, triples(x, y)))
    assert all(np.isfinite(la)) and la[0] != la[1] and la[0] != lb


def _lib(tmp_path):
    lib = ctypes.CDLL(capi_build.build_library(
        str(tmp_path / "libpd_inference.so")))
    lib.PD_NewTrainer.restype = ctypes.c_void_p
    lib.PD_NewTrainer.argtypes = [ctypes.c_char_p]
    lib.PD_TrainerStep.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int32,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.PD_DeleteTrainer.argtypes = [ctypes.c_void_p]
    lib.PD_GetLastError.restype = ctypes.c_char_p
    return lib


class PDTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p),
                ("shape", ctypes.c_int64 * 8),
                ("ndim", ctypes.c_int32),
                ("dtype", ctypes.c_char * 16)]


def test_pd_trainer_step_through_the_library(exported, tmp_path,
                                             monkeypatch):
    """``PD_NewTrainer`` returns a handle and ``PD_TrainerStep`` the live
    trainer's losses (the shim in this process, through ctypes)."""
    monkeypatch.setenv("PD_INFERENCE_DEVICE", "cpu")
    lib = _lib(tmp_path)
    handle = lib.PD_NewTrainer(exported.encode())
    assert handle, lib.PD_GetLastError()
    x, y = example_batch()
    batch = (PDTensor * 2)()
    for t, a in zip(batch, (x, y)):
        t.data = a.ctypes.data_as(ctypes.c_void_p)
        t.ndim = 2
        t.shape[0], t.shape[1] = a.shape
        t.dtype = b"float32"
    live = make_trainer()
    loss = ctypes.c_float()
    for i in range(3):
        assert lib.PD_TrainerStep(handle, batch, 2, ctypes.byref(loss)) \
            == 0, lib.PD_GetLastError()
        assert loss.value == pytest.approx(float(live.train_step(x, y)),
                                           rel=REL)
    batch[0].dtype = b"complex7"
    assert lib.PD_TrainerStep(handle, batch, 2, ctypes.byref(loss)) == -1
    assert b"bad dtype" in lib.PD_GetLastError()
    lib.PD_DeleteTrainer(handle)
    assert not lib.PD_NewTrainer(b"/nonexistent/model")
    assert b"PD_NewTrainer" in lib.PD_GetLastError()


def test_standalone_c_train_demo(exported, tmp_path):
    """``pd_capi_train_demo`` (built with ``cc``) steps the export 20 times
    and prints ``CAPI-TRAIN-OK``."""
    exe = capi_build.build_demo(str(tmp_path / "pd_capi_train_demo"),
                                source="capi_train_demo.c")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in sys.path if p])
    env["PD_INFERENCE_DEVICE"] = "cpu"
    proc = subprocess.run([exe, exported, "6", "8"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CAPI-TRAIN-OK" in proc.stdout
    assert proc.stdout.count("STEP ") == 20


def test_export_refuses_fp16_guard_and_policies(tmp_path):
    x, y = np.ones((2, 6), np.float32), np.ones((2, 1), np.float32)
    st = DistributedStrategy()
    st.amp = True
    st.amp_configs = {"use_bf16": False}
    with pytest.raises(NotImplementedError, match="fp16 scaler"):
        make_trainer(st).export_train_step(str(tmp_path / "a"), x, y)
    tp.seed(0)
    model = tnn.Linear(6, 1)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    tr = SpmdTrainer(model, opt, lambda o, t: TF.mse_loss(o, t),
                     anomaly_policy="skip")
    with pytest.raises(NotImplementedError, match="anomaly policy"):
        tr.export_train_step(str(tmp_path / "b"), x, y)
    tp.core.set_flags({"FLAGS_check_nan_inf": True})
    try:
        tr = SpmdTrainer(tnn.Linear(6, 1), opt,
                         lambda o, t: TF.mse_loss(o, t))
    finally:
        tp.core.set_flags({"FLAGS_check_nan_inf": False})
    with pytest.raises(NotImplementedError, match="nan guard"):
        tr.export_train_step(str(tmp_path / "c"), x, y)
    assert not os.path.exists(str(tmp_path / "a.pdtrain"))
