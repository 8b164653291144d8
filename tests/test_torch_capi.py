"""The port's C inference API on the CPU: ``libpd_inference.so`` built
with ``cc`` from the repo's sources, driven through ctypes on a
``jit.save`` artifact (its output bitwise equal to the Python
predictor's), ``PD_GetLastError`` on a bad path for the predictor and
the trainer (``tests/test_torch_capi_train.py`` steps a trainer), and
the standalone ``pd_capi_demo``
binary as a subprocess (``slow``, as the JAX package's is).  The
embedded interpreter runs the predictor on the device
``PD_INFERENCE_DEVICE`` names, here ``cpu``."""
import torch_cpu  # noqa: F401  (one intra-op thread)
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.inference import capi_bridge
from paddle_tpu_torch.inference.capi import build as capi_build
from paddle_tpu_torch.static import InputSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class PDTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p),
                ("shape", ctypes.c_int64 * 8),
                ("ndim", ctypes.c_int32),
                ("dtype", ctypes.c_char * 16)]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tp.set_device("cpu")
    tp.seed(0)
    model = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    path = str(tmp_path_factory.mktemp("export") / "lin")
    tp.jit.save(model, path, input_spec=[InputSpec([None, 4], "float32")])
    x = np.arange(8, dtype=np.float32).reshape(2, 4) * 0.1
    want = tp.inference.load_predictor(path, device="cpu")(x)
    return path, x, want.numpy()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    path = capi_build.build_library(
        str(tmp_path_factory.mktemp("capi") / "libpd_inference.so"))
    lib = ctypes.CDLL(path)
    lib.PD_NewPredictor.restype = ctypes.c_void_p
    lib.PD_NewPredictor.argtypes = [ctypes.c_char_p]
    lib.PD_NewTrainer.restype = ctypes.c_void_p
    lib.PD_NewTrainer.argtypes = [ctypes.c_char_p]
    lib.PD_PredictorRun.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(PDTensor), ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(PDTensor)),
        ctypes.POINTER(ctypes.c_int32)]
    lib.PD_TrainerStep.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(PDTensor), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float)]
    lib.PD_GetLastError.restype = ctypes.c_char_p
    lib.PD_DeletePredictor.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(autouse=True)
def cpu_predictor(monkeypatch):
    monkeypatch.setenv("PD_INFERENCE_DEVICE", "cpu")


def test_build_inputs_are_present():
    inc, libdir, ver, ok = capi_build.embed_inputs()
    assert ok, (inc, libdir, ver)


def test_ctypes_run_equals_the_python_predictor(exported, lib):
    path, x, want = exported
    pred = lib.PD_NewPredictor(path.encode())
    assert pred, lib.PD_GetLastError()
    xin = np.ascontiguousarray(x)
    t = PDTensor()
    t.data = xin.ctypes.data_as(ctypes.c_void_p)
    t.ndim = 2
    t.shape[0], t.shape[1] = xin.shape
    t.dtype = b"float32"
    outs = ctypes.POINTER(PDTensor)()
    n_outs = ctypes.c_int32()
    rc = lib.PD_PredictorRun(pred, ctypes.byref(t), 1, ctypes.byref(outs),
                             ctypes.byref(n_outs))
    assert rc == 0, lib.PD_GetLastError()
    assert n_outs.value == 1 and outs[0].dtype == b"float32"
    shape = tuple(outs[0].shape[i] for i in range(outs[0].ndim))
    assert shape == (2, 2)
    got = ctypes.string_at(outs[0].data, 4 * 2 * 2)
    assert got == want.tobytes()
    lib.PD_TensorsFree(outs, n_outs)
    lib.PD_DeletePredictor(pred)


def _run(lib, pred, x):
    """``PD_PredictorRun`` on one float32 input: (rc, outputs, count)."""
    t = PDTensor()
    t.data = x.ctypes.data_as(ctypes.c_void_p)
    t.ndim = x.ndim
    for i, d in enumerate(x.shape):
        t.shape[i] = d
    t.dtype = b"float32"
    outs = ctypes.POINTER(PDTensor)()
    n_outs = ctypes.c_int32()
    rc = lib.PD_PredictorRun(pred, ctypes.byref(t), 1, ctypes.byref(outs),
                             ctypes.byref(n_outs))
    return rc, outs, n_outs


class _NineDims(tnn.Layer):
    def forward(self, x):
        return x.reshape([1] * 7 + [-1, 4])


def test_an_output_with_more_dims_than_the_abi_holds_fails(lib, tmp_path):
    """``PD_Tensor.shape`` holds PD_MAX_DIMS (8) dims: a 9-dim output
    fails the run with a reason."""
    tp.set_device("cpu")
    path = str(tmp_path / "nine")
    tp.jit.save(_NineDims(), path,
                input_spec=[InputSpec([None, 4], "float32")])
    pred = lib.PD_NewPredictor(path.encode())
    assert pred, lib.PD_GetLastError()
    x = np.ones((2, 4), np.float32)
    rc, _, _ = _run(lib, pred, x)
    assert rc == -1
    assert b"9 dims" in lib.PD_GetLastError()
    lib.PD_DeletePredictor(pred)


def test_errors_reach_the_c_caller(lib):
    assert not lib.PD_NewPredictor(b"/nonexistent/model")
    assert b"PD_NewPredictor" in lib.PD_GetLastError()
    assert not lib.PD_NewTrainer(b"/nonexistent/model")
    err = lib.PD_GetLastError()
    assert b"PD_NewTrainer" in err and b"/nonexistent/model.pdtrain" in err
    loss = ctypes.c_float()
    assert lib.PD_TrainerStep(None, None, 0, ctypes.byref(loss)) == -1
    assert b"PD_TrainerStep" in lib.PD_GetLastError()
    with pytest.raises(FileNotFoundError):
        capi_bridge.create_trainer("/nonexistent/model", device="cpu")


def test_bridge_round_trip(exported):
    path, x, want = exported
    h = capi_bridge.create(path)
    (raw, shape, dtype), = capi_bridge.run(h, [(x.tobytes(), x.shape,
                                                "float32")])
    capi_bridge.destroy(h)
    assert (raw, shape, dtype) == (want.tobytes(), (2, 2), "float32")
    assert capi_bridge.checksum(np.arange(3, dtype=np.uint32).tobytes()) \
        == 0 * 1 + 1 * 2 + 2 * 3


@pytest.mark.slow
def test_standalone_c_binary_serves_the_export(exported, tmp_path):
    path, _, _ = exported
    exe = capi_build.build_demo(str(tmp_path / "pd_capi_demo"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in sys.path if p])
    env["PD_INFERENCE_DEVICE"] = "cpu"
    proc = subprocess.run([exe, path, "float32", "1x4"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CAPI-DEMO-OK" in proc.stdout
    ramp = (np.arange(4, dtype=np.float32) * np.float32(0.1)).reshape(1, 4)
    want = tp.inference.load_predictor(path, device="cpu")(ramp).numpy()
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("OUT 0"))
    assert int(line.split("checksum=")[1].split(":")[0]) == \
        capi_bridge.checksum(want.tobytes())
    assert torch.tensor(want).shape == (1, 2)
