"""Build the hand-written CUDA kernels and bind them with ctypes.

Every ``paddle_tpu_torch/csrc/*.cu`` file (which may include the shared
``csrc/*.cuh`` headers) exports plain C entry points
(pointers and the stream as ``void*``, sizes as ``int``) that return the
``cudaGetLastError()`` of their launch.  At first use each source is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/paddle_tpu_torch/`` beside the package, named by a hash of the
source and the flags so an edited source never loads a stale library.
Several sources build in parallel: one ``nvcc`` process each, all
started together.  A failed build raises with the compiler's output.
Nothing is imported from outside the repository; no PyTorch headers are
compiled, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "CudaKernel", "build",
           "library_path", "build_log", "stream_ptr", "ptr", "DTYPE_CODES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built from source at first use and need the "
                       "CUDA toolkit (CUDA_HOME or nvcc on PATH)")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives.  The name
    hashes the source, every shared header (``csrc/*.cuh``) and the
    flags, so an edit to any of them builds afresh."""
    src = CSRC / source
    data = src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(sources: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every given source (default: all of ``csrc/*.cu``) whose
    library is missing, one ``nvcc`` each, all at once.  Returns the
    seconds each compile took (0.0 for a library already built)."""
    names = sorted(p.name for p in CSRC.glob("*.cu")) if sources is None \
        else list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    procs: List[tuple] = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        _LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(source: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills per kernel) from this process's build of ``source``."""
    return _LOGS.get(source, "")


def _load(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(path))
    return lib


class CudaKernel:
    """One C entry point of a ``csrc`` source, built at first call.

    ``launches`` counts the launches this process made through it: it
    grows by one after each launch CUDA accepted, and nowhere
    else, so a run can show that its path went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} ({self.source}): launch failed "
                               f"with cudaError {err}")
        self.launches += 1


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
