"""Build the C inference library and the demo binaries, inference and
training (counterpart of ``paddle_tpu/inference/capi/build.py``): one
``cc`` call each with CPython's embed flags, into
``build/paddle_tpu_torch/capi/`` beside the package (ignored by git), not
into the package directory.

    python -m paddle_tpu_torch.inference.capi.build
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    HERE))), "build", "paddle_tpu_torch", "capi")


def embed_inputs():
    """What the build needs of this Python: ``(Python.h's directory,
    libpython's directory, its version tag, whether Python.h and a shared
    libpython are there)``."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    shared = any(os.path.exists(os.path.join(libdir, f"libpython{ver}{ext}"))
                 for ext in (".so", ".so.1.0"))
    return inc, libdir, ver, (os.path.exists(os.path.join(inc, "Python.h"))
                              and shared)


def _embed_flags():
    inc, libdir, ver, _ = embed_inputs()
    return ([f"-I{inc}"],
            [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}",
             "-ldl", "-lm"])


def _cc():
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        raise RuntimeError("no C compiler found (need cc/gcc/g++)")
    return cc


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")


def build_library(output: str | None = None) -> str:
    """Compile pd_inference.c -> libpd_inference.so; returns its path."""
    out = output or os.path.join(OUT_DIR, "libpd_inference.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    incs, libs = _embed_flags()
    _run([_cc(), "-O2", "-fPIC", "-shared",
          os.path.join(HERE, "pd_inference.c"), "-o", out, *incs, *libs])
    return out


def build_demo(output: str | None = None,
               source: str = "capi_demo.c") -> str:
    """Compile a standalone demo executable with the library's source
    (``capi_demo.c``, the inference demo ``pd_capi_demo``, or
    ``capi_train_demo.c``, the training demo ``pd_capi_train_demo``);
    returns its path."""
    out = output or os.path.join(
        OUT_DIR, os.path.splitext(source)[0].replace("capi_", "pd_capi_"))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    incs, libs = _embed_flags()
    _run([_cc(), "-O2", os.path.join(HERE, source),
          os.path.join(HERE, "pd_inference.c"), "-o", out, f"-I{HERE}",
          *incs, *libs])
    return out


if __name__ == "__main__":
    print(build_library())
    print(build_demo())
    print(build_demo(source="capi_train_demo.c"))
