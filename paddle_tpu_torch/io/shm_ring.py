"""Python bindings of the shared-memory ring (counterpart of
``paddle_tpu/io/shm_ring.py``) over the port's own copy of its C source,
``io/native/shm_ring.c``: a single-producer, single-consumer ring of
length-framed bytes in POSIX shared memory, on C11 atomics.

The library is built at first use by the system C compiler (``cc``,
``-O2 -shared -fPIC -std=c11``) into ``build/paddle_tpu_torch/`` beside
the package (``ops._build.BUILD_DIR``), named by a hash of the source,
the compiler and the flags.  A build writes a temporary name of its own
and renames it into place, so processes that build at once (test
workers) each load a whole library.  ``available()`` is False where no
compiler exists: the DataLoader then takes its thread prefetcher, as in
the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from multiprocessing import shared_memory
from typing import Optional

__all__ = ["ShmRing", "RingClosed", "RingTimeout", "available"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "native", "shm_ring.c")
_CFLAGS = ["-O2", "-shared", "-fPIC", "-std=c11"]
_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()


def _compiler() -> str:
    cc = (os.environ.get("CC") or shutil.which("cc") or
          shutil.which("gcc") or shutil.which("clang"))
    if cc is None:
        raise RuntimeError("no C compiler on PATH")
    return cc


def library_path(cc: str) -> str:
    """Where the ring's library built by ``cc`` lives."""
    from ..ops._build import BUILD_DIR
    with open(_SRC, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(
        data + " ".join([cc, *_CFLAGS]).encode()).hexdigest()[:16]
    return os.path.join(str(BUILD_DIR), f"shm_ring-{digest}.so")


def _bind(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    lib.ring_needed.restype = ctypes.c_uint64
    lib.ring_needed.argtypes = [ctypes.c_uint64]
    lib.ring_init.restype = None
    lib.ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ring_close.restype = None
    lib.ring_close.argtypes = [ctypes.c_void_p]
    lib.ring_is_closed.restype = ctypes.c_int
    lib.ring_is_closed.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint64, ctypes.c_long]
    lib.ring_peek.restype = ctypes.c_int64
    lib.ring_peek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.ring_pop.restype = ctypes.c_int64
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_uint64, ctypes.c_long]
    return lib


def _build() -> ctypes.CDLL:
    """The loaded library, built first where it is missing; a failure is
    remembered and raised again."""
    global _lib, _lib_err
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_err is not None:
            raise RuntimeError(_lib_err)
        try:
            cc = _compiler()
            so = library_path(cc)
            if not os.path.exists(so):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = f"{so}.build{os.getpid()}"
                subprocess.run([cc, *_CFLAGS, _SRC, "-o", tmp], check=True,
                               capture_output=True)
                os.replace(tmp, so)
            _lib = _bind(so)
            return _lib
        except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _lib_err = (f"shm_ring native build failed: {e} "
                        f"{detail.decode(errors='replace')}").strip()
            raise RuntimeError(_lib_err) from e


def available() -> bool:
    """True when the ring's library builds and loads here."""
    try:
        _build()
        return True
    except RuntimeError:
        return False


class RingClosed(Exception):
    pass


class RingTimeout(Exception):
    pass


class ShmRing:
    """Single-producer / single-consumer byte-frame ring in POSIX shared
    memory.  One side ``create()``s it, the other ``attach()``es by
    name."""

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool):
        self._lib = _build()
        self._shm = shm
        self._owner = owner
        self._addr = ctypes.addressof(ctypes.c_char.from_buffer(shm.buf))

    @classmethod
    def create(cls, capacity: int = 32 << 20,
               name: Optional[str] = None) -> "ShmRing":
        lib = _build()
        size = int(lib.ring_needed(capacity))
        shm = shared_memory.SharedMemory(create=True, size=size, name=name)
        ring = cls(shm, owner=True)
        lib.ring_init(ring._addr, capacity)
        return ring

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        return cls(shared_memory.SharedMemory(name=name), owner=False)

    @staticmethod
    def needed(capacity: int) -> int:
        """Bytes of shared memory a ring of ``capacity`` takes."""
        return int(_build().ring_needed(capacity))

    @property
    def name(self) -> str:
        return self._shm.name

    def push(self, payload: bytes, timeout_ms: int = -1):
        rc = self._lib.ring_push(self._addr, payload, len(payload),
                                 timeout_ms)
        if rc == 0:
            return
        if rc == -2:
            raise RingClosed("ring closed")
        if rc == -3:
            raise ValueError(
                f"frame of {len(payload)} bytes exceeds half the ring "
                f"capacity (the wrap-progress bound); raise DataLoader "
                f"shm_ring_capacity to > {2 * len(payload)} bytes")
        raise RingTimeout("push timed out")

    def pop(self, timeout_ms: int = -1) -> bytes:
        n = self._lib.ring_peek(self._addr, timeout_ms)
        if n == -2:
            raise RingClosed("ring closed and drained")
        if n == -1:
            raise RingTimeout("pop timed out")
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.ring_pop(self._addr, buf, int(n), timeout_ms)
        if got < 0:
            raise RuntimeError(f"ring_pop rc={got}")
        return buf.raw[:got]

    def close_writer(self):
        """The producer's end of stream: the consumer drains the ring,
        then sees RingClosed."""
        self._lib.ring_close(self._addr)

    def destroy(self):
        """Unmap the ring, and unlink its name where this side created
        it."""
        self._addr = None
        try:
            self._shm.close()
        except BufferError:
            # a view of the mapping is still alive (held in a cycle):
            # collect it and close again.  Not collected up front: a full
            # collection in a large process costs far more than the
            # close, and a loader destroys W rings an epoch
            import gc
            gc.collect()
            try:
                self._shm.close()
            except BufferError:
                pass
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
