"""File systems for save and checkpoint paths (counterpart of
``paddle_tpu/framework/fs.py``): the local file system, and HDFS / AFS
through the ``hadoop fs`` command line, as Paddle's ``fs.cc`` runs it.

A path that starts with ``hdfs://`` or ``afs://`` goes through the
hadoop CLI; any other path is local.  A remote write is staged in a
local temporary file and uploaded when it closes; a remote read
downloads to a temporary file first, so pickle and numpy only ever see
local files.

- Every write is flushed and fsync'd before its atomic rename, so a
  crash never commits an empty or partial file;
- ``LocalFS.put`` survives ``EXDEV`` (the temporary file and the
  destination on different file systems) by copying next to the
  destination and renaming there;
- ``HadoopFS`` commands retry with exponential backoff and jitter
  (``PADDLE_TPU_FS_RETRIES``, default 3);
- faults are injected deterministically by ``testing.faults``
  (``PADDLE_FAULT_FS``, ``PADDLE_FAULT_FS_DELAY_MS``).
"""
from __future__ import annotations

import errno
import os
import random
import shutil
import subprocess
import tempfile
import time
from contextlib import contextmanager
from typing import List

__all__ = ["LocalFS", "HadoopFS", "get_fs", "open_for_write",
           "open_for_read", "retry_with_backoff", "fsync_file"]


def _fault(op: str):
    """Fault point — no-op unless PADDLE_FAULT_FS /
    PADDLE_FAULT_FS_DELAY_MS arms it (delay fires first: a slow THEN
    failing store is the realistic compound fault)."""
    if os.environ.get("PADDLE_FAULT_FS_DELAY_MS"):
        from ..testing import faults
        faults.maybe_delay_fs(op)
    if os.environ.get("PADDLE_FAULT_FS"):
        from ..testing import faults
        faults.maybe_fail_fs(op)


def fsync_file(f):
    """Flush a file object's buffers all the way to stable storage."""
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str):
    """Best-effort durability for a rename: fsync the containing
    directory so the new directory entry survives a crash."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:  # pragma: no cover (exotic fs)
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def retry_with_backoff(fn, *, tries: int = None, base_ms: float = 50.0,
                       max_ms: float = 5000.0, jitter: float = 0.25,
                       retry_on=(OSError, subprocess.SubprocessError),
                       desc: str = "fs op", sleep=time.sleep):
    """Run fn() with exponential backoff + jitter on transient errors.

    ``tries`` defaults to ``PADDLE_TPU_FS_RETRIES`` (3).  The delay
    before attempt k is ``min(max_ms, base_ms * 2**(k-1))`` scaled by a
    random factor in ``[1, 1 + jitter]``: a storage hiccup costs a
    bounded wait, not the training run.
    """
    if tries is None:
        tries = int(os.environ.get("PADDLE_TPU_FS_RETRIES", "3"))
    tries = max(1, tries)
    for attempt in range(tries):
        try:
            return fn()
        except retry_on:
            if attempt + 1 >= tries:
                raise
            delay = min(max_ms, base_ms * (2 ** attempt)) / 1000.0
            delay *= 1.0 + random.random() * jitter
            sleep(delay)


class LocalFS:
    def exists(self, path: str) -> bool:
        _fault("exists")
        return os.path.exists(path)

    def makedirs(self, path: str):
        _fault("mkdir")
        if path:
            os.makedirs(path, exist_ok=True)

    def remove(self, path: str):
        _fault("remove")
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def list_dir(self, path: str) -> List[str]:
        _fault("list")
        return sorted(os.listdir(path))

    def put(self, local: str, dest: str):
        _fault("put")
        self.makedirs(os.path.dirname(dest))
        try:
            os.replace(local, dest)  # atomic on the same filesystem
        except OSError as e:
            if e.errno != errno.EXDEV:
                raise
            # the temporary file and dest sit on different file systems
            # (a tmpfs staging directory and an NFS checkpoint
            # directory): stage a copy next to dest, so the final rename
            # is atomic on one file system
            tmp = dest + ".xdev.tmp"
            with open(local, "rb") as src, open(tmp, "wb") as out:
                shutil.copyfileobj(src, out)
                fsync_file(out)
            os.replace(tmp, dest)
            os.remove(local)
        _fsync_dir(os.path.dirname(dest))

    def get(self, src: str, local: str):
        _fault("get")
        shutil.copyfile(src, local)


class HadoopFS:
    """The ``hadoop fs`` command line (the commands ``fs.cc`` runs).

    The binary is ``PADDLE_HADOOP_BIN`` (default ``hadoop``), so tests
    and other installs can point at their own wrapper.  Every command
    retries with backoff."""

    def __init__(self):
        self.bin = os.environ.get("PADDLE_HADOOP_BIN", "hadoop")

    def _run_once(self, cmd, check) -> subprocess.CompletedProcess:
        try:
            return subprocess.run(cmd, capture_output=True, text=True,
                                  check=check, timeout=300)
        except FileNotFoundError:
            raise RuntimeError(
                f"hadoop CLI {self.bin!r} not found; install hadoop or "
                f"set PADDLE_HADOOP_BIN (needed for hdfs:// paths)")

    def _run(self, *args, check=True) -> subprocess.CompletedProcess:
        cmd = [self.bin, "fs", *args]

        def attempt():
            _fault("run")
            return self._run_once(cmd, check)

        # CalledProcessError/TimeoutExpired are SubprocessError; the
        # RuntimeError for a missing binary is deliberately NOT retried
        return retry_with_backoff(attempt, desc=f"hadoop {args[0]}")

    def exists(self, path: str) -> bool:
        return self._run("-test", "-e", path, check=False).returncode == 0

    def makedirs(self, path: str):
        if path:
            self._run("-mkdir", "-p", path)

    def remove(self, path: str):
        self._run("-rm", "-r", "-f", path)

    def list_dir(self, path: str) -> List[str]:
        out = self._run("-ls", path).stdout
        names = []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) >= 8:
                names.append(parts[-1].rsplit("/", 1)[-1])
        return sorted(names)

    def put(self, local: str, dest: str):
        self.makedirs(dest.rsplit("/", 1)[0])
        # -f: overwrite, the semantics of os.replace
        self._run("-put", "-f", local, dest)
        os.remove(local)

    def get(self, src: str, local: str):
        self._run("-get", src, local)


_REMOTE_SCHEMES = ("hdfs://", "afs://")


def get_fs(path: str):
    if any(path.startswith(s) for s in _REMOTE_SCHEMES):
        return HadoopFS()
    return LocalFS()


@contextmanager
def open_for_write(path: str, mode: str = "wb"):
    """Yield a local file handle; on a clean exit the bytes land at
    ``path`` atomically (local: fsync, then rename a temporary file;
    remote: fsync, then put).  A crash mid-write leaves the destination
    as it was, and an exception inside the block removes the temporary
    file."""
    fs = get_fs(path)
    if isinstance(fs, LocalFS):
        _fault("open_write")
        d = os.path.dirname(path)
        fs.makedirs(d)
        tmp = path + ".tmp"
        try:
            with open(tmp, mode) as f:
                yield f
                fsync_file(f)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        os.replace(tmp, path)
        _fsync_dir(d)
    else:
        _fault("open_write")
        fd, tmp = tempfile.mkstemp(suffix=".pdtmp")
        os.close(fd)
        try:
            with open(tmp, mode) as f:
                yield f
                fsync_file(f)
            fs.put(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


@contextmanager
def open_for_read(path: str, mode: str = "rb"):
    fs = get_fs(path)
    if isinstance(fs, LocalFS):
        _fault("open_read")
        with open(path, mode) as f:
            yield f
    else:
        _fault("open_read")
        fd, tmp = tempfile.mkstemp(suffix=".pdtmp")
        os.close(fd)
        try:
            fs.get(path, tmp)  # retried inside HadoopFS._run
            with open(tmp, mode) as f:
                yield f
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
