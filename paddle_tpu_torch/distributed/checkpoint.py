"""Trainer checkpoints on one device (counterpart of
``paddle_tpu/distributed/checkpoint.py``).

A checkpoint is the JAX package's: a pickle (protocol 4) of a state dict
of numpy arrays and Python values, ``{"format", "version", "step_count",
"params", "opt_state", "extra"}`` plus, where the trainer has them,
``"buffers"``, ``"grad_buf"`` (gradient merge), ``"scaler"`` (fp16 AMP:
``scale, good, bad, t, found_inf``), ``"anomaly"`` (skip: ``t,
skipped``) and ``"lr_scheduler"``.  Parameters and their merge buffers
are keyed by parameter name, ``opt_state`` by parameter name then
accumulator name (``moment1``, ``moment2``).  So a checkpoint either
package writes restores in the other (``models.convert.
trainer_state_from_paddle_tpu`` checks the names), and each package's
``validate_checkpoint`` accepts the other's directories.

Two on-disk formats:
- the single file, written through ``framework.fs.open_for_write`` (a
  local path: the pickle to ``path + ".tmp"``, fsync'd and renamed into
  place; ``hdfs://`` / ``afs://``: staged locally and put) and read
  through ``open_for_read``;
- the manifest directory: the pickle as ``state.pdtrainer`` and
  ``MANIFEST.json`` (sha256 and size per entry) written LAST inside a
  ``<name>.tmp`` staging directory that is renamed into place, so a
  directory at its final name always has its manifest, and a manifest
  that validates proves the payload is the bytes the writer produced.

The JAX package's version-2 states also record the mesh and each leaf's
sharding; on one device that record is read and ignored, and the port
writes version 1 (no record).

``PADDLE_FAULT_CKPT_TRUNCATE=n`` (``testing.faults``) makes the nth
manifest commit of a process write half its payload under a manifest of
the whole, rename it into its final name, leave a flight-recorder bundle
and exit 137; ``latest_checkpoint`` and ``CheckpointManager.
restore_latest`` walk past it to the newest checkpoint that validates.

Telemetry: ``save_trainer`` counts ``checkpoint_saves_total`` (label
``format``) and sets ``checkpoint_save_ms``, ``load_trainer`` counts
``checkpoint_restores_total`` and sets ``checkpoint_restore_ms``; the
flight recorder notes each save and restore.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..framework.fs import open_for_read, open_for_write
from ..observability import flightrec as _flightrec
from ..observability import metrics as _metrics
from ..optimizer.lr import LRScheduler
from ..testing import faults as _faults

__all__ = ["save_trainer", "load_trainer", "latest_checkpoint",
           "snapshot_trainer", "restore_trainer", "write_checkpoint",
           "read_checkpoint", "validate_checkpoint", "read_manifest",
           "checkpoint_candidates", "gc_stale_tmps", "fsync_file"]

_FORMAT = "paddle_tpu_trainer_ckpt_v1"
_MANIFEST_FORMAT = "paddle_tpu_ckpt_manifest_v1"
_MANIFEST = "MANIFEST.json"
_STATE_ENTRY = "state.pdtrainer"
_STATE_VERSION = 1


def fsync_file(f):
    """Flush a file object's buffers all the way to stable storage."""
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str):
    """Best-effort durability for a rename: fsync the containing
    directory so the new directory entry survives a crash."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy that owns its memory (a CPU tensor's ``numpy()`` is
    a view the next in-place step would overwrite)."""
    return t.detach().to("cpu", copy=True).numpy()


# ---------------------------------------------------------------------------
# trainer state <-> host dict
# ---------------------------------------------------------------------------
def snapshot_trainer(trainer, extra: Optional[dict] = None) -> dict:
    """Device -> host copy of a trainer's whole training state.  This is
    the only part of a save that must run on the training thread;
    serializing and writing can run on another
    (``resilience.CheckpointManager``)."""
    opt = trainer.optimizer
    state = {
        "format": _FORMAT,
        "version": _STATE_VERSION,
        "step_count": trainer._step_count,
        "params": {n: _host(p) for n, p in trainer._params.items()},
        "opt_state": {n: {a: _host(t) for a, t in
                          opt._accumulators[n].items()}
                      for n in trainer._train},
        "extra": extra or {},
    }
    buffers = {n: b for n, b in trainer.model.named_buffers()
               if b is not None}
    if buffers:
        state["buffers"] = {n: _host(b) for n, b in buffers.items()}
    for key, tree in (("grad_buf", trainer._grad_buf),
                      ("scaler", trainer._scaler_state),
                      ("anomaly", trainer._anomaly_state)):
        if tree is not None:
            state[key] = {n: _host(t) for n, t in tree.items()}
    lr = getattr(opt, "_lr", None)
    if isinstance(lr, LRScheduler):
        state["lr_scheduler"] = lr.state_dict()
    return state


def _restore_into(live: dict, host: dict, what: str):
    """Copy ``host[name]`` into each ``live[name]`` in place, after
    checking both hold the same names and shapes."""
    if set(host) != set(live):
        raise ValueError(
            f"checkpoint {what} names differ from the trainer's: missing "
            f"{sorted(set(live) - set(host))}, unexpected "
            f"{sorted(set(host) - set(live))}")
    for n, t in live.items():
        h = np.asarray(host[n])
        if tuple(h.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {what} {n}: shape {h.shape} != "
                             f"trainer {tuple(t.shape)}")
    with torch.no_grad():
        for n, t in live.items():
            t.copy_(torch.from_numpy(np.array(host[n], copy=True)))


def _device_tree(host: dict, like: dict) -> dict:
    """Host scalars -> device tensors of the live state's dtypes."""
    return {n: torch.as_tensor(np.asarray(host[n]), dtype=t.dtype,
                               device=t.device)
            for n, t in like.items()}


def restore_trainer(trainer, state: dict) -> dict:
    """Apply a ``snapshot_trainer`` state (of either package) to a built
    trainer; returns its ``extra`` dict.  A state whose names or shapes
    differ from the trainer's raises ``ValueError``."""
    if state.get("format") != _FORMAT:
        raise ValueError(f"state is not a {_FORMAT} checkpoint")
    opt = trainer.optimizer
    _restore_into(trainer._params, state["params"], "parameter")
    opt_host = state["opt_state"]
    missing = sorted(set(trainer._train) - set(opt_host))
    if missing:
        raise ValueError(f"checkpoint has no optimizer state for {missing}")
    for n in trainer._train:
        _restore_into(opt._accumulators[n], opt_host[n],
                      f"optimizer state of {n}:")
    buffers = {n: b for n, b in trainer.model.named_buffers()
               if b is not None}
    if buffers and "buffers" in state:
        _restore_into(buffers, state["buffers"], "buffer")
    if trainer._grad_buf is not None and "grad_buf" in state:
        _restore_into(trainer._grad_buf, state["grad_buf"],
                      "gradient-merge buffer")
    if trainer._scaler_state is not None and "scaler" in state:
        trainer._scaler_state = _device_tree(state["scaler"],
                                             trainer._scaler_state)
    if trainer._anomaly_state is not None:
        # a state written without skip counters applied every step it
        # counts: the optimizer's count is the step count
        anomaly = state.get("anomaly") or {
            "t": int(state["step_count"]), "skipped": 0}
        trainer._anomaly_state = _device_tree(anomaly,
                                              trainer._anomaly_state)
    trainer._step_count = int(state["step_count"])
    opt._step_count = trainer._step_count // max(trainer.k_steps, 1)
    lr = getattr(opt, "_lr", None)
    if isinstance(lr, LRScheduler) and "lr_scheduler" in state:
        lr.set_state_dict(state["lr_scheduler"])
    # one device: a checkpoint is never resharded
    _flightrec.note_event("checkpoint_restore", step=trainer._step_count,
                          resharded=False)
    return state.get("extra", {})


# ---------------------------------------------------------------------------
# on-disk formats
# ---------------------------------------------------------------------------
def _rm(path: str):
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def checkpoint_candidates(directory: str, prefix: str = "ckpt-"):
    """Committed ``{prefix}{int step}`` entries as (step, path), newest
    first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith(prefix) or name.endswith(".tmp"):
            continue
        try:
            step = int(name[len(prefix):])
        except ValueError:
            continue
        out.append((step, os.path.join(directory, name)))
    return sorted(out, reverse=True)


def gc_stale_tmps(directory: str, prefix: str = "ckpt-"):
    """Remove ``.tmp`` staging orphans of crashed saves (call only when
    no writer is active on the directory)."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".tmp"):
            try:
                _rm(os.path.join(directory, name))
            except OSError:
                pass


def write_checkpoint(state: dict, path: str) -> str:
    """Commit ``state`` as a manifest directory at ``path``: serialize
    into ``path + ".tmp"``, fsync the payload, write MANIFEST.json
    (checksums) last, fsync it, then rename the staging directory into
    place.  A crash leaves the old checkpoint or a ``.tmp`` orphan,
    never a half-written final directory."""
    tmp = path + ".tmp"
    _rm(tmp)
    os.makedirs(tmp)
    payload = pickle.dumps(state, protocol=4)
    # fault point: a commit killed mid-write, whose cut payload sits at
    # the final path under a manifest of the whole
    truncate_and_die = _faults.ckpt_truncate_commit()
    body = payload[:max(1, len(payload) // 2)] if truncate_and_die \
        else payload
    with open(os.path.join(tmp, _STATE_ENTRY), "wb") as f:
        f.write(body)
        fsync_file(f)
    manifest = {
        "format": _MANIFEST_FORMAT,
        "version": int(state.get("version", 1)),
        "step": int(state.get("step_count", -1)),
        "entries": {_STATE_ENTRY: {
            "sha256": hashlib.sha256(payload).hexdigest(),
            "size": len(payload),
        }},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        fsync_file(f)
    if truncate_and_die:
        _rm(path)
        os.rename(tmp, path)
        _faults.flightrec_dump("ckpt_truncate")
        os._exit(137)
    if os.path.exists(path):
        # a re-save of the same step: the old one is renamed aside first,
        # so no checkpoint is missing for longer than two renames
        old = path + ".old.tmp"
        _rm(old)
        os.rename(path, old)
        os.rename(tmp, path)
        _rm(old)
    else:
        os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))
    return path


def validate_checkpoint(path: str) -> bool:
    """Integrity check without a restore: a manifest directory's entries
    must match their recorded size and sha256; a single file must start
    like a pickle (``\\x80``) or a JSON marker (``{``)."""
    if os.path.isdir(path):
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
            if manifest.get("format") != _MANIFEST_FORMAT:
                return False
            for name, meta in manifest.get("entries", {}).items():
                p = os.path.join(path, name)
                if not os.path.isfile(p) or \
                        os.path.getsize(p) != int(meta["size"]):
                    return False
                h = hashlib.sha256()
                with open(p, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
                if h.hexdigest() != meta["sha256"]:
                    return False
            return True
        except (OSError, ValueError, KeyError, TypeError):
            return False
    try:
        if os.path.getsize(path) == 0:
            return False
        with open(path, "rb") as f:
            head = f.read(1)
        return head in (b"\x80", b"{")
    except OSError:
        return False


def read_manifest(path: str) -> Optional[dict]:
    """MANIFEST.json of a directory checkpoint (None for a single file
    or a missing manifest)."""
    if not os.path.isdir(path):
        return None
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_checkpoint(path: str) -> dict:
    """A checkpoint's state dict from either format; a directory that
    fails validation raises ``ValueError``."""
    if os.path.isdir(path):
        if not validate_checkpoint(path):
            raise ValueError(
                f"checkpoint {path} failed manifest/checksum validation "
                f"(truncated or corrupt)")
        with open(os.path.join(path, _STATE_ENTRY), "rb") as f:
            return pickle.load(f)
    with open_for_read(path, "rb") as f:
        return pickle.load(f)


def _write_file(state: dict, path: str):
    with open_for_write(path, "wb") as f:
        pickle.dump(state, f, protocol=4)


# ---------------------------------------------------------------------------
# the trainer's save/load
# ---------------------------------------------------------------------------
def save_trainer(trainer, path: str, extra: Optional[dict] = None,
                 manifest: bool = False) -> str:
    """Persist a trainer's whole training state: the single file, or
    with ``manifest=True`` the checked directory."""
    t0 = time.perf_counter()
    state = snapshot_trainer(trainer, extra=extra)
    if manifest:
        write_checkpoint(state, path)
    else:
        _write_file(state, path)
    ms = (time.perf_counter() - t0) * 1e3
    _metrics.counter("checkpoint_saves_total", "trainer checkpoints "
                     "written", labels=("format",)).labels(
        format="manifest" if manifest else "pickle").inc()
    _metrics.gauge("checkpoint_save_ms", "last checkpoint save wall "
                   "time").set(ms)
    _flightrec.note_event("checkpoint_save", path=str(path),
                          ms=round(ms, 2))
    return path


def load_trainer(trainer, path: str) -> dict:
    """Restore a checkpoint of either format into a built trainer;
    returns its ``extra`` dict."""
    t0 = time.perf_counter()
    state = read_checkpoint(path)
    if not isinstance(state, dict) or state.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a {_FORMAT} checkpoint")
    out = restore_trainer(trainer, state)
    _metrics.counter("checkpoint_restores_total",
                     "trainer checkpoints restored").inc()
    _metrics.gauge("checkpoint_restore_ms", "last checkpoint restore "
                   "wall time").set((time.perf_counter() - t0) * 1e3)
    return out


def latest_checkpoint(directory: str, prefix: str = "ckpt-",
                      validate: bool = True, gc_tmp: bool = True):
    """The newest ``{prefix}{step}`` entry that validates (None if none
    does); stale ``.tmp`` orphans are removed first unless
    ``gc_tmp=False``."""
    if gc_tmp:
        gc_stale_tmps(directory, prefix)
    for _, full in checkpoint_candidates(directory, prefix):
        if not validate or validate_checkpoint(full):
            return full
    return None
