"""One tuning table for every tunable knob, keyed by device kind and
shape (counterpart of ``paddle_tpu/utils/tuning.py``).

One store, namespaced by op:

- **process cache first**: a value recorded in this process wins for the
  process's lifetime;
- **on-disk JSON second**: ``PADDLE_TPU_TUNING_CACHE`` names the file
  ("0" / "off" turns persistence off; default
  ``~/.cache/paddle_tpu_torch/tuning.json``, under ``XDG_CACHE_HOME``
  when that is set).  Writes go through ``framework.fs.open_for_write``
  (fsync, then an atomic rename), so a crash never commits a truncated
  table;
- **a corrupt table loads as empty**: the next sweep measures again and
  rewrites it; nothing raises;
- **sweeps are opt-in**: ``PADDLE_TPU_TUNING=sweep`` arms the card-side
  sweeps of ops that have one (the int8 matmul's plans).

The disk format is the JAX package's: ``"<op>|<part>|<part>|..."`` with
parts stringified (bools as 0/1) and provenance under the reserved op
``__meta__``, so a table written by either package loads in the other.
Consumers:

- ``ops.quantized_matmul.get_qmm_tiles``: op ``qmm_tiles``, key
  ``(device_kind, m_bucket, n, k, dtype)``;
- ``inference.engine.default_prefill_buckets``: op ``prefill_buckets``,
  key ``(device_kind, max_seq_len)``;
- ``distributed.spmd.tuned_remat_policy``: op ``remat_policy``, key
  ``(device_kind, hidden, layers, max_seq_len)``.
"""
from __future__ import annotations

import functools
import json
import math
import os
import threading
from typing import Any, Dict, Optional, Tuple

__all__ = ["lookup", "lookup_nearest", "record", "entries", "tuning_path",
           "device_kind", "normalize_kind", "sweep_enabled", "key_str",
           "reset_for_tests", "provenance", "all_entries", "META_OP"]

# provenance: "__meta__|<op>|<part>|..." -> {source, run, improvement}
META_OP = "__meta__"

_lock = threading.RLock()
# op -> {key tuple of strs: value}; the disk table merged in once
_STATE: Dict[str, Any] = {"loaded": False, "cache": {}}

# (substring of a lower-case device name, its short kind): the card
# names torch reports, then the JAX package's TPU kinds, so a table keyed
# by either package's kinds reads the same
_KINDS = (("h100", "h100"), ("h200", "h200"), ("h800", "h800"),
          ("a100", "a100"), ("l40", "l40"),
          ("v5 lite", "v5e"), ("v5litepod", "v5e"), ("v5e", "v5e"),
          ("v5p", "v5p"), ("v6 lite", "v6e"), ("v6e", "v6e"),
          ("v4", "v4"), ("v3", "v3"), ("v2", "v2"))


def normalize_kind(kind: str) -> str:
    """Short device kind: 'NVIDIA H100 80GB HBM3' -> 'h100', 'TPU v5
    lite' -> 'v5e'; anything else lower-cased."""
    k = (kind or "").lower()
    for alias, canon in _KINDS:
        if alias in k:
            return canon
    return k


@functools.lru_cache(maxsize=None)
def _card_kind(index: int) -> str:
    import torch
    return normalize_kind(torch.cuda.get_device_name(index))


def device_kind() -> str:
    """Normalized kind of the current device: the card's ('h100'), or
    'cpu' without one (the JAX package's CPU kind)."""
    import torch
    if not torch.cuda.is_available() or torch.cuda._is_in_bad_fork():
        return "cpu"
    return _card_kind(torch.cuda.current_device())


def sweep_enabled() -> bool:
    """``PADDLE_TPU_TUNING=sweep``: the opt-in card-side sweeps."""
    return os.environ.get("PADDLE_TPU_TUNING", "").strip() == "sweep"


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
def tuning_path() -> Optional[str]:
    p = os.environ.get("PADDLE_TPU_TUNING_CACHE", "").strip()
    if p.lower() in ("0", "off", "false", "none"):
        return None
    if p:
        return os.path.expanduser(p)
    base = os.environ.get("XDG_CACHE_HOME") or \
        os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "paddle_tpu_torch", "tuning.json")


def key_str(op: str, parts) -> str:
    return "|".join([op, *_key_tuple(parts)])


def _key_tuple(parts) -> Tuple[str, ...]:
    return tuple(str(int(p)) if isinstance(p, bool) else str(p)
                 for p in parts)


def _load_once() -> None:
    """Merge the disk table into the process cache once; values this
    process recorded win over the disk's."""
    if _STATE["loaded"]:
        return
    _STATE["loaded"] = True
    path = tuning_path()
    if not path:
        return
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            return
        for k, v in data.items():
            parts = str(k).split("|")
            if len(parts) < 2:
                continue
            _STATE["cache"].setdefault(parts[0], {}).setdefault(
                tuple(parts[1:]), v)
    except (OSError, ValueError, TypeError):
        pass  # corrupt or unreadable: measure again, then rewrite it


def lookup(op: str, parts) -> Any:
    """The tuned value of (op, key), or None."""
    with _lock:
        _load_once()
        return _STATE["cache"].get(op, {}).get(_key_tuple(parts))


def lookup_nearest(op: str, parts, match_idx, near_idx,
                   max_dist: Optional[float] = None) -> Any:
    """The tuned value of (op, key), else that of the nearest tabled key:
    candidates must equal the query at every ``match_idx`` position; the
    distance is the sum of ``|log(query / candidate)|`` over the
    ``near_idx`` positions (numeric shape dims: half and twice the size
    are equally near); non-numeric candidates there are skipped;
    ``max_dist`` caps the distance accepted.  None when nothing
    qualifies."""
    exact = lookup(op, parts)
    if exact is not None:
        return exact
    q = _key_tuple(parts)
    best, best_d = None, None
    with _lock:
        _load_once()
        table = dict(_STATE["cache"].get(op, {}))
    for key, val in table.items():
        if len(key) != len(q) or any(key[i] != q[i] for i in match_idx):
            continue
        try:
            d = 0.0
            for i in near_idx:
                a, b = float(q[i]), float(key[i])
                if a <= 0 or b <= 0:
                    d += 0.0 if a == b else float("inf")
                else:
                    d += abs(math.log(a / b))
        except ValueError:
            continue
        if max_dist is not None and d > max_dist:
            continue
        if best_d is None or d < best_d:
            best, best_d = val, d
    return best


def entries(op: str) -> Dict[Tuple[str, ...], Any]:
    """Every known entry of one op (a copy)."""
    with _lock:
        _load_once()
        return dict(_STATE["cache"].get(op, {}))


def record(op: str, parts, value, *, source: Optional[str] = None,
           run: Optional[str] = None,
           improvement: Optional[float] = None) -> None:
    """Record a tuned value: the process cache at once, the disk table
    best effort by an atomic read-modify-write.  ``source`` ('sweep' |
    'autotune' | 'manual'), ``run`` and ``improvement`` (the measured
    fraction it beat the incumbent by) stamp provenance, written in the
    same atomic write as the value."""
    meta = None
    if source is not None or run is not None or improvement is not None:
        meta = {"source": source or "manual"}
        if run:
            meta["run"] = str(run)
        if improvement is not None:
            meta["improvement"] = round(float(improvement), 6)
    with _lock:
        _load_once()
        _STATE["cache"].setdefault(op, {})[_key_tuple(parts)] = value
        if meta is not None:
            _STATE["cache"].setdefault(META_OP, {})[
                (op,) + _key_tuple(parts)] = meta
        path = tuning_path()
        if not path:
            return
        try:
            data = {}
            try:
                with open(path) as f:
                    loaded = json.load(f)
                if isinstance(loaded, dict):
                    data = loaded
            except (OSError, ValueError):
                pass  # corrupt table: overwrite it with what we know
            data[key_str(op, parts)] = value
            if meta is not None:
                data[key_str(META_OP, (op,) + _key_tuple(parts))] = meta
            from ..framework.fs import open_for_write
            with open_for_write(path, "w") as f:
                json.dump(data, f, indent=0, sort_keys=True)
        except OSError:
            pass


def provenance(op: str, parts) -> Optional[Dict[str, Any]]:
    """The provenance stamp recorded with (op, key), or None."""
    with _lock:
        _load_once()
        m = _STATE["cache"].get(META_OP, {}).get((op,) + _key_tuple(parts))
        return dict(m) if isinstance(m, dict) else None


def all_entries() -> Dict[str, Dict[Tuple[str, ...], Any]]:
    """Every op's entries (a copy), provenance left out: the report's
    feed."""
    with _lock:
        _load_once()
        return {op: dict(t) for op, t in _STATE["cache"].items()
                if op != META_OP}


def reset_for_tests() -> None:
    """Drop the process cache so the next lookup reads the file again
    (after ``PADDLE_TPU_TUNING_CACHE`` points elsewhere)."""
    with _lock:
        _STATE["loaded"] = False
        _STATE["cache"] = {}
