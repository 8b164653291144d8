"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/fleet/strategy.py``): the JAX package's on/off
flags with their defaults, and the settings the port's ``SpmdTrainer``
reads.  The trainer honors ``amp`` (bf16) and ``recompute`` and raises
on every other enabled flag but the three that are moot on one
device."""
from __future__ import annotations

import copy
from typing import Any, Dict

__all__ = ["DistributedStrategy"]

_DEFAULTS: Dict[str, Any] = {
    "amp": False,
    # bf16 needs no loss scaling; fp16 with dynamic loss scaling (the
    # JAX package's other amp_configs keys) is not ported
    "amp_configs": {"use_bf16": True},
    "recompute": False,
    "recompute_configs": {"policy": "dots", "scan_layers": False},
    # flags of the JAX package's trainers that this one refuses for now
    "sharding": False, "gradient_merge": False, "qat": False,
    "tensor_parallel": False, "pipeline": False, "sequence_parallel": False,
    "expert_parallel": False, "lamb": False, "lars": False,
    "localsgd": False, "adaptive_localsgd": False, "dgc": False,
    "a_sync": False, "elastic": False, "auto": False,
    "fp16_allreduce": False,
    # moot on one device
    "find_unused_parameters": False, "use_hierarchical_allreduce": False,
    "fuse_all_reduce_ops": True,
}


class DistributedStrategy:
    def __init__(self):
        self._conf = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        conf = object.__getattribute__(self, "_conf")
        if name in conf:
            return conf[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name == "_conf":
            object.__setattr__(self, name, value)
            return
        if name not in self._conf:
            raise AttributeError(f"unknown strategy field {name!r}")
        cur = self._conf[name]
        if isinstance(cur, dict) and isinstance(value, dict):
            cur.update(value)
        else:
            self._conf[name] = value

    def to_dict(self):
        return copy.deepcopy(self._conf)

    def __repr__(self):
        on = [k for k, v in self._conf.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
