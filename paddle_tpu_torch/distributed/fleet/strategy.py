"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/fleet/strategy.py``): the JAX package's on/off
flags with their defaults, and the settings the port's ``SpmdTrainer``
reads.  The trainer honors ``amp`` (bf16, or fp16 with dynamic loss
scaling), ``recompute`` (every policy), ``qat`` and ``gradient_merge``,
and raises on every other enabled flag but the three that are moot on
one device."""
from __future__ import annotations

import copy
from typing import Any, Dict

__all__ = ["DistributedStrategy"]

_DEFAULTS: Dict[str, Any] = {
    "amp": False,
    # bf16 needs no loss scaling; use_bf16=False is fp16 with dynamic
    # loss scaling under these settings (use_dynamic_loss_scaling and the
    # white/black lists are the JAX package's keys and read by neither
    # trainer)
    "amp_configs": {
        "init_loss_scaling": 32768.0, "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2, "incr_ratio": 2.0, "decr_ratio": 0.5,
        "min_loss_scaling": 1.0, "use_dynamic_loss_scaling": True,
        "custom_white_list": [], "custom_black_list": [],
        "use_pure_fp16": False, "use_bf16": True,
    },
    "recompute": False,
    "recompute_configs": {"policy": "dots", "scan_layers": False},
    # quantization-aware training: every block linear through the int8
    # (or, with {"quantize": "fp8"}, e4m3) fake-quant matmul
    "qat": False,
    "qat_configs": {"quantize": "int8"},
    # k micro-steps accumulate their gradients; the update runs every
    # k-th step (divided by k under avg)
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    # flags of the JAX package's trainers that this one refuses for now
    "sharding": False,
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
