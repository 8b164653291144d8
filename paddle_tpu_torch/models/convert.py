"""Weight bridge from a ``paddle_tpu`` GPT to the port.

The input is ``{name: np.asarray(p.data) for name, p in
jax_model.named_parameters()}``.  Both packages name and lay out GPT
parameters identically (linear weights ``[in, out]``, embeddings
``[vocab, hidden]``, a MoE layer's ``gate [H, E]`` and stacked expert
weights ``experts.w_up [E, H, F]`` ...), so every JAX name maps to the
port parameter of the same name and NO tensor is transposed.

``trainer_state_from_paddle_tpu`` carries a whole training state, the
dict the JAX package's ``snapshot_trainer`` makes (and its checkpoints
pickle), into the port's ``restore_trainer``.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_paddle_tpu", "load_paddle_tpu_params",
           "trainer_state_from_paddle_tpu"]

# every GPT parameter name the port defines
_NAME = re.compile(
    r"^(gpt\.(wte|wpe|ln_f)\.(weight|bias)"
    r"|gpt\.blocks\.\d+\.(ln_1|ln_2|attn\.qkv_proj|attn\.out_proj"
    r"|mlp\.up_proj|mlp\.down_proj)\.(weight|bias)"
    r"|gpt\.blocks\.\d+\.mlp\.(gate|experts\.(w_up|b_up|w_down|b_down))"
    r"|lm_head\.weight)$")


def params_from_paddle_tpu(named: Dict[str, np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
    """``{port name: CPU tensor}`` from the JAX package's named arrays;
    raises on a name the port has no parameter for."""
    unknown = sorted(n for n in named if not _NAME.match(n))
    if unknown:
        raise KeyError(f"no paddle_tpu_torch parameter for: {unknown}")
    return {n: torch.from_numpy(np.array(a, copy=True))
            for n, a in named.items()}


def load_paddle_tpu_params(model: torch.nn.Module,
                           named: Dict[str, np.ndarray],
                           dtype: Optional[torch.dtype] = None
                           ) -> torch.nn.Module:
    """Copy the JAX package's weights into ``model`` in place (cast to
    ``dtype``, default each parameter's own).  Every name must match one
    model parameter of the same shape, and every model parameter must be
    covered: an unknown, missing or misshapen name raises."""
    tensors = params_from_paddle_tpu(named)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(tensors))
    extra = sorted(set(tensors) - set(params))
    if missing or extra:
        raise KeyError(f"weight names differ: missing {missing}, "
                       f"unexpected {extra}")
    for n, t in tensors.items():
        p = params[n]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{n}: shape {tuple(t.shape)} != model "
                             f"{tuple(p.shape)}")
    with torch.no_grad():
        for n, t in tensors.items():
            p = params[n]
            if dtype is not None:
                p.data = p.data.to(dtype)
            p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model


# the JAX state's record of its mesh and shardings: no meaning on one
# device
_TOPOLOGY_KEYS = ("mesh_axes", "sharding_specs")


def _owned(tree):
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def trainer_state_from_paddle_tpu(state: dict) -> dict:
    """The port's trainer state from a JAX ``snapshot_trainer`` dict
    (numpy): parameters, Adam moments and gradient-merge buffers under
    the same parameter names, the step count, the LR scheduler's state,
    the fp16 scaler and the skip counters.  Every parameter name must
    be one the port defines (``KeyError`` otherwise); the mesh record of
    a version-2 state is dropped.  Arrays are copied, so the result
    shares no memory with ``state``."""
    if state.get("format") != "paddle_tpu_trainer_ckpt_v1":
        raise ValueError("not a paddle_tpu trainer state")
    names = set(state["params"]) | set(state["opt_state"]) | \
        set(state.get("grad_buf") or ())
    unknown = sorted(n for n in names if not _NAME.match(n))
    if unknown:
        raise KeyError(f"no paddle_tpu_torch parameter for: {unknown}")
    out = {k: v for k, v in state.items() if k not in _TOPOLOGY_KEYS}
    out["version"] = 1
    for key in ("params", "opt_state", "buffers", "grad_buf", "scaler",
                "anomaly"):
        if key in state:
            out[key] = _owned(state[key])
    out["step_count"] = int(state["step_count"])
    if "lr_scheduler" in state:
        out["lr_scheduler"] = dict(state["lr_scheduler"])
    out["extra"] = dict(state.get("extra") or {})
    return out
