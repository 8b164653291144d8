"""Weight bridge from a ``paddle_tpu`` GPT to the port.

The input is ``{name: np.asarray(p.data) for name, p in
jax_model.named_parameters()}``.  Both packages name and lay out GPT
parameters identically (linear weights ``[in, out]``, embeddings
``[vocab, hidden]``), so every JAX name maps to the port parameter of
the same name and NO tensor is transposed.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_paddle_tpu", "load_paddle_tpu_params"]

# every GPT parameter name the port defines
_NAME = re.compile(
    r"^(gpt\.(wte|wpe|ln_f)\.(weight|bias)"
    r"|gpt\.blocks\.\d+\.(ln_1|ln_2|attn\.qkv_proj|attn\.out_proj"
    r"|mlp\.up_proj|mlp\.down_proj)\.(weight|bias)"
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
