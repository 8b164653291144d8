"""Unique-name scopes (counterpart of ``paddle_tpu/utils/unique_name.py``).

``generate(key)`` hands out ``key_0``, ``key_1``, ... from per-key
counters.  Layers take their default full names (``linear_0``, and so
their parameters' ``linear_0.w_0``) from per-class counters in
``nn.layer_base``.  ``guard()`` swaps in fresh counters of both kinds
(and, given a string, a name prefix) for the block and restores the old
ones after it, so a model built inside it gets the same names in every
process, whatever was built before.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

__all__ = ["generate", "guard", "switch"]

_generate_counters: Dict[str, int] = {}
_prefix: str = ""


def generate(key: str) -> str:
    """``key`` -> ``key_0``, ``key_1``, ... under the active guard's
    prefix."""
    idx = _generate_counters.get(key, 0)
    _generate_counters[key] = idx + 1
    return f"{_prefix}{key}_{idx}"


def switch(new_counters: Optional[dict] = None):
    """Swap the ``generate`` counters and clear the layers' naming
    counters; returns the previous ``(generate, layer)`` counters."""
    from ..nn import layer_base
    global _generate_counters
    prev = (_generate_counters, dict(layer_base._layer_name_counters))
    _generate_counters = new_counters or {}
    layer_base._layer_name_counters.clear()
    return prev


@contextlib.contextmanager
def guard(new_generator: Optional[str] = None):
    """Fresh name counters inside the block, optionally under the string
    prefix ``new_generator`` (layers' default names take it too, so two
    guards give disjoint state-dict keys); the previous scope after."""
    from ..nn import layer_base
    global _prefix, _generate_counters
    if new_generator is not None and not isinstance(new_generator, str):
        raise TypeError("guard(new_generator) takes a str prefix")
    prev_gen, prev_layer = switch()
    prev_prefix, _prefix = _prefix, (new_generator or "")
    layer_base._layer_name_prefix = _prefix
    try:
        yield
    finally:
        _generate_counters = prev_gen
        _prefix = prev_prefix
        layer_base._layer_name_prefix = prev_prefix
        layer_base._layer_name_counters.clear()
        layer_base._layer_name_counters.update(prev_layer)
