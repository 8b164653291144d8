"""KV-cache quantization (counterpart of the KV half of
``paddle_tpu/ops/quantized_matmul.py``).

Symmetric amax scaling at per-(position, head) granularity: each
``head_dim`` vector of a key or value gets one f32 scale
``max(amax, 1e-8) / 127`` and is stored as int8 codes
``clip(round(x / scale), -127, 127)`` (``torch.round`` rounds half to
even, as ``jnp.round`` does).  The decode kernels stream the codes and
scales and dequantize in registers; the composites dequantize first.

Only ``'int8'`` is served.  ``'fp8'`` (e4m3) is a mode name of the JAX
package, where it rides the composite with no kernel; the card has e4m3
natively, so fp8 KV is its own later item (ROADMAP.md, Queue 2) and
raises ``NotImplementedError`` here.  The int8 matmul half of the JAX
module (``quantized_matmul``, ``fake_quant_matmul``) is not ported yet.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["QUANT_DTYPES", "kv_storage_dtype", "kv_quant_mode",
           "resolve_kv_quant", "quantize_channel", "quantize_kv",
           "dequantize_kv"]

QUANT_DTYPES = ("int8", "fp8")
_EPS = 1e-8


def _check_mode(dtype: str) -> str:
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"quantize dtype must be one of {QUANT_DTYPES}, "
                         f"got {dtype!r}")
    if dtype == "fp8":
        raise NotImplementedError(
            "fp8 (e4m3) KV quantization is not ported yet: the JAX package "
            "serves it through its composite only; see ROADMAP.md, Queue 2 "
            "(fp8 KV) — use 'int8'")
    return dtype


def _qmax(dtype: str) -> float:
    """Largest code of the mode: ±127 for int8."""
    _check_mode(dtype)
    return 127.0


def kv_storage_dtype(dtype: str) -> torch.dtype:
    """The storage dtype of a quantized KV cache."""
    _check_mode(dtype)
    return torch.int8


def kv_quant_mode(storage_dtype: torch.dtype) -> str:
    """Inverse of :func:`kv_storage_dtype`."""
    if storage_dtype == torch.int8:
        return "int8"
    raise ValueError(f"not a quantized KV storage dtype: {storage_dtype}")


def resolve_kv_quant(name: Optional[str] = None) -> Optional[str]:
    """Normalize a ``kv_dtype`` knob (argument, else the
    ``PADDLE_TPU_KV_DTYPE`` environment variable) to a quant mode, or
    None for the full-precision cache (the default)."""
    if name is None:
        name = os.environ.get("PADDLE_TPU_KV_DTYPE", "")
    name = str(name).strip().lower()
    if name in ("", "0", "none", "off", "dense", "fp32", "bf16",
                "bfloat16", "float32"):
        return None
    return _check_mode(name)


def _cast_q(x_scaled: torch.Tensor) -> torch.Tensor:
    """Scaled values -> int8 codes: round half to even, clip to ±127."""
    return torch.clamp(torch.round(x_scaled), -127.0, 127.0).to(torch.int8)


def quantize_channel(x: torch.Tensor, axis: int, dtype: str = "int8"):
    """Symmetric amax quantization per channel along ``axis`` (the axis
    reduced per channel).  Returns ``(q, scale)`` with ``scale``
    keepdims-shaped so ``q.float() * scale ≈ x``."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / _qmax(dtype)
    return _cast_q(xf / scale), scale


def quantize_kv(x: torch.Tensor, dtype: str = "int8"):
    """``x [..., head_dim]`` -> ``(q [..., head_dim] int8, scale [...]
    f32)`` with ``q.float() * scale[..., None] ≈ x``."""
    q, scale = quantize_channel(x, axis=-1, dtype=dtype)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (``scale`` without the trailing
    head_dim axis)."""
    return (q.float() * scale[..., None].float()).to(dtype)


def kv_zeros(shape, mode: Optional[str], dtype: torch.dtype, device):
    """Zeroed storage of a KV cache (dense or paged) of ``shape [...,
    Hkv, D]``: ``(k, v, None, None)`` in ``dtype``, or for a quant
    ``mode`` its codes and f32 scales ``shape[:-1]``."""
    if mode is None:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device), None, None)
    codes = kv_storage_dtype(mode)
    return (torch.zeros(shape, dtype=codes, device=device),
            torch.zeros(shape, dtype=codes, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))
