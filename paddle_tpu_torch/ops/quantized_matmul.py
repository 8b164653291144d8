"""int8 quantized compute and KV-cache quantization (counterpart of
``paddle_tpu/ops/quantized_matmul.py``).

Symmetric amax scaling at per-(position, head) granularity: each
``head_dim`` vector of a key or value gets one f32 scale
``max(amax, 1e-8) / 127`` and is stored as int8 codes
``clip(round(x / scale), -127, 127)`` (``torch.round`` rounds half to
even, as ``jnp.round`` does).  The decode kernels stream the codes and
scales and dequantize in registers; the composites dequantize first.

The matmul half: :func:`quantized_matmul` computes ``x @ w`` through
int8 codes, activations scaled per row and weights per output column,
exact int32 sums rescaled in f32 as ``(acc * sx) * sw``;
:func:`fake_quant_matmul` is the training op of ``GPTConfig(quantize=
'int8')`` and ``strategy.qat`` (that forward, a straight-through
backward over the dequantized operands).  A CPU tensor runs the plain
version ``_qmm_plain``; a CUDA tensor runs the hand-written kernel
``csrc/quantized_matmul.cu`` (int8 tensor-core products) or raises.  The
kernel takes the weight codes transposed, ``[N, K]``: the int8 tensor
core product wants both operands K-contiguous.  Weights are quantized on
every call, as the JAX package does.  The JAX module's TPU tile table
(``get_qmm_tiles``, ``autotune_qmm_sweep``) and its backend probe
(``quantized_matmul_available``) have no counterpart here.

Only ``'int8'`` is served.  ``'fp8'`` (e4m3) is a mode name of the JAX
package, where it rides the composite with no kernel; the card has e4m3
natively, so fp8 is its own later item (ROADMAP.md, Queue 2) and raises
``NotImplementedError`` here.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import _build

__all__ = ["QUANT_DTYPES", "kv_storage_dtype", "kv_quant_mode",
           "resolve_kv_quant", "quantize_channel", "quantize_kv",
           "dequantize_kv", "write_kv", "quantized_matmul",
           "fake_quant_matmul",
           "QUANTIZED_MATMUL"]

QUANT_DTYPES = ("int8", "fp8")
_EPS = 1e-8


def _check_mode(dtype: str) -> str:
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"quantize dtype must be one of {QUANT_DTYPES}, "
                         f"got {dtype!r}")
    if dtype == "fp8":
        raise NotImplementedError(
            "fp8 (e4m3) quantization is not ported yet: the JAX package "
            "serves it through its composite only; see ROADMAP.md, Queue 2 "
            "(fp8) — use 'int8'")
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
    amax = torch.clamp(xf.abs().amax(dim=axis, keepdim=True), min=_EPS)
    # a tensor divisor: on the card PyTorch multiplies by the reciprocal
    # of a scalar divisor, which can land one ulp off the quotient the CPU
    # and the JAX package compute
    scale = amax / torch.full_like(amax, _qmax(dtype))
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


def write_kv(k_dst, v_dst, ks_dst, vs_dst, index, k, v):
    """Store k/v ``[..., Hkv, D]`` at ``k_dst[index]``/``v_dst[index]``
    (in place), dense or paged: as they are, or as int8 codes with their
    scales when the cache is quantized (``ks_dst`` not None)."""
    if ks_dst is None:
        k_dst[index] = k.to(k_dst.dtype)
        v_dst[index] = v.to(v_dst.dtype)
        return
    # k and v quantized together: one pass of the quantizer's small
    # elementwise kernels instead of two, on the per-step decode path
    codes, scales = quantize_kv(torch.stack([k, v]))
    k_dst[index], ks_dst[index] = codes[0], scales[0]
    v_dst[index], vs_dst[index] = codes[1], scales[1]


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


# ---- quantized compute: int8 x int8 -> exact int32 -> f32 rescale ------

_P, _I = ctypes.c_void_p, ctypes.c_int
QUANTIZED_MATMUL = _build.CudaKernel(
    "quantized_matmul.cu", "quantized_matmul", [_P] * 5 + [_I] * 4 + [_P])
_OUT_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _qmm_plain(qx, qw, sx, sw, out_dtype):
    """The JAX ``_qmm_composite``: ``qx [M, K] @ qw [K, N]`` in exact
    integer arithmetic (int64 on the CPU; float64 on the card, exact below
    2^53), then ``(acc.float() * sx) * sw`` in f32, cast to
    ``out_dtype``."""
    wide = torch.float64 if qx.is_cuda else torch.int64
    acc = torch.matmul(qx.to(wide), qw.to(wide))
    return (acc.float() * sx * sw).to(out_dtype)


def _qmm_cuda(qx, qw_t, sx, sw, out_dtype):
    """The kernel on int8 ``qx [M, K]`` and transposed weight codes
    ``qw_t [N, K]``, f32 ``sx [M, 1]`` and ``sw [1, N]``; raises on what it
    does not take: N and K multiples of 128, out dtype bf16/fp16/f32,
    contiguous 16-byte aligned tensors on one device."""
    m, k = qx.shape
    n = qw_t.shape[0]
    if qw_t.shape[1] != k or tuple(sx.shape) != (m, 1) \
            or tuple(sw.shape) != (1, n):
        raise ValueError(f"quantized_matmul: shapes qx {tuple(qx.shape)}, "
                         f"qw_t {tuple(qw_t.shape)}, sx {tuple(sx.shape)}, "
                         f"sw {tuple(sw.shape)} do not agree")
    if n % 128 or k % 128:
        raise ValueError(f"quantized_matmul kernel needs N and K multiples "
                         f"of 128, got N={n}, K={k}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"quantized_matmul kernel writes bf16/fp16/f32, not "
                        f"{out_dtype}")
    for name, t, dt in (("qx", qx, torch.int8), ("qw_t", qw_t, torch.int8),
                        ("sx", sx, torch.float32), ("sw", sw, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"quantized_matmul kernel needs {dt} {name}, got "
                            f"{t.dtype}")
        if t.device != qx.device:
            raise ValueError(f"quantized_matmul: {name} on {t.device}, qx on "
                             f"{qx.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"quantized_matmul kernel needs contiguous, "
                             f"16-byte aligned {name}")
    y = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    QUANTIZED_MATMUL(_build.ptr(qx), _build.ptr(qw_t), _build.ptr(sx),
                     _build.ptr(sw), _build.ptr(y), m, n, k,
                     _OUT_CODES[out_dtype], _build.stream_ptr(qx))
    return y


def _qmm_forward(x, w, dtype, out_dtype):
    """Quantize and dispatch, shared by :func:`quantized_matmul` and the
    fake-quant forward: returns ``(y [..., N], qx, sx, qw, sw)`` with
    ``qx``/``sx`` over the flattened ``[M, K]`` activations and ``qw``
    ``[K, N]``.  On the card the weight codes are made transposed
    (``quantize_channel`` of ``w.t()`` over its rows: the same codes and
    scales) and ``qw`` is their ``[K, N]`` view; any M goes to the kernel,
    where the JAX package sends ``M % 32 != 0`` to its composite."""
    _check_mode(dtype)
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[-1]
    qx, sx = quantize_channel(x.reshape(-1, k), axis=1, dtype=dtype)
    if x.device.type == "cpu":
        qw, sw = quantize_channel(w, axis=0, dtype=dtype)
        y = _qmm_plain(qx, qw, sx, sw, out_dtype)
    elif x.device.type == "cuda":
        qw_t, sw_t = quantize_channel(w.t(), axis=1, dtype=dtype)
        qw_t = qw_t.contiguous()
        sw = sw_t.reshape(1, n)
        y = _qmm_cuda(qx.contiguous(), qw_t, sx, sw, out_dtype)
        qw = qw_t.t()
    else:
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    return y.reshape(*lead, n), qx, sx, qw, sw


def quantized_matmul(x, w, dtype: str = "int8", out_dtype=None):
    """``x [..., K] @ w [K, N]`` through ``dtype`` quantization:
    activations amax-scaled per row, weights per output column, the int8
    product's exact sums rescaled to ``out_dtype`` (default ``x.dtype``).
    CPU tensors run the plain version; CUDA tensors run the kernel or
    raise."""
    y, *_ = _qmm_forward(x, w, dtype, out_dtype or x.dtype)
    return y


class _FakeQuantMatmul(torch.autograd.Function):
    """Quantized forward; straight-through backward: the two plain
    products of the JAX ``_fake_quant_bwd`` over the dequantized operands
    in f32, as if quantization were the identity."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        y, qx, sx, qw, sw = _qmm_forward(x, w, dtype, x.dtype)
        xdq = (qx.float() * sx).reshape(x.shape).to(x.dtype)
        wdq = (qw.float() * sw).to(w.dtype)
        ctx.save_for_backward(xdq, wdq)
        return y

    @staticmethod
    def backward(ctx, g):
        xdq, wdq = ctx.saved_tensors
        k, n = xdq.shape[-1], g.shape[-1]
        g2 = g.reshape(-1, n).float()
        dx = torch.matmul(g2, wdq.float().t())
        dw = torch.matmul(xdq.reshape(-1, k).float().t(), g2)
        return dx.reshape(xdq.shape).to(xdq.dtype), dw.to(wdq.dtype), None


def fake_quant_matmul(x, w, dtype: str = "int8"):
    """Quantized forward, straight-through backward: numerically
    ``fq(x) @ fq(w)`` with ``fq(t) = t + (qdq(t) - t).detach()``.  The
    parameters keep their dtype, so optimizers are untouched."""
    _check_mode(dtype)
    if not torch.is_grad_enabled() or not (x.requires_grad
                                           or w.requires_grad):
        # no backward to come: the forward alone, without the dequantized
        # copies the backward would keep
        return quantized_matmul(x, w, dtype)
    return _FakeQuantMatmul.apply(x, w, dtype)
