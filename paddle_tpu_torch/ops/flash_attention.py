"""Flash attention, forward and backward: hand-written Hopper kernels +
plain versions.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  Layout contract
is the JAX package's: q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]`` with
``H % Hkv == 0`` (query head ``h = hk * G + g`` reads kv head ``hk``),
an optional key mask ``kv_mask [B, S]`` (1 = attend, 0 = padding).

``flash_attention`` / ``flash_attention_fwd`` run through the autograd
function ``_FlashAttention``: its forward emits o and the per-row lse
``[B, H, S]`` (f32) and saves both; its backward makes ``do``
contiguous, computes ``delta = rowsum(do * o)`` in f32 from the SAVED o
(as the JAX ``_bwd_gqa`` does) and calls the dq and dk/dv kernels.

Dispatch: CPU tensors run the plain versions (``_flash_plain``,
``_flash_bwd_plain``); CUDA tensors run the kernels in
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkv.cu`` or the call raises.  The kernels take
bf16/fp16, D in {64, 128}, S == Sk of any length (the ragged edge is
masked in the kernels) and contiguous tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "FLASH_FWD",
           "FLASH_BWD_DQ", "FLASH_BWD_DKV"]

_NEG = -1e30

FLASH_FWD = _build.CudaKernel(
    "flash_fwd.cu", "flash_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
FLASH_BWD_DQ = _build.CudaKernel(
    "flash_bwd_dq.cu", "flash_bwd_dq",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
FLASH_BWD_DKV = _build.CudaKernel(
    "flash_bwd_dkv.cu", "flash_bwd_dkv",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _math_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 for the half types and f32, f64 for f64 (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _masked_scores(q, k, causal, kv_mask):
    """``scale * q k^T`` as ``[B, H, S, Sk]`` in the math dtype, masked
    scores set to -1e30, and k expanded to H heads."""
    b, s, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kf = k.to(_math_dtype(q))
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(kf.dtype), kf) \
        / math.sqrt(d)
    keep = torch.ones(s, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep, diagonal=sk - s)
    keep = keep[None, None]
    if kv_mask is not None:
        keep = keep & (kv_mask[:, None, None, :] > 0)
    return torch.where(keep, scores, torch.full_like(scores, _NEG)), kf


def _expand(t, h):
    hkv = t.shape[2]
    return t if hkv == h else t.repeat_interleave(h // hkv, dim=2)


def _flash_plain(q, k, v, causal: bool = False,
                 kv_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference math in f32 (f64 for f64 inputs), mirroring the JAX
    ``_composite``: scores masked to -1e30, fully masked rows give exact
    zeros.  Also returns the per-row lse ``[B, H, S]`` the kernel emits:
    ``m + log(max(l, 1e-30))`` with ``m`` the masked row max and ``l``
    the sum of ``exp(s - m)`` over unmasked keys."""
    scores, _ = _masked_scores(q, k, causal, kv_mask)
    vf = _expand(v.to(scores.dtype), q.shape[2])
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(scores <= _NEG / 2, torch.zeros_like(scores),
                    torch.exp(scores - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vf)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _flash_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                     kv_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference backward in f32 (f64 for f64 inputs), the math of the
    JAX ``_bwd_gqa``: ``p = exp(s - lse)`` recomputed from the saved lse
    (0 where masked), ``delta = rowsum(do * o)`` from the saved o,
    ``ds = p * (dp - delta)``; dk and dv summed over each kv head's
    group.  Returns ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scores, kf = _masked_scores(q, k, causal, kv_mask)
    acc = scores.dtype
    qf, of, dof = q.to(acc), o.to(acc), do.to(acc)
    vf = _expand(v.to(acc), h)
    p = torch.where(scores <= _NEG / 2, torch.zeros_like(scores),
                    torch.exp(scores - lse.to(acc)[..., None]))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)                  # [B, H, S]
    ds = p * (dp - delta[..., None])
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    if hkv != h:        # query head h = hk * G + g: sum each group
        dk = dk.reshape(b, s, hkv, h // hkv, d).sum(3)
        dv = dv.reshape(b, s, hkv, h // hkv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(q, k, v, kv_mask):
    b, s, h, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b:
        raise ValueError(f"flash_attention: k/v must be [B, S, Hkv, D] like "
                         f"q {tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    sk, hkv = k.shape[1], k.shape[2]
    if sk != s or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention kernel needs S == Sk, equal D and "
                         f"H % Hkv == 0: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_attention kernel supports D in (64, 128), "
                         f"got {d}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16/fp16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs contiguous, "
                             f"16-byte aligned {name}")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, s) or kv_mask.dtype != torch.float32 \
                or not kv_mask.is_contiguous() or kv_mask.device != q.device:
            raise ValueError(f"flash_attention kernel needs kv_mask as a "
                             f"contiguous f32 [B, S] tensor on {q.device}")


def _check_operand(name, t, q, shape, dtype):
    """A backward operand: on q's device, of ``shape`` and ``dtype``,
    contiguous and 16-byte aligned."""
    if t.device != q.device:
        raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                         f"{q.device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"flash_attention backward kernels need a "
                         f"contiguous, 16-byte aligned {name} of shape "
                         f"{tuple(shape)} and dtype {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _flash_cuda(q, k, v, causal, kv_mask):
    _check_cuda(q, k, v, kv_mask)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    FLASH_FWD(_build.ptr(q), _build.ptr(k), _build.ptr(v),
              _build.ptr(kv_mask), _build.ptr(o), _build.ptr(lse),
              b, s, h, k.shape[2], d, int(bool(causal)),
              _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    return o, lse


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask):
    _check_cuda(q, k, v, kv_mask)
    b, s, h, d = q.shape
    _check_operand("o", o, q, q.shape, q.dtype)
    _check_operand("do", do, q, q.shape, q.dtype)
    _check_operand("lse", lse, q, (b, h, s), torch.float32)
    # delta_i = do_i . o_i from the saved o, in f32 (JAX _bwd_gqa :577)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(kv_mask))
    dims = (b, s, h, k.shape[2], d, int(bool(causal)),
            _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    FLASH_BWD_DQ(*args, _build.ptr(dq), *dims)
    FLASH_BWD_DKV(*args, _build.ptr(dk), _build.ptr(dv), *dims)
    return dq, dk, dv


def _fwd(q, k, v, causal, kv_mask):
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, kv_mask)
    return _flash_cuda(q, k, v, causal, kv_mask)


def _bwd(q, k, v, o, lse, do, causal, kv_mask):
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, o, lse, do, causal, kv_mask)
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask)


class _FlashAttention(torch.autograd.Function):
    """o and lse from the forward kernel; the backward recomputes p from
    the saved lse in the dq and dk/dv kernels (plain versions on the
    CPU).  lse is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        o, lse = _fwd(q, k, v, causal, kv_mask)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                          kv_mask)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, S, H, D], lse [B, H, S] f32)``, differentiable in q, k
    and v.  CPU tensors run the plain versions; CUDA tensors run the
    kernels or raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal))


def flash_attention(q, k, v, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output ``[B, S, H, D]`` (see ``flash_attention_fwd``)."""
    return flash_attention_fwd(q, k, v, causal, kv_mask)[0]
