"""Flash-attention forward: hand-written Hopper kernel + plain version.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  Layout contract
is the JAX package's: q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]`` with
``H % Hkv == 0`` (query head ``h = hk * G + g`` reads kv head ``hk``),
an optional key mask ``kv_mask [B, S]`` (1 = attend, 0 = padding).

Dispatch: a CPU tensor goes to the plain PyTorch version
(``_flash_plain``); a CUDA tensor goes to the kernel in
``csrc/flash_fwd.cu`` or the call raises.  The kernel takes bf16/fp16,
D in {64, 128}, S == Sk of any length (prefill buckets 16, 32, ...: the
ragged edge is masked in the kernel) and contiguous tensors.

Only the forward is here; the backward kernels come with training.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "FLASH_FWD"]

_NEG = -1e30

FLASH_FWD = _build.CudaKernel(
    "flash_fwd.cu", "flash_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _flash_plain(q, k, v, causal: bool = False,
                 kv_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference math in f32, mirroring the JAX ``_composite``: scores
    masked to -1e30, fully masked rows give exact zeros.  Also returns
    the per-row lse ``[B, H, S]`` (f32) the kernel emits:
    ``m + log(max(l, 1e-30))`` with ``m`` the masked row max and ``l``
    the sum of ``exp(s - m)`` over unmasked keys."""
    b, s, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=2)
        vf = vf.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    keep = torch.ones(s, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep, diagonal=sk - s)
    keep = keep[None, None]
    if kv_mask is not None:
        keep = keep & (kv_mask[:, None, None, :] > 0)
    scores = torch.where(keep, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(scores <= _NEG / 2, torch.zeros_like(scores),
                    torch.exp(scores - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vf)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


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


def flash_attention_fwd(q, k, v, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, S, H, D], lse [B, H, S] f32)``.  CPU tensors run the plain
    version; CUDA tensors run the kernel or raise."""
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_cuda(q, k, v, causal, kv_mask)


def flash_attention(q, k, v, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output ``[B, S, H, D]`` (see ``flash_attention_fwd``)."""
    return flash_attention_fwd(q, k, v, causal, kv_mask)[0]
