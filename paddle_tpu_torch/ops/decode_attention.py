"""Single-token decode attention over a dense KV cache: hand-written
Hopper kernel + plain version.

Counterpart of the dense path of ``paddle_tpu/ops/decode_attention.py``.
Layout contract is the JAX package's: q ``[B, H, D]`` (the new token's
query per slot), caches ``[B, S, Hkv, D]`` that already hold the new
token's k/v, lengths ``[B]`` int32 counting the valid positions per slot
including the new one.  GQA native (``h = hk * G + g``).

Dispatch: a CPU tensor goes to the plain version (``_decode_plain``); a
CUDA tensor goes to the kernel in ``csrc/decode_attention.cu`` or the
call raises.  The kernel takes bf16/fp16, D in {64, 128}, H / Hkv in
{1, 2, 4, 8}, contiguous tensors and int32 lengths, and reads only the
positions below ``lengths[b]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["decode_attention", "DECODE_ATTENTION"]

_NEG = -1e30

DECODE_ATTENTION = _build.CudaKernel(
    "decode_attention.cu", "decode_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _decode_plain(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """Reference math in f32, mirroring the JAX ``_decode_composite``,
    except that a slot with ``lengths[b] == 0`` gives zeros (the JAX
    kernel's ``1e-30`` guard) rather than the composite's uniform
    average over masked positions."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(d)
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(torch.int64)[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p / l, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def _decode_cuda(q, k_cache, v_cache, lengths):
    b, h, d = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: caches must be [B, S, Hkv, D] "
                         f"matching q {tuple(q.shape)}, got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if hkv == 0 or h % hkv or h // hkv not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention kernel needs H / Hkv in "
                         f"(1, 2, 4, 8), got H={h}, Hkv={hkv}")
    if d not in (64, 128):
        raise ValueError(f"decode_attention kernel supports D in (64, 128), "
                         f"got {d}")
    if q.dtype not in _build.DTYPE_CODES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes bf16/fp16 q and "
                        f"caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise TypeError(f"decode_attention kernel needs int32 lengths [B], "
                        f"got {lengths.dtype} {tuple(lengths.shape)}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention kernel needs contiguous, "
                             f"16-byte aligned {name}")
    o = torch.empty_like(q)
    DECODE_ATTENTION(_build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
                     _build.ptr(lengths), _build.ptr(o), b, s, h, hkv, d,
                     _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    return o


def decode_attention(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """Attention of each slot's new token over its first ``lengths[b]``
    cache positions; returns ``[B, H, D]``.  CPU tensors run the plain
    version; CUDA tensors run the kernel or raise."""
    if q.device.type == "cpu":
        return _decode_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _decode_cuda(q, k_cache, v_cache, lengths)
