"""Decode attention over a dense or a paged KV cache, full precision,
int8 or fp8 (e4m3), for one new token per slot or a window of W:
hand-written Hopper kernels + plain versions.

Counterpart of ``paddle_tpu/ops/decode_attention.py`` (single-token and
window paths).
Layout contract is the JAX package's: q ``[B, H, D]`` (the new token's
query per slot), caches that already hold the new token's k/v, lengths
``[B]`` int32 counting the valid positions per slot including the new
one.  GQA native (``h = hk * G + g``, any ``G = H / Hkv``).

- ``decode_attention``: dense caches ``[B, S, Hkv, D]``;
- ``paged_decode_attention``: pools ``[NB, bs, Hkv, D]`` read through
  block tables ``[B, MB]`` int32 (position t of slot b at
  ``pool[tables[b, t // bs], t % bs]``; entries past a slot's extent
  point at the null block 0);
- with ``k_scale``/``v_scale`` (``[B, S, Hkv]`` dense, ``[NB, bs, Hkv]``
  paged, f32) the caches hold int8 or e4m3 (``torch.float8_e4m3fn``)
  codes of ``ops.quantized_matmul.quantize_kv``, dequantized inside the
  kernels.  The JAX package has TPU kernels for int8 caches only; its
  fp8 caches ride the composites, which the e4m3 kernels here
  (``*_f8.cu``) compute.

Dispatch: a CPU tensor goes to the plain version (``_decode_plain``,
``_paged_plain``); a CUDA tensor goes to its kernel in ``csrc/``
(``decode_attention.cu``, ``decode_attention_q.cu``,
``paged_decode_attention.cu``, ``paged_decode_attention_q.cu`` and the
e4m3 ``decode_attention_f8.cu``, ``paged_decode_attention_f8.cu``) or
the call raises.  The kernels take bf16/fp16 q, D in {64, 128}, bs a
multiple of 16, contiguous 16-byte-aligned tensors and int32 lengths and
tables, and read only the positions below ``lengths[b]``.

Window variants (the spec-decode verify and chunked prefill):
``decode_attention_window`` and ``paged_decode_attention_window`` take q
``[B, W, H, D]``, W consecutive new tokens per slot whose k/v the cache
already holds at ``lengths[b] .. lengths[b] + W - 1``, with ``lengths``
counting the tokens cached BEFORE the window; query i attends
``j <= lengths[b] + i`` (clamped to the capacity).  ``W = 1`` is
``decode_attention`` with ``lengths + 1``.  Plain versions
``_window_plain`` and ``_paged_window_plain``; kernels
``window_attention.cu``, ``window_attention_q.cu``,
``paged_window_attention.cu`` and ``paged_window_attention_q.cu``, and
the e4m3 ``window_attention_f8.cu`` and ``paged_window_attention_f8.cu``.
``chunk_prefill_attention`` and ``paged_chunk_prefill_attention`` name
the same functions for the chunked-prefill path.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .quantized_matmul import CODE_DTYPES

__all__ = ["decode_attention", "paged_decode_attention",
           "decode_attention_window", "paged_decode_attention_window",
           "chunk_prefill_attention", "paged_chunk_prefill_attention",
           "DECODE_ATTENTION", "DECODE_ATTENTION_Q", "PAGED_DECODE_ATTENTION",
           "PAGED_DECODE_ATTENTION_Q", "WINDOW_ATTENTION",
           "WINDOW_ATTENTION_Q", "PAGED_WINDOW_ATTENTION",
           "PAGED_WINDOW_ATTENTION_Q", "DECODE_ATTENTION_F8",
           "PAGED_DECODE_ATTENTION_F8", "WINDOW_ATTENTION_F8",
           "PAGED_WINDOW_ATTENTION_F8"]

_NEG = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
DECODE_ATTENTION = _build.CudaKernel(
    "decode_attention.cu", "decode_attention", [_P] * 5 + [_I] * 6 + [_P])
DECODE_ATTENTION_Q = _build.CudaKernel(
    "decode_attention_q.cu", "decode_attention_q", [_P] * 7 + [_I] * 6 + [_P])
PAGED_DECODE_ATTENTION = _build.CudaKernel(
    "paged_decode_attention.cu", "paged_decode_attention",
    [_P] * 6 + [_I] * 7 + [_P])
PAGED_DECODE_ATTENTION_Q = _build.CudaKernel(
    "paged_decode_attention_q.cu", "paged_decode_attention_q",
    [_P] * 8 + [_I] * 7 + [_P])
WINDOW_ATTENTION = _build.CudaKernel(
    "window_attention.cu", "window_attention", [_P] * 5 + [_I] * 7 + [_P])
WINDOW_ATTENTION_Q = _build.CudaKernel(
    "window_attention_q.cu", "window_attention_q", [_P] * 7 + [_I] * 7 + [_P])
PAGED_WINDOW_ATTENTION = _build.CudaKernel(
    "paged_window_attention.cu", "paged_window_attention",
    [_P] * 6 + [_I] * 8 + [_P])
PAGED_WINDOW_ATTENTION_Q = _build.CudaKernel(
    "paged_window_attention_q.cu", "paged_window_attention_q",
    [_P] * 8 + [_I] * 8 + [_P])
# the e4m3 forms: the same arguments as the int8 ones
DECODE_ATTENTION_F8 = _build.CudaKernel(
    "decode_attention_f8.cu", "decode_attention_f8",
    [_P] * 7 + [_I] * 6 + [_P])
PAGED_DECODE_ATTENTION_F8 = _build.CudaKernel(
    "paged_decode_attention_f8.cu", "paged_decode_attention_f8",
    [_P] * 8 + [_I] * 7 + [_P])
WINDOW_ATTENTION_F8 = _build.CudaKernel(
    "window_attention_f8.cu", "window_attention_f8",
    [_P] * 7 + [_I] * 7 + [_P])
PAGED_WINDOW_ATTENTION_F8 = _build.CudaKernel(
    "paged_window_attention_f8.cu", "paged_window_attention_f8",
    [_P] * 8 + [_I] * 8 + [_P])


def _quant_kernel(k, int8_kernel, f8_kernel):
    """The kernel of a quantized cache's code dtype (checked before)."""
    return f8_kernel if k.dtype == torch.float8_e4m3fn else int8_kernel


def _dequant_cache(cache, scale, dtype):
    """int8 or e4m3 cache values ``[..., Hkv, D]`` × per-(position, head)
    scales ``[..., Hkv]`` -> ``dtype`` (the JAX ``_dequant_cache``)."""
    return (cache.float() * scale[..., None].float()).to(dtype)


def _decode_plain(q, k_cache, v_cache, lengths, k_scale=None,
                  v_scale=None) -> torch.Tensor:
    """Reference math in f32, mirroring the JAX ``_decode_composite``:
    with scales, the caches are dequantized to q's dtype first (as the
    JAX kernel rounds its dequantized blocks to q's dtype).  A slot with
    ``lengths[b] == 0`` gives zeros (the JAX kernel's ``1e-30`` guard)
    rather than the composite's uniform average over masked positions."""
    if k_scale is not None:
        k_cache = _dequant_cache(k_cache, k_scale, q.dtype)
        v_cache = _dequant_cache(v_cache, v_scale, q.dtype)
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


def _paged_plain(q, k_pool, v_pool, tables, lengths, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """The JAX ``_paged_composite``: gather each slot's blocks through
    its table into the dense ``[B, MB * bs, Hkv, D]`` layout (scale pools
    likewise) and run the dense plain version."""
    b, mb = tables.shape
    bs, hkv, d = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    idx = tables.long()
    kg = k_pool[idx].reshape(b, mb * bs, hkv, d)
    vg = v_pool[idx].reshape(b, mb * bs, hkv, d)
    ksg = vsg = None
    if k_scale is not None:
        ksg = k_scale[idx].reshape(b, mb * bs, hkv)
        vsg = v_scale[idx].reshape(b, mb * bs, hkv)
    return _decode_plain(q, kg, vg, lengths, ksg, vsg)


def _check_cuda(name, q, k, v, lengths, k_scale, v_scale, scale_shape,
                tables=None):
    """Raise on anything the kernel does not take: q bf16/fp16 ``[B, H,
    D]`` (``[B, W, H, D]`` for the window kernels) with D in {64, 128};
    k/v of one shape with ``H % Hkv == 0``, in q's dtype (int8 or e4m3
    codes with scales of ``scale_shape`` f32); int32 lengths ``[B]`` (and
    tables
    ``[B, MB]``); every tensor on q's device, contiguous, 16-byte
    aligned."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    hkv = k.shape[-2]
    if v.shape != k.shape or k.shape[-1] != d or hkv == 0 or h % hkv:
        raise ValueError(f"{name}: k/v must have one shape [..., Hkv, D] "
                         f"with H % Hkv == 0 and q's D: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"{name} kernel supports D in (64, 128), got {d}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name} kernel takes a bf16/fp16 q, got {q.dtype}")
    quantized = k_scale is not None
    want = (k.dtype if k.dtype in CODE_DTYPES else torch.int8) \
        if quantized else q.dtype
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"{name} kernel needs {want} caches here, got "
                        f"{k.dtype}, {v.dtype}")
    if (v_scale is None) == quantized:
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    named = [("q", q), ("k", k), ("v", v), ("lengths", lengths)]
    if quantized:
        for sname, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or tuple(s.shape) != scale_shape:
                raise TypeError(f"{name} kernel needs f32 {sname} of shape "
                                f"{scale_shape}, got {s.dtype} "
                                f"{tuple(s.shape)}")
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise TypeError(f"{name} kernel needs int32 lengths [B], got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if tables is not None:
        if tables.dtype != torch.int32 or tables.dim() != 2 \
                or tables.shape[0] != b:
            raise TypeError(f"{name} kernel needs int32 tables [B, MB], got "
                            f"{tables.dtype} {tuple(tables.shape)}")
        named.append(("tables", tables))
    for tname, t in named:
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             f"aligned {tname}")


def _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale):
    b, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b:
        raise ValueError(f"decode_attention: caches must be [B, S, Hkv, D] "
                         f"matching q {tuple(q.shape)}, got "
                         f"{tuple(k_cache.shape)}")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    _check_cuda("decode_attention", q, k_cache, v_cache, lengths, k_scale,
                v_scale, (b, s, hkv))
    o = torch.empty_like(q)
    dims = (b, s, h, hkv, d, _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    if k_scale is None:
        DECODE_ATTENTION(_build.ptr(q), _build.ptr(k_cache),
                         _build.ptr(v_cache), _build.ptr(lengths),
                         _build.ptr(o), *dims)
    else:
        kernel = _quant_kernel(k_cache, DECODE_ATTENTION_Q,
                               DECODE_ATTENTION_F8)
        kernel(_build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
               _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(lengths),
               _build.ptr(o), *dims)
    return o


def _paged_cuda(q, k_pool, v_pool, tables, lengths, k_scale, v_scale):
    b, h, d = q.shape
    if k_pool.dim() != 4:
        raise ValueError(f"paged_decode_attention: pools must be "
                         f"[NB, bs, Hkv, D], got {tuple(k_pool.shape)}")
    nb, bs, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    _check_cuda("paged_decode_attention", q, k_pool, v_pool, lengths,
                k_scale, v_scale, (nb, bs, hkv), tables)
    if bs % 16:
        raise ValueError(f"paged_decode_attention kernel needs a block size "
                         f"that is a multiple of 16, got {bs}")
    o = torch.empty_like(q)
    dims = (b, tables.shape[1], bs, h, hkv, d, _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q))
    if k_scale is None:
        PAGED_DECODE_ATTENTION(_build.ptr(q), _build.ptr(k_pool),
                               _build.ptr(v_pool), _build.ptr(tables),
                               _build.ptr(lengths), _build.ptr(o), *dims)
    else:
        kernel = _quant_kernel(k_pool, PAGED_DECODE_ATTENTION_Q,
                               PAGED_DECODE_ATTENTION_F8)
        kernel(_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
               _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(tables),
               _build.ptr(lengths), _build.ptr(o), *dims)
    return o


def _device_of(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


def decode_attention(q, k_cache, v_cache, lengths, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """Attention of each slot's new token over its first ``lengths[b]``
    positions of a dense cache (int8 or e4m3 with ``k_scale``/``v_scale``);
    returns ``[B, H, D]``.  CPU tensors run the plain version; CUDA
    tensors run the kernel or raise."""
    if _device_of("decode_attention", q) == "cpu":
        return _decode_plain(q, k_cache, v_cache, lengths, k_scale, v_scale)
    return _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Attention of each slot's new token over its first ``lengths[b]``
    positions, read from the block pools through ``tables`` (int8 / e4m3 with
    ``k_scale``/``v_scale`` scale pools); returns ``[B, H, D]``.  CPU
    tensors run the plain version; CUDA tensors run the kernel or raise."""
    if _device_of("paged_decode_attention", q) == "cpu":
        return _paged_plain(q, k_pool, v_pool, tables, lengths, k_scale,
                            v_scale)
    return _paged_cuda(q, k_pool, v_pool, tables, lengths, k_scale, v_scale)


# ---- window variants: W new tokens per slot ------------------------------

def _window_plain(q, k_cache, v_cache, lengths, k_scale=None,
                  v_scale=None) -> torch.Tensor:
    """Reference math in f32, mirroring the JAX ``_window_composite``:
    int8 / e4m3 caches are dequantized to q's dtype first, then query i of slot
    b takes a softmax over positions ``j < lengths[b] + i + 1``."""
    if k_scale is not None:
        k_cache = _dequant_cache(k_cache, k_scale, q.dtype)
        v_cache = _dequant_cache(v_cache, v_scale, q.dtype)
    b, w, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, w, hkv, g, d)
    scores = torch.einsum("bwkgd,bskd->bkwgs", qg,
                          k_cache.float()) / math.sqrt(d)
    limit = (lengths.to(torch.int64)[:, None]
             + torch.arange(w, device=q.device)[None, :] + 1)      # [b, w]
    valid = (torch.arange(s, device=q.device)[None, None, :]
             < limit[:, :, None])[:, None, :, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkwgs,bskd->bwkgd", p / l, v_cache.float())
    return out.reshape(b, w, h, d).to(q.dtype)


def _paged_window_plain(q, k_pool, v_pool, tables, lengths, k_scale=None,
                        v_scale=None) -> torch.Tensor:
    """The JAX ``_paged_window_composite``: gather each slot's blocks
    dense, then the dense window plain version."""
    b, mb = tables.shape
    bs, hkv, d = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    idx = tables.long()
    kg = k_pool[idx].reshape(b, mb * bs, hkv, d)
    vg = v_pool[idx].reshape(b, mb * bs, hkv, d)
    ksg = vsg = None
    if k_scale is not None:
        ksg = k_scale[idx].reshape(b, mb * bs, hkv)
        vsg = v_scale[idx].reshape(b, mb * bs, hkv)
    return _window_plain(q, kg, vg, lengths, ksg, vsg)


def _window_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale):
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"decode_attention_window: q must be [B, W, H, D] "
                         f"and caches [B, S, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    b, w, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    _check_cuda("decode_attention_window", q, k_cache, v_cache, lengths,
                k_scale, v_scale, (b, s, hkv))
    o = torch.empty_like(q)
    dims = (b, w, s, h, hkv, d, _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q))
    if k_scale is None:
        WINDOW_ATTENTION(_build.ptr(q), _build.ptr(k_cache),
                         _build.ptr(v_cache), _build.ptr(lengths),
                         _build.ptr(o), *dims)
    else:
        kernel = _quant_kernel(k_cache, WINDOW_ATTENTION_Q,
                               WINDOW_ATTENTION_F8)
        kernel(_build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
               _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(lengths),
               _build.ptr(o), *dims)
    return o


def _paged_window_cuda(q, k_pool, v_pool, tables, lengths, k_scale,
                       v_scale):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"paged_decode_attention_window: q must be "
                         f"[B, W, H, D] and pools [NB, bs, Hkv, D], got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}")
    b, w, h, d = q.shape
    nb, bs, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    _check_cuda("paged_decode_attention_window", q, k_pool, v_pool, lengths,
                k_scale, v_scale, (nb, bs, hkv), tables)
    if bs % 16:
        raise ValueError(f"paged_decode_attention_window kernel needs a "
                         f"block size that is a multiple of 16, got {bs}")
    o = torch.empty_like(q)
    dims = (b, w, tables.shape[1], bs, h, hkv, d,
            _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    if k_scale is None:
        PAGED_WINDOW_ATTENTION(_build.ptr(q), _build.ptr(k_pool),
                               _build.ptr(v_pool), _build.ptr(tables),
                               _build.ptr(lengths), _build.ptr(o), *dims)
    else:
        kernel = _quant_kernel(k_pool, PAGED_WINDOW_ATTENTION_Q,
                               PAGED_WINDOW_ATTENTION_F8)
        kernel(_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
               _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(tables),
               _build.ptr(lengths), _build.ptr(o), *dims)
    return o


def decode_attention_window(q, k_cache, v_cache, lengths, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    """Attention of W new tokens per slot over a dense cache: q ``[B, W,
    H, D]``, caches ``[B, S, Hkv, D]`` that already hold the window's
    k/v at ``lengths[b] + i``, lengths ``[B]`` int32 EXCLUDING the
    window; query i attends ``j <= lengths[b] + i``.  int8 / e4m3 caches with
    ``k_scale``/``v_scale`` ``[B, S, Hkv]``.  Returns ``[B, W, H, D]``.
    CPU tensors run the plain version; CUDA tensors run the kernel or
    raise."""
    if _device_of("decode_attention_window", q) == "cpu":
        return _window_plain(q, k_cache, v_cache, lengths, k_scale, v_scale)
    return _window_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale)


def paged_decode_attention_window(q, k_pool, v_pool, tables, lengths,
                                  k_scale=None, v_scale=None) -> torch.Tensor:
    """The window attention over block pools read through ``tables``
    (int8 / e4m3 with ``[NB, bs, Hkv]`` scale pools); lengths EXCLUDING the
    window.  Returns ``[B, W, H, D]``.  CPU tensors run the plain
    version; CUDA tensors run the kernel or raise."""
    if _device_of("paged_decode_attention_window", q) == "cpu":
        return _paged_window_plain(q, k_pool, v_pool, tables, lengths,
                                   k_scale, v_scale)
    return _paged_window_cuda(q, k_pool, v_pool, tables, lengths, k_scale,
                              v_scale)


# chunked prefill is the window attention with W = the chunk (the JAX
# package's aliases)
chunk_prefill_attention = decode_attention_window
paged_chunk_prefill_attention = paged_decode_attention_window
