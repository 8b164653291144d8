"""One GPT layer's whole decode step as one op (counterpart of
``paddle_tpu/ops/decode_megakernel.py``).

A composed decode step runs, per layer, LayerNorm, the qkv product, the
cache write, the decode attention, the out product, the residual, the
second LayerNorm and the MLP as some forty eager launches; on one GPU that
step is bound by the host that issues them (``PERF.md``).  Here the whole
layer step is one call:

- :func:`decode_layer_step` over a dense cache ``[B, cap, Hkv, D]``;
- :func:`decode_layer_step_paged` over block pools ``[NB, bs, Hkv, D]``
  read through tables ``[B, MB]``.

Both take x ``[B, H]`` (each slot's new token at this layer), the 12
layer arrays in :data:`LAYER_WEIGHTS` order, the cache BEFORE the new
token is written (int8 with ``k_scale``/``v_scale``) and lengths ``[B]``
int32 that EXCLUDE the new token, and return ``(x_out [B, H], k_new
[B, Hkv, D], v_new)``: the new token's k/v raw (before any quantization),
for the caller to write where the composed path writes them.  The new
token is attended from the qkv product (through the int8 round trip on an
int8 cache), so the op reads the cache and writes nothing into it.

Dispatch: with ``quantize`` set (int8 or fp8 compute), or over an e4m3
cache (the kernel reads bf16/fp16 or int8 caches), the composed route
``_composite`` runs, as in the JAX package: its projections go through
``ops.quantized_matmul`` and its attention through ``ops.decode_attention``
or ``ops.paged_decode_attention`` (kernels on the card), and it writes the
new token's k/v into the cache in place before attending (the values the
caller then writes there again; JAX writes into a copy).  Otherwise a CPU
tensor runs the plain version ``_mega_plain`` and a CUDA tensor the
hand-written kernel (``csrc/decode_megakernel.cu``, ``_q``,
``paged_decode_megakernel.cu``, ``_q``: one cooperative launch per layer
step, one block per SM) or raises.  The kernel takes bf16/fp16 x and
weights of x's dtype, B <= 16, D in {64, 128}, H and F multiples of 128,
block sizes that are multiples of 16, and contiguous tensors.  Unlike the
JAX package, an unsupported shape on the card raises instead of taking
the composite.

The launch is capturable in a CUDA graph: its scratch comes from the
caching allocator, and its only other state, a workspace holding a
grid-barrier word (every launch leaves it as it found it) and strip
counters (every launch zeroes them before use), is allocated once per
device.  :func:`_partition` is the split of each product's weight tiles
over the blocks that the kernel follows (``csrc/decode_megakernel.cuh``,
``Part``).
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
import threading
from typing import Dict

import torch

from . import _build
from .decode_attention import (_device_of, decode_attention,
                               paged_decode_attention)
from .quantized_matmul import quantized_matmul, write_kv

__all__ = ["decode_layer_step", "decode_layer_step_paged",
           "megakernel_enabled", "LAYER_WEIGHTS", "DECODE_MEGAKERNEL",
           "DECODE_MEGAKERNEL_Q", "PAGED_DECODE_MEGAKERNEL",
           "PAGED_DECODE_MEGAKERNEL_Q"]

_NEG = -1e30

# the 12 per-layer arrays a fused step consumes, in argument order
LAYER_WEIGHTS = ("ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_out", "b_out",
                 "ln2_w", "ln2_b", "w_up", "b_up", "w_down", "b_down")

_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         ctypes.c_float, ctypes.c_void_p]
DECODE_MEGAKERNEL = _build.CudaKernel(
    "decode_megakernel.cu", "decode_megakernel", _ARGS)
DECODE_MEGAKERNEL_Q = _build.CudaKernel(
    "decode_megakernel_q.cu", "decode_megakernel_q", _ARGS)
PAGED_DECODE_MEGAKERNEL = _build.CudaKernel(
    "paged_decode_megakernel.cu", "paged_decode_megakernel", _ARGS)
PAGED_DECODE_MEGAKERNEL_Q = _build.CudaKernel(
    "paged_decode_megakernel_q.cu", "paged_decode_megakernel_q", _ARGS)

# the kernel's limits (csrc/decode_megakernel.cuh)
_MAX_SLOTS = 16
_MAX_CHUNK = 2048
_TILE = 64            # a weight tile: 64 input rows x 64 output columns
_MAX_PARTS = 8        # position parts of one attention pair at most
_WORK_INTS = 2 + 16384  # grid barrier + strip counters
_SMS: Dict[int, int] = {}
_WORK: Dict[tuple, torch.Tensor] = {}
# guards insertions into _SMS, _WORK and _CHECKED (engine replicas launch
# from threads of their own)
_STATE_LOCK = threading.Lock()
# layer weight sets already checked, by their data pointers, dtype and
# device: a decode step checks its 24 layers' 12 arrays once, not per step
_CHECKED: Dict[tuple, bool] = {}


def megakernel_enabled(cfg) -> bool:
    """The serving knob: ``PADDLE_TPU_DECODE_MEGAKERNEL`` overrides (any
    value but ``"0"`` arms it), else ``cfg.decode_megakernel``."""
    env = os.environ.get("PADDLE_TPU_DECODE_MEGAKERNEL")
    if env is not None:
        return env != "0"
    return bool(getattr(cfg, "decode_megakernel", False))


# ---- the plain version: what the kernel computes ------------------------

def _gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _ln(xf, w, b, eps):
    """LayerNorm in f32 (the kernel's: mean, mean of squared deviations)."""
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _qdq(t):
    """The int8 round trip the composed path puts the new k/v through
    (stored as codes, attended dequantized): per head vector."""
    sc = torch.clamp(t.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(t / sc), -127.0, 127.0) * sc


def _mega_plain(x, w, k, v, lengths, k_scale=None, v_scale=None,
                tables=None, eps: float = 1e-5):
    """What ``_mega_kernel`` computes, in f32: LayerNorm in f32; each
    product's input cast to the weights' dtype, f32 accumulation and f32
    bias; the slot's cached positions (dense: below ``min(len, cap - 1)``;
    paged, through ``tables``: below ``len``) plus the new token, whose k/v
    come from the qkv product (through the int8 round trip on an int8
    cache), in one softmax; tanh GELU in f32; ``x_out = (x2 + mlp) +
    b_down`` in x's dtype.  Returns ``(x_out, k_new, v_new)``, the new k/v
    raw in x's dtype."""
    (ln1_w, ln1_b, w_qkv, b_qkv, w_out, b_out,
     ln2_w, ln2_b, w_up, b_up, w_down, b_down) = w
    wdt = w_qkv.dtype
    bsz, h = x.shape
    hkv, d = k.shape[-2], k.shape[-1]
    kvd = hkv * d
    g = (w_qkv.shape[1] - 2 * kvd) // d // hkv
    scale = 1.0 / math.sqrt(d)

    def mm(a, wt):
        return torch.matmul(a.to(wdt).float(), wt.float())

    xf = x.float()
    qkv = mm(_ln(xf, ln1_w, ln1_b, eps), w_qkv) + b_qkv.float()
    q = qkv[:, :h].reshape(bsz, hkv, g, d)
    kn = qkv[:, h:h + kvd].reshape(bsz, hkv, d)
    vn = qkv[:, h + kvd:].reshape(bsz, hkv, d)
    kn_att, vn_att = (_qdq(kn), _qdq(vn)) if k_scale is not None \
        else (kn, vn)
    if tables is None:
        limit = torch.clamp(lengths.long(), max=k.shape[1] - 1)
    else:
        mb, bs = tables.shape[1], k.shape[1]
        idx = tables.long()
        k, v = (t[idx].reshape(bsz, mb * bs, hkv, d) for t in (k, v))
        if k_scale is not None:
            k_scale, v_scale = (t[idx].reshape(bsz, mb * bs, hkv)
                                for t in (k_scale, v_scale))
        limit = torch.clamp(lengths.long(), max=mb * bs)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None].float()
        vf = vf * v_scale[..., None].float()
    s = torch.einsum("bkgd,bskd->bkgs", q, kf) * scale
    valid = (torch.arange(kf.shape[1], device=x.device)[None, :]
             < limit[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    s_new = (q * kn_att[:, :, None, :]).sum(-1, keepdim=True) * scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_new)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    p_new = torch.exp(s_new - m)
    den = p.sum(-1, keepdim=True) + p_new
    attn = (torch.einsum("bkgs,bskd->bkgd", p, vf)
            + p_new * vn_att[:, :, None, :]) / den
    x2 = xf + mm(attn.reshape(bsz, h), w_out) + b_out.float()
    u = mm(_ln(x2, ln2_w, ln2_b, eps), w_up) + b_up.float()
    mlp = mm(_gelu_tanh(u), w_down)
    x_out = (x2 + mlp + b_down.float()).to(x.dtype)
    return x_out, kn.to(x.dtype), vn.to(x.dtype)


# ---- the composed route (quantize set) -----------------------------------

def _mm(x2, w, bias, quantize):
    """The composed path's projection: ``x2 @ w`` or, with ``quantize``,
    ``quantized_matmul`` (the int8 or e4m3 kernel on the card)."""
    y = quantized_matmul(x2, w, dtype=quantize, out_dtype=x2.dtype) \
        if quantize else torch.matmul(x2, w)
    return y if bias is None else y + bias


def _ln_f32(x2, w, bias, eps):
    """The JAX ``_ln_f32``: LayerNorm in f32, cast to x2's dtype."""
    xf = x2.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + bias).to(x2.dtype)


def _split_qkv(qkv, h, hkv, d):
    bsz = qkv.shape[0]
    kvd = hkv * d
    heads = (qkv.shape[1] - 2 * kvd) // d
    return (qkv[:, :h].reshape(bsz, heads, d).contiguous(),
            qkv[:, h:h + kvd].reshape(bsz, hkv, d).contiguous(),
            qkv[:, h + kvd:].reshape(bsz, hkv, d).contiguous())


def _composed(quantize, k, k_scale) -> bool:
    """The composed route runs (the JAX ``_fused_supported`` is False):
    quantized compute, or a quantized cache whose codes are not int8
    (fp8 caches ride the composite)."""
    return bool(quantize) or (k_scale is not None and k.dtype != torch.int8)


def _composite(x, w, attend, *, quantize, eps, hkv, d):
    """The composed path op for op; ``attend(q, k_new, v_new)`` runs the
    layout's attention over the cache with the new token written."""
    (ln1_w, ln1_b, w_qkv, b_qkv, w_out, b_out,
     ln2_w, ln2_b, w_up, b_up, w_down, b_down) = w
    h = x.shape[1]
    qkv = _mm(_ln_f32(x, ln1_w, ln1_b, eps), w_qkv, b_qkv, quantize)
    q, k_new, v_new = _split_qkv(qkv, h, hkv, d)
    attn = attend(q, k_new, v_new)                       # [B, heads, d]
    o = _mm(attn.reshape(x.shape[0], -1).to(x.dtype), w_out, None,
            quantize) + b_out
    x2 = x + o.to(x.dtype)
    u = _mm(_ln_f32(x2, ln2_w, ln2_b, eps), w_up, b_up, quantize)
    act = torch.nn.functional.gelu(u, approximate="tanh")
    mlp = _mm(act, w_down, None, quantize) + b_down
    return x2 + mlp.to(x.dtype), k_new, v_new


def _dense_attend(q, k_new, v_new, k_cache, v_cache, lengths, k_scale,
                  v_scale):
    b, cap = q.shape[0], k_cache.shape[1]
    idx = torch.clamp(lengths.long(), max=cap - 1)
    write_kv(k_cache, v_cache, k_scale, v_scale,
               (torch.arange(b, device=q.device), idx), k_new, v_new)
    lens = (idx + 1).to(torch.int32)
    if k_scale is not None:
        return decode_attention(q, k_cache, v_cache, lens, k_scale, v_scale)
    return decode_attention(q.to(k_cache.dtype), k_cache, v_cache,
                            lens).to(q.dtype)


def _paged_attend(q, k_new, v_new, k_pool, v_pool, tables, lengths,
                  k_scale, v_scale):
    b = q.shape[0]
    bs, mb = k_pool.shape[1], tables.shape[1]
    lens = lengths.to(torch.int32)
    rows = torch.arange(b, device=q.device)
    blk = tables[rows, torch.clamp(lens.long() // bs, max=mb - 1)].long()
    write_kv(k_pool, v_pool, k_scale, v_scale, (blk, lens.long() % bs),
               k_new, v_new)
    if k_scale is not None:
        return paged_decode_attention(q, k_pool, v_pool, tables, lens + 1,
                                      k_scale, v_scale)
    return paged_decode_attention(q.to(k_pool.dtype), k_pool, v_pool, tables,
                                  lens + 1).to(q.dtype)


# ---- the kernel ----------------------------------------------------------

def _sms(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        with _STATE_LOCK:
            _SMS[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
    return _SMS[idx]


class _Part:
    """How a ``k x n`` product's weight tiles (64-column strip x 64-row
    k-tile, strip-major) split over ``blocks``: block b streams tiles
    ``[start(b), start(b + 1))``; chunk c is tiles ``[c cl, (c + 1) cl)``
    of one strip (``cl`` the largest divisor of the strip's k-tiles with
    ``cl * 64 <= 2048``); each block writes one f32 partial for each chunk
    its run touches.  The kernel's ``Part`` computes the same."""

    def __init__(self, k: int, n: int, blocks: int):
        self.k, self.n, self.blocks = k, n, blocks
        self.nk = k // _TILE
        self.cl = max(d for d in range(1, self.nk + 1)
                      if self.nk % d == 0 and d * _TILE <= _MAX_CHUNK)
        self.total = (n // _TILE) * self.nk

    def start(self, b: int) -> int:
        return b * self.total // self.blocks

    def blk(self, t: int) -> int:
        """The block whose run holds tile t."""
        return ((t + 1) * self.blocks - 1) // self.total

    @functools.cached_property
    def parts(self) -> int:
        """Partials a chunk at most (the scratch holds that many)."""
        return max(self.blk(c * self.cl + self.cl - 1) - self.blk(c * self.cl)
                   + 1 for c in range(self.total // self.cl))


@functools.lru_cache(maxsize=None)
def _part(k: int, n: int, blocks: int) -> _Part:
    return _Part(k, n, blocks)


def _partition(k: int, n: int, blocks: int):
    """Each block's pieces of a ``k x n`` product, ``[(strip, k0, k1),
    ...]`` in the order it streams them: input rows ``[k0, k1)`` of
    64-column strip ``strip``, cut at strip and chunk edges, so every
    piece's rows fit the kernel's activation chunk."""
    pt = _part(k, n, blocks)
    out = []
    for b in range(blocks):
        pieces, t, t1 = [], pt.start(b), pt.start(b + 1)
        while t < t1:
            te = min(t1, (t // pt.cl + 1) * pt.cl)
            s, kt = divmod(t, pt.nk)
            pieces.append((s, kt * _TILE, (kt + te - t) * _TILE))
            t = te
        out.append(pieces)
    return out


def _scratch_floats(bsz, h, hkv, d, f, rt, np_, parts):
    """Floats of the kernel's scratch (its ``Layout``): each product's
    partials, the attention items' partial rows (acc, then m and l), the
    new token's scores and v, the attention output, x2 and its strips'
    statistics, the gelu activations; areas 64-float aligned."""
    def up64(x):
        return -(-x // 64) * 64
    pq, po, pu, pd = parts
    heads = h // d

    def floats(pt):
        return (pt.total // pt.cl) * pt.parts * bsz * _TILE
    items = bsz * hkv * rt * np_
    total = up64(floats(pq))
    total = up64(total + items * 16 * d)
    total = up64(total + items * 16 * 2)
    total = up64(total + bsz * heads)
    total = up64(total + bsz * hkv * d)
    total = up64(total + bsz * h // 2)
    total = up64(total + floats(po))
    total = up64(total + bsz * h)
    total = up64(total + (h // _TILE) * bsz * 2)
    total = up64(total + floats(pu))
    total = up64(total + bsz * f // 2)
    return up64(total + floats(pd))


def _workspace(device) -> torch.Tensor:
    """The kernel's grid-barrier word and strip counters for a launch on
    the current stream: one buffer per (device, stream), zeroed when made
    (the kernel leaves it consistent for the next launch), so launches on
    two streams never share a barrier.  Under CUDA-graph capture on a
    stream that has none yet, a buffer zeroed inside the graph and not
    kept, as row 10's counters."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    buf = _WORK.get(key)
    if buf is not None:
        return buf
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(_WORK_INTS, dtype=torch.int32, device=device)
    with _STATE_LOCK:
        if key not in _WORK:
            _WORK[key] = torch.zeros(_WORK_INTS, dtype=torch.int32,
                                     device=device)
        return _WORK[key]


def _check_cuda_tensors(name, x, named):
    for tname, t in named:
        if t.device != x.device:
            raise ValueError(f"{name}: {tname} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             f"aligned {tname}")


def _check_weights(name, x, w, h, nq, f):
    shapes = [(h,), (h,), (h, nq), (nq,), (h, h), (h,), (h,), (h,), (h, f),
              (f,), (f, h), (h,)]
    for wname, t, shape in zip(LAYER_WEIGHTS, w, shapes):
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise TypeError(f"{name} kernel needs {wname} {shape} in "
                            f"{x.dtype}, got {t.dtype} {tuple(t.shape)}")
    _check_cuda_tensors(name, x, list(zip(LAYER_WEIGHTS, w)))


def _mega_cuda(x, w, k, v, lengths, k_scale, v_scale, tables, eps):
    """Check what the kernel takes (raise on anything else), allocate the
    outputs and the f32 scratch, launch."""
    name = "decode_layer_step" + ("_paged" if tables is not None else "")
    if x.dim() != 2 or x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name} kernel takes x [B, H] in bf16/fp16, got "
                        f"{x.dtype} {tuple(x.shape)}")
    bsz, h = x.shape
    if len(w) != len(LAYER_WEIGHTS):
        raise ValueError(f"{name}: {len(LAYER_WEIGHTS)} layer arrays "
                         f"({', '.join(LAYER_WEIGHTS)}), got {len(w)}")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: k/v must have one shape [..., Hkv, D], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    hkv, d = k.shape[2], k.shape[3]
    f = w[8].shape[-1]
    nq = h + 2 * hkv * d
    if not 1 <= bsz <= _MAX_SLOTS:
        raise ValueError(f"{name} kernel takes 1 to {_MAX_SLOTS} slots, got "
                         f"{bsz}")
    if d not in (64, 128):
        raise ValueError(f"{name} kernel supports D in (64, 128), got {d}")
    if h % 128 or f % 128 or h % (hkv * d):
        raise ValueError(f"{name} kernel needs H and F multiples of 128 and "
                         f"H a multiple of Hkv * D, got H={h}, F={f}, "
                         f"Hkv={hkv}, D={d}")
    key = (tuple(t.data_ptr() for t in w), x.dtype, x.device, nq, f)
    if key not in _CHECKED:
        _check_weights(name, x, w, h, nq, f)
        with _STATE_LOCK:
            if len(_CHECKED) > 4096:
                _CHECKED.clear()
            _CHECKED[key] = True
    quantized = k_scale is not None
    if (v_scale is None) == quantized:
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    want = torch.int8 if quantized else x.dtype
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"{name} kernel needs {want} caches here, got "
                        f"{k.dtype}, {v.dtype}")
    named = [("x", x), ("k", k), ("v", v), ("lengths", lengths)]
    if quantized:
        for sname, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != k.shape[:3]:
                raise TypeError(f"{name} kernel needs f32 {sname} of shape "
                                f"{tuple(k.shape[:3])}, got {s.dtype} "
                                f"{tuple(s.shape)}")
            named.append((sname, s))
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (bsz,):
        raise TypeError(f"{name} kernel needs int32 lengths [B], got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if tables is None:
        if k.shape[0] != bsz:
            raise ValueError(f"{name}: caches must be [B, cap, Hkv, D] with "
                             f"B={bsz}, got {tuple(k.shape)}")
        cap, bs, mb = k.shape[1], 0, 0
    else:
        if tables.dtype != torch.int32 or tables.dim() != 2 \
                or tables.shape[0] != bsz:
            raise TypeError(f"{name} kernel needs int32 tables [B, MB], got "
                            f"{tables.dtype} {tuple(tables.shape)}")
        named.append(("tables", tables))
        cap, bs, mb = 0, k.shape[1], tables.shape[1]
    if tables is not None and bs % 16:
        raise ValueError(f"{name} kernel needs a block size that is a "
                         f"multiple of 16, got {bs}")
    _check_cuda_tensors(name, x, named)
    ptrs, dims, outs, _, _ = _launch_args(x, w, k, v, lengths, k_scale,
                                          v_scale, tables)
    kernel = {(False, False): DECODE_MEGAKERNEL,
              (True, False): DECODE_MEGAKERNEL_Q,
              (False, True): PAGED_DECODE_MEGAKERNEL,
              (True, True): PAGED_DECODE_MEGAKERNEL_Q}[
                  (quantized, tables is not None)]
    kernel((ctypes.c_void_p * len(ptrs))(
               *[None if t is None else t.data_ptr() for t in ptrs]),
           (ctypes.c_int * len(dims))(*dims), ctypes.c_float(eps),
           _build.stream_ptr(x))
    return outs


def _launch_args(x, w, k, v, lengths, k_scale, v_scale, tables, extra=0):
    """The kernel's C arguments for checked tensors: ``(ptrs, dims,
    (x_out, k_new, v_new), scratch, scratch floats)``; ``extra`` floats
    past the scratch (zeroed) are for a timing variant's stamps."""
    bsz, h = x.shape
    hkv, d = k.shape[2], k.shape[3]
    f = w[8].shape[-1]
    nq = h + 2 * hkv * d
    grid = _sms(x.device)
    parts = (_part(h, nq, grid), _part(h, h, grid), _part(h, f, grid),
             _part(f, h, grid))
    rt = -(-(h // d // hkv) // 16)
    np_ = max(1, min(_MAX_PARTS, grid // (bsz * hkv * rt)))
    total = _scratch_floats(bsz, h, hkv, d, f, rt, np_, parts)
    if tables is None:
        cap, bs, mb = k.shape[1], 0, 0
    else:
        cap, bs, mb = 0, k.shape[1], tables.shape[1]
    x_out = torch.empty_like(x)
    k_new = torch.empty((bsz, hkv, d), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    scratch = (torch.zeros if extra else torch.empty)(
        total + extra, dtype=torch.float32, device=x.device)
    ptrs = [x, *w, k, v, k_scale, v_scale, tables, lengths, x_out, k_new,
            v_new, scratch, _workspace(x.device)]
    dims = [bsz, h, hkv, d, f, cap, bs, mb, grid, np_,
            *(pt.parts for pt in parts), total & 0x7FFFFFFF, total >> 31,
            _build.DTYPE_CODES[x.dtype]]
    return ptrs, dims, (x_out, k_new, v_new), scratch, total


def decode_layer_step(x, w, k_cache, v_cache, lengths, k_scale=None,
                      v_scale=None, *, quantize=None, eps: float = 1e-5):
    """One GPT layer's decode step over a dense cache ``[B, cap, Hkv,
    D]`` (int8 with ``[B, cap, Hkv]`` scales) holding each slot's tokens
    before the new one; lengths ``[B]`` int32 EXCLUDE it.  Returns
    ``(x_out [B, H], k_new [B, Hkv, D], v_new)``; the caller writes the new
    k/v at ``min(lengths[b], cap - 1)``.  ``quantize`` takes the composed
    route; otherwise CPU tensors run the plain version and CUDA tensors
    the kernel or raise.  An e4m3 cache takes the composed route too."""
    hkv, d = k_cache.shape[2], k_cache.shape[3]
    if _composed(quantize, k_cache, k_scale):
        attend = functools.partial(_dense_attend, k_cache=k_cache,
                                   v_cache=v_cache, lengths=lengths,
                                   k_scale=k_scale, v_scale=v_scale)
        return _composite(x, w, attend, quantize=quantize, eps=eps, hkv=hkv,
                          d=d)
    if _device_of("decode_layer_step", x) == "cpu":
        return _mega_plain(x, w, k_cache, v_cache, lengths, k_scale, v_scale,
                           eps=eps)
    return _mega_cuda(x, w, k_cache, v_cache, lengths, k_scale, v_scale,
                      None, eps)


def decode_layer_step_paged(x, w, k_pool, v_pool, tables, lengths,
                            k_scale=None, v_scale=None, *, quantize=None,
                            eps: float = 1e-5):
    """The same layer step over block pools ``[NB, bs, Hkv, D]`` read
    through ``tables [B, MB]`` int32 (int8 with ``[NB, bs, Hkv]`` scale
    pools); lengths EXCLUDE the new token.  The caller writes the new k/v
    at ``(tables[b, lengths[b] // bs], lengths[b] % bs)``."""
    hkv, d = k_pool.shape[2], k_pool.shape[3]
    if _composed(quantize, k_pool, k_scale):
        attend = functools.partial(_paged_attend, k_pool=k_pool,
                                   v_pool=v_pool, tables=tables,
                                   lengths=lengths, k_scale=k_scale,
                                   v_scale=v_scale)
        return _composite(x, w, attend, quantize=quantize, eps=eps, hkv=hkv,
                          d=d)
    if _device_of("decode_layer_step_paged", x) == "cpu":
        return _mega_plain(x, w, k_pool, v_pool, lengths, k_scale, v_scale,
                           tables, eps=eps)
    return _mega_cuda(x, w, k_pool, v_pool, lengths, k_scale, v_scale,
                      tables, eps)
