"""Flash attention, forward and backward: hand-written Hopper kernels +
plain versions.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  Layout contract
is the JAX package's: q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]`` with
``H % Hkv == 0`` (query head ``h = hk * G + g`` reads kv head ``hk``),
an optional key mask ``kv_mask [B, S]`` (1 = attend, 0 = padding).

``flash_attention`` / ``flash_attention_fwd`` call the custom op
``paddle_tpu::flash_fwd`` (``torch.library``): it emits o and the
per-row lse ``[B, H, S]`` (f32), and its registered backward makes
``do`` contiguous and calls ``_bwd``, which on CUDA tensors runs the
custom ops ``paddle_tpu::flash_bwd_dq`` (the dq kernel, which also forms
``delta = rowsum(do * o)`` in f32 from the SAVED o, as the JAX
``_bwd_gqa`` does, and writes it out) and ``paddle_tpu::flash_bwd_dkv``
(the dk/dv kernel, which reads that delta).  Each op has a fake
implementation that gives its shapes and dtypes, so a graph capture
(``torch.export``, ``jit.to_static``, ``jit.save``) records the op
instead of tracing into the ``ctypes`` launch; the captured program
calls the kernels at run time, and their launch counts grow there.

Attention dropout (``dropout_p`` in [0, 1)): the JAX composite's
``probs = where(keep, probs / (1 - p), 0)`` after the softmax, whose
normaliser runs over every key, so lse is unchanged.  The keep bits are
Philox4x32-10 of a ``(seed, offset)`` pair (``core.random.philox_pair``,
an int64 ``[2]`` tensor drawn on the device per call, saved for the
backward) and of the element's (b, h, i, j) alone (``_philox``): the
forward kernel draws them and the dq and dk/dv kernels draw the same
bits again; ``o`` is the dropped output, so delta = rowsum(do * o) and
``ds = p * (keep * dp / (1 - p) - delta)``, ``dv += (keep * p / (1 -
p))^T do``.  Each kernel's dropout form is its own entry point
(``FLASH_FWD_DROPOUT``, ``FLASH_BWD_DQ_DROPOUT``,
``FLASH_BWD_DKV_DROPOUT``, counted apart); at p = 0 the calls are the
kernels without it.  The plain versions take the pair, or an explicit
``keep [B, H, S, Sk]`` (tests feed the JAX package's own mask).

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
from torch.utils.flop_counter import register_flop_formula

from ..core import random as _random
from . import _build, _philox

__all__ = ["flash_attention", "flash_attention_fwd", "FLASH_FWD",
           "FLASH_BWD_DQ", "FLASH_BWD_DKV", "FLASH_FWD_DROPOUT",
           "FLASH_BWD_DQ_DROPOUT", "FLASH_BWD_DKV_DROPOUT"]

_NEG = -1e30

FLASH_FWD = _build.CudaKernel(
    "flash_fwd.cu", "flash_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
FLASH_BWD_DQ = _build.CudaKernel(
    "flash_bwd_dq.cu", "flash_bwd_dq",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
FLASH_BWD_DKV = _build.CudaKernel(
    "flash_bwd_dkv.cu", "flash_bwd_dkv",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
# the dropout forms: the same arguments, then the (seed, offset) pair's
# pointer, the keep threshold and 1 / (1 - p)
_DROP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
FLASH_FWD_DROPOUT = _build.CudaKernel(
    "flash_fwd.cu", "flash_fwd_dropout",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + _DROP_ARGS
    + [ctypes.c_void_p])
FLASH_BWD_DQ_DROPOUT = _build.CudaKernel(
    "flash_bwd_dq.cu", "flash_bwd_dq_dropout",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + _DROP_ARGS
    + [ctypes.c_void_p])
FLASH_BWD_DKV_DROPOUT = _build.CudaKernel(
    "flash_bwd_dkv.cu", "flash_bwd_dkv_dropout",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + _DROP_ARGS
    + [ctypes.c_void_p])


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


def _kept(q, k, dropout_p, philox, keep):
    """``keep / (1 - p)`` ``[B, H, S, Sk]`` in the math dtype: from the
    explicit ``keep`` mask, else the Philox bits of the pair; None at
    p = 0."""
    if not dropout_p:
        return None
    if keep is None:
        b, s, h, _ = q.shape
        keep = _philox.keep_mask(philox, b, h, s, k.shape[1], dropout_p)
    return keep.to(_math_dtype(q)) * (1.0 / (1.0 - dropout_p))


def _flash_plain(q, k, v, causal: bool = False,
                 kv_mask: Optional[torch.Tensor] = None,
                 dropout_p: float = 0.0,
                 philox: Optional[torch.Tensor] = None,
                 keep: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference math in f32 (f64 for f64 inputs), mirroring the JAX
    ``_composite``: scores masked to -1e30, fully masked rows give exact
    zeros.  Also returns the per-row lse ``[B, H, S]`` the kernel emits:
    ``m + log(max(l, 1e-30))`` with ``m`` the masked row max and ``l``
    the sum of ``exp(s - m)`` over unmasked keys.  With ``dropout_p`` the
    normalised probabilities are kept by the pair's bits (or ``keep``)
    and scaled by 1 / (1 - p) before the product with v."""
    scores, _ = _masked_scores(q, k, causal, kv_mask)
    vf = _expand(v.to(scores.dtype), q.shape[2])
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(scores <= _NEG / 2, torch.zeros_like(scores),
                    torch.exp(scores - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = p / l
    kept = _kept(q, k, dropout_p, philox, keep)
    if kept is not None:
        probs = probs * kept
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _flash_bwd_delta_plain(o, do) -> torch.Tensor:
    """``delta = rowsum(do * o)`` ``[B, H, S]`` in the math dtype (f32
    for the half types), as the JAX ``_bwd_gqa`` forms it and the dq
    kernel writes it."""
    acc = _math_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)


def _flash_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                     kv_mask: Optional[torch.Tensor] = None,
                     dropout_p: float = 0.0,
                     philox: Optional[torch.Tensor] = None,
                     keep: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference backward in f32 (f64 for f64 inputs), the math of the
    JAX ``_bwd_gqa``: ``p = exp(s - lse)`` recomputed from the saved lse
    (0 where masked), ``delta = rowsum(do * o)`` from the saved o,
    ``ds = p * (dp - delta)``; dk and dv summed over each kv head's
    group.  With ``dropout_p`` (the forward's pair or ``keep``), z =
    keep / (1 - p): ``ds = p * (z * dp - delta)`` and dv takes ``z * p``.
    Returns ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scores, kf = _masked_scores(q, k, causal, kv_mask)
    acc = scores.dtype
    qf, of, dof = q.to(acc), o.to(acc), do.to(acc)
    vf = _expand(v.to(acc), h)
    p = torch.where(scores <= _NEG / 2, torch.zeros_like(scores),
                    torch.exp(scores - lse.to(acc)[..., None]))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = _flash_bwd_delta_plain(of, dof)
    kept = _kept(q, k, dropout_p, philox, keep)
    pv = p if kept is None else p * kept
    ds = p * ((dp if kept is None else dp * kept) - delta[..., None])
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pv, dof)
    if hkv != h:        # query head h = hk * G + g: sum each group
        dk = dk.reshape(b, s, hkv, h // hkv, d).sum(3)
        dv = dv.reshape(b, s, hkv, h // hkv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_dropout(dropout_p):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash_attention: dropout must lie in [0, 1), "
                         f"got {dropout_p}")


def _check_shapes(q, k, v, kv_mask, dropout_p=0.0, philox=None):
    """The kernels' conditions that shapes, dtypes and devices decide
    (the fake implementations check them too, so a capture of an
    unsupported call raises before anything runs)."""
    b, s, h, d = q.shape
    _check_dropout(dropout_p)
    if dropout_p and (philox is None or tuple(philox.shape) != (2,)
                      or philox.dtype != torch.int64
                      or philox.device != q.device
                      or not philox.is_contiguous()):
        raise ValueError(f"flash_attention kernel with dropout needs the "
                         f"(seed, offset) pair as a contiguous int64 [2] "
                         f"tensor on {q.device}")
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
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, s) or kv_mask.dtype != torch.float32 \
                or kv_mask.device != q.device:
            raise ValueError(f"flash_attention kernel needs kv_mask as a "
                             f"contiguous f32 [B, S] tensor on {q.device}")


def _check_cuda(q, k, v, kv_mask, dropout_p=0.0, philox=None):
    _check_shapes(q, k, v, kv_mask, dropout_p, philox)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs contiguous, "
                             f"16-byte aligned {name}")
    if kv_mask is not None and not kv_mask.is_contiguous():
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


def _drop_args(dropout_p, philox):
    """The dropout forms' extra arguments: the pair's pointer, the keep
    threshold (``_philox.threshold``) and 1 / (1 - p)."""
    return (_build.ptr(philox), _philox.threshold(dropout_p),
            1.0 / (1.0 - dropout_p))


def _flash_cuda(q, k, v, causal, kv_mask, dropout_p=0.0, philox=None):
    _check_cuda(q, k, v, kv_mask, dropout_p, philox)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(kv_mask), _build.ptr(o), _build.ptr(lse),
            b, s, h, k.shape[2], d, int(bool(causal)),
            _build.DTYPE_CODES[q.dtype])
    if dropout_p:
        FLASH_FWD_DROPOUT(*args, *_drop_args(dropout_p, philox),
                          _build.stream_ptr(q))
    else:
        FLASH_FWD(*args, _build.stream_ptr(q))
    return o, lse


def _flash_bwd_dq_cuda(q, k, v, o, lse, do, causal, kv_mask,
                       dropout_p=0.0, philox=None):
    """``(dq, delta)`` from the dq kernel; delta ``[B, H, S]`` f32 is its
    rowsum ``do . o`` from the saved o (JAX ``_bwd_gqa`` :577)."""
    _check_cuda(q, k, v, kv_mask, dropout_p, philox)
    b, s, h, d = q.shape
    _check_operand("o", o, q, q.shape, q.dtype)
    _check_operand("do", do, q, q.shape, q.dtype)
    _check_operand("lse", lse, q, (b, h, s), torch.float32)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    kernel = FLASH_BWD_DQ_DROPOUT if dropout_p else FLASH_BWD_DQ
    kernel(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
           _build.ptr(do), _build.ptr(lse), _build.ptr(kv_mask),
           _build.ptr(dq), _build.ptr(delta), *_dims(q, k, causal),
           *_tail(q, dropout_p, philox))
    return dq, delta


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, kv_mask,
                        dropout_p=0.0, philox=None):
    """``(dk, dv)`` from the dk/dv kernel, which reads the dq kernel's
    delta."""
    _check_cuda(q, k, v, kv_mask, dropout_p, philox)
    b, s, h, d = q.shape
    _check_operand("do", do, q, q.shape, q.dtype)
    _check_operand("lse", lse, q, (b, h, s), torch.float32)
    _check_operand("delta", delta, q, (b, h, s), torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    kernel = FLASH_BWD_DKV_DROPOUT if dropout_p else FLASH_BWD_DKV
    kernel(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
           _build.ptr(lse), _build.ptr(delta), _build.ptr(kv_mask),
           _build.ptr(dk), _build.ptr(dv), *_dims(q, k, causal),
           *_tail(q, dropout_p, philox))
    return dk, dv


def _dims(q, k, causal):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, int(bool(causal)),
            _build.DTYPE_CODES[q.dtype])


def _tail(q, dropout_p, philox):
    return ((*_drop_args(dropout_p, philox), _build.stream_ptr(q))
            if dropout_p else (_build.stream_ptr(q),))


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, kv_mask, dropout_p=0.0,
                    philox=None):
    """``(dq, dk, dv, delta)`` from the two kernels; delta ``[B, H, S]``
    f32 is the dq kernel's rowsum ``do . o``."""
    dq, delta = _flash_bwd_dq_cuda(q, k, v, o, lse, do, causal, kv_mask,
                                   dropout_p, philox)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, kv_mask,
                                 dropout_p, philox)
    return dq, dk, dv, delta


def _fwd(q, k, v, causal, kv_mask, dropout_p=0.0, philox=None):
    if q.device.type == "cpu":
        o, lse = _flash_plain(q, k, v, causal, kv_mask, dropout_p, philox)
        # in the layout the op's fake form gives (q's strides, lse
        # contiguous): a graph traced on fake tensors views the outputs
        # by those strides
        return torch.empty_like(q).copy_(o), lse.contiguous()
    return _flash_cuda(q, k, v, causal, kv_mask, dropout_p, philox)


def _bwd(q, k, v, o, lse, do, causal, kv_mask, dropout_p=0.0, philox=None):
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, o, lse, do, causal, kv_mask,
                                dropout_p, philox)
    dq, delta = torch.ops.paddle_tpu.flash_bwd_dq(
        q, k, v, o, lse, do, kv_mask, causal, dropout_p, philox)
    dk, dv = torch.ops.paddle_tpu.flash_bwd_dkv(
        q, k, v, do, lse, delta, kv_mask, causal, dropout_p, philox)
    return dq, dk, dv


# The three entries as torch.library custom ops.  Their CUDA form is the
# kernel's ctypes launch; the forward's CPU form is the plain version,
# and the two backward ops are CUDA only (``_bwd`` runs the plain
# backward on CPU tensors).  The fake forms give shapes and dtypes (and
# check the kernels' shape conditions for CUDA tensors) so that a
# capture records the op.

@torch.library.custom_op("paddle_tpu::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor], causal: bool,
                  dropout_p: float, philox: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _fwd(q, k, v, causal, kv_mask, dropout_p, philox)


@_flash_fwd_op.register_fake
def _(q, k, v, kv_mask, causal, dropout_p, philox):
    if q.device.type == "cuda":
        _check_shapes(q, k, v, kv_mask, dropout_p, philox)
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


@torch.library.custom_op("paddle_tpu::flash_bwd_dq", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     kv_mask: Optional[torch.Tensor], causal: bool,
                     dropout_p: float, philox: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _flash_bwd_dq_cuda(q, k, v, o, lse, do, causal, kv_mask,
                              dropout_p, philox)


@_flash_bwd_dq_op.register_fake
def _(q, k, v, o, lse, do, kv_mask, causal, dropout_p, philox):
    if q.device.type == "cuda":
        _check_shapes(q, k, v, kv_mask, dropout_p, philox)
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


@torch.library.custom_op("paddle_tpu::flash_bwd_dkv", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, kv_mask: Optional[torch.Tensor],
                      causal: bool, dropout_p: float,
                      philox: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, kv_mask,
                               dropout_p, philox)


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, delta, kv_mask, causal, dropout_p, philox):
    if q.device.type == "cuda":
        _check_shapes(q, k, v, kv_mask, dropout_p, philox)
    return torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, kv_mask, causal, dropout_p, philox = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.kv_mask, ctx.philox = kv_mask, philox
    ctx.causal, ctx.dropout_p = causal, dropout_p
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    """The backward recomputes p from the saved lse in the dq and dk/dv
    kernels (plain versions on the CPU), and with dropout redraws the
    keep bits from the saved (seed, offset) pair.  lse has no
    gradient."""
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                      ctx.kv_mask, ctx.dropout_p, ctx.philox)
    return dq, dk, dv, None, None, None, None


_flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)


# flop formulas (``torch.utils.flop_counter``, read by ``profiler.
# cost_stats``): model flops over the full Sq x Sk square, whether causal
# or not (the convention of torch's SDPA formula and of
# ``GPTConfig.flops_per_token``); the forward's two products, 4 B H Sq Sk
# D, and each backward kernel its two (dq: dP and dQ; dk/dv: dV and dK),
# the recomputed QK^T left out, so a step's attention is 3x its forward
def _attn_flops(q_shape, k_shape) -> int:
    b, sq, h, d = q_shape
    return 4 * b * h * sq * k_shape[1] * d


@register_flop_formula(torch.ops.paddle_tpu.flash_fwd)
def _(q, k, v, *args, out_shape=None, **kwargs):
    return _attn_flops(q, k)


@register_flop_formula([torch.ops.paddle_tpu.flash_bwd_dq,
                        torch.ops.paddle_tpu.flash_bwd_dkv])
def _(q, k, v, *args, out_shape=None, **kwargs):
    return _attn_flops(q, k)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, S, H, D], lse [B, H, S] f32)``, differentiable in q, k
    and v.  CPU tensors run the plain versions; CUDA tensors run the
    kernels or raise.  ``dropout_p`` in [0, 1) drops attention
    probabilities with the bits of a fresh (seed, offset) pair from the
    device's default generator."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    dropout_p = float(dropout_p)
    _check_dropout(dropout_p)
    philox = _random.philox_pair(q.device, like=q) if dropout_p else None
    return torch.ops.paddle_tpu.flash_fwd(q, k, v, kv_mask, bool(causal),
                                          dropout_p, philox)


def flash_attention(q, k, v, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0) -> torch.Tensor:
    """Attention output ``[B, S, H, D]`` (see ``flash_attention_fwd``)."""
    return flash_attention_fwd(q, k, v, causal, kv_mask, dropout_p)[0]
