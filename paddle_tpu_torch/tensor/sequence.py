"""Sequence ops on the dense-plus-lengths ragged convention (counterpart
of ``paddle_tpu/tensor/sequence.py``).

Ragged data is ``[B, T, ...]`` plus per-row lengths ``[B]``; every op is
a masked dense op on the device, differentiable by PyTorch.  The outputs
whose size depends on the lengths (``sequence_expand``,
``sequence_concat``, ``sequence_slice``, ``sequence_unpad``) read it
back to the host; ``sequence_pad`` takes host rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..autograd import apply
from ..core.tensor import from_numpy
from ..device import current_device
from ._util import tensor as _t

__all__ = [
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_pad", "sequence_unpad", "sequence_expand",
    "sequence_concat", "sequence_enumerate", "sequence_first_step",
    "sequence_last_step", "sequence_slice",
]

_NEG = -1e30


def _lens(lengths, device):
    return _t(lengths).to(device=device).long().reshape(-1)


def _mask(lengths, maxlen):
    pos = torch.arange(maxlen, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def _tail(m, ndim):
    """``m [B, T]`` shaped to broadcast against a ``[B, T, ...]``
    tensor."""
    return m.reshape(m.shape + (1,) * (ndim - 2))


def sequence_pool(x, lengths, pool_type: str = "sum"):
    """Masked pooling over the time dim: SUM, AVERAGE, SQRT, MAX, FIRST
    or LAST.  ``x [B, T, ...]``, ``lengths [B]``."""
    pool_type = pool_type.lower()
    x = _t(x)
    la = _lens(lengths, x.device)

    def fn(xa):
        m = _tail(_mask(la, xa.shape[1]), xa.dim())
        n = torch.clamp(la, min=1).to(xa.dtype).reshape(
            (-1,) + (1,) * (xa.dim() - 2))
        if pool_type == "sum":
            return torch.where(m, xa, 0).sum(1)
        if pool_type in ("average", "mean", "avg"):
            return torch.where(m, xa, 0).sum(1) / n
        if pool_type == "sqrt":
            return torch.where(m, xa, 0).sum(1) / torch.sqrt(n)
        if pool_type == "max":
            return torch.where(m, xa, _NEG).amax(1)
        if pool_type == "first":
            return xa[:, 0]
        if pool_type == "last":
            idx = torch.clamp(la - 1, min=0)
            return xa[torch.arange(xa.shape[0], device=xa.device), idx]
        raise ValueError(f"unknown pool_type {pool_type!r}")

    return apply(fn, x, name="sequence_pool")


def sequence_first_step(x, lengths):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths):
    return sequence_pool(x, lengths, "last")


def sequence_softmax(x, lengths):
    """Per-row softmax over the valid prefix of ``x [B, T]``; padded
    positions get probability 0."""
    x = _t(x)
    la = _lens(lengths, x.device)

    def fn(xa):
        m = _mask(la, xa.shape[1])
        scores = torch.where(m, xa, _NEG)
        p = torch.exp(scores - scores.amax(1, keepdim=True))
        p = torch.where(m, p, 0)
        return p / torch.clamp(p.sum(1, keepdim=True), min=1e-30)

    return apply(fn, x, name="sequence_softmax")


def sequence_reverse(x, lengths):
    """Each row's valid prefix reversed; padding stays where it is."""
    x = _t(x)
    la = _lens(lengths, x.device)

    def fn(xa):
        pos = torch.arange(xa.shape[1], device=xa.device)[None, :]
        li = la[:, None]
        src = torch.where(pos < li, li - 1 - pos, pos)
        return torch.take_along_dim(xa, _tail(src, xa.dim()), 1)

    return apply(fn, x, name="sequence_reverse")


def sequence_pad(sequences: Sequence, pad_value=0.0,
                 maxlen: Optional[int] = None, *, device=None):
    """Host rows to ``(padded [B, maxlen, ...], lengths [B] int64)`` on
    the current device (or ``device``)."""
    seqs = [np.asarray(s.detach().cpu() if torch.is_tensor(s) else s)
            for s in sequences]
    lengths = np.asarray([len(s) for s in seqs], np.int64)
    t = int(maxlen) if maxlen is not None else int(lengths.max())
    out = np.full((len(seqs), t) + seqs[0].shape[1:], pad_value,
                  dtype=seqs[0].dtype)
    for i, s in enumerate(seqs):
        n = min(len(s), t)
        out[i, :n] = s[:n]
    dev = current_device() if device is None else device
    return from_numpy(out).to(dev), from_numpy(lengths).to(dev)


def sequence_unpad(x, lengths) -> List[torch.Tensor]:
    """The valid prefix of each row, as a list of tensors."""
    x = _t(x)
    return [x[i, :n] for i, n in enumerate(_lens(lengths, x.device).tolist())]


def sequence_expand(x, ref_lengths):
    """Row ``i`` repeated ``ref_lengths[i]`` times: ``[sum(ref), ...]``."""
    x = _t(x)
    la = _lens(ref_lengths, x.device)
    if la.shape[0] != x.shape[0]:
        raise ValueError(f"ref_lengths has {la.shape[0]} rows, x has "
                         f"{x.shape[0]}")
    return apply(lambda xa: torch.repeat_interleave(xa, la, 0), x,
                 name="sequence_expand")


def sequence_concat(xs: Sequence, lengths: Sequence):
    """Rows of several ragged tensors joined along time: the valid
    prefixes abut, padding moves to the tail.  Returns the
    ``[B, max(sum of lengths), ...]`` tensor and the summed lengths."""
    xs = [_t(x) for x in xs]
    if len(xs) != len(lengths):
        raise ValueError("need one lengths vector per input")
    lens = [_lens(v, xs[0].device) for v in lengths]
    total = torch.stack(lens).sum(0)
    t_out = int(total.max())

    def fn(*arrs):
        b, tail = arrs[0].shape[0], arrs[0].shape[2:]
        out = arrs[0].new_zeros((b, t_out + 1) + tail)
        off = torch.zeros_like(total)
        for a, la in zip(arrs, lens):
            pos = torch.arange(a.shape[1], device=a.device)[None, :]
            dest = torch.where(pos < la[:, None], off[:, None] + pos, t_out)
            idx = _tail(dest, a.dim()).expand(a.shape)
            out = out.scatter_add(1, idx, a)
            off = off + la
        return out[:, :t_out]

    return apply(fn, *xs, name="sequence_concat"), total


def sequence_enumerate(x, win_size: int, pad_value=0):
    """Sliding windows over each row: ``[B, T] -> [B, T, win_size]``,
    windows past the end padded with ``pad_value``."""
    def fn(xa):
        t = xa.shape[1]
        pad = torch.full(xa.shape[:1] + (win_size - 1,) + xa.shape[2:],
                         pad_value, dtype=xa.dtype, device=xa.device)
        ext = torch.cat([xa, pad], 1)
        cols = torch.arange(t, device=xa.device)[:, None] + \
            torch.arange(win_size, device=xa.device)[None, :]
        return ext[:, cols]

    return apply(fn, _t(x), name="sequence_enumerate")


def sequence_slice(x, lengths, offset, length):
    """Row ``i`` keeps ``[offset[i], offset[i] + length[i])`` of its valid
    prefix: ``([B, max(length), ...], length)``."""
    x = _t(x)
    off = _lens(offset, x.device)
    ln = _lens(length, x.device)
    la = _lens(lengths, x.device)
    if bool(((off + ln) > la).any()):
        raise ValueError("sequence_slice: offset+length exceeds row "
                         "lengths")
    t_out = int(ln.max())

    def fn(xa):
        pos = torch.arange(t_out, device=xa.device)[None, :]
        src = torch.clamp(off[:, None] + pos, max=xa.shape[1] - 1)
        out = torch.take_along_dim(xa, _tail(src, xa.dim()), 1)
        return torch.where(_tail(pos < ln[:, None], xa.dim()), out, 0)

    return apply(fn, x, name="sequence_slice"), ln
