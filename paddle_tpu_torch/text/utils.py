"""Dense padding and masking helpers (counterpart of
``paddle_tpu/text/utils.py``): ragged batches become ``[B, max_len]``
plus a mask, which is how a caller builds a search's prompts.

Tensor helpers return tensors on their input's device; one given a host
list or array, or none at all (``causal_mask``), makes its tensor on
``device`` (CUDA unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["sequence_mask", "pad_sequences", "truncate_sequences",
           "shift_tokens_right", "causal_mask", "padding_attn_mask"]


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def sequence_mask(lengths, maxlen: Optional[int] = None, dtype="bool",
                  device=None) -> torch.Tensor:
    """``[B]`` lengths -> ``[B, maxlen]`` mask, ``pos < length`` (maxlen
    defaults to the largest length, one host read)."""
    ln = _tensor(lengths, device)
    if maxlen is None:
        maxlen = int(ln.max().item())
    pos = torch.arange(maxlen, dtype=torch.int32, device=ln.device)
    return (pos < ln[..., None].to(torch.int32)).to(_dtype(dtype))


def pad_sequences(seqs: Sequence[Sequence[int]], maxlen: Optional[int] = None,
                  pad_value=0, dtype=np.int64, truncate_from="right",
                  return_lengths=False):
    """Ragged Python sequences -> a dense ``[B, maxlen]`` numpy array
    (and the lengths kept)."""
    if maxlen is None:
        maxlen = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), maxlen), pad_value, dtype=dtype)
    lengths = np.zeros((len(seqs),), np.int64)
    for i, s in enumerate(seqs):
        s = list(s)
        if len(s) > maxlen:
            s = s[-maxlen:] if truncate_from == "left" else s[:maxlen]
        out[i, :len(s)] = s
        lengths[i] = len(s)
    if return_lengths:
        return out, lengths
    return out


def truncate_sequences(seqs, maxlen: int, truncate_from="right"):
    return [list(s)[-maxlen:] if truncate_from == "left" else
            list(s)[:maxlen] for s in seqs]


def shift_tokens_right(input_ids, pad_id: int = 0,
                       device=None) -> torch.Tensor:
    """Labels of a causal LM: ``labels[:, t] = input_ids[:, t + 1]``, the
    last position ``pad_id``."""
    a = _tensor(input_ids, device)
    return torch.cat([a[:, 1:], torch.full((a.shape[0], 1), pad_id,
                                           dtype=a.dtype, device=a.device)],
                     dim=1)


def causal_mask(seq_len: int, dtype="bool", device=None) -> torch.Tensor:
    """``[1, 1, S, S]`` lower-triangular mask."""
    m = torch.ones((seq_len, seq_len), dtype=torch.bool,
                   device=resolve_device(device)).tril()
    return m[None, None].to(_dtype(dtype))


def padding_attn_mask(lengths, seq_len: int, device=None) -> torch.Tensor:
    """``[B]`` lengths -> ``[B, 1, 1, S]`` boolean key-padding mask
    (broadcasts over heads and query positions)."""
    return sequence_mask(lengths, maxlen=seq_len, dtype="bool",
                         device=device)[:, None, None, :]
