"""Philox4x32-10 keep bits for attention dropout: the plain twin of
``csrc/philox.cuh``, in torch int64 arithmetic.

Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; the generator behind ``curand_Philox4x32_10``) maps a
128-bit counter and a 64-bit key to four 32-bit words.  The keep bit of
attention element (b, h, i, j) (batch, query head, query row, key) is a
fixed function of ``(seed, offset, b, h, i, j)`` and of nothing else:
not of the kernels' tile sizes, nor of which thread holds the element.

One Philox call gives eight 16-bit fields, the decisions of eight
elements: query rows ``{i0, i0 + 8}`` times keys ``{j0, j0 + 1, j0 + 8,
j0 + 9}`` of one 16 x 16 block, where ``i0 = i & 7`` and ``j0 = 2 *
((j >> 1) & 3)`` inside the block.  That is the set one thread of the
forward and dq kernels holds in its wgmma fragments (rows gid and gid +
8, keys 2 tig, 2 tig + 1 of two neighbouring 8-key groups), so those
kernels draw each call once; the dk/dv kernel's fragments are the
transpose, and two threads share two calls (``philox.cuh``).

- counter: ``c0 = (j >> 4) * 32 + (i & 7) * 4 + ((j >> 1) & 3)``,
  ``c1 = i >> 4``, ``c2 = b * H + h``, ``c3 = offset mod 2^32``;
- key: the seed's low and high 32 bits;
- field: word ``(j & 1) * 2 + ((i >> 3) & 1)``, its low half where
  ``(j >> 3) & 1 == 0``, else its high half;
- keep iff ``field >= round(p * 65536)``: the drop rate is p to 2^-16.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["philox4x32_10", "threshold", "keep_mask", "PHILOX_WORDS",
           "KEEP_BITS", "philox_words_cuda", "keep_bits_cuda"]

# check entries of csrc/philox_check.cu (no path launches them)
PHILOX_WORDS = _build.CudaKernel(
    "philox_check.cu", "philox_words",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
KEEP_BITS = _build.CudaKernel(
    "philox_check.cu", "flash_keep_bits",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_void_p])

M0, M1 = 0xD2511F53, 0xCD9E8D57      # multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # key increments (Weyl)
_U32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32 bits of ``m * x`` for 32-bit ``m`` and ``x`` in
    [0, 2^32): the product is split at 16 bits of ``m`` so that no
    partial sum leaves int64."""
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    return (b + (a >> 16)) >> 16, (((b & 0xFFFF) << 16) + a) & _U32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four words of Philox4x32-10 at counter ``(c0, c1, c2, c3)``
    and key ``(k0, k1)``: int64 tensors (or ints) holding 32-bit values,
    broadcast together."""
    c = [torch.as_tensor(x, dtype=torch.int64) & _U32
         for x in (c0, c1, c2, c3)]
    k0 = torch.as_tensor(k0, dtype=torch.int64) & _U32
    k1 = torch.as_tensor(k1, dtype=torch.int64) & _U32
    for r in range(10):
        if r:
            k0 = (k0 + W0) & _U32
            k1 = (k1 + W1) & _U32
        hi0, lo0 = _mulhilo(M0, c[0])
        hi1, lo1 = _mulhilo(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def threshold(p: float) -> int:
    """The 16-bit field a kept element reaches: ``round(p * 65536)``."""
    return int(round(float(p) * 65536))


def keep_mask(philox: torch.Tensor, b: int, h: int, s: int, sk: int,
              p: float) -> torch.Tensor:
    """Keep bits ``[B, H, S, Sk]`` (bool) of the (seed, offset) pair
    ``philox`` (int64 ``[2]``) at drop rate ``p``, on ``philox``'s
    device; the elements a kernel draws for the same pair."""
    dev = philox.device
    seed, offset = philox[0], philox[1]
    i = torch.arange(s, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(sk, dtype=torch.int64, device=dev)[None, :]
    c0 = (j >> 4) * 32 + (i & 7) * 4 + ((j >> 1) & 3)
    word = (j & 1) * 2 + ((i >> 3) & 1)
    shift = ((j >> 3) & 1) * 16
    thr = threshold(p)
    out = torch.empty((b * h, s, sk), dtype=torch.bool, device=dev)
    # rows of (b, h) pairs in chunks of at most 2^24 elements
    step = max(1, (1 << 24) // max(1, s * sk))
    for lo in range(0, b * h, step):
        bh = torch.arange(lo, min(lo + step, b * h), dtype=torch.int64,
                          device=dev)[:, None, None]
        words = torch.stack(philox4x32_10(
            c0, i >> 4, bh, offset, seed, seed >> 32), 0)
        picked = torch.gather(words, 0,
                              word.expand_as(words[0])[None])[0]
        out[lo:lo + step] = ((picked >> shift) & 0xFFFF) >= thr
    return out.reshape(b, h, s, sk)


def philox_words_cuda(inputs: torch.Tensor) -> torch.Tensor:
    """``[n, 8]`` int32 words on the card for ``inputs [n, 6]`` int32
    (the bit patterns of c0, c1, c2, c3, k0, k1): philox.cuh's four
    words, then ``curand_Philox4x32_10``'s."""
    if inputs.device.type != "cuda" or inputs.dtype != torch.int32 \
            or inputs.dim() != 2 or inputs.shape[1] != 6 \
            or not inputs.is_contiguous():
        raise ValueError("philox_words_cuda takes a contiguous int32 "
                         "[n, 6] tensor on the card")
    out = torch.empty((inputs.shape[0], 8), dtype=torch.int32,
                      device=inputs.device)
    PHILOX_WORDS(_build.ptr(inputs), _build.ptr(out), inputs.shape[0],
                 _build.stream_ptr(inputs))
    return out


def keep_bits_cuda(philox: torch.Tensor, b: int, h: int, s: int, sk: int,
                   p: float) -> torch.Tensor:
    """``keep_mask`` computed on the card by philox.cuh, one element a
    thread: bool ``[B, H, S, Sk]``."""
    if philox.device.type != "cuda" or philox.dtype != torch.int64 \
            or tuple(philox.shape) != (2,):
        raise ValueError("keep_bits_cuda takes the int64 [2] pair on the "
                         "card")
    out = torch.empty((b, h, s, sk), dtype=torch.uint8, device=philox.device)
    KEEP_BITS(_build.ptr(philox), _build.ptr(out), b, h, s, sk,
              threshold(p), _build.stream_ptr(philox))
    return out.bool()
