"""Paged KV cache: a fixed block pool + per-slot block tables
(counterpart of ``paddle_tpu/inference/paged_kv.py``).

A dense cache reserves ``max_seq_len`` positions per slot whether it
uses them or not.  Here (Kwon et al., *Efficient Memory Management for
Large Language Model Serving with PagedAttention*) K/V live in a pool of
fixed-size blocks ``[layers, num_blocks, block_size, kv_heads,
head_dim]`` and each slot holds a small block table of pool indices: a
slot consumes ``ceil(len / block_size)`` blocks, and blocks can be
shared between slots (refcounts), which is what makes the radix prefix
cache (``prefix_cache.py``) free.

- Device (:class:`PagedKVCache`): the pools, updated IN PLACE by the
  model's paged prefill and decode (the JAX package returns new pools).
- Host (:class:`BlockAllocator`): LIFO free list + per-block refcounts.
  Block 0 is the reserved NULL block: unused table entries point at it,
  so no kernel sees an out-of-range index, and whatever lands there is
  masked by the per-slot lengths.

Block tables and lengths are host state of the engine.  Each pool
reports ``kv_blocks_in_use`` and ``kv_blocks_capacity`` to the metrics
registry (label ``pool="pN"``).
"""
from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np
import torch

from ..observability import metrics as _metrics
from ..ops.quantized_matmul import kv_zeros, resolve_kv_quant

__all__ = ["PagedKVCache", "BlockAllocator", "init_paged_cache",
           "blocks_for", "blocks_to_extend"]


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return -(-int(n_tokens) // int(block_size))


def blocks_to_extend(have_blocks: int, new_len: int,
                     block_size: int) -> int:
    """Additional blocks a slot holding ``have_blocks`` needs to cover
    ``new_len`` positions."""
    return max(blocks_for(new_len, block_size) - int(have_blocks), 0)


class PagedKVCache:
    """Device half of the paged cache: ``k``/``v`` are
    ``[layers, num_blocks, block_size, kv_heads, head_dim]`` block pools.

    Quantized form (``kv_dtype='int8'`` or ``'fp8'``): int8 or e4m3 value
    pools and
    ``k_scale``/``v_scale``, the per-(position, head) f32 scale pools
    ``[layers, num_blocks, block_size, kv_heads]``.  Full-precision pools
    (``k_scale is None``) are the default."""

    __slots__ = ("k", "v", "k_scale", "v_scale")

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
        self.k, self.v = k, v
        self.k_scale, self.v_scale = k_scale, v_scale

    @property
    def num_layers(self):
        return self.k.shape[0]

    @property
    def num_blocks(self):
        return self.k.shape[1]

    @property
    def block_size(self):
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def __repr__(self):
        return (f"PagedKVCache(layers={self.k.shape[0]}, "
                f"blocks={self.k.shape[1]}, block_size={self.k.shape[2]}, "
                f"kv_heads={self.k.shape[3]}, dtype={self.k.dtype}"
                f"{', quantized' if self.quantized else ''})")


def init_paged_cache(model, num_blocks: int, block_size: int,
                     kv_dtype: Optional[str] = None) -> PagedKVCache:
    """Zeroed block pools for ``model`` (a GPTForCausalLM or GPTModel) in
    its embedding's dtype, on its device.  ``num_blocks`` INCLUDES the
    null block 0.  ``kv_dtype='int8'`` or ``'fp8'`` (default from
    ``PADDLE_TPU_KV_DTYPE``) allocates int8 or e4m3 value pools plus f32
    scale pools."""
    gpt = getattr(model, "gpt", model)
    cfg = gpt.cfg
    w = gpt.wte.weight
    return PagedKVCache(*kv_zeros(
        (cfg.num_layers, int(num_blocks), int(block_size), cfg.num_kv_heads,
         cfg.head_dim), resolve_kv_quant(kv_dtype), w.dtype, w.device))


class BlockAllocator:
    """Host-side pool bookkeeping: LIFO free list + refcounts.

    Block ids run ``1..num_blocks-1`` (0 is the null block and is never
    handed out).  ``alloc`` refuses rather than over-commits: the
    scheduler turns a refusal into queueing, eviction or preemption.
    ``incref`` is how a second owner (a slot sharing a prefix, or the
    radix cache) holds a block; ``decref`` frees at zero.
    """

    _ids = itertools.count()

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the "
                             "reserved null block)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._refs = np.zeros(self.num_blocks, np.int32)
        # LIFO: recently freed blocks are handed out first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        # alloc attempts (successes and refusals): a blocked head-of-line
        # request must not be re-probed every step
        self.probes = 0
        # pool pressure: one gauge set per alloc and decref
        pool = f"p{next(BlockAllocator._ids)}"
        self._m_in_use = _metrics.gauge(
            "kv_blocks_in_use", "paged KV blocks held",
            labels=("pool",)).labels(pool=pool)
        _metrics.gauge("kv_blocks_capacity", "allocatable pool blocks",
                       labels=("pool",)).labels(pool=pool).set(
            self.capacity)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (null block excluded)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return self.capacity - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._refs[block])

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None when the pool cannot
        satisfy the request."""
        self.probes += 1
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self._m_in_use.set(self.capacity - len(self._free))
        return out

    def incref(self, blocks) -> None:
        for b in blocks:
            if self._refs[b] <= 0:
                raise RuntimeError(f"incref on free block {b}")
            self._refs[b] += 1

    def decref(self, blocks) -> None:
        for b in blocks:
            r = int(self._refs[b]) - 1
            if r < 0:
                raise RuntimeError(f"double free of block {b}")
            self._refs[b] = r
            if r == 0:
                self._free.append(b)
        self._m_in_use.set(self.capacity - len(self._free))

    def check_leak_free(self) -> None:
        """Raise unless every block is back on the free list."""
        if self.num_free != self.capacity:
            held = [b for b in range(1, self.num_blocks)
                    if self._refs[b] > 0]
            raise AssertionError(
                f"block pool leak: {self.num_free}/{self.capacity} free; "
                f"held blocks {held[:16]}{'...' if len(held) > 16 else ''}")
