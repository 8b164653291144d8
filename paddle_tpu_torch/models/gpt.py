"""GPT decoder for serving on one GPU (counterpart of
``paddle_tpu/models/gpt.py``: the dense, single-device, full-precision
cache path, plus the no-cache forward).

Parameters keep the JAX package's names and ``[in, out]`` layout
(``gpt.blocks.3.attn.qkv_proj.weight`` ...), so ``models.convert`` loads
a ``paddle_tpu`` model's weights one to one.  Attention goes through
``ops.flash_attention`` (prefill, no-cache forward) and
``ops.decode_attention`` (decode): hand-written kernels on the card,
their plain versions on the CPU.  The projections are ``torch.matmul``.

Differences from the JAX package: the serving cache is updated in place
(JAX returns a new cache each call), and the model lives on one explicit
device, CUDA unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import random as prandom
from ..device import resolve_device
from ..distributed.parallel_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.norm import LayerNorm
from .. import ops

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "StaticKVCache",
           "gpt_configs"]


class StaticKVCache:
    """Preallocated serving KV cache: ``k``/``v`` are
    ``[layers, batch_slots, capacity, kv_heads, head_dim]`` and
    ``lengths`` is ``[batch_slots]`` int32, the valid tokens per slot.

    Statically shaped, like the JAX cache, but updated IN PLACE: prefill
    and decode write into ``k``/``v``/``lengths`` and return this same
    object.
    """

    __slots__ = ("k", "v", "lengths")

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor):
        self.k, self.v, self.lengths = k, v, lengths

    @property
    def num_layers(self):
        return self.k.shape[0]

    @property
    def batch_slots(self):
        return self.k.shape[1]

    @property
    def capacity(self):
        return self.k.shape[2]

    def __repr__(self):
        return (f"StaticKVCache(layers={self.k.shape[0]}, "
                f"slots={self.k.shape[1]}, capacity={self.k.shape[2]}, "
                f"kv_heads={self.k.shape[3]}, dtype={self.k.dtype})")


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA; None -> MHA
    ffn_hidden_size: Optional[int] = None  # None -> 4 * hidden
    max_seq_len: int = 1024
    dropout: float = 0.0
    attn_dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def gpt_configs():
    """Named configs, as in the JAX package."""
    return {
        "gpt3-tiny": GPTConfig(vocab_size=512, hidden_size=128,
                               num_layers=2, num_heads=4, max_seq_len=256),
        "gpt3-125m": GPTConfig(hidden_size=768, num_layers=12,
                               num_heads=12, max_seq_len=2048),
        "gpt3-350m": GPTConfig(hidden_size=1024, num_layers=24,
                               num_heads=16, max_seq_len=2048),
        "gpt3-1.3b": GPTConfig(hidden_size=2048, num_layers=24,
                               num_heads=16, max_seq_len=2048),
        "gpt3-6.7b": GPTConfig(hidden_size=4096, num_layers=32,
                               num_heads=32, max_seq_len=2048),
        "gpt3-13b": GPTConfig(hidden_size=5120, num_layers=40,
                              num_heads=40, max_seq_len=2048),
    }


class GPTAttention(nn.Module):
    """Causal self-attention: fused qkv projection, attention kernel,
    output projection."""

    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        kv_dim = config.num_kv_heads * config.head_dim
        init = I.Normal(0.0, config.initializer_range)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv_proj = ColumnParallelLinear(h, h + 2 * kv_dim, init, **kw)
        self.out_proj = RowParallelLinear(h, h, init, **kw)
        self.dropout = Dropout(config.dropout)

    def _qkv_arrays(self, x):
        """qkv projection split into contiguous q ``[B, S, H, D]`` and
        k/v ``[B, S, Hkv, D]`` (the kernels take contiguous tensors)."""
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x)
        h_dim = cfg.hidden_size
        kv_dim = cfg.num_kv_heads * cfg.head_dim
        q = qkv[..., :h_dim].reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = qkv[..., h_dim:h_dim + kv_dim].reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        v = qkv[..., h_dim + kv_dim:].reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def _proj_out(self, out, b, s):
        return self.dropout(self.out_proj(out.reshape(b, s, -1)))

    def _attend_fresh(self, q, k, v):
        """No-past causal attention through the flash kernel."""
        return F.flash_attention(
            q, k, v, dropout=self.cfg.attn_dropout if self.training else 0.0,
            causal=q.shape[1] > 1)

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._qkv_arrays(x)
        return self._proj_out(self._attend_fresh(q, k, v), b, s)

    def forward_prefill(self, x):
        """Causal attention over a fresh prompt, also returning the
        per-token k/v for the cache write: ``(out, k, v)``."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._qkv_arrays(x)
        return self._proj_out(self._attend_fresh(q, k, v), b, s), k, v

    def forward_decode(self, x, k_layer, v_layer, lengths):
        """One decode step over a cache layer: write each slot's new k/v
        at ``min(lengths[b], cap - 1)`` in place, then attend over the
        first ``idx + 1`` positions.  x ``[B, 1, hidden]``; k_layer /
        v_layer ``[B, cap, Hkv, D]``; lengths ``[B]`` int32, tokens in the
        cache EXCLUDING this one."""
        b = x.shape[0]
        cap = k_layer.shape[1]
        q, k, v = self._qkv_arrays(x)
        idx = torch.clamp(lengths, max=cap - 1)
        rows = torch.arange(b, device=x.device)
        k_layer[rows, idx] = k[:, 0]
        v_layer[rows, idx] = v[:, 0]
        out = ops.decode_attention(q[:, 0], k_layer, v_layer,
                                   (idx + 1).to(torch.int32))
        return self._proj_out(out[:, None], b, 1)


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.up_proj = ColumnParallelLinear(
            config.hidden_size, config.ffn_hidden_size,
            I.Normal(0.0, config.initializer_range), **kw)
        self.down_proj = RowParallelLinear(
            config.ffn_hidden_size, config.hidden_size,
            I.Normal(0.0, config.initializer_range
                     / math.sqrt(2.0 * config.num_layers)), **kw)
        self.dropout = Dropout(config.dropout)

    def forward(self, x):
        return self.dropout(self.down_proj(
            F.gelu(self.up_proj(x), approximate=True)))


class GPTBlock(nn.Module):
    """Pre-LN decoder block."""

    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size,
                              config.layer_norm_epsilon, **kw)
        self.attn = GPTAttention(config, generator=generator, **kw)
        self.ln_2 = LayerNorm(config.hidden_size,
                              config.layer_norm_epsilon, **kw)
        self.mlp = GPTMLP(config, generator=generator, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def forward_prefill(self, x):
        """Block forward that also returns this layer's k/v."""
        a, k, v = self.attn.forward_prefill(self.ln_1(x))
        x = x + a
        return x + self.mlp(self.ln_2(x)), k, v

    def forward_decode(self, x, k_layer, v_layer, lengths):
        """Single-token block step over one cache layer (written in
        place)."""
        x = x + self.attn.forward_decode(self.ln_1(x), k_layer, v_layer,
                                         lengths)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    """Embeddings + N blocks + final norm; returns hidden states."""

    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = config
        init = I.Normal(0.0, config.initializer_range)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, init, **kw)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size, init,
                             **kw)
        self.drop = Dropout(config.dropout)
        self.blocks = nn.ModuleList(
            [GPTBlock(config, **kw) for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def _embed(self, ids, pos):
        return self.drop(self.wte(ids) + self.wpe(pos))

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self._embed(input_ids, pos)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)

    # ---- serving path: static KV cache --------------------------------
    def init_kv_cache(self, batch_slots: int,
                      capacity: Optional[int] = None) -> StaticKVCache:
        """Zeroed cache ``[layers, batch_slots, capacity, Hkv, D]`` in the
        embedding's dtype (capacity defaults to max_seq_len)."""
        cfg = self.cfg
        cap = int(capacity or cfg.max_seq_len)
        w = self.wte.weight
        shape = (cfg.num_layers, int(batch_slots), cap, cfg.num_kv_heads,
                 cfg.head_dim)
        return StaticKVCache(
            torch.zeros(shape, dtype=w.dtype, device=w.device),
            torch.zeros(shape, dtype=w.dtype, device=w.device),
            torch.zeros(int(batch_slots), dtype=torch.int32, device=w.device))

    @torch.no_grad()
    def forward_prefill(self, input_ids, cache: StaticKVCache, slot: int,
                        prompt_len: int):
        """Prefill ONE slot: causal forward over the (possibly bucket-
        padded) prompt ``input_ids [1, s]``, every layer's k/v written at
        ``(layer, slot, 0:s)`` and ``lengths[slot] = prompt_len``.  The
        padding's k/v lie past the recorded length, so no later decode
        step reads them.  Returns hidden ``[1, s, hidden]``."""
        s = input_ids.shape[1]
        if s > cache.capacity:
            raise ValueError(f"prefill of {s} tokens exceeds the cache "
                             f"capacity {cache.capacity}")
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self._embed(input_ids, pos)
        for i, blk in enumerate(self.blocks):
            x, k, v = blk.forward_prefill(x)
            cache.k[i, slot, :s] = k[0]
            cache.v[i, slot, :s] = v[0]
        cache.lengths[slot] = int(prompt_len)
        return self.ln_f(x)

    @torch.no_grad()
    def forward_decode(self, tokens, cache: StaticKVCache, active):
        """One decode step for every slot: append ``tokens [B]`` at each
        slot's length, attend, and advance ``lengths`` by ``active [B]``
        (0/1) clamped at capacity.  Position ids clamp at
        ``max_seq_len - 1``.  Returns hidden ``[B, 1, hidden]``."""
        cfg = self.cfg
        b = cache.batch_slots
        pos = torch.clamp(cache.lengths, max=cfg.max_seq_len - 1)
        x = self._embed(tokens.reshape(b, 1), pos.reshape(b, 1))
        for i, blk in enumerate(self.blocks):
            x = blk.forward_decode(x, cache.k[i], cache.v[i], cache.lengths)
        cache.lengths.copy_(torch.clamp(
            cache.lengths + active.to(torch.int32), max=cache.capacity))
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """LM head on top; tied to the token embedding by default (logits =
    h @ wte^T).

    ``device=None`` means the CUDA device (raises without one); pass
    ``device="cpu"`` to run on the CPU.  Weights are drawn from
    ``generator`` (default: a generator seeded with 0 on that device).
    """

    def __init__(self, config: GPTConfig, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else prandom.seed(0, dev)
        self.cfg = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype, generator=gen)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size,
                I.Normal(0.0, config.initializer_range), has_bias=False,
                device=dev, dtype=dtype, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids):
        """Logits ``[B, S, vocab]`` of a causal forward without cache."""
        return self._head_logits(self.gpt(input_ids))

    def init_kv_cache(self, batch_slots: int,
                      capacity: Optional[int] = None) -> StaticKVCache:
        return self.gpt.init_kv_cache(batch_slots, capacity)

    def _head_logits(self, hidden):
        if self.cfg.tie_word_embeddings:
            return torch.matmul(hidden, self.gpt.wte.weight.t())
        return self.lm_head(hidden)

    @torch.no_grad()
    def prefill(self, input_ids, cache: StaticKVCache, slot: int,
                prompt_len: int):
        """Prefill one slot; returns ``(logits [1, V], cache)``: the
        logits at the last real prompt token (position prompt_len - 1)."""
        h = self.gpt.forward_prefill(input_ids, cache, slot, prompt_len)
        return self._head_logits(h[:, int(prompt_len) - 1]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: StaticKVCache, active):
        """One decode step for all slots; returns ``(logits [B, V],
        cache)``."""
        h = self.gpt.forward_decode(tokens, cache, active)
        return self._head_logits(h)[:, 0], cache

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 include_prompt: bool = False) -> np.ndarray:
        """Single-request convenience wrapper over a one-slot
        ``InferenceEngine`` on this model's device.  Returns a 1-D numpy
        array of generated token ids."""
        from ..inference.engine import InferenceEngine
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids).reshape(-1).astype(np.int32)
        eng = InferenceEngine(self, batch_slots=1, top_k=top_k, seed=seed,
                              device=self.device)
        gen = np.asarray(eng.generate(ids, max_new_tokens=max_new_tokens,
                                      eos_id=eos_id, temperature=temperature,
                                      top_p=top_p), np.int32)
        return np.concatenate([ids, gen]) if include_prompt else gen
