"""GPT decoder on one GPU (counterpart of ``paddle_tpu/models/gpt.py``:
the single-device serving paths over the dense and the paged KV cache,
full precision, int8 or fp8 (e4m3), with the W-token window steps of
speculative decoding and chunked prefill, the fused per-layer decode
step, int8 and fp8 quantized compute, the no-cache forward and the training surface:
recompute, the fused-CE head and ``GPTPretrainingCriterion``).

Parameters keep the JAX package's names and ``[in, out]`` layout
(``gpt.blocks.3.attn.qkv_proj.weight`` ...), so ``models.convert`` loads
a ``paddle_tpu`` model's weights one to one.  Attention goes through
``ops.flash_attention`` (prefill without a cached prefix, no-cache
forward), ``ops.decode_attention`` and ``ops.paged_decode_attention``
(decode, full precision, int8 or e4m3), ``ops.decode_attention_window`` and
``ops.paged_decode_attention_window`` (verify windows and prefill
chunks): hand-written kernels on the card,
their plain versions on the CPU; under autograd the flash backward runs
the dq and dk/dv kernels.  A paged prefill over a cached prefix attends
through ``masked_attention``, a plain masked composite, as the JAX
package does through its XLA composite.  The projections are
``torch.matmul``, or ``ops.fake_quant_matmul`` (the int8 or e4m3 kernel
on the card) under ``quantize='int8'`` or ``'fp8'``.  With ``decode_megakernel`` a decode
step runs each layer as one ``ops.decode_layer_step(_paged)`` call (one
kernel launch on the card) and writes the returned k/v itself.

Differences from the JAX package: the serving caches are updated in
place (JAX returns new caches each call; the paged prefill writes only
the new tokens' positions instead of gathering and scattering the slot's
whole row), and the model lives on one explicit device, CUDA unless
``device="cpu"`` is asked for.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import random as prandom
from ..device import resolve_device
from ..distributed.moe import MoELayer
from ..distributed.recompute import checkpoint_policy, recompute
from ..distributed.parallel_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.norm import LayerNorm
from .. import ops
from ..ops.decode_megakernel import megakernel_enabled
from ..ops.quantized_matmul import (_check_mode, dequantize_kv, kv_zeros,
                                    resolve_kv_quant, write_kv)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "StaticKVCache", "gpt_configs",
           "masked_attention"]


class StaticKVCache:
    """Preallocated serving KV cache: ``k``/``v`` are
    ``[layers, batch_slots, capacity, kv_heads, head_dim]`` and
    ``lengths`` is ``[batch_slots]`` int32, the valid tokens per slot.
    Quantized form (``kv_dtype='int8'`` or ``'fp8'``): int8 or e4m3
    (``torch.float8_e4m3fn``) ``k``/``v`` and
    ``k_scale``/``v_scale``, per-(position, head) f32 scales
    ``[layers, batch_slots, capacity, kv_heads]``.

    Statically shaped, like the JAX cache, but updated IN PLACE: prefill
    and decode write into it and return this same object.
    """

    __slots__ = ("k", "v", "lengths", "k_scale", "v_scale")

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
        self.k, self.v, self.lengths = k, v, lengths
        self.k_scale, self.v_scale = k_scale, v_scale

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

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
                f"kv_heads={self.k.shape[3]}, dtype={self.k.dtype}"
                f"{', quantized' if self.quantized else ''})")


def _decode_at(lengths, cap: int):
    """Where each slot's new token goes in a dense cache layer: ``(rows,
    min(lengths, cap - 1))``."""
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    return rows, torch.clamp(lengths, max=cap - 1)


def _paged_decode_at(tables, lengths, bs: int):
    """Where each slot's new token goes in a paged layer: ``(tables[b,
    min(lengths[b] // bs, MB - 1)], lengths[b] % bs)``."""
    rows = torch.arange(tables.shape[0], device=tables.device)
    blk = tables[rows, torch.clamp(lengths // bs, max=tables.shape[1] - 1)]
    return blk.long(), lengths % bs


def masked_attention(q, k, v, offset: int) -> torch.Tensor:
    """Attention of queries at absolute positions ``offset + i`` over
    keys ``j <= offset + i``: q ``[B, S, H, D]``, k/v ``[B, N, Hkv, D]``
    (GQA expanded here).  A plain composite (matmul, masked softmax,
    matmul) in f32, mirroring the JAX package's ``_sdpa_reference``
    with a boolean mask; returns q's dtype."""
    b, s, h, d = q.shape
    n, hkv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=2)
        vf = vf.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    keep = (torch.arange(n, device=q.device)[None, :]
            <= offset + torch.arange(s, device=q.device)[:, None])
    scores = torch.where(keep, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


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
    # False raises on the card (the port has no library attention); on
    # the CPU both settings run the plain attention
    use_flash_attention: bool = True
    tie_word_embeddings: bool = True
    # fused LM loss: in training the model returns (hidden, wte.weight)
    # and the criterion runs the blocked cross-entropy over vocab chunks
    # (ops.fused_cross_entropy): no [B, S, V] logits.  Needs tied
    # embeddings.
    fused_ce: bool = False
    # quantized compute: 'int8' or 'fp8' routes every block linear (qkv,
    # out, up, down) through ops.fake_quant_matmul (quantized forward, straight-
    # through backward); embeddings and the LM head stay full precision.
    # None keeps the unquantized products.
    quantize: Optional[str] = None
    # serving: each decode step runs every layer as one fused op
    # (ops.decode_layer_step); PADDLE_TPU_DECODE_MEGAKERNEL overrides
    decode_megakernel: bool = False
    # mixture of experts (0 experts = dense): every moe_every_n_layers-th
    # block's MLP is a distributed.moe.MoELayer
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_every_n_layers: int = 1
    moe_aux_loss_coeff: float = 0.01
    moe_z_loss_coeff: float = 0.0
    ep_axis: str = "ep"

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.quantize is not None:
            _check_mode(self.quantize)
            if self.moe_num_experts > 0:
                # the expert FFNs are batched products, not the block
                # linears: they would stay full precision while the
                # config said int8 or fp8
                raise NotImplementedError(
                    f"quantize={self.quantize!r} COMPUTE with MoE is "
                    f"not supported: expert FFN matmuls (the dominant "
                    f"MoE FLOPs) have no quantized path yet, and "
                    f"quantizing only attention would misattribute the "
                    f"measured MFU. Quantized KV CACHES are orthogonal "
                    f"and do work with MoE engines — pass "
                    f"kv_dtype='int8' or 'fp8' to InferenceEngine/"
                    f"init_kv_cache "
                    f"instead")

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (self.moe_num_experts > 0 and
                (layer_idx + 1) % self.moe_every_n_layers == 0)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def num_params(self, include_embeddings=True):
        h, l, v = self.hidden_size, self.num_layers, self.vocab_size
        # qkv (h*(h+2*kv)) + out (h*h) + mlp (2*h*ffn) + biases/norms
        kv_dim = self.num_kv_heads * self.head_dim
        per_block = h * (h + 2 * kv_dim) + h * h + \
            2 * h * self.ffn_hidden_size + 13 * h
        total = l * per_block + 2 * h  # final norm
        if include_embeddings:
            total += v * h + self.max_seq_len * h
        return int(total)

    def flops_per_token(self, seq_len=None):
        """Model FLOPs per token (fwd+bwd, 6N + attention quadratic
        term): the MFU formula of the JAX package's bench.py."""
        s = seq_len or self.max_seq_len
        n = self.num_params(include_embeddings=False)
        return 6 * n + 12 * self.num_layers * self.hidden_size * s


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
    output projection.  In training, ``attn_dropout`` drops attention
    probabilities inside the flash kernels; the serving paths run in
    eval and apply none."""

    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        kv_dim = config.num_kv_heads * config.head_dim
        init = I.Normal(0.0, config.initializer_range)
        kw = dict(device=device, dtype=dtype, generator=generator,
                  quantize=config.quantize)
        self.qkv_proj = ColumnParallelLinear(h, h + 2 * kv_dim, init, **kw)
        self.out_proj = RowParallelLinear(h, h, init, **kw)
        self.dropout = Dropout(p=config.dropout)

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
        """No-past causal attention through the flash kernels, with
        ``attn_dropout`` in training.  It calls ``ops.flash_attention``
        itself, not the layer API's route: on the card a shape or dtype
        the kernels do not take raises, and never falls to the
        composite."""
        if not self.cfg.use_flash_attention and q.is_cuda:
            raise NotImplementedError(
                "use_flash_attention=False: the port has no library "
                "attention on the card; its flash kernels (attention "
                "dropout included) are the attention")
        return ops.flash_attention(
            q, k, v, causal=q.shape[1] > 1,
            dropout_p=self.cfg.attn_dropout if self.training else 0.0)

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

    def forward_decode(self, x, k_layer, v_layer, lengths, k_scale=None,
                       v_scale=None):
        """One decode step over a cache layer: write each slot's new k/v
        at ``min(lengths[b], cap - 1)`` in place, then attend over the
        first ``idx + 1`` positions.  x ``[B, 1, hidden]``; k_layer /
        v_layer ``[B, cap, Hkv, D]``; lengths ``[B]`` int32, tokens in the
        cache EXCLUDING this one.  Quantized layer: ``k_scale``/
        ``v_scale`` ``[B, cap, Hkv]`` f32; the new k/v are quantized per
        head on write, q stays in the model dtype."""
        b = x.shape[0]
        q, k, v = self._qkv_arrays(x)
        at = _decode_at(lengths, k_layer.shape[1])
        write_kv(k_layer, v_layer, k_scale, v_scale, at, k[:, 0], v[:, 0])
        out = ops.decode_attention(q[:, 0], k_layer, v_layer,
                                   (at[1] + 1).to(torch.int32), k_scale,
                                   v_scale)
        return self._proj_out(out[:, None], b, 1)

    def forward_prefill_paged(self, x, k_prefix=None, v_prefix=None):
        """Prefill attention of one slot's new tokens (absolute positions
        ``prefix_len + i``, ``prefix_len = len(k_prefix)``) over its
        cached prefix ``k_prefix``/``v_prefix`` ``[prefix_len, Hkv, D]``
        and the new tokens' own k/v; returns ``(out, k, v)`` for the
        cache write.  Cold (no prefix): the flash kernel, exactly as the
        dense prefill.  Over a prefix: ``masked_attention`` (query i sees
        keys ``j <= prefix_len + i``), the JAX package's composite path;
        the prefix is cast to q's dtype first, as JAX casts its buffer."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._qkv_arrays(x)
        if k_prefix is None or k_prefix.shape[0] == 0:
            out = self._attend_fresh(q, k, v)
        elif self.training and self.cfg.attn_dropout > 0:
            raise NotImplementedError(
                "attention dropout over a cached prefix: the prefix "
                "composite (masked_attention) applies none; prefix "
                "prefills are a serving path, run them in eval")
        else:
            kf = torch.cat([k_prefix.to(q.dtype)[None], k], dim=1)
            vf = torch.cat([v_prefix.to(q.dtype)[None], v], dim=1)
            out = masked_attention(q, kf, vf, k_prefix.shape[0])
        return self._proj_out(out, b, s), k, v

    def forward_decode_paged(self, x, k_pool, v_pool, tables, lengths,
                             k_scale=None, v_scale=None):
        """One decode step over a paged layer: write each slot's new k/v
        at pool position ``(tables[b, lengths[b] // bs], lengths[b] %
        bs)`` in place, then attend through the block tables.  x
        ``[B, 1, hidden]``; pools ``[NB, bs, Hkv, D]``; tables ``[B, MB]``
        int32; lengths ``[B]`` int32 EXCLUDING the new token.  Inactive
        slots (table rows all 0, length 0) write into the null block and
        attend one position there; their outputs are ignored.  Quantized
        pools: ``k_scale``/``v_scale`` ``[NB, bs, Hkv]`` f32."""
        b = x.shape[0]
        q, k, v = self._qkv_arrays(x)
        write_kv(k_pool, v_pool, k_scale, v_scale,
                  _paged_decode_at(tables, lengths, k_pool.shape[1]),
                  k[:, 0], v[:, 0])
        out = ops.paged_decode_attention(q[:, 0], k_pool, v_pool, tables,
                                         lengths + 1, k_scale, v_scale)
        return self._proj_out(out[:, None], b, 1)

    def forward_verify(self, x, k_layer, v_layer, lengths, k_scale=None,
                       v_scale=None):
        """W-token window step over a cache layer (the spec-decode verify
        and draft catch-up, and a prefill chunk): write the W new k/v at
        ``min(lengths[b] + i, cap - 1)`` in place (quantized per head on
        an int8 layer), then query i attends ``j <= lengths[b] + i``.  x
        ``[B, W, hidden]``; lengths ``[B]`` int32 EXCLUDING the window.
        Clamped writes of several window rows may share the last
        position: only rows past the capacity collide, and their outputs
        are never used."""
        b, w = x.shape[0], x.shape[1]
        cap = k_layer.shape[1]
        q, k, v = self._qkv_arrays(x)
        lens = lengths.to(torch.int32)
        idx = torch.clamp(lens[:, None].long()
                          + torch.arange(w, device=x.device)[None, :],
                          max=cap - 1)
        rows = torch.arange(b, device=x.device)[:, None]
        write_kv(k_layer, v_layer, k_scale, v_scale, (rows, idx), k, v)
        out = ops.decode_attention_window(q, k_layer, v_layer, lens, k_scale,
                                          v_scale)
        return self._proj_out(out, b, w)

    def forward_verify_paged(self, x, k_pool, v_pool, tables, lengths,
                             k_scale=None, v_scale=None):
        """Paged twin of ``forward_verify``: the W new k/v go through each
        slot's table to ``(tables[b, t // bs], t % bs)``, t = lengths[b] +
        i, then the paged window attention.  Positions past a slot's
        blocks land in the null block: a zero table entry, or t >=
        MB * bs.  The second matters to a slot decoding in its last table
        block that rides a chunk tick with advance 0: clamping t to block
        MB - 1 (as the JAX package does) would overwrite its own cached
        positions."""
        b, w = x.shape[0], x.shape[1]
        bs, mb = k_pool.shape[1], tables.shape[1]
        q, k, v = self._qkv_arrays(x)
        lens = lengths.to(torch.int32)
        pos = lens[:, None].long() + torch.arange(w, device=x.device)[None, :]
        rows = torch.arange(b, device=x.device)[:, None]
        blk = torch.where(pos < mb * bs,
                          tables[rows, torch.clamp(pos // bs, max=mb - 1)],
                          0).long()
        write_kv(k_pool, v_pool, k_scale, v_scale, (blk, pos % bs), k, v)
        out = ops.paged_decode_attention_window(q, k_pool, v_pool, tables,
                                                lens, k_scale, v_scale)
        return self._proj_out(out, b, w)


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  quantize=config.quantize)
        self.up_proj = ColumnParallelLinear(
            config.hidden_size, config.ffn_hidden_size,
            I.Normal(0.0, config.initializer_range), **kw)
        self.down_proj = RowParallelLinear(
            config.ffn_hidden_size, config.hidden_size,
            I.Normal(0.0, config.initializer_range
                     / math.sqrt(2.0 * config.num_layers)), **kw)
        self.dropout = Dropout(p=config.dropout)

    def forward(self, x):
        return self.dropout(self.down_proj(
            F.gelu(self.up_proj(x), approximate=True)))


class GPTBlock(nn.Module):
    """Pre-LN decoder block.  Where the config marks the layer as MoE the
    MLP is a ``distributed.moe.MoELayer`` (the switch-transformer
    block)."""

    def __init__(self, config: GPTConfig, layer_idx: int = 0, *, device,
                 dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **kw)
        self.attn = GPTAttention(config, generator=generator, **kw)
        self.ln_2 = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **kw)
        self.is_moe = config.is_moe_layer(layer_idx)
        if self.is_moe:
            self.mlp = MoELayer(
                config.hidden_size, config.ffn_hidden_size,
                num_experts=config.moe_num_experts, top_k=config.moe_top_k,
                capacity_factor=config.moe_capacity_factor,
                aux_loss_coeff=config.moe_aux_loss_coeff,
                z_loss_coeff=config.moe_z_loss_coeff,
                ep_axis=config.ep_axis,
                weight_init=I.Normal(0.0, config.initializer_range),
                # depth-scaled residual-out init, as GPTMLP.down_proj
                down_weight_init=I.Normal(0.0, config.initializer_range
                                          / math.sqrt(2.0
                                                      * config.num_layers)),
                generator=generator, **kw)
        else:
            self.mlp = GPTMLP(config, generator=generator, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def forward_prefill(self, x):
        """Block forward that also returns this layer's k/v."""
        a, k, v = self.attn.forward_prefill(self.ln_1(x))
        x = x + a
        return x + self.mlp(self.ln_2(x)), k, v

    def forward_decode(self, x, k_layer, v_layer, lengths, k_scale=None,
                       v_scale=None):
        """Single-token block step over one cache layer (written in
        place)."""
        x = x + self.attn.forward_decode(self.ln_1(x), k_layer, v_layer,
                                         lengths, k_scale, v_scale)
        return x + self.mlp(self.ln_2(x))

    def forward_prefill_paged(self, x, k_prefix=None, v_prefix=None):
        """Block prefill over one slot's cached prefix; also returns this
        layer's new k/v."""
        a, k, v = self.attn.forward_prefill_paged(self.ln_1(x), k_prefix,
                                                  v_prefix)
        x = x + a
        return x + self.mlp(self.ln_2(x)), k, v

    def forward_decode_paged(self, x, k_pool, v_pool, tables, lengths,
                             k_scale=None, v_scale=None):
        """Single-token block step over one paged layer (written in
        place)."""
        x = x + self.attn.forward_decode_paged(self.ln_1(x), k_pool, v_pool,
                                               tables, lengths, k_scale,
                                               v_scale)
        return x + self.mlp(self.ln_2(x))

    def forward_verify(self, x, k_layer, v_layer, lengths, k_scale=None,
                       v_scale=None):
        """W-token window block step over one cache layer (written in
        place)."""
        x = x + self.attn.forward_verify(self.ln_1(x), k_layer, v_layer,
                                         lengths, k_scale, v_scale)
        return x + self.mlp(self.ln_2(x))

    def forward_verify_paged(self, x, k_pool, v_pool, tables, lengths,
                             k_scale=None, v_scale=None):
        """W-token window block step over one paged layer (written in
        place)."""
        x = x + self.attn.forward_verify_paged(self.ln_1(x), k_pool, v_pool,
                                               tables, lengths, k_scale,
                                               v_scale)
        return x + self.mlp(self.ln_2(x))

    # ---- fused (megakernel) decode step ---------------------------------
    def _megakernel_weights(self):
        """The 12 per-layer arrays of the fused step, in
        ``ops.decode_megakernel.LAYER_WEIGHTS`` order."""
        a, m = self.attn, self.mlp
        return (self.ln_1.weight, self.ln_1.bias,
                a.qkv_proj.weight, a.qkv_proj.bias,
                a.out_proj.weight, a.out_proj.bias,
                self.ln_2.weight, self.ln_2.bias,
                m.up_proj.weight, m.up_proj.bias,
                m.down_proj.weight, m.down_proj.bias)

    def _megakernel_ok(self) -> bool:
        """Every projection carries its bias (the fused step adds them)."""
        a, m = self.attn, self.mlp
        return all(t is not None for t in (
            a.qkv_proj.bias, a.out_proj.bias, m.up_proj.bias,
            m.down_proj.bias))

    def forward_decode_fused(self, x, k_layer, v_layer, lengths,
                             k_scale=None, v_scale=None):
        """``forward_decode`` as one fused op: the layer step
        (``ops.decode_layer_step``, with the live ``quantize`` of the
        projections, which ``enable_quantize`` flips), then the new k/v
        written at ``min(lengths[b], cap - 1)`` in place."""
        xo, k_new, v_new = ops.decode_layer_step(
            x[:, 0], self._megakernel_weights(), k_layer, v_layer, lengths,
            k_scale, v_scale, quantize=self.attn.qkv_proj.quantize,
            eps=self.ln_1.epsilon)
        write_kv(k_layer, v_layer, k_scale, v_scale,
                  _decode_at(lengths, k_layer.shape[1]), k_new, v_new)
        return xo[:, None]

    def forward_decode_paged_fused(self, x, k_pool, v_pool, tables, lengths,
                                   k_scale=None, v_scale=None):
        """``forward_decode_paged`` as one fused op, then the new k/v
        written through the block table as ``forward_decode_paged``
        writes them."""
        xo, k_new, v_new = ops.decode_layer_step_paged(
            x[:, 0], self._megakernel_weights(), k_pool, v_pool, tables,
            lengths, k_scale, v_scale, quantize=self.attn.qkv_proj.quantize,
            eps=self.ln_1.epsilon)
        write_kv(k_pool, v_pool, k_scale, v_scale,
                  _paged_decode_at(tables, lengths, k_pool.shape[1]),
                  k_new, v_new)
        return xo[:, None]


class GPTModel(nn.Module):
    """Embeddings + N blocks + final norm; returns hidden states."""

    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.cfg = config
        init = I.Normal(0.0, config.initializer_range)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, init, **kw)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size,
                             weight_attr=init, **kw)
        self.drop = Dropout(p=config.dropout)
        self.blocks = nn.ModuleList(
            [GPTBlock(config, i, **kw) for i in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon,
                              device=device, dtype=dtype)
        self._recompute = False
        self._recompute_policy = None

    def enable_recompute(self, policy=None):
        """Recompute every block in the backward when training
        (``torch.utils.checkpoint``), keeping what ``policy`` names
        (``distributed.recompute.POLICIES``; ``None`` is full recompute,
        an unknown name raises ``ValueError``).  Parameter names are
        unchanged."""
        checkpoint_policy(policy)
        self._recompute = True
        self._recompute_policy = policy
        return self

    def enable_quantize(self, mode: Optional[str] = "int8"):
        """The ``strategy.qat`` hook: route every block linear (qkv, out,
        up, down) through ``ops.fake_quant_matmul`` after construction;
        ``None`` restores the unquantized products.  Parameters, their
        names and dtypes are untouched."""
        if mode is not None:
            _check_mode(mode)
            if self.cfg.moe_num_experts > 0:
                raise NotImplementedError(
                    "enable_quantize on a MoE model is not supported: "
                    "expert FFN matmuls have no quantized COMPUTE path "
                    "yet (see GPTConfig.quantize). Quantized KV caches "
                    "are orthogonal and do work — pass kv_dtype='int8' "
                    "or 'fp8' "
                    "to InferenceEngine/init_kv_cache instead")
        self.cfg = replace(self.cfg, quantize=mode)
        for blk in self.blocks:
            lins = [blk.attn.qkv_proj, blk.attn.out_proj]
            if not blk.is_moe:
                lins += [blk.mlp.up_proj, blk.mlp.down_proj]
            for lin in lins:
                lin.quantize = mode
        return self

    def enable_decode_megakernel(self, flag: bool = True):
        """Run every serving decode step through the fused per-layer op
        (``ops.decode_layer_step(_paged)``); parameters and caches are
        untouched, so flipping the flag back restores the composed
        step."""
        self.cfg = replace(self.cfg, decode_megakernel=bool(flag))
        return self

    def _megakernel_active(self) -> bool:
        """The fused decode step runs: the knob is armed (config or
        ``PADDLE_TPU_DECODE_MEGAKERNEL``), the model is dense (MoE blocks
        keep the composed step), no dropout is live, and every block
        carries its biases."""
        cfg = self.cfg
        if not megakernel_enabled(cfg):
            return False
        if cfg.moe_num_experts > 0:
            return False
        if self.training and (cfg.dropout > 0 or cfg.attn_dropout > 0):
            return False
        return all(blk._megakernel_ok() for blk in self.blocks)

    def _embed(self, ids, pos):
        return self.drop(self.wte(ids) + self.wpe(pos))

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self._embed(input_ids, pos)
        for blk in self.blocks:
            x = recompute(blk, x, policy=self._recompute_policy) \
                if self._recompute and self.training else blk(x)
        return self.ln_f(x)

    # ---- serving path: static KV cache --------------------------------
    def init_kv_cache(self, batch_slots: int, capacity: Optional[int] = None,
                      kv_dtype: Optional[str] = None) -> StaticKVCache:
        """Zeroed cache ``[layers, batch_slots, capacity, Hkv, D]``
        (capacity defaults to max_seq_len) in the embedding's dtype.
        ``kv_dtype='int8'`` or ``'fp8'`` (default from
        ``PADDLE_TPU_KV_DTYPE``) stores int8 or e4m3 codes plus
        per-(position, head) f32 scales."""
        cfg = self.cfg
        cap = int(capacity or cfg.max_seq_len)
        w = self.wte.weight
        k, v, k_scale, v_scale = kv_zeros(
            (cfg.num_layers, int(batch_slots), cap, cfg.num_kv_heads,
             cfg.head_dim), resolve_kv_quant(kv_dtype), w.dtype, w.device)
        return StaticKVCache(
            k, v,
            torch.zeros(int(batch_slots), dtype=torch.int32, device=w.device),
            k_scale, v_scale)

    @torch.no_grad()
    def forward_prefill(self, input_ids, cache: StaticKVCache, slot: int,
                        prompt_len: int):
        """Prefill ONE slot: causal forward over the (possibly bucket-
        padded) prompt ``input_ids [1, s]``, every layer's k/v written at
        ``(layer, slot, 0:s)`` and ``lengths[slot] = prompt_len``.  The
        padding's k/v lie past the recorded length, so no later decode
        step reads them.  A quantized cache stores int8 or e4m3 codes;
        attention ran on the full-precision k/v.  Returns hidden ``[1, s,
        hidden]``."""
        s = input_ids.shape[1]
        if s > cache.capacity:
            raise ValueError(f"prefill of {s} tokens exceeds the cache "
                             f"capacity {cache.capacity}")
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self._embed(input_ids, pos)
        for i, blk in enumerate(self.blocks):
            x, k, v = blk.forward_prefill(x)
            write_kv(cache.k[i, slot], cache.v[i, slot],
                      cache.k_scale[i, slot] if cache.quantized else None,
                      cache.v_scale[i, slot] if cache.quantized else None,
                      slice(0, s), k[0], v[0])
        cache.lengths[slot] = int(prompt_len)
        return self.ln_f(x)

    def _layer_scales(self, cache, i):
        if not cache.quantized:
            return None, None
        return cache.k_scale[i], cache.v_scale[i]

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
        fused = self._megakernel_active()
        for i, blk in enumerate(self.blocks):
            step = blk.forward_decode_fused if fused else blk.forward_decode
            x = step(x, cache.k[i], cache.v[i], cache.lengths,
                     *self._layer_scales(cache, i))
        cache.lengths.copy_(torch.clamp(
            cache.lengths + active.to(torch.int32), max=cache.capacity))
        return self.ln_f(x)

    def _window_positions(self, tokens, lengths):
        """Embeddings of ``tokens [B, W]`` at positions ``lengths[b] + i``
        (clamped at ``max_seq_len - 1``)."""
        w = tokens.shape[1]
        pos = torch.clamp(lengths[:, None].long()
                          + torch.arange(w, device=tokens.device)[None, :],
                          max=self.cfg.max_seq_len - 1)
        return self._embed(tokens, pos)

    def _forward_window(self, tokens, cache: StaticKVCache, lengths):
        x = self._window_positions(tokens, lengths)
        for i, blk in enumerate(self.blocks):
            x = blk.forward_verify(x, cache.k[i], cache.v[i], lengths,
                                   *self._layer_scales(cache, i))
        return self.ln_f(x)

    @torch.no_grad()
    def forward_verify(self, tokens, cache: StaticKVCache):
        """W-token window step for every slot (the spec-decode verify and
        draft catch-up): ``tokens [B, W]`` are W consecutive new tokens
        per slot from ``cache.lengths[b]`` on; their k/v are written and
        query i attends ``j <= lengths[b] + i``.  Lengths stay UNCHANGED:
        the caller advances them by what it commits.  Window positions
        past the committed count hold masked garbage above the length.
        Returns hidden ``[B, W, hidden]``."""
        return self._forward_window(tokens, cache, cache.lengths)

    @torch.no_grad()
    def forward_prefill_chunk(self, tokens, cache: StaticKVCache, lengths,
                              advance):
        """Chunked-prefill step for every slot over the dense cache:
        ``tokens [B, C]`` carry the next prompt tokens of each
        still-prefilling slot, written and attended as in
        ``forward_verify`` from the scheduler's host ``lengths [B]``
        int32 (not ``cache.lengths``, which a retired slot may leave
        stale); then ``cache.lengths = min(lengths + advance, capacity)``
        with ``advance [B]`` int32 (0 for slots outside the chunk).  Rows
        past a slot's advance write masked garbage above its new length.
        Returns hidden ``[B, C, hidden]``."""
        h = self._forward_window(tokens, cache, lengths)
        cache.lengths.copy_(torch.clamp(lengths + advance.to(torch.int32),
                                        max=cache.capacity))
        return h

    # ---- serving path: paged KV cache ---------------------------------
    @torch.no_grad()
    def forward_prefill_paged(self, input_ids, cache, table_row,
                              prefix_len: int):
        """Prefill ONE slot over a PAGED cache: ``input_ids [1, s]`` is
        the (bucket-padded) divergent suffix, tokens ``prefix_len``
        onward of the prompt; ``table_row [MB]`` int32 maps the slot's
        positions to pool blocks (cached prefix blocks, fresh blocks for
        the suffix, null block 0 beyond).  Per layer: read the prefix's
        k/v through the table (dequantized into f32 from an int8 or e4m3
        pool), attend, and write the s new k/v at positions ``prefix_len
        + i`` in place (quantized on a quantized pool).  Returns hidden
        ``[1, s, hidden]``."""
        cfg = self.cfg
        s = input_ids.shape[1]
        bs, mb = cache.block_size, table_row.shape[0]
        p0 = int(prefix_len)
        if p0 + s > mb * bs:
            raise ValueError(f"prefix {p0} + {s} tokens exceed the slot's "
                             f"{mb} blocks of {bs}")
        dev = input_ids.device
        t_new = p0 + torch.arange(s, device=dev)
        x = self._embed(input_ids,
                        torch.clamp(t_new, max=cfg.max_seq_len - 1)[None])
        tbl = table_row.long()
        new_at = (tbl[t_new // bs], t_new % bs)
        t_old = torch.arange(p0, device=dev)
        old_at = (tbl[t_old // bs], t_old % bs)
        for i, blk in enumerate(self.blocks):
            ks_i, vs_i = self._layer_scales(cache, i)
            k_prefix = v_prefix = None
            if p0:
                k_prefix, v_prefix = cache.k[i][old_at], cache.v[i][old_at]
                if ks_i is not None:
                    # f32, as JAX's working buffer: its requantization of
                    # the prefix is then exact, and the attention casts
                    # to q's dtype
                    k_prefix = dequantize_kv(k_prefix, ks_i[old_at])
                    v_prefix = dequantize_kv(v_prefix, vs_i[old_at])
            x, k, v = blk.forward_prefill_paged(x, k_prefix, v_prefix)
            write_kv(cache.k[i], cache.v[i], ks_i, vs_i, new_at, k[0], v[0])
        return self.ln_f(x)

    @torch.no_grad()
    def forward_decode_paged(self, tokens, cache, tables, lengths):
        """One decode step for every slot over the PAGED cache: append
        ``tokens [B]`` at each slot's ``lengths[b]`` through its block
        table and attend.  Lengths are HOST state of the scheduler with
        the paged layout: they come in as ``[B]`` int32 on the model's
        device and are not advanced here.  Returns hidden
        ``[B, 1, hidden]``."""
        cfg = self.cfg
        b = tables.shape[0]
        pos = torch.clamp(lengths, max=cfg.max_seq_len - 1)
        x = self._embed(tokens.reshape(b, 1), pos.reshape(b, 1))
        fused = self._megakernel_active()
        for i, blk in enumerate(self.blocks):
            step = blk.forward_decode_paged_fused if fused \
                else blk.forward_decode_paged
            x = step(x, cache.k[i], cache.v[i], tables, lengths,
                     *self._layer_scales(cache, i))
        return self.ln_f(x)

    @torch.no_grad()
    def forward_verify_paged(self, tokens, cache, tables, lengths):
        """Paged twin of ``forward_verify``: ``tokens [B, W]`` written
        through the block tables from the host ``lengths [B]`` int32
        (EXCLUDING the window, not advanced here).  Returns hidden
        ``[B, W, hidden]``."""
        x = self._window_positions(tokens, lengths)
        for i, blk in enumerate(self.blocks):
            x = blk.forward_verify_paged(x, cache.k[i], cache.v[i], tables,
                                         lengths,
                                         *self._layer_scales(cache, i))
        return self.ln_f(x)

    def forward_prefill_chunk_paged(self, tokens, cache, tables, lengths,
                                    advance):
        """Paged chunked-prefill step: the paged window step itself; the
        scheduler advances its host lengths (``advance`` is not read).
        Rows outside a slot's extent write into the null block."""
        del advance
        return self.forward_verify_paged(tokens, cache, tables, lengths)


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

    def enable_recompute(self, policy=None):
        self.gpt.enable_recompute(policy)
        return self

    def enable_quantize(self, mode: Optional[str] = "int8"):
        self.gpt.enable_quantize(mode)
        self.cfg = self.gpt.cfg
        return self

    def enable_decode_megakernel(self, flag: bool = True):
        self.gpt.enable_decode_megakernel(flag)
        self.cfg = self.gpt.cfg
        return self

    def forward(self, input_ids):
        """Logits ``[B, S, vocab]`` of a causal forward without cache; in
        training with ``fused_ce`` (tied embeddings) ``(hidden [B, S, H],
        wte.weight [V, H])`` for the criterion's blocked loss."""
        x = self.gpt(input_ids)
        if (self.cfg.fused_ce and self.training
                and self.cfg.tie_word_embeddings):
            return x, self.gpt.wte.weight
        return self._head_logits(x)

    def init_kv_cache(self, batch_slots: int, capacity: Optional[int] = None,
                      kv_dtype: Optional[str] = None) -> StaticKVCache:
        return self.gpt.init_kv_cache(batch_slots, capacity, kv_dtype)

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

    @torch.no_grad()
    def prefill_paged(self, input_ids, cache, table_row, prefix_len: int,
                      suffix_len: int):
        """Paged prefill of one slot; ``input_ids`` is the bucket-padded
        divergent suffix and ``suffix_len`` its real token count.  Returns
        ``(logits [1, V], cache)``: the logits of the last real suffix
        token (the first generated token's distribution)."""
        h = self.gpt.forward_prefill_paged(input_ids, cache, table_row,
                                           prefix_len)
        return self._head_logits(h[:, int(suffix_len) - 1]), cache

    @torch.no_grad()
    def decode_step_paged(self, tokens, cache, tables, lengths):
        """One paged decode step for all slots; returns ``(logits [B, V],
        cache)``."""
        h = self.gpt.forward_decode_paged(tokens, cache, tables, lengths)
        return self._head_logits(h)[:, 0], cache

    @torch.no_grad()
    def verify_step(self, tokens, cache: StaticKVCache):
        """W-token window step for all slots (spec-decode verify, draft
        catch-up); returns ``(logits [B, W, V], cache)``: logits[:, i] is
        the next-token distribution after tokens[:, :i + 1].  Lengths are
        not advanced."""
        return self._head_logits(self.gpt.forward_verify(tokens, cache)), \
            cache

    @torch.no_grad()
    def verify_step_paged(self, tokens, cache, tables, lengths):
        """Paged W-token window step for all slots; returns ``(logits
        [B, W, V], cache)``."""
        h = self.gpt.forward_verify_paged(tokens, cache, tables, lengths)
        return self._head_logits(h), cache

    def _chunk_last_logits(self, h, advance):
        """Logits ``[B, V]`` of each slot's last real chunk token (window
        row ``advance[b] - 1``, row 0 for slots outside the chunk, whose
        logits the scheduler ignores): one head product per tick."""
        idx = torch.clamp(advance.long() - 1, 0, h.shape[1] - 1)
        last = h[torch.arange(h.shape[0], device=h.device), idx]
        return self._head_logits(last)

    @torch.no_grad()
    def prefill_chunk(self, tokens, cache: StaticKVCache, lengths, advance):
        """Chunked-prefill step for all slots (dense cache); returns
        ``(logits [B, V], cache)``: the logits after each slot's last
        real chunk token, the first token's distribution for slots whose
        prompt this chunk completes."""
        h = self.gpt.forward_prefill_chunk(tokens, cache, lengths, advance)
        return self._chunk_last_logits(h, advance), cache

    @torch.no_grad()
    def prefill_chunk_paged(self, tokens, cache, tables, lengths, advance):
        """Paged chunked-prefill step for all slots; returns ``(logits
        [B, V], cache)``."""
        h = self.gpt.forward_prefill_chunk_paged(tokens, cache, tables,
                                                 lengths, advance)
        return self._chunk_last_logits(h, advance), cache

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


class GPTPretrainingCriterion(nn.Module):
    """Shifted-token cross-entropy with an optional loss mask.  ``labels``
    are already shifted (``labels[t] = input_ids[t + 1]``).  Given the
    fused-CE pair ``(hidden, weight)`` the loss runs blockwise over the
    vocab; given logits ``[B, S, V]`` it is the plain cross-entropy."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels, loss_mask=None):
        flat_labels = labels.reshape(-1)
        if isinstance(logits, (tuple, list)) and len(logits) == 2:
            hidden, w = logits
            losses = F.fused_linear_cross_entropy(
                hidden.reshape(-1, hidden.shape[-1]), w, flat_labels,
                reduction="none", ignore_index=self.ignore_index)
        else:
            losses = F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), flat_labels,
                reduction="none", ignore_index=self.ignore_index)
        if loss_mask is not None:
            m = loss_mask.reshape(-1).to(losses.dtype)
            return (losses * m).sum() / m.sum()
        return losses.mean()
