"""Analytic cost of the engine's and the trainer's step kinds, from the
model config (the port's stand-in for XLA's cost and memory analyses,
read by ``exec_registry.analyze``).

flops are model flops: every matmul of the step (the block linears, the
tied LM head) and attention over the full Sq x Sk square whether causal
or not, the convention of ``GPTConfig.flops_per_token`` and of torch's
SDPA flop formula.  A training step is three forwards (the backward two
products for each of the forward's), with no recompute counted, as in
MFU.  ``profiler.cost_stats`` over the plain path on the CPU counts the
same products plus what the plain versions recompute or pad: the flash
backward's recomputed QK^T (2 B H S^2 D a layer) and, in a decode step,
attention over the whole ``max_seq_len`` cache where the kernels read
each slot's length (``tests/test_torch_autotune.py`` holds the two
to each other exactly under these terms).

bytes follow XLA's per-op convention (each op reads its operands and
writes its result, nothing fused), as ``profiler.cost_stats`` counts
them:

- a training step: ``TRAIN_PARAM_BYTES`` a parameter (the bf16 copies
  of the f32 masters, the gradients and the optimizer's eager passes)
  and, a token, ``TRAIN_ACT_BYTES`` for each layer and unit of width,
  ``TRAIN_VOCAB_BYTES`` for each vocabulary entry and
  ``TRAIN_EMBED_BYTES`` for each unit of width outside the layers.
  The constants were counted by ``profiler.cost_stats`` over the port's
  bf16-AMP Adam step on the CPU at widths 64-128, depth 2-4, vocabulary
  256-1024 and 2-128 tokens of sequences of 2, where attention moves
  its operands once a token, as rows 1-3 do (no square is stored);
- a serving step (kernel-level, as the kernels and the library products
  run it): the weights once, each slot's K/V rows read once (the length
  it holds), the new K/V rows written once, and ``SERVE_ACT_BYTES`` a
  token, layer and unit of width (a third of training's: the forward's
  share of its passes).

Memory: argument bytes (weights, optimizer state, the cache, the
batch), output bytes (logits or the loss) and temp bytes (training: the
activations kept for the backward, ``34 h`` bytes a token and layer in
16-bit, Korthikanti et al.'s count without the attention square that
rows 1-3 never store).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["gpt_step_cost", "TRAIN_PARAM_BYTES", "TRAIN_ACT_BYTES",
           "TRAIN_VOCAB_BYTES", "TRAIN_EMBED_BYTES", "SERVE_ACT_BYTES"]

TRAIN_PARAM_BYTES = 136
TRAIN_ACT_BYTES = 1115
TRAIN_VOCAB_BYTES = 100
TRAIN_EMBED_BYTES = 70
SERVE_ACT_BYTES = TRAIN_ACT_BYTES // 3


def _layer_weights(cfg, moe_layer: bool) -> int:
    """Matmul weights one token meets in a layer (MoE: top_k experts and
    the router)."""
    h, f = cfg.hidden_size, cfg.ffn_hidden_size
    kv = cfg.num_kv_heads * (h // cfg.num_heads)
    attn = h * (h + 2 * kv) + h * h
    mlp = 2 * h * f
    if moe_layer:
        return attn + cfg.moe_top_k * mlp + h * cfg.moe_num_experts
    return attn + mlp


def _matmul_weights(cfg) -> int:
    is_moe = getattr(cfg, "is_moe_layer", None)
    return sum(_layer_weights(cfg, bool(is_moe and cfg.moe_num_experts > 0
                                        and is_moe(i)))
               for i in range(cfg.num_layers))


def _param_count(cfg) -> int:
    """Every parameter (embeddings, every expert, biases, norms)."""
    h, f, v = cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size
    kv = cfg.num_kv_heads * (h // cfg.num_heads)
    attn = h * (h + 2 * kv) + (h + 2 * kv) + h * h + h + 4 * h
    mlp = 2 * h * f + f + h
    n = v * h + cfg.max_seq_len * h + 2 * h
    is_moe = getattr(cfg, "is_moe_layer", None)
    for i in range(cfg.num_layers):
        moe = bool(is_moe and cfg.moe_num_experts > 0 and is_moe(i))
        n += attn + (cfg.moe_num_experts * mlp + h * cfg.moe_num_experts
                     if moe else mlp)
    return n


def _forward_flops(cfg, tokens: int, keys: float, head_rows: int) -> float:
    """Products of a forward over ``tokens`` tokens that each attend to
    ``keys`` keys (a mean, full square), the head over ``head_rows``."""
    h, L = cfg.hidden_size, cfg.num_layers
    return (2.0 * tokens * _matmul_weights(cfg)
            + 4.0 * h * L * tokens * keys
            + 2.0 * head_rows * cfg.vocab_size * h)


def gpt_step_cost(cfg, kind: str, *, batch: int = 1, seq: int = 0,
                  context: float = 0.0, window: int = 1,
                  weight_itemsize: int = 2, kv_itemsize: int = 2,
                  kv_scales: bool = False) -> Optional[dict]:
    """``{"flops", "bytes_accessed", "argument_bytes", "output_bytes",
    "temp_bytes", "peak_bytes"}`` of one step of ``kind`` (None for a
    kind with no model):

    - ``train_step``: ``batch`` sequences of ``seq`` tokens;
    - ``prefill``: one sequence of ``seq`` tokens (the bucket), logits at
      one position;
    - ``decode`` / ``megakernel_decode``: ``batch`` live slots holding
      ``context`` tokens on average, one new token each;
    - ``spec_verify``: ``batch`` slots verifying ``window`` tokens each;
    - ``sample``: a sampler over ``batch`` rows of logits.
    """
    h, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    kv = cfg.num_kv_heads * (h // cfg.num_heads)
    n_params = _param_count(cfg)
    # K/V bytes of one token across the layers (scales: f32 a head)
    kv_row = 2 * L * (kv * kv_itemsize +
                      (4 * cfg.num_kv_heads if kv_scales else 0))
    if kind == "train_step":
        t = batch * seq
        flops = 3.0 * _forward_flops(cfg, t, seq, t)
        nbytes = (TRAIN_PARAM_BYTES * n_params +
                  t * (TRAIN_ACT_BYTES * L * h + TRAIN_VOCAB_BYTES * V +
                       TRAIN_EMBED_BYTES * h))
        args = n_params * 4 * 3 + t * 8          # masters, Adam's moments
        out = 4
        temp = 34 * h * L * t
    elif kind in ("prefill", "decode", "megakernel_decode", "spec_verify"):
        weights = weight_itemsize * n_params
        if kind == "prefill":
            rows, keys, new, read_ctx, head = seq, seq, seq, 0.0, 1
        elif kind == "spec_verify":
            rows = batch * window
            keys = context + window
            new, read_ctx, head = rows, batch * context, rows
        else:
            rows, keys, new, head = batch, context + 1, batch, batch
            read_ctx = batch * context
        flops = _forward_flops(cfg, rows, keys, head)
        nbytes = (weights + kv_row * (read_ctx + new) +
                  SERVE_ACT_BYTES * L * h * rows + 4 * head * V)
        args = weights + kv_row * (read_ctx + new)
        out = 4 * head * V
        temp = 0
    elif kind == "sample":
        flops = 0.0
        nbytes = 2 * 4 * batch * V
        args, out, temp = 4 * batch * V, 8 * batch, 0
    else:
        return None
    return {"flops": float(flops), "bytes_accessed": float(nbytes),
            "argument_bytes": int(args), "output_bytes": int(out),
            "temp_bytes": int(temp), "alias_bytes": 0,
            "peak_bytes": int(args + out + temp)}
