"""Kernel ops of the ported paths: each a hand-written CUDA kernel for
Hopper with its plain PyTorch version beside it (see ``_build``), the
fused cross-entropy (plain products, no kernel of its own), the int8 and
e4m3 matmul and the KV quantization helpers."""
from ._philox import KEEP_BITS, PHILOX_WORDS
from .decode_attention import (DECODE_ATTENTION, DECODE_ATTENTION_F8,
                               DECODE_ATTENTION_Q, PAGED_DECODE_ATTENTION,
                               PAGED_DECODE_ATTENTION_F8,
                               PAGED_DECODE_ATTENTION_Q,
                               PAGED_WINDOW_ATTENTION,
                               PAGED_WINDOW_ATTENTION_F8,
                               PAGED_WINDOW_ATTENTION_Q, WINDOW_ATTENTION,
                               WINDOW_ATTENTION_F8, WINDOW_ATTENTION_Q,
                               chunk_prefill_attention,
                               decode_attention, decode_attention_window,
                               paged_chunk_prefill_attention,
                               paged_decode_attention,
                               paged_decode_attention_window)
from .flash_attention import (FLASH_BWD_DKV, FLASH_BWD_DKV_DROPOUT,
                              FLASH_BWD_DQ, FLASH_BWD_DQ_DROPOUT, FLASH_FWD,
                              FLASH_FWD_DROPOUT, flash_attention,
                              flash_attention_fwd)
from .fused_cross_entropy import fused_linear_cross_entropy, pick_vocab_block
from .decode_megakernel import (DECODE_MEGAKERNEL, DECODE_MEGAKERNEL_Q,
                                PAGED_DECODE_MEGAKERNEL,
                                PAGED_DECODE_MEGAKERNEL_Q, decode_layer_step,
                                decode_layer_step_paged)
from .quantized_matmul import (QUANTIZED_MATMUL, QUANTIZED_MATMUL_F8,
                               dequantize_kv,
                               fake_quant_matmul, quantize_kv,
                               quantized_matmul)

__all__ = ["decode_attention", "paged_decode_attention",
           "decode_attention_window", "paged_decode_attention_window",
           "chunk_prefill_attention", "paged_chunk_prefill_attention",
           "flash_attention",
           "flash_attention_fwd", "fused_linear_cross_entropy",
           "pick_vocab_block", "quantize_kv", "dequantize_kv",
           "quantized_matmul", "fake_quant_matmul", "decode_layer_step",
           "decode_layer_step_paged", "QUANTIZED_MATMUL", "DECODE_MEGAKERNEL",
           "DECODE_MEGAKERNEL_Q", "PAGED_DECODE_MEGAKERNEL",
           "PAGED_DECODE_MEGAKERNEL_Q",
           "DECODE_ATTENTION", "DECODE_ATTENTION_Q", "PAGED_DECODE_ATTENTION",
           "PAGED_DECODE_ATTENTION_Q", "WINDOW_ATTENTION",
           "WINDOW_ATTENTION_Q", "PAGED_WINDOW_ATTENTION",
           "PAGED_WINDOW_ATTENTION_Q", "DECODE_ATTENTION_F8",
           "PAGED_DECODE_ATTENTION_F8", "WINDOW_ATTENTION_F8",
           "PAGED_WINDOW_ATTENTION_F8", "QUANTIZED_MATMUL_F8",
           "FLASH_FWD", "FLASH_BWD_DQ",
           "FLASH_BWD_DKV", "FLASH_FWD_DROPOUT", "FLASH_BWD_DQ_DROPOUT",
           "FLASH_BWD_DKV_DROPOUT", "PHILOX_WORDS", "KEEP_BITS", "KERNELS",
           "LAUNCHERS"]

# every kernel of the package by source file, for builds and launch counts
KERNELS = {"flash_fwd.cu": FLASH_FWD, "flash_bwd_dq.cu": FLASH_BWD_DQ,
           "flash_bwd_dkv.cu": FLASH_BWD_DKV,
           "decode_attention.cu": DECODE_ATTENTION,
           "decode_attention_q.cu": DECODE_ATTENTION_Q,
           "paged_decode_attention.cu": PAGED_DECODE_ATTENTION,
           "paged_decode_attention_q.cu": PAGED_DECODE_ATTENTION_Q,
           "window_attention.cu": WINDOW_ATTENTION,
           "window_attention_q.cu": WINDOW_ATTENTION_Q,
           "paged_window_attention.cu": PAGED_WINDOW_ATTENTION,
           "paged_window_attention_q.cu": PAGED_WINDOW_ATTENTION_Q,
           "quantized_matmul.cu": QUANTIZED_MATMUL,
           "decode_attention_f8.cu": DECODE_ATTENTION_F8,
           "paged_decode_attention_f8.cu": PAGED_DECODE_ATTENTION_F8,
           "window_attention_f8.cu": WINDOW_ATTENTION_F8,
           "paged_window_attention_f8.cu": PAGED_WINDOW_ATTENTION_F8,
           "quantized_matmul_f8.cu": QUANTIZED_MATMUL_F8,
           "decode_megakernel.cu": DECODE_MEGAKERNEL,
           "decode_megakernel_q.cu": DECODE_MEGAKERNEL_Q,
           "paged_decode_megakernel.cu": PAGED_DECODE_MEGAKERNEL,
           "paged_decode_megakernel_q.cu": PAGED_DECODE_MEGAKERNEL_Q,
           "philox_check.cu": KEEP_BITS}

# every C entry point by symbol, for launch counts: a source's kernel in
# KERNELS, the flash kernels' dropout forms beside it, the check entries
LAUNCHERS = {k.symbol: k for k in (*KERNELS.values(), FLASH_FWD_DROPOUT,
                                   FLASH_BWD_DQ_DROPOUT,
                                   FLASH_BWD_DKV_DROPOUT, PHILOX_WORDS)}
