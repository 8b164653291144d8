"""Text helpers (counterpart of ``paddle_tpu/text``): the padding and
masking utilities and the decoding API.  The datasets are not ported
(they need downloads; see ROADMAP.md)."""
from .decoding import (beam_search, gather_tree, gpt_step_fn,
                       greedy_search, viterbi_decode)
from .utils import (causal_mask, pad_sequences, padding_attn_mask,
                    sequence_mask, shift_tokens_right, truncate_sequences)

__all__ = [
    "sequence_mask", "pad_sequences", "truncate_sequences",
    "shift_tokens_right", "causal_mask", "padding_attn_mask",
    "beam_search", "greedy_search", "gather_tree", "gpt_step_fn",
    "viterbi_decode",
]
