"""Text helpers (counterpart of ``paddle_tpu/text``): the padding and
masking utilities, the datasets (local files or synthetic samples; no
downloads) and the decoding API."""
from .datasets import (Conll05st, Imdb, Imikolov, Movielens, UCIHousing,
                       WMT14, WMT16)
from .decoding import (beam_search, gather_tree, gpt_step_fn,
                       greedy_search, viterbi_decode)
from .utils import (causal_mask, pad_sequences, padding_attn_mask,
                    sequence_mask, shift_tokens_right, truncate_sequences)

__all__ = [
    "sequence_mask", "pad_sequences", "truncate_sequences",
    "shift_tokens_right", "causal_mask", "padding_attn_mask",
    "UCIHousing", "Imdb", "Imikolov", "Movielens", "WMT14", "WMT16",
    "Conll05st", "beam_search", "greedy_search", "gather_tree",
    "gpt_step_fn", "viterbi_decode",
]
