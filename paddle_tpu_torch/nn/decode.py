"""``BeamSearchDecoder`` and ``dynamic_decode`` (counterpart of
``paddle_tpu/nn/decode.py``): the decoder bundles a cell, an embedding
and an output projection, and ``dynamic_decode`` runs
``text.decoding.beam_search`` over it to ``max_step_num`` steps."""
from __future__ import annotations

import torch

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


class BeamSearchDecoder:
    """Beam-search decoding around a cell.

    cell: any callable ``(inputs [N, E], states) -> (outputs [N, H],
      new_states)``.
    embedding_fn: token ids ``[N]`` -> embeddings ``[N, E]`` (required).
    output_fn: cell outputs ``[N, H]`` -> vocab logits ``[N, V]``.
    """

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[B, ...]`` -> ``[B * beam_size, ...]``: each batch row
        repeated ``beam_size`` times."""
        return torch.repeat_interleave(torch.as_tensor(x), int(beam_size),
                                       dim=0)

    def _step_fn(self):
        if self.embedding_fn is None:
            raise ValueError("BeamSearchDecoder needs embedding_fn")

        def step(tokens, state):
            out, new_state = self.cell(self.embedding_fn(tokens), state)
            logits = out if self.output_fn is None else self.output_fn(out)
            return logits, new_state
        return step


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` to ``max_step_num`` steps.

    inits: the initial cell state with a leading batch dim B (tiled to
    B * beam here).  Returns ``(predicted_ids, scores)``: ids ``[B, T,
    beam]`` (``[T, B, beam]`` when ``output_time_major``) int32, best
    beam first, scores ``[B, beam]``; and each beam's length (int64,
    up to and including its first EOS) when ``return_length``."""
    from ..text.decoding import _tree_leaves, _tree_map, beam_search

    if inits is None:
        raise ValueError("dynamic_decode needs the initial cell state")
    K = decoder.beam_size
    state0 = _tree_map(
        lambda t: BeamSearchDecoder.tile_beam_merge_with_batch(t, K), inits)
    B = _tree_leaves(state0)[0].shape[0] // K
    seqs, scores = beam_search(
        decoder._step_fn(), state0, batch_size=B, beam_size=K,
        max_len=int(max_step_num), bos_id=decoder.start_token,
        eos_id=decoder.end_token)
    ids = seqs.permute(0, 2, 1)                          # [B, T, K]
    if output_time_major:
        ids = ids.permute(1, 0, 2)                       # [T, B, K]
    out = (ids.contiguous(), scores)
    if return_length:
        eos_hit = seqs == decoder.end_token
        first = eos_hit.int().argmax(dim=2) + 1
        lengths = torch.where(eos_hit.any(dim=2), first,
                              torch.full_like(first, seqs.shape[2]))
        return out + (lengths.to(torch.int64),)
    return out
