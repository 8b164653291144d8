"""Sequence decoding: beam search, greedy search, gather_tree and the
CRF Viterbi decode (counterpart of ``paddle_tpu/text/decoding.py``).

Plain functions on tensors, on the device of their inputs: the card runs
the search's top-k, parent gather and finished masking as PyTorch ops
over fixed ``[max_len, ...]`` buffers, and ``step_fn`` does the model's
work (``gpt_step_fn``: ``GPTForCausalLM.decode_step``, whose attention is
the decode kernel of the cache's form).  As in the JAX package the
search stops once every beam has finished; the buffers are prefilled
with EOS tokens and identity parents, so the outputs equal the
full-length run.  The Python loop reads ``finished.all()`` back once per
step from the second on; nothing else in the loop reads back.

Where the port differs from the JAX package:
- the per-step top-k is the first K of a stable descending sort of the
  ``[B, K*V]`` totals, which keeps ``lax.top_k``'s order on ties (the
  lower flat index first); ``torch.topk`` promises no order on ties, and
  finished beams make ties routine;
- a ``StaticKVCache`` state is regathered by its named fields (``k``,
  ``v``, ``k_scale``, ``v_scale`` on axis 1, ``lengths`` on axis 0) and
  in place; JAX picks the axis by shape, so a cache whose layer count
  equals B*K gathers the wrong axis there.  Every other state leaf
  (tensors in nested tuples, lists and dicts) follows JAX's shape rule:
  axis 0 if its length is B*K, else axis 1.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.gpt import StaticKVCache

__all__ = ["beam_search", "greedy_search", "gather_tree",
           "viterbi_decode", "gpt_step_fn"]

_NEG = -1e9


def gpt_step_fn(model) -> Callable:
    """step_fn over a ``GPTForCausalLM``: ``step(tokens [N], cache) ->
    (logits [N, V], cache)`` where cache is a ``StaticKVCache`` with N
    slots (``model.init_kv_cache(N)``, optionally prefilled per slot by
    ``model.prefill``).  Every step appends one token per slot, in place.
    Call ``model.eval()`` first so dropout is inert."""
    active = {}

    def step(tokens, cache):
        n = cache.batch_slots
        key = (n, cache.lengths.device)
        if key not in active:
            active[key] = torch.ones(n, dtype=torch.int32,
                                     device=cache.lengths.device)
        return model.decode_step(tokens, cache, active[key])
    return step


def _tree_map(fn, tree):
    """``fn`` over every tensor leaf of nested tuples, lists and dicts; a
    ``StaticKVCache`` is one leaf, ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _tree_leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _state_device(state, device):
    """The device of the first tensor in ``state`` (a cache's ``k``);
    with none, ``device`` (CUDA unless the caller asks for the CPU)."""
    for leaf in _tree_leaves(state):
        if isinstance(leaf, StaticKVCache):
            return leaf.k.device
        if torch.is_tensor(leaf):
            return leaf.device
    return resolve_device(device)


def gather_tree(token_ids, parent_ids) -> torch.Tensor:
    """Backtrack beam parent pointers into full sequences.
    ``token_ids``/``parent_ids``: ``[T, B, K]`` -> ``[T, B, K]`` where
    ``output[:, b, k]`` is the whole sequence feeding beam k at the last
    step."""
    ids = torch.as_tensor(token_ids)
    parents = torch.as_tensor(parent_ids, device=ids.device).long()
    out = torch.empty_like(ids)
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].gather(1, beam)
    return out


def _regather(state, flat_parent, bk: int):
    """Shuffle every state leaf by the beams' parents (``flat_parent``:
    the ``[B*K]`` source rows)."""
    def leaf(a):
        if isinstance(a, StaticKVCache):
            for name in ("k", "v", "k_scale", "v_scale"):
                t = getattr(a, name)
                if t is not None:
                    t.copy_(t.index_select(1, flat_parent))
            a.lengths.copy_(a.lengths.index_select(0, flat_parent))
            return a
        shape = tuple(getattr(a, "shape", ()))
        if len(shape) >= 1 and shape[0] == bk:
            return a.index_select(0, flat_parent)
        if len(shape) >= 2 and shape[1] == bk:
            return a.index_select(1, flat_parent)
        raise ValueError(f"beam_search state leaf {shape} carries no "
                         f"[B*K]={bk} dim on axis 0 or 1")
    return _tree_map(leaf, state)


def beam_search(step_fn: Callable, init_state, batch_size: int,
                beam_size: int, max_len: int, bos_id: int, eos_id: int,
                length_penalty: float = 0.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search.  Returns ``(sequences [B, K, max_len] int32, scores
    [B, K] f32)``, best first.

    ``step_fn(tokens [B*K] int32, state) -> (logits [B*K, V], state)``;
    state leaves carry a leading ``[B*K]`` dim (tile an encoder state K
    times) or are a ``StaticKVCache`` of B*K slots.  ``length_penalty``:
    GNMT alpha, scores divided by ``((5 + len) / 6) ** alpha``.  Runs on
    the device of the state's first tensor (``device`` when it has
    none)."""
    B, K = int(batch_size), int(beam_size)
    dev = _state_device(init_state, device)
    tokens = torch.full((B * K,), bos_id, dtype=torch.int32, device=dev)
    # only beam 0 is live at t = 0, or every beam would decode the same
    cum = torch.tensor([0.0] + [_NEG] * (K - 1), dtype=torch.float32,
                       device=dev).repeat(B, 1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    # unexecuted steps: EOS tokens with identity parents, so gather_tree
    # backtracks through them unchanged
    toks = torch.full((max_len, B, K), eos_id, dtype=torch.int32, device=dev)
    pars = torch.arange(K, dtype=torch.int32, device=dev).repeat(
        max_len, B, 1)
    rows = (torch.arange(B, device=dev) * K)[:, None]
    state, eos_only = init_state, None
    for t in range(max_len):
        # the one host read of a step: stop once every beam has finished
        if t > 0 and finished.all().item():
            break
        logits, state = step_fn(tokens, state)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        if eos_only is None:
            # finished beams emit only EOS, at no cost
            eos_only = torch.full((V,), _NEG, dtype=torch.float32,
                                  device=dev)
            eos_only[eos_id] = 0.0
        logp = torch.where(finished[..., None], eos_only, logp)
        total = (cum[..., None] + logp).view(B, K * V)
        # lax.top_k's order: the lower flat index first on ties
        vals, idx = torch.sort(total, dim=1, descending=True, stable=True)
        cum, idx = vals[:, :K].contiguous(), idx[:, :K]
        parent = idx // V
        token = (idx % V).to(torch.int32)
        finished = finished.gather(1, parent) | (token == eos_id)
        state = _regather(state, (rows + parent).reshape(-1), B * K)
        toks[t] = token
        pars[t] = parent.to(torch.int32)
        tokens = token.reshape(-1)

    seqs = gather_tree(toks, pars).permute(1, 2, 0)      # [B, K, T]
    # the length penalty at the final ranking
    is_eos = seqs == eos_id
    lengths = torch.clamp(is_eos.int().argmax(dim=2) + 1,
                          max=max_len).float()
    lengths = torch.where(is_eos.any(dim=2), lengths,
                          torch.full_like(lengths, float(max_len)))
    scores = cum / ((5.0 + lengths) / 6.0) ** length_penalty
    order = torch.argsort(-scores, dim=1, stable=True)
    seqs = seqs.gather(1, order[..., None].expand_as(seqs)).contiguous()
    return seqs, scores.gather(1, order)


def greedy_search(step_fn: Callable, init_state, batch_size: int,
                  max_len: int, bos_id: int, eos_id: int,
                  device=None) -> torch.Tensor:
    """Greedy argmax decode with the EOS early exit; returns ``[B,
    max_len]`` int32 (EOS after a row finishes)."""
    B = int(batch_size)
    dev = _state_device(init_state, device)
    tokens = torch.full((B,), bos_id, dtype=torch.int32, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = torch.full((max_len, B), eos_id, dtype=torch.int32, device=dev)
    state = init_state
    for t in range(max_len):
        if t > 0 and finished.all().item():
            break
        logits, state = step_fn(tokens, state)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(finished, eos_id, nxt)
        finished = finished | (nxt == eos_id)
        out[t] = nxt
        tokens = nxt
    return out.t().contiguous()


def viterbi_decode(potentials, transition, lengths=None,
                   include_bos_eos_tag: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CRF Viterbi decode: emission ``potentials [B, T, N]`` and
    ``transition [N, N]`` -> ``(scores [B] f32, paths [B, T] int32)``.
    Rows past ``lengths`` keep their last tag.  ``include_bos_eos_tag``:
    tag N-2 is BOS (its transition row starts each path) and tag N-1 is
    EOS (its transition column ends it)."""
    em = torch.as_tensor(potentials).float()
    tr = torch.as_tensor(transition, device=em.device).float()
    b, t, n = em.shape
    if lengths is None:
        ln = torch.full((b,), t, dtype=torch.int32, device=em.device)
    else:
        ln = torch.as_tensor(lengths, device=em.device).to(torch.int32)
    if include_bos_eos_tag:
        start, stop = tr[n - 2], tr[:, n - 1]
    else:
        start = stop = torch.zeros(n, dtype=torch.float32, device=em.device)
    alpha = em[:, 0] + start[None, :]
    bps = []
    for i in range(1, t):
        # the score of reaching tag j from tag k: [B, from, to]
        cand = alpha[:, :, None] + tr[None, :, :]
        best = cand.amax(dim=1) + em[:, i]
        bps.append(cand.argmax(dim=1))
        alpha = torch.where((i < ln)[:, None], best, alpha)
    final = alpha + stop[None, :]
    scores = final.amax(dim=1)
    tag = final.argmax(dim=1)
    path = [None] * t
    for i in range(t - 2, -1, -1):
        path[i + 1] = tag
        prev = bps[i].gather(1, tag[:, None])[:, 0]
        # positions at and after the row's end keep the frozen tag
        tag = torch.where(i + 1 < ln, prev, tag)
    path[0] = tag
    return scores, torch.stack(path, dim=1).to(torch.int32)
