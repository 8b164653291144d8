"""Speculative decoding: a small draft GPT proposes, the target verifies
(counterpart of ``paddle_tpu/inference/spec_decode.py``; Leviathan et
al., *Fast Inference from Transformers via Speculative Decoding*).

Per tick, for every live slot:

1. draft catch-up: the committed tokens the draft has not processed yet
   (1 or 2) ride in as a fixed ``[B, K+1]`` window through the draft's
   ``verify_step``, and its last real logit row proposes draft token 1;
2. propose: K-1 single-token draft decode steps propose the rest;
3. verify: the target runs ONE window step over ``[last committed, d_1
   .. d_K]``, writing all K+1 k/v into its cache (dense or paged, fp,
   int8 or fp8);
4. accept: greedy slots keep the longest prefix with ``d_i == argmax
   p_{i-1}`` plus one target token, so the stream is token-identical to
   the non-speculative engine; sampled slots run the rejection rule over
   the warped (temperature, top-k, top-p) distributions and resample the
   first rejected position from ``norm(max(p - q, 0))``.

The tick ends in ONE device-to-host copy: ``[B, K+2]`` (K+1 committed
stream tokens and the committed count per slot).  The draft rides a dense
``StaticKVCache`` whose lengths stay on the device, advanced and rolled
back in place; the host's catch-up window (``win``/``nprev``) reaches the
card through pinned staging tensors without a sync (the previous tick's
sync has finished the previous copy before the host writes again).
Random draws come from the engine's ``torch.Generator``: proposals and
the residual by the engine sampler's exponential race, the acceptance
``u`` by ``torch.rand``.  Rejected window positions hold garbage above
each cache's advanced length, the masked-garbage convention of every
decode path.

A tick writes its whole K+1 window before knowing how much commits, so a
stream retires once ``len + K + 1`` would pass ``max_seq_len``
(``stats()['spec_capacity_retirements']``), up to K tokens before a
non-speculative engine would.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch

from ..device import same_device

__all__ = ["SpecDecoder", "resolve_spec_k"]


def resolve_spec_k(spec_k: Optional[int]) -> int:
    """Draft window size: the explicit argument, else
    ``PADDLE_TPU_SPEC_K``, else 0 (off), as the JAX package resolves
    it."""
    if spec_k is not None:
        return int(spec_k)
    return int(os.environ.get("PADDLE_TPU_SPEC_K", 0) or 0)


class SpecDecoder:
    """The engine's speculative half: owns the draft model and its dense
    KV cache and replaces the one-token decode step with the K+1-token
    tick.  The engine stays the scheduler (admission, retirement,
    preemption, block accounting)."""

    def __init__(self, engine, draft_model, k: int):
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        dcfg = draft_model.cfg
        tcfg = engine.model.cfg
        if dcfg.vocab_size != tcfg.vocab_size:
            raise ValueError(f"draft vocab {dcfg.vocab_size} != target vocab "
                             f"{tcfg.vocab_size}")
        if dcfg.max_seq_len < engine.max_seq_len:
            raise ValueError(f"draft max_seq_len {dcfg.max_seq_len} < engine "
                             f"max_seq_len {engine.max_seq_len}: the draft "
                             f"must reach every position the target serves")
        if not same_device(draft_model.device, engine.device):
            raise ValueError(f"draft model is on {draft_model.device}, engine "
                             f"on {engine.device}")
        draft_model.eval()
        self.engine = engine
        self.k = int(k)
        self.draft = draft_model
        b, dev = engine.batch_slots, engine.device
        self.draft_cache = draft_model.init_kv_cache(b, engine.max_seq_len)
        # per-slot catch-up window: committed tokens the draft has not
        # seen (1 after an admission, up to 2 mid-stream)
        pin = dev.type == "cuda"
        self._h_win = torch.zeros((b, self.k + 1), dtype=torch.int64,
                                  pin_memory=pin)
        self._h_nprev = torch.ones(b, dtype=torch.int64, pin_memory=pin)
        self.win = self._h_win.numpy()
        self.nprev = self._h_nprev.numpy()
        self._d_win = torch.zeros((b, self.k + 1), dtype=torch.int64,
                                  device=dev)
        self._d_nprev = torch.ones(b, dtype=torch.int64, device=dev)

    # ---- sampling ------------------------------------------------------
    def _warped_probs(self, logits, temps, top_ps):
        """The engine sampler's warping (temperature, static top-k,
        per-row top-p) as probabilities ``[N, V]`` in token order: the p
        and q the rejection rule compares are the distributions actually
        sampled from."""
        logits = logits.float()
        v = logits.shape[-1]
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        top_k = self.engine.top_k
        if top_k and top_k < v:
            kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30),
                                 scaled)
        s_logits, sort_idx = torch.sort(scaled, dim=-1, descending=True,
                                        stable=True)
        probs = torch.softmax(s_logits, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        s_logits = torch.where(csum - probs < top_ps[:, None], s_logits,
                               torch.full_like(s_logits, -1e30))
        s_probs = torch.softmax(s_logits, dim=-1)
        return torch.empty_like(s_probs).scatter_(-1, sort_idx, s_probs)

    def _draw(self, probs):
        """One index per row with probability ``probs[i] / sum(probs)``:
        the exponential race ``argmax(p / E)``, E ~ Exp(1)."""
        e = torch.empty_like(probs).exponential_(generator=self.engine._gen)
        return torch.argmax(probs / e, dim=-1)

    def _propose_from(self, logits, temps, top_ps):
        """One proposal per slot from the draft's logit row: argmax for
        greedy slots, a draw from the warped q for sampled ones.  Returns
        ``(token [B] int64, q [B, V])``."""
        q = self._warped_probs(logits, temps, top_ps)
        greedy = torch.argmax(logits.float(), dim=-1)
        return torch.where(temps > 0, self._draw(q), greedy), q

    def _draft_propose(self, active, temps, top_ps):
        """Catch-up window and K-1 single-token steps: K proposals
        ``[B, K]`` and their distributions ``[B, K, V]``, the draft cache
        advanced past everything it processed (rolled back later)."""
        cache = self.draft_cache
        logits_d, _ = self.draft.verify_step(self._d_win, cache)
        cache.lengths.add_((self._d_nprev * active).to(torch.int32))
        rows = torch.arange(logits_d.shape[0], device=logits_d.device)
        last = logits_d[rows, torch.clamp(self._d_nprev - 1, min=0)]
        d_prev, q0 = self._propose_from(last, temps, top_ps)
        drafts, qs = [d_prev], [q0]
        for _ in range(self.k - 1):
            lg, _ = self.draft.decode_step(d_prev, cache, active)
            d_prev, qi = self._propose_from(lg, temps, top_ps)
            drafts.append(d_prev)
            qs.append(qi)
        return torch.stack(drafts, dim=1), torch.stack(qs, dim=1)

    def _accept(self, drafts, q, logits_t, active, temps, top_ps):
        """The acceptance rule for greedy and sampled rows at once.
        ``logits_t [B, K+1, V]``: target logits over ``[last committed,
        d_1 .. d_K]``; ``q [B, K, V]``: the warped draft distributions.

        Greedy rows (temp <= 0) accept while ``d_i == argmax p_i``, the
        exact comparison, so their streams equal the non-speculative
        engine's.  Sampled rows accept position i iff ``u_i * q_i(d_i) <
        p_i(d_i)`` and commit the accepted prefix plus one draw from the
        residual ``norm(max(p - q, 0))`` at the first rejection, with
        ``q_K = 0`` so a fully accepted window's bonus is drawn from
        ``p_K``; a zero residual (p == q) draws from p.

        Returns ``(toks [B, K+1], n_acc [B], n_emit [B] = (n_acc + 1) *
        active)``."""
        b, kp1, v = logits_t.shape
        k = self.k
        g = torch.argmax(logits_t.float(), dim=-1)
        match = (drafts == g[:, :k]).to(torch.int64)
        n_acc_g = torch.cumprod(match, dim=1).sum(dim=1)
        p = self._warped_probs(logits_t.reshape(b * kp1, v),
                               temps.repeat_interleave(kp1),
                               top_ps.repeat_interleave(kp1)
                               ).reshape(b, kp1, v)
        u = torch.rand((b, k), generator=self.engine._gen,
                       device=logits_t.device)
        p_d = torch.gather(p[:, :k], 2, drafts[:, :, None])[:, :, 0]
        q_d = torch.gather(q, 2, drafts[:, :, None])[:, :, 0]
        acc_s = (u * q_d < p_d).to(torch.int64)
        n_acc_s = torch.cumprod(acc_s, dim=1).sum(dim=1)
        q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
        res = torch.clamp(p - q_pad, min=0.0)
        rsum = res.sum(dim=-1, keepdim=True)
        res = torch.where(rsum > 0, res / torch.clamp(rsum, min=1e-38), p)
        r_tok = self._draw(res.reshape(b * kp1, v)).reshape(b, kp1)
        pos = torch.arange(kp1, device=logits_t.device)[None, :]
        bonus = torch.gather(r_tok, 1, n_acc_s[:, None])
        d_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        toks_s = torch.where(pos < n_acc_s[:, None], d_pad, bonus)
        sampled = temps > 0
        toks = torch.where(sampled[:, None], toks_s, g)
        n_acc = torch.where(sampled, n_acc_s, n_acc_g)
        return toks, n_acc, (n_acc + 1) * active.to(torch.int64)

    def _draft_rollback(self, n_acc, active):
        """Roll the draft's lengths back over proposals past the accepted
        prefix.  d_K was never fed back, so the overshoot is
        ``max(K - 1 - n_acc, 0)``."""
        over = torch.clamp(self.k - 1 - n_acc, min=0) * active.to(torch.int64)
        self.draft_cache.lengths.sub_(over.to(torch.int32))

    # ---- the tick -------------------------------------------------------
    @torch.no_grad()
    def tick(self, accum_moe: bool = True) -> torch.Tensor:
        """One spec tick over the engine's slots (live ones by the
        engine's device activity mask); returns ``out [B, K+2]`` on the
        device: the K+1 committed-stream tokens and the committed count
        per slot.  Dense targets advance ``cache.lengths`` by that count
        here; paged targets' lengths are the scheduler's host state.  A
        MoE target's verify window adds to the engine's expert stats
        (the draft's calls never do); ``accum_moe=False`` (warmup) leaves
        them out."""
        eng = self.engine
        self._d_win.copy_(self._h_win, non_blocking=True)
        self._d_nprev.copy_(self._h_nprev, non_blocking=True)
        active, temps, top_ps = eng._d_active, eng._d_temps, eng._d_top_ps
        drafts, q = self._draft_propose(active, temps, top_ps)
        t0 = torch.gather(self._d_win, 1,
                          torch.clamp(self._d_nprev - 1, min=0)[:, None])
        window = torch.cat([t0, drafts], dim=1)                  # [B, K+1]
        with eng._expert_stats() if accum_moe else contextlib.nullcontext():
            if eng.kv_layout == "paged":
                eng._stage_paged()
                logits_t, _ = eng.model.verify_step_paged(
                    window, eng.cache, eng._d_tables, eng._d_lens)
            else:
                logits_t, _ = eng.model.verify_step(window, eng.cache)
        toks, n_acc, n_emit = self._accept(drafts, q, logits_t, active, temps,
                                           top_ps)
        if eng.kv_layout != "paged":
            cache = eng.cache
            cache.lengths.copy_(torch.clamp(
                cache.lengths + n_emit.to(torch.int32), max=cache.capacity))
        self._draft_rollback(n_acc, active)
        return torch.cat([toks, n_emit[:, None]], dim=1)

    @torch.no_grad()
    def warmup(self):
        """One draft prefill per engine bucket and one tick with every
        slot inactive before traffic, then both caches' lengths zeroed
        (the paged target's lengths are host state, already 0)."""
        eng = self.engine
        for b in eng.buckets:
            self.draft.prefill(eng._zeros(1, b), self.draft_cache, 0, 1)
        self.tick(accum_moe=False)
        self.draft_cache.lengths.zero_()
        if eng.kv_layout != "paged":
            eng.cache.lengths.zero_()

    # ---- host-side hooks the engine calls -------------------------------
    def on_admit(self, req, slot: int, first_tok: int):
        """``req`` was just prefilled into ``slot`` on the target: prefill
        the draft over the same prompt and seed the catch-up window with
        the first sampled token."""
        eng = self.engine
        prompt = req.effective_prompt()
        bucket = eng._bucket_for(prompt.size)
        self.draft.prefill(eng._ids_on_device(prompt, bucket),
                           self.draft_cache, slot, prompt.size)
        self.win[slot, :] = 0
        self.win[slot, 0] = first_tok
        self.nprev[slot] = 1

    def on_release(self, slot: int):
        """The slot retired or was preempted: neutralize its window (the
        draft cache row is reset by the next admission's prefill)."""
        self.win[slot, :] = 0
        self.nprev[slot] = 1

    def after_commit(self, slot: int, emitted):
        """The scheduler committed ``emitted`` for ``slot``: queue what
        the draft has not processed as the next catch-up window.  The
        draft holds the accepted proposals it fed itself (``min(n_emit -
        1, K - 1)``); it lacks the bonus token and, when everything was
        accepted, the never-fed d_K."""
        in_cache = min(len(emitted) - 1, self.k - 1)
        tail = np.asarray(emitted[in_cache:], np.int64)
        self.win[slot, :] = 0
        self.win[slot, :tail.size] = tail
        self.nprev[slot] = tail.size
