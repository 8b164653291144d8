"""Continuous-batching serving engine on the dense static KV cache
(counterpart of the dense layout of ``paddle_tpu/inference/engine.py``).

Prompts are padded to a prefill bucket and prefilled one slot at a time
(``GPTForCausalLM.prefill``, flash-attention kernel); every step then
decodes one token for all slots at once (``decode_step``, decode-
attention kernel).  Requests are admitted into free slots between decode
steps and retire on EOS, on ``max_new_tokens`` or when the slot's
sequence reaches ``max_seq_len``.  Sampling (greedy, temperature, static
top-k, per-slot top-p) runs on the engine's device with its own
``torch.Generator``, and the sampled ids are the ONE device-to-host copy
of a decode step (``stats()['decode_host_syncs']``).  An admission costs
one more, for its first token.

Left for later slices: the paged layout, prefix cache, quantized KV,
speculative decoding, chunked prefill, deadlines, drain and telemetry.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device, same_device

__all__ = ["InferenceEngine", "Request", "default_prefill_buckets"]


def default_prefill_buckets(max_seq_len: int, lo: int = 16) -> List[int]:
    """Powers of two from ``lo`` below ``max_seq_len``, then
    ``max_seq_len`` itself."""
    bks = []
    b = lo
    while b < max_seq_len:
        bks.append(b)
        b *= 2
    bks.append(max_seq_len)
    return bks


class Request:
    """One in-flight generation request (host-side bookkeeping)."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, eos_id, temperature, top_p):
        self.rid = next(Request._ids)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.generated: List[int] = []
        self.slot: Optional[int] = None


class InferenceEngine:
    """Continuous-batching serving engine for ``GPTForCausalLM``.

    Usage::

        eng = InferenceEngine(model, batch_slots=8)
        rid = eng.add_request(prompt_ids, max_new_tokens=64, eos_id=eos)
        outputs = eng.run()          # {rid: np.int32 generated tokens}

    ``device=None`` means the CUDA device (raises without one); the
    model must live on the engine's device.
    """

    def __init__(self, model, batch_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 top_k: int = 0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        model.eval()
        self.model = model
        cfg = model.cfg
        self.batch_slots = int(batch_slots)
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        if self.max_seq_len > cfg.max_seq_len:
            raise ValueError(f"max_seq_len {self.max_seq_len} exceeds the "
                             f"model's position table ({cfg.max_seq_len})")
        self.buckets = sorted(prefill_buckets or
                              default_prefill_buckets(self.max_seq_len))
        self.top_k = int(top_k)
        self.cache = model.init_kv_cache(self.batch_slots, self.max_seq_len)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        b = self.batch_slots
        self._queue: deque = deque()
        self._slots: List[Optional[Request]] = [None] * b
        self._slot_len = np.zeros(b, np.int64)
        # per-slot device state, written one element at a time on
        # admission/retirement (no host->device copy on the decode step)
        self._d_next = torch.zeros(b, dtype=torch.int64, device=self.device)
        self._d_active = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._d_temps = torch.zeros(b, dtype=torch.float32, device=self.device)
        self._d_top_ps = torch.ones(b, dtype=torch.float32, device=self.device)
        self.results: Dict[int, np.ndarray] = {}
        self._timings = {
            "prefill_ms": 0.0, "decode_ms": 0.0, "prefills": 0,
            "prefill_tokens": 0, "decode_steps": 0, "tokens_generated": 0,
            "decode_host_syncs": 0, "prefill_host_syncs": 0,
        }
        self._bucket_ms: Dict[int, List[float]] = {}

    # ---- sampling -----------------------------------------------------
    def _sample(self, logits, temps, top_ps):
        """Greedy where ``temps <= 0``, else temperature + (static) top-k
        + (per-row) top-p sampling.  logits ``[N, V]``; returns int64
        ``[N]`` on the device, without a host sync."""
        logits = logits.float()
        greedy = torch.argmax(logits, dim=-1)
        v = logits.shape[-1]
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        if self.top_k and self.top_k < v:
            kth = torch.topk(scaled, self.top_k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled < kth,
                                 torch.full_like(scaled, -1e30), scaled)
        # top-p in sorted order: keep tokens whose PRECEDING cumulative
        # mass is below p (the first token always survives)
        s_logits, sort_idx = torch.sort(scaled, dim=-1, descending=True)
        probs = torch.softmax(s_logits, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        probs = torch.where(csum - probs < top_ps[:, None], probs,
                            torch.zeros_like(probs))
        # exponential-race draw: argmax(p / E), E ~ Exp(1), picks index i
        # with probability p_i / sum(p)
        e = torch.empty_like(probs).exponential_(generator=self._gen)
        choice = torch.argmax(probs / e, dim=-1, keepdim=True)
        sampled = torch.gather(sort_idx, -1, choice)[:, 0]
        return torch.where(temps > 0, sampled, greedy)

    # ---- public API ---------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 32,
                    eos_id: Optional[int] = None, temperature: float = 0.0,
                    top_p: float = 1.0) -> int:
        """Queue a request; returns its id.  Admitted into a free slot at
        the next ``step()``."""
        req = Request(prompt, max_new_tokens, eos_id, temperature, top_p)
        if req.prompt.size > self.buckets[-1]:
            raise ValueError(f"prompt of {req.prompt.size} tokens exceeds "
                             f"the largest prefill bucket "
                             f"({self.buckets[-1]})")
        if req.prompt.size >= self.max_seq_len:
            raise ValueError(f"prompt of {req.prompt.size} tokens leaves no "
                             f"room to generate within "
                             f"max_seq_len={self.max_seq_len}")
        self._queue.append(req)
        return req.rid

    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_p: float = 1.0) -> np.ndarray:
        """Blocking single-request generation through the admission
        queue (waits for a free slot while in-flight requests decode)."""
        rid = self.add_request(prompt, max_new_tokens, eos_id, temperature,
                               top_p)
        while rid not in self.results:
            self.step()
        return self.results[rid]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # ---- admission ----------------------------------------------------
    def _admit_dense(self, req: Request, slot: int):
        """Prefill the bucket-padded prompt into ``slot`` and sample the
        first token from its logits."""
        t0 = time.perf_counter()
        plen = req.prompt.size
        bucket = self._bucket_for(plen)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :plen] = req.prompt
        ids_d = torch.from_numpy(ids).to(self.device, non_blocking=True)
        logits, _ = self.model.prefill(ids_d, self.cache, slot, plen)
        self._timings["prefill_tokens"] += bucket
        self._record_admission(req, slot, plen, logits)
        ms = (time.perf_counter() - t0) * 1e3
        self._timings["prefill_ms"] += ms
        self._bucket_ms.setdefault(bucket, []).append(ms)

    def _record_admission(self, req: Request, slot: int, plen: int, logits):
        """Sample the first token from the prefill logits and bind the
        request to its slot."""
        temps = torch.full((1,), req.temperature, device=self.device)
        top_ps = torch.full((1,), req.top_p, device=self.device)
        with torch.no_grad():
            tok_d = self._sample(logits, temps, top_ps)
        tok = tok_d.tolist()[0]
        self._timings["prefill_host_syncs"] += 1
        self._timings["prefills"] += 1
        req.slot = slot
        self._slots[slot] = req
        self._slot_len[slot] = plen
        self._d_next[slot] = tok
        self._d_active[slot] = 1
        self._d_temps[slot] = req.temperature
        self._d_top_ps[slot] = req.top_p
        req.generated.append(tok)
        self._retire_if_done(req, tok)

    # ---- retirement ---------------------------------------------------
    def _retire_if_done(self, req: Request, last_tok: int):
        """EOS / max-new-tokens / capacity retirement."""
        full = self._slot_len[req.slot] + 1 >= self.max_seq_len
        if (last_tok == req.eos_id
                or len(req.generated) >= req.max_new_tokens or full):
            self._retire(req)

    def _retire(self, req: Request):
        slot = req.slot
        self.results[req.rid] = np.asarray(req.generated, np.int32)
        self._slots[slot] = None
        self._d_active[slot] = 0
        self._d_temps[slot] = 0.0
        self._d_top_ps[slot] = 1.0
        req.slot = None

    # ---- the loop -----------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self.num_active > 0

    def step(self) -> int:
        """Admit queued requests into free slots, then decode one token
        for every active slot.  Returns the tokens produced this step
        (first tokens of admissions included)."""
        produced = 0
        for slot in range(self.batch_slots):
            if self._slots[slot] is None and self._queue:
                self._admit_dense(self._queue.popleft(), slot)
                produced += 1
        if self.num_active == 0:
            return produced
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = self.model.decode_step(self._d_next, self.cache,
                                               self._d_active)
            nxt = self._sample(logits, self._d_temps, self._d_top_ps)
        self._d_next = nxt
        # the ONE device->host copy of the step: the scheduler needs the
        # sampled ids for retirement
        nxt_host = nxt.tolist()
        self._timings["decode_host_syncs"] += 1
        self._timings["decode_steps"] += 1
        self._timings["decode_ms"] += (time.perf_counter() - t0) * 1e3
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            tok = nxt_host[slot]
            self._slot_len[slot] += 1        # the token just appended
            req.generated.append(tok)
            produced += 1
            self._timings["tokens_generated"] += 1
            self._retire_if_done(req, tok)
        return produced

    def run(self) -> Dict[int, np.ndarray]:
        """Step until every queued request finished; returns
        ``{request id: generated token ids}``."""
        while self.has_work:
            self.step()
        return self.results

    def stats(self) -> dict:
        """Cumulative wall-clock and counters.  Every step ends in a
        device-to-host copy, so the host clock measures device work."""
        t = self._timings
        s = dict(t)
        s["host_syncs"] = t["decode_host_syncs"] + t["prefill_host_syncs"]
        decode_s = t["decode_ms"] / 1e3
        s["decode_tokens_per_sec"] = (t["tokens_generated"] / decode_s
                                      if decode_s > 0 else None)
        s["prefill_ms_by_bucket"] = {
            b: {"count": len(v), "mean_ms": sum(v) / len(v)}
            for b, v in sorted(self._bucket_ms.items())}
        s["batch_slots"] = self.batch_slots
        s["buckets"] = list(self.buckets)
        s["device"] = str(self.device)
        return s
