"""Continuous-batching serving engine on the dense static KV cache or a
paged block pool (counterpart of ``paddle_tpu/inference/engine.py``).

Prompts are padded to a prefill bucket and prefilled one slot at a time
(``GPTForCausalLM.prefill`` / ``prefill_paged``, flash-attention
kernel); every step then decodes one token for all slots at once
(``decode_step`` / ``decode_step_paged``, decode-attention kernels).
Requests are admitted between decode steps and retire on EOS, on
``max_new_tokens`` or when the slot's sequence reaches ``max_seq_len``.
Sampling (greedy, temperature, static top-k, per-slot top-p) runs on
the engine's device with its own ``torch.Generator``, and the sampled
ids are the ONE device-to-host copy of a decode step
(``stats()['decode_host_syncs']``, also counted by
``distributed.async_dispatch.record_host_sync``).  An admission costs one
more, for its first token.

``kv_layout='paged'`` (Kwon et al., *PagedAttention*): the cache is a
block pool (``inference.paged_kv``) and each slot holds a block table,
so admission is by free blocks; a radix prefix cache
(``inference.prefix_cache``) shares prompt-prefix blocks so a shared
prefix prefills once; on pool exhaustion the scheduler evicts unpinned
cached blocks, then PREEMPTS the youngest request back onto the queue
(it resumes through a prefill over prompt + generated) instead of
deadlocking.  Block tables and lengths are host state; each paged decode
step stages them in pinned memory and copies them to the device without
a sync (the previous step's sync has finished the previous copy before
the host writes the staging buffers again).  ``kv_dtype='int8'`` or
``'fp8'`` (``PADDLE_TPU_KV_DTYPE``) stores either layout as int8 or e4m3
codes with per-(position, head) f32 scales, read by the int8 or e4m3
attention kernels; an fp8 cache keeps a megakernel-enabled model on the
composed decode step, as in the JAX package.

``prefill_chunk=C`` (Sarathi-style chunked prefill): admission binds a
request to a slot without running a prefill; each ``step()`` then feeds
up to C prompt tokens in total, oldest admission first, through ONE
fixed ``[batch_slots, C]`` window step (``prefill_chunk`` /
``prefill_chunk_paged``, the window-attention kernels) before the
decode step, so live streams never stall behind a long prompt.  A slot
still prefilling is inactive on the decode step; when its prompt
completes it graduates and its first token is sampled.  A chunk tick
makes no host sync unless a slot graduates, and then one.  Every slot
row goes through the chunk (advance 0 outside it): the product work of
those rows is spent, as in the JAX package.

``spec_k=K, draft_model=...`` (speculative decoding,
``inference.spec_decode``): every decode step becomes a tick in which the
draft proposes K tokens and the target verifies K+1 in one window step;
greedy streams stay token-identical to the non-speculative engine,
sampled ones follow the rejection rule.  One host sync per tick.

Request lifecycle: ``deadline_s`` on ``add_request``/``generate`` bounds
a request's time from enqueue (a queued request past it is delivered
empty, a live one retired with its partial tokens; both flagged
``timed_out``); the sweep at the top of every ``step()`` reads only the
host clock.  ``drain(timeout_s)`` closes admission, finishes the
in-flight slots (force-retiring them once ``timeout_s`` passes) and
hands back the queue; an attached ``PreemptionGuard``
(``distributed.resilience``) makes ``run``/``generate``/
``step_or_raise`` drain once it fires and park the queue in
``undelivered``.  Every finished request leaves a record in
``request_stats`` (TTFT, queued ms, decode tokens/s, inter-token gaps,
preemptions, ``timed_out``), which ``stats()`` pools into TTFT and ITL
percentiles.  ``warmup()`` runs every kernel and library the serving
path calls once with throwaway tokens, so traffic loads and builds
nothing.

Telemetry (``observability``), all host arithmetic on values the engine
already holds, no device read: the ``serve_*`` counters, histogram and
gauges (label ``engine="eN"``); with the span tracer armed a
``decode_tick`` or ``spec_tick`` span per tick and one track per request
(``queued``, ``prefill``, ``decode``, a ``preempt`` instant); a
flight-recorder record per decode, chunk and spec tick; the stall
watchdog (``PADDLE_TPU_WATCHDOG_S``), beaten per step and parked while
the engine has no work; a ``PADDLE_TPU_PROFILE`` capture window over
decode ticks; the step-kind registry and the HBM ledger's params, KV
cache and draft lines; ``stats()["exec_profile"]``, ``["hbm"]`` and
``["doctor"]``.

A MoE model (``GPTConfig.moe_num_experts > 0``) serves on every path
above.  Each model call of traffic (prefill, paged prefill, decode step,
chunk tick, the target's verify window) runs under
``distributed.moe.collect_expert_stats``; its kept-token load per expert
is added to a device accumulator and its assigned count (``top_k x B x
S`` per MoE layer, known from shapes) to a host counter, so the stats
add no host read.  ``stats()`` reads the accumulator once and reports
``moe_expert_load``, ``moe_dropped_rate`` and ``moe_load_skew``; the HBM
ledger carries a ``moe_experts`` line.  Warmup's throwaway tokens are
not counted.

Environment knobs, read where an argument is left unset (an explicit
argument wins), as the JAX engine reads them: ``PADDLE_TPU_DECODE_SLOTS``
(``batch_slots``, default 8), ``PADDLE_TPU_KV_LAYOUT`` (``kv_layout``,
default ``dense``), ``PADDLE_TPU_CHUNKED_PREFILL`` (``prefill_chunk``,
default 0), ``PADDLE_TPU_KV_BLOCK_SIZE`` (default 128),
``PADDLE_TPU_KV_BLOCKS`` (usable pool blocks, default the
dense-equivalent pool), ``PADDLE_TPU_PREFIX_CACHE`` (``0`` turns the
radix cache off), ``PADDLE_TPU_PREFILL_BUCKETS`` (a comma list, through
``default_prefill_buckets``), ``PADDLE_TPU_KV_DTYPE`` and
``PADDLE_TPU_SPEC_K`` (which needs a ``draft_model``).  The engine
serves on one device: ``PADDLE_TPU_SERVE_TP`` or ``PADDLE_TPU_SERVE_EP``
above 1 raises (tensor- and expert-parallel serving wait for the port's
meshes).  ``PADDLE_TPU_INFER_DONATE`` (XLA buffer donation) has no
counterpart in eager PyTorch and is not read.

Autotune: with no ``prefill_buckets`` and no
``PADDLE_TPU_PREFILL_BUCKETS``, the bucket list is the tuning table's
(``utils.tuning``, op ``prefill_buckets``, key ``(device_kind,
max_seq_len)``) before the powers-of-two default, so a list tuned for a
traffic mix outlives the process.  ``PADDLE_TPU_AUTOTUNE=live`` arms an
``autotune.live.LiveRetuner`` at construction (``_retuner``; None
otherwise), whose ``notify_slo`` an ``SLOMonitor`` listener feeds and
whose tick hook, at the top of ``step()``, runs a scheduled episode on a
quiesced engine only.  ``_exec_cost(key, kind)`` gives the registry the
analytic cost of each step kind (``observability.cost_model``) from
this run's buckets, live slots and context lengths.  The fault point
``PADDLE_FAULT_HANG`` (``testing.faults.maybe_hang``) sits after each
decode and spec tick.

Threads: every engine entry point runs its model calls under the
model's own ``torch.no_grad`` methods (grad mode is per thread), and
the op wrappers' shared state (kernel libraries, launch counts, the
megakernel's and the int8 matmul's per-stream buffers) takes locks, so
replicas in one process may each be driven from a thread of their own
(``run_fleet_loadtest``).  One engine is not to be stepped from two
threads at once.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device, same_device
from ..distributed.async_dispatch import record_host_sync
from ..distributed.moe import collect_expert_stats, fold_expert_stats
from ..observability import doctor as _doctor
from ..observability import exec_registry as _exec_registry
from ..observability import flightrec as _flightrec
from ..observability import metrics as _metrics
from ..observability import spans as _spans
from ..observability import watchdog as _watchdog
from ..observability.capture import ProfileWindow
from ..observability.cost_model import gpt_step_cost
from ..ops.quantized_matmul import resolve_kv_quant
from ..testing import faults as _faults
from ..utils import tuning as _tuning
from .paged_kv import (BlockAllocator, blocks_for, blocks_to_extend,
                       init_paged_cache)
from .prefix_cache import RadixPrefixCache
from .spec_decode import SpecDecoder, resolve_spec_k

__all__ = ["InferenceEngine", "Request", "default_prefill_buckets"]


def default_prefill_buckets(max_seq_len: int, lo: int = 16) -> List[int]:
    """Powers of two from ``lo`` below ``max_seq_len``, then
    ``max_seq_len`` itself; ``PADDLE_TPU_PREFILL_BUCKETS="64,256,1024"``
    replaces them, and between the two sits the tuning table (op
    ``prefill_buckets``, key ``(device_kind, max_seq_len)``).  Entries
    above ``max_seq_len`` are dropped."""
    env = os.environ.get("PADDLE_TPU_PREFILL_BUCKETS", "").strip()
    if env:
        bks = sorted({int(x) for x in env.split(",") if x.strip()})
    else:
        bks = None
        try:
            tuned = _tuning.lookup("prefill_buckets",
                                   (_tuning.device_kind(), max_seq_len))
            if tuned:
                bks = sorted({int(x) for x in tuned})
        except (ValueError, TypeError):
            pass
        if not bks:
            bks = []
            b = lo
            while b < max_seq_len:
                bks.append(b)
                b *= 2
            bks.append(max_seq_len)
    return [b for b in bks if b <= max_seq_len] or [max_seq_len]


def _check_single_device():
    """Raise when ``PADDLE_TPU_SERVE_TP`` or ``PADDLE_TPU_SERVE_EP`` asks
    for more than one device: the port serves on one."""
    for name in ("PADDLE_TPU_SERVE_TP", "PADDLE_TPU_SERVE_EP"):
        env = os.environ.get(name, "").strip()
        if env and int(env) > 1:
            raise NotImplementedError(
                f"{name}={env}: tensor- and expert-parallel serving need "
                f"device meshes, which the port does not have yet (ROADMAP "
                f"Queue 1 item 3.1); the engine serves on one device")


class Request:
    """One in-flight generation request (host-side bookkeeping)."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, eos_id, temperature, top_p,
                 deadline_s: Optional[float] = None):
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
        # absolute perf_counter deadline: past it the request is retired
        # with what it generated and flagged timed_out
        self.deadline: Optional[float] = None if deadline_s is None \
            else time.perf_counter() + float(deadline_s)
        self.timed_out = False
        # latency accounting: decode time summed over activations only
        # (a preempted request's requeue wait is not decode time) and
        # queue time over waits only
        self.t_enqueue = time.perf_counter()
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.active_s = 0.0
        self.t_live: Optional[float] = None
        self.queued_s = 0.0
        self.t_queue_since = self.t_enqueue
        # delivery time of every token (first token and each commit)
        self.token_times: List[float] = []
        # preemption: a preempted request resumes through a prefill over
        # prompt + generated so far (this field), keeping `generated`
        self.resume_prompt: Optional[np.ndarray] = None
        self.preemptions = 0
        self.admit_seq: Optional[int] = None
        # chunked prefill: bound to a slot while its prompt is still being
        # fed (prefill_pos tokens are in the cache so far)
        self.prefilling = False
        self.prefill_pos = 0

    def effective_prompt(self) -> np.ndarray:
        return self.prompt if self.resume_prompt is None \
            else self.resume_prompt


class InferenceEngine:
    """Continuous-batching serving engine for ``GPTForCausalLM``.

    Usage::

        eng = InferenceEngine(model, batch_slots=8, kv_layout="paged")
        rid = eng.add_request(prompt_ids, max_new_tokens=64, eos_id=eos)
        outputs = eng.run()          # {rid: np.int32 generated tokens}

    Unset arguments fall back to the environment knobs of the module
    docstring.  ``kv_layout``: ``'dense'`` (default; ``batch_slots x
    max_seq_len`` positions) or ``'paged'`` (a pool of ``kv_num_blocks`` blocks of
    ``kv_block_size`` positions, default the dense-equivalent memory,
    with a radix prefix cache unless ``prefix_cache=False``).
    ``kv_dtype='int8'`` or ``'fp8'`` quantizes either cache.  ``prefill_chunk=C > 0``
    admits by chunks of C prompt tokens per step; ``spec_k=K`` with a
    ``draft_model`` (a ``GPTForCausalLM`` of the same vocabulary on the
    same device) decodes speculatively.  ``device=None`` means the CUDA
    device (raises without one); the model must live on the engine's
    device.
    """

    _engine_ids = itertools.count()

    def __init__(self, model, batch_slots: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 top_k: int = 0, seed: int = 0, device=None,
                 kv_layout: Optional[str] = None,
                 kv_block_size: Optional[int] = None,
                 kv_num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_dtype: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 spec_k: Optional[int] = None, draft_model=None):
        _check_single_device()
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        model.eval()
        self.model = model
        cfg = model.cfg
        self.batch_slots = int(batch_slots or
                               os.environ.get("PADDLE_TPU_DECODE_SLOTS", 8))
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        if self.max_seq_len > cfg.max_seq_len:
            raise ValueError(f"max_seq_len {self.max_seq_len} exceeds the "
                             f"model's position table ({cfg.max_seq_len})")
        self.buckets = sorted(prefill_buckets or
                              default_prefill_buckets(self.max_seq_len))
        self.top_k = int(top_k)
        kv_layout = kv_layout or os.environ.get("PADDLE_TPU_KV_LAYOUT",
                                                "dense")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be dense|paged, got "
                             f"{kv_layout!r}")
        self.kv_layout = kv_layout
        self.kv_dtype = resolve_kv_quant(kv_dtype)
        if prefill_chunk is None:
            env = os.environ.get("PADDLE_TPU_CHUNKED_PREFILL", "").strip()
            prefill_chunk = int(env) if env else 0
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{self.prefill_chunk}")
        self._chunked = self.prefill_chunk > 0
        self._alloc: Optional[BlockAllocator] = None
        self._prefix: Optional[RadixPrefixCache] = None
        if kv_layout == "paged":
            self._init_paged(kv_block_size, kv_num_blocks, prefix_cache)
        else:
            self.cache = model.init_kv_cache(self.batch_slots,
                                             self.max_seq_len,
                                             kv_dtype=self.kv_dtype)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        b = self.batch_slots
        self._queue: deque = deque()
        self._slots: List[Optional[Request]] = [None] * b
        self._slot_len = np.zeros(b, np.int64)
        self._admit_counter = itertools.count()
        # head-of-line admission memo: once the queue head fails paged
        # admission, remember (rid, free blocks, release epoch) and do not
        # re-run its radix match and allocation until blocks could have
        # come free; the epoch catches releases that leave num_free
        # unchanged (blocks the radix cache pins become evictable)
        self._hol_block: Optional[tuple] = None
        self._release_epoch = 0
        # per-slot device state, written one element at a time on
        # admission/retirement (no host->device copy on the decode step)
        self._d_next = torch.zeros(b, dtype=torch.int64, device=self.device)
        self._d_active = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._d_temps = torch.zeros(b, dtype=torch.float32, device=self.device)
        self._d_top_ps = torch.ones(b, dtype=torch.float32, device=self.device)
        self.results: Dict[int, np.ndarray] = {}
        self.request_stats: Dict[int, dict] = {}
        self._request_stats_cap = 4096     # bounded per-request history
        self._results_cap = 65536          # results eviction safety net
        # drain / preemption guard: while draining, admission is closed
        self._draining = False
        self._guard = None
        self._guard_timeout: Optional[float] = None
        self.undelivered: List[Request] = []
        self._timings = {
            "prefill_ms": 0.0, "decode_ms": 0.0, "prefills": 0,
            "prefill_tokens": 0, "decode_steps": 0, "tokens_generated": 0,
            "decode_host_syncs": 0, "prefill_host_syncs": 0,
            "preemptions": 0, "memory_capped_retirements": 0,
            "deadline_retirements": 0, "drain_forced_retirements": 0,
            "occupancy_sum": 0.0, "block_occupancy_sum": 0.0,
            # decode-step wall time spent in monolithic admission prefills
            # while other streams waited (0 when chunked)
            "prefill_stall_ms": 0.0,
            "chunk_ticks": 0, "chunk_graduation_ticks": 0,
            "decode_steps_with_chunk": 0,
            "spec_ticks": 0, "spec_tokens_committed": 0,
            "spec_slot_ticks": 0, "spec_capacity_retirements": 0,
        }
        self._bucket_ms: Dict[int, List[float]] = {}
        # expert balance: kept-token load per expert summed on the device
        # (f64, so a long-lived server loses no counts), the assigned
        # count on the host
        self._is_moe = cfg.moe_num_experts > 0
        self._moe_load_d = torch.zeros(
            cfg.moe_num_experts, dtype=torch.float64, device=self.device) \
            if self._is_moe else None
        self._moe_assigned = 0.0
        sk = resolve_spec_k(spec_k)
        self._spec: Optional[SpecDecoder] = None
        if sk > 0:
            if draft_model is None:
                raise ValueError("spec_k set but no draft_model given: "
                                 "speculation needs a draft (the target "
                                 "itself is a valid one)")
            self._spec = SpecDecoder(self, draft_model, sk)
        self.spec_k = self._spec.k if self._spec else 0
        # live slots and their context tokens summed over decode steps
        # and spec ticks: the cost model's mean batch and length
        self._decode_rows_sum = 0
        self._decode_ctx_sum = 0
        self._init_telemetry()
        # PADDLE_TPU_AUTOTUNE=live: the SLO-triggered bucket retuner
        from ..autotune.live import arm_engine
        self._retuner = arm_engine(self)

    def _init_telemetry(self):
        """Registry children bound once (a tick costs attribute
        arithmetic), the tracer handle (gated on ``.active``), the capture
        window over decode ticks, the ledger's lines, the crash hooks; the
        watchdog starts on the first step when ``PADDLE_TPU_WATCHDOG_S``
        arms it."""
        self.telemetry_label = f"e{next(InferenceEngine._engine_ids)}"
        self._exec_component = f"engine:{self.telemetry_label}"
        self._exec_meta = {"kv_layout": self.kv_layout,
                           "kv_dtype": self.kv_dtype or "dense",
                           "batch_slots": self.batch_slots}
        label = self.telemetry_label
        cache = self.cache
        _exec_registry.track_bytes(self, "params", label,
                                   _exec_registry.tree_bytes(self.model))
        _exec_registry.track_bytes(
            self, "kv_cache", label,
            _exec_registry.tree_bytes(
                [cache.k, cache.v, cache.k_scale, cache.v_scale]),
            layout=self.kv_layout, kv_dtype=self.kv_dtype or "dense")
        if self._spec is not None:
            dc = self._spec.draft_cache
            _exec_registry.track_bytes(
                self, "spec_draft", label,
                _exec_registry.tree_bytes(self._spec.draft)
                + _exec_registry.tree_bytes([dc.k, dc.v]))
        if self._is_moe:
            # the expert FFN weights' residency (one device holds all E;
            # the router's gate is not one)
            _exec_registry.track_bytes(
                self, "moe_experts", label,
                _exec_registry.tree_bytes(
                    [p for n, p in self.model.named_parameters()
                     if ".experts." in n]),
                ep=1, num_experts=int(self.model.cfg.moe_num_experts))
        self._tracer = _spans.tracer()
        self._profile = ProfileWindow.from_env(kind="serve")

        def child(make, name, help, **extra):
            return make(name, help, labels=("engine",) + tuple(extra)
                        ).labels(engine=label, **extra)

        c, g = _metrics.counter, _metrics.gauge
        self._m_ticks = child(c, "serve_decode_ticks_total",
                              "decode steps/ticks")
        self._m_tokens = child(c, "serve_tokens_total", "generated tokens")
        self._m_prefills = child(c, "serve_prefills_total",
                                 "admission prefills")
        self._m_preempts = child(c, "serve_preemptions_total",
                                 "requests preempted to queue")
        self._m_req_ok = child(c, "serve_requests_total",
                               "finished requests", outcome="ok")
        self._m_req_to = child(c, "serve_requests_total",
                               "finished requests", outcome="timed_out")
        self._m_ttft = child(_metrics.histogram, "serve_ttft_ms",
                             "enqueue -> first token")
        self._m_queue = child(g, "serve_queue_depth", "queued requests")
        self._m_active = child(g, "serve_active_slots",
                               "occupied decode slots")
        _flightrec.install()
        self.watchdog: Optional[_watchdog.Watchdog] = None
        self._wd_checked = False

    # ---- MoE expert balance -------------------------------------------
    @contextlib.contextmanager
    def _expert_stats(self):
        """Around one model call of traffic: the MoE layers' kept-token
        loads go to the device accumulator (no host read), their assigned
        counts to the host counter.  A dense model opens nothing."""
        if not self._is_moe:
            yield
            return
        with collect_expert_stats() as bucket:
            yield
        folded = fold_expert_stats(bucket)
        if folded is not None:
            self._moe_load_d += folded["load"]
            self._moe_assigned += folded["assigned"]

    def moe_load(self) -> Optional[np.ndarray]:
        """The kept-token load per expert summed over traffic, read from
        the device (float64 ``[E]``); None for a dense model or before
        any traffic."""
        if not self._moe_assigned:
            return None
        # one read (a copy on the CPU too)
        return np.asarray(self._moe_load_d.tolist(), np.float64)

    def _exec_cost(self, key, kind: str) -> Optional[dict]:
        """The analytic cost of one step of ``kind`` (the registry's
        ``analyze``): a prefill at its bucket (a chunk tick at its slots
        x chunk), decode and spec ticks at this run's mean live slots and
        context, the sampler over every slot."""
        cfg = self.model.cfg
        steps = self._decode_rows_sum and self._timings["decode_steps"]
        rows = self._decode_rows_sum / steps if steps else self.batch_slots
        ctx = self._decode_ctx_sum / self._decode_rows_sum \
            if self._decode_rows_sum else 0.0
        quant = self.kv_dtype is not None
        kw = dict(weight_itemsize=next(self.model.parameters()).element_size(),
                  kv_itemsize=1 if quant else 2, kv_scales=quant)
        if kind == "prefill":
            tokens = int(key[1])
            if str(key[0]).startswith("prefill_chunk"):
                tokens *= self.batch_slots
            return gpt_step_cost(cfg, "prefill", seq=tokens, **kw)
        if kind in ("decode", "megakernel_decode"):
            return gpt_step_cost(cfg, kind, batch=rows, context=ctx, **kw)
        if kind == "spec_verify":
            return gpt_step_cost(cfg, kind, batch=rows, context=ctx,
                                 window=self.spec_k + 1, **kw)
        if kind == "sample":
            return gpt_step_cost(cfg, kind, batch=self.batch_slots)
        return None

    def _exec(self, key, kind: str, dt_ms: float):
        """The step kind's registry entry (its first call's time includes
        the libraries' loads)."""
        _exec_registry.registry().note_call(
            self._exec_component, key, kind, dt_ms, meta=self._exec_meta,
            owner=self)

    # ---- paged layout setup -------------------------------------------
    def _init_paged(self, kv_block_size, kv_num_blocks, prefix_cache):
        """Block pool + allocator + host block tables + radix cache.  The
        default pool is dense-equivalent memory (batch_slots x
        ceil(max_seq_len / bs) blocks), plus the null block 0."""
        bs = int(kv_block_size or
                 os.environ.get("PADDLE_TPU_KV_BLOCK_SIZE", 128))
        if bs < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {bs}")
        self.block_size = bs
        self.blocks_per_slot = blocks_for(self.max_seq_len, bs)
        usable = int(kv_num_blocks or
                     os.environ.get("PADDLE_TPU_KV_BLOCKS", 0)) or \
            self.batch_slots * self.blocks_per_slot
        self.num_blocks = usable
        self.cache = init_paged_cache(self.model, usable + 1, bs,
                                      kv_dtype=self.kv_dtype)
        self._alloc = BlockAllocator(usable + 1, bs)
        # host tables and lengths live in (pinned, on the card) staging
        # tensors; each decode step copies them to the device mirrors
        shape = (self.batch_slots, self.blocks_per_slot)
        pin = self.device.type == "cuda"
        self._h_tables = torch.zeros(shape, dtype=torch.int32, pin_memory=pin)
        self._h_lens = torch.zeros(self.batch_slots, dtype=torch.int32,
                                   pin_memory=pin)
        self._tables = self._h_tables.numpy()
        self._lens_np = self._h_lens.numpy()
        self._d_tables = torch.zeros(shape, dtype=torch.int32,
                                     device=self.device)
        self._d_lens = torch.zeros(self.batch_slots, dtype=torch.int32,
                                   device=self.device)
        self._slot_blocks: List[List[int]] = \
            [[] for _ in range(self.batch_slots)]
        if prefix_cache is None:
            prefix_cache = os.environ.get("PADDLE_TPU_PREFIX_CACHE",
                                          "1") != "0"
        self._prefix = RadixPrefixCache(self._alloc, bs) if prefix_cache \
            else None

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
                    top_p: float = 1.0,
                    deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its id.  Admitted into a free slot
        (dense) or free blocks (paged) at the next ``step()``.  Past
        ``deadline_s`` seconds from now (queueing included) it is retired
        with what it generated and reported ``timed_out``."""
        req = Request(prompt, max_new_tokens, eos_id, temperature, top_p,
                      deadline_s=deadline_s)
        if req.prompt.size > self.buckets[-1]:
            raise ValueError(f"prompt of {req.prompt.size} tokens exceeds "
                             f"the largest prefill bucket "
                             f"({self.buckets[-1]})")
        if req.prompt.size >= self.max_seq_len:
            raise ValueError(f"prompt of {req.prompt.size} tokens leaves no "
                             f"room to generate within "
                             f"max_seq_len={self.max_seq_len}")
        if self.kv_layout == "paged":
            # can it EVER run alone on an empty pool: its bucket-padded
            # prefill, then its full extent
            bs = self.block_size
            # a spec tick writes its K+1 window before it knows how much
            # commits, so the steady extent carries that margin
            worst = max(
                blocks_for(self._bucket_for(req.prompt.size), bs),
                blocks_for(min(req.prompt.size + req.max_new_tokens
                               + self.spec_k, self.max_seq_len), bs))
            if worst > self._alloc.capacity:
                raise ValueError(f"request needs {worst} KV blocks but the "
                                 f"pool only has {self._alloc.capacity}")
        self._queue.append(req)
        return req.rid

    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_p: float = 1.0,
                 deadline_s: Optional[float] = None) -> np.ndarray:
        """Blocking single-request generation through the admission
        queue (waits for capacity while in-flight requests decode).  With
        ``deadline_s`` the wait is bounded: past it the partial (possibly
        empty) generation comes back.  A fired guard drains the engine
        and returns what exists."""
        rid = self.add_request(prompt, max_new_tokens, eos_id, temperature,
                               top_p, deadline_s=deadline_s)
        while rid not in self.results:
            if self._guard is not None and self._guard.preempted:
                self.undelivered.extend(self.drain(self._guard_timeout))
                return self.results.get(rid, np.zeros(0, np.int32))
            self.step_or_raise()
        return self.results[rid]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # ---- paged block accounting ---------------------------------------
    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Allocate n blocks, evicting unpinned radix-cache blocks if the
        free list alone cannot cover it."""
        if n <= 0:
            return []
        out = self._alloc.alloc(n)
        if out is None and self._prefix is not None:
            self._prefix.evict(n - self._alloc.num_free)
            out = self._alloc.alloc(n)
        return out

    def _free_slot_blocks(self, slot: int):
        self._alloc.decref(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._tables[slot, :] = 0
        self._slot_len[slot] = 0

    def _release_slot(self, req: Request):
        """Slot teardown shared by retirement and preemption."""
        slot = req.slot
        if self.kv_layout == "paged":
            self._free_slot_blocks(slot)
        self._slots[slot] = None
        self._d_active[slot] = 0
        self._d_temps[slot] = 0.0
        self._d_top_ps[slot] = 1.0
        if self._spec is not None:
            self._spec.on_release(slot)
        req.slot = None
        req.prefilling = False
        req.prefill_pos = 0
        # any release can make blocks free or evictable: wake the
        # head-of-line memo
        self._release_epoch += 1

    def _preempt(self, req: Request):
        """Put an active request back at the queue head: free its blocks
        now; it resumes through a prefill over prompt + generated (which
        usually hits the radix cache), which re-derives its last sampled
        token's k/v."""
        req.resume_prompt = np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)])
        req.preemptions += 1
        now = time.perf_counter()
        # a still-prefilling victim never went live: no activation to close
        if req.t_live is not None:
            req.active_s += now - req.t_live
        self._m_preempts.inc()
        if self._tracer.active:
            if req.t_live is not None:
                self._span_request("decode", req, req.t_live, now,
                                   tokens=len(req.generated), preempted=True)
            else:
                self._span_request("prefill", req, req.t_admit, now,
                                   chunk_pos=req.prefill_pos, preempted=True)
            self._tracer.instant("preempt", pid=_spans.PID_REQUESTS,
                                 tid=req.rid, cat="request",
                                 ts_us=self._tracer.to_us(now))
        req.t_live = None
        req.t_queue_since = now
        self._timings["preemptions"] += 1
        self._release_slot(req)
        self._queue.appendleft(req)

    def _resumable(self, req: Request) -> bool:
        """Its prompt + generated fits a prefill bucket whose cold
        admission fits the pool, so a preemption can re-admit it."""
        total = len(req.prompt) + len(req.generated)
        return (total <= self.buckets[-1] and
                blocks_for(self._bucket_for(total), self.block_size)
                <= self._alloc.capacity)

    def _preempt_for_blocks(self, n: int,
                            exclude: Request) -> Optional[List[int]]:
        """The pool is dry mid-decode: preempt the youngest other
        resumable request(s) until n blocks come free."""
        while True:
            out = self._alloc_blocks(n)
            if out is not None:
                return out
            victims = [r for r in self._slots
                       if r is not None and r is not exclude
                       and self._resumable(r)]
            if not victims:
                return None
            self._preempt(max(victims, key=lambda r: r.admit_seq))

    def _ensure_decode_room(self, need_tokens: int = 1):
        """Before a paged decode step (or spec tick, ``need_tokens`` = K +
        1), every decoding slot whose next writes fall past its blocks
        gets fresh blocks: from the free list, by radix-cache eviction,
        or by preempting the youngest other request.  With no resumable
        victim the requester itself is preempted if it can resume, else
        retired with the tokens it has (a memory-capped finish).
        Still-prefilling slots are left to ``_ensure_chunk_room``."""
        for slot in range(self.batch_slots):
            req = self._slots[slot]
            if req is None or req.prefilling:
                continue
            need = blocks_for(int(self._slot_len[slot]) + need_tokens,
                              self.block_size)
            while (self._slots[slot] is req
                   and len(self._slot_blocks[slot]) < need):
                nb = self._alloc_blocks(1)
                if nb is None:
                    nb = self._preempt_for_blocks(1, exclude=req)
                if nb is None:
                    if self._resumable(req):
                        self._preempt(req)
                    else:
                        self._timings["memory_capped_retirements"] += 1
                        self._retire(req)
                    break
                self._tables[slot, len(self._slot_blocks[slot])] = nb[0]
                self._slot_blocks[slot].append(nb[0])

    # ---- admission ----------------------------------------------------
    def _try_admit(self, req: Request, slot: int) -> bool:
        """Admit into ``slot`` if capacity allows; False leaves the
        request at the queue head (admission is FIFO)."""
        if self.kv_layout == "dense":
            self._admit_dense(req, slot)
            return True
        return self._admit_paged(req, slot)

    def _ids_on_device(self, tokens, bucket: int) -> torch.Tensor:
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :tokens.size] = tokens
        return torch.from_numpy(ids).to(self.device, non_blocking=True)

    def _admit_dense(self, req: Request, slot: int):
        """Prefill the bucket-padded prompt into ``slot`` and sample the
        first token from its logits."""
        t0 = req.t_admit = time.perf_counter()
        prompt = req.effective_prompt()
        plen = prompt.size
        bucket = self._bucket_for(plen)
        with self._expert_stats():
            logits, _ = self.model.prefill(
                self._ids_on_device(prompt, bucket), self.cache, slot, plen)
        self._timings["prefill_tokens"] += bucket
        self._record_admission(req, slot, plen, logits)
        self._note_prefill(bucket, t0)

    def _note_prefill(self, bucket: int, t0: float, family: str = "prefill"):
        ms = (time.perf_counter() - t0) * 1e3
        self._timings["prefill_ms"] += ms
        self._bucket_ms.setdefault(bucket, []).append(ms)
        self._exec((family, bucket), "prefill", ms)

    def _admit_paged(self, req: Request, slot: int) -> bool:
        """Paged admission: one prefill, then the slot adoption."""
        rec = self._paged_prefill(req)
        if rec is None:
            return False                      # stays queued
        blocks, _plen, logits = rec
        self.admit_handoff(req, slot, blocks, logits)
        return True

    def _match_prefix(self, prompt, fits):
        """Radix match of ``prompt``, shedding cached blocks from its end
        (their tokens are recomputed) until ``fits(prefix_len)``.  Returns
        ``(shared blocks, prefix_len, counters)``, ``counters`` the hit
        counters before the match: a blocked head-of-line request
        re-matches on every retry, so a refused admission rolls them back
        and they count admissions, not retries."""
        if self._prefix is None:
            return [], 0, None
        pc = self._prefix
        counters = (pc.queries, pc.hit_queries, pc.hit_blocks)
        shared, prefix_len = pc.match(prompt)
        shed = 0
        while shared and not fits(prefix_len):
            shared = shared[:-1]
            prefix_len -= self.block_size
            shed += 1
        if shed:
            pc.hit_blocks -= shed
            if not shared:
                pc.hit_queries -= 1
        return shared, prefix_len, counters

    def _claim_blocks(self, shared, n_total: int,
                      counters) -> Optional[List[int]]:
        """The slot's reference on the ``shared`` prefix blocks, then
        ``n_total - len(shared)`` fresh ones.  The reference comes BEFORE
        any allocation: an eviction could otherwise free a matched block
        and hand it out again as this request's own.  None (nothing held,
        hit counters rolled back) when the pool cannot hold them yet."""
        self._alloc.incref(shared)
        new_blocks = self._alloc_blocks(n_total - len(shared))
        if new_blocks is None:
            self._alloc.decref(shared)
            if counters is not None:
                pc = self._prefix
                pc.queries, pc.hit_queries, pc.hit_blocks = counters
            return None
        return list(shared) + new_blocks

    def _paged_prefill(self, req: Request, family: str = "prefill_paged"):
        """Match the radix cache, allocate blocks for the divergent
        suffix's bucket, prefill ONLY the suffix, then return the bucket
        padding's blocks and adopt the prompt's full blocks into the
        radix tree.  Returns ``(blocks, plen, logits)`` with the slot's
        references taken, or None when the pool cannot hold the request
        yet.  ``family`` keys the prefill's timing (``prefill_ms`` by
        bucket and its step-kind entry): the engine's own admissions use
        ``prefill_paged``, a disaggregated ``PrefillWorker`` ``disagg``."""
        bs = self.block_size
        prompt = req.effective_prompt()
        # the bucket-padded extent must fit the slot's table and the
        # whole pool; prefix 0 always fits (add_request checked it)
        fit = min(self.blocks_per_slot, self._alloc.capacity)
        shared, prefix_len, counters = self._match_prefix(
            prompt, lambda p: blocks_for(
                p + self._bucket_for(prompt.size - p), bs) <= fit)
        suffix = prompt[prefix_len:]
        bucket = self._bucket_for(suffix.size)
        blocks = self._claim_blocks(shared, blocks_for(prefix_len + bucket, bs),
                                    counters)
        if blocks is None:
            return None
        t0 = req.t_admit = time.perf_counter()
        self._timings["prefill_tokens"] += bucket
        row = np.zeros(self.blocks_per_slot, np.int32)
        row[:len(blocks)] = blocks
        with self._expert_stats():
            logits, _ = self.model.prefill_paged(
                self._ids_on_device(suffix, bucket), self.cache,
                torch.from_numpy(row).to(self.device, non_blocking=True),
                prefix_len, suffix.size)
        self._note_prefill(bucket, t0, family)
        # blocks past the real prompt held only bucket padding
        plen = int(prefix_len + suffix.size)
        keep = blocks_for(plen, bs)
        if len(blocks) > keep:
            self._alloc.decref(blocks[keep:])
            blocks = blocks[:keep]
        if self._prefix is not None:
            n_full = prompt.size // bs
            if n_full:
                self._prefix.insert(prompt[:n_full * bs], blocks[:n_full])
        return blocks, plen, logits

    def admit_handoff(self, req: Request, slot: int, blocks, logits):
        """Adopt a request whose prefill already ran: install its block
        table (the blocks arrive trimmed, radix-adopted and owned by this
        slot) and finish admission from its last-token logits."""
        if self.kv_layout != "paged":
            raise ValueError("admit_handoff needs the paged layout")
        self._slot_blocks[slot] = list(blocks)
        self._tables[slot, :] = 0
        self._tables[slot, :len(blocks)] = blocks
        self._record_admission(req, slot, int(req.effective_prompt().size),
                               logits)

    def _record_admission(self, req: Request, slot: int, plen: int, logits):
        """Sample the first token from the prefill logits and bind the
        request to its slot."""
        t0 = time.perf_counter()
        temps = torch.full((1,), req.temperature, device=self.device)
        top_ps = torch.full((1,), req.top_p, device=self.device)
        with torch.no_grad():
            tok_d = self._sample(logits, temps, top_ps)
        tok = tok_d.tolist()[0]
        now = time.perf_counter()
        self._exec(("sample", 1), "sample", (now - t0) * 1e3)
        if req.t_first is None:
            req.t_first = now
            self._m_ttft.observe((now - req.t_enqueue) * 1e3)
        req.t_live = now
        req.token_times.append(now)
        req.queued_s += req.t_admit - req.t_queue_since
        self._timings["prefill_host_syncs"] += 1
        record_host_sync()
        self._timings["prefills"] += 1
        self._m_prefills.inc()
        if self._tracer.active:
            # the request's track, from timestamps already held
            self._span_queued(req)
            self._span_request("prefill", req, req.t_admit, now, slot=slot)
        req.slot = slot
        req.admit_seq = next(self._admit_counter)
        self._slots[slot] = req
        self._slot_len[slot] = plen
        self._d_next[slot] = tok
        self._d_active[slot] = 1
        self._d_temps[slot] = req.temperature
        self._d_top_ps[slot] = req.top_p
        req.generated.append(tok)
        self._retire_if_done(req, tok)
        if self._spec is not None and self._slots[slot] is req:
            self._spec.on_admit(req, slot, tok)

    # ---- chunked prefill ------------------------------------------------
    def _try_admit_chunked(self, req: Request, slot: int) -> bool:
        """Chunked admission: bind the request to ``slot`` without a
        prefill; ``_chunk_tick`` feeds its prompt.  Paged, the slot starts
        with blocks for its radix-matched prefix plus its first chunk;
        False (pool dry) leaves it at the queue head."""
        prompt = req.effective_prompt()
        plen0 = 0
        if self.kv_layout == "paged":
            bs = self.block_size
            # the match cannot exceed the slot's table or the pool
            fit = min(self.blocks_per_slot, self._alloc.capacity)
            shared, prefix_len, counters = self._match_prefix(
                prompt, lambda p: p // bs <= fit)
            first = min(self.prefill_chunk, prompt.size - prefix_len)
            blocks = self._claim_blocks(
                shared, blocks_for(prefix_len + first, bs), counters)
            if blocks is None:
                return False
            self._slot_blocks[slot] = blocks
            self._tables[slot, :] = 0
            self._tables[slot, :len(blocks)] = blocks
            plen0 = prefix_len
        now = req.t_admit = time.perf_counter()
        req.queued_s += now - req.t_queue_since
        req.prefilling = True
        req.prefill_pos = plen0
        req.slot = slot
        req.admit_seq = next(self._admit_counter)
        self._slots[slot] = req
        self._slot_len[slot] = plen0
        self._d_temps[slot] = req.temperature
        self._d_top_ps[slot] = req.top_p
        if self._tracer.active:
            self._span_queued(req)
        return True

    def _span_queued(self, req: Request):
        self._span_request("queued", req, req.t_queue_since, req.t_admit,
                           prompt_tokens=int(req.prompt.size),
                           resume=req.resume_prompt is not None)

    def _span_request(self, name: str, req: Request, t0: float, t1: float,
                      **args):
        """One lifecycle span on the request's own track."""
        tr = self._tracer
        ts = tr.to_us(t0)
        tr.complete(name, ts, tr.to_us(t1) - ts, pid=_spans.PID_REQUESTS,
                    tid=req.rid, cat="request", args=args)

    def _ensure_chunk_room(self, req: Request, adv: int) -> int:
        """Grow ``req``'s blocks to cover its next ``adv`` prompt tokens
        (free list, radix eviction, then preempting the youngest other
        request).  Returns the advance that is safe: 0 when the requester
        itself had to be preempted (a still-prefilling request can always
        resume, so it is never retired here)."""
        slot = req.slot
        while (self._slots[slot] is req and blocks_to_extend(
                len(self._slot_blocks[slot]), req.prefill_pos + adv,
                self.block_size) > 0):
            nb = self._alloc_blocks(1)
            if nb is None:
                nb = self._preempt_for_blocks(1, exclude=req)
            if nb is None:
                self._preempt(req)
                break
            self._tables[slot, len(self._slot_blocks[slot])] = nb[0]
            self._slot_blocks[slot].append(nb[0])
        return adv if self._slots[slot] is req else 0

    def _chunk_tick(self) -> int:
        """Advance the still-prefilling slots by up to ``prefill_chunk``
        prompt tokens in total (oldest admission first) through ONE
        ``[batch_slots, C]`` chunk step, then graduate the slots whose
        prompt completed.  The chunk's inputs are copied from pageable
        host memory (a copy the host may overwrite at once: no sync
        guards a chunk tick).  Returns the first tokens sampled."""
        pre = sorted(((s, r) for s, r in enumerate(self._slots)
                      if r is not None and r.prefilling),
                     key=lambda sr: sr[1].admit_seq)
        if not pre:
            return 0
        c = self.prefill_chunk
        budget = c
        tokens = np.zeros((self.batch_slots, c), np.int64)
        advance = np.zeros(self.batch_slots, np.int32)
        for slot, req in pre:
            if budget <= 0:
                break
            prompt = req.effective_prompt()
            adv = min(prompt.size - req.prefill_pos, budget)
            if self.kv_layout == "paged":
                # may preempt other prefilling slots: their rows then
                # write into the null block through a zeroed table row
                adv = self._ensure_chunk_room(req, adv)
            if self._slots[slot] is not req or adv <= 0:
                continue
            tokens[slot, :adv] = prompt[req.prefill_pos:req.prefill_pos + adv]
            advance[slot] = adv
            budget -= adv
        if not advance.any():
            return 0
        t0 = time.perf_counter()
        self._timings["prefill_tokens"] += int(advance.sum())
        self._timings["chunk_ticks"] += 1
        dev = self.device
        lens = torch.from_numpy(self._slot_len.astype(np.int32)).to(
            dev, non_blocking=True)
        with torch.no_grad(), self._expert_stats():
            tok_d = torch.from_numpy(tokens).to(dev, non_blocking=True)
            adv_d = torch.from_numpy(advance).to(dev, non_blocking=True)
            if self.kv_layout == "paged":
                tables = torch.from_numpy(self._tables.copy()).to(
                    dev, non_blocking=True)
                logits, _ = self.model.prefill_chunk_paged(
                    tok_d, self.cache, tables, lens, adv_d)
            else:
                logits, _ = self.model.prefill_chunk(tok_d, self.cache, lens,
                                                     adv_d)
        grads = []
        for slot, req in pre:
            adv = int(advance[slot])
            if self._slots[slot] is not req or adv <= 0:
                continue
            req.prefill_pos += adv
            self._slot_len[slot] = req.prefill_pos
            prompt = req.effective_prompt()
            if self.kv_layout == "paged" and self._prefix is not None:
                # completed blocks join the radix tree now, so a request
                # admitted meanwhile already shares them
                n_full = req.prefill_pos // self.block_size
                if n_full:
                    self._prefix.insert(prompt[:n_full * self.block_size],
                                        self._slot_blocks[slot][:n_full])
            if req.prefill_pos >= prompt.size:
                grads.append((slot, req))
        if grads:
            with torch.no_grad():
                nxt = self._sample(logits, self._d_temps, self._d_top_ps)
            toks = nxt.tolist()
            self._timings["prefill_host_syncs"] += 1
            record_host_sync()
            self._timings["chunk_graduation_ticks"] += 1
            for slot, req in grads:
                self._graduate(req, slot, toks[slot])
        ms = (time.perf_counter() - t0) * 1e3
        self._timings["prefill_ms"] += ms
        self._exec(("prefill_chunk_paged" if self.kv_layout == "paged"
                    else "prefill_chunk", c), "prefill", ms)
        _flightrec.record("chunk_tick", dur_ms=ms, prefilling=len(pre),
                          tokens=int(advance.sum()), graduated=len(grads))
        return len(grads)

    def _graduate(self, req: Request, slot: int, tok: int):
        """The slot's prompt completed: commit its first token and make
        the slot live on the decode step."""
        now = time.perf_counter()
        if req.t_first is None:
            req.t_first = now
            self._m_ttft.observe((now - req.t_enqueue) * 1e3)
        req.t_live = now
        req.token_times.append(now)
        req.prefilling = False
        self._timings["prefills"] += 1
        self._m_prefills.inc()
        if self._tracer.active:
            self._span_request("prefill", req, req.t_admit, now, slot=slot,
                               chunked=True)
        req.generated.append(tok)
        self._d_next[slot] = tok
        self._d_active[slot] = 1
        self._retire_if_done(req, tok)
        if self._spec is not None and self._slots[slot] is req:
            self._spec.on_admit(req, slot, tok)

    def set_prefill_chunk(self, chunk: int) -> bool:
        """Switch the chunk budget (0 = monolithic admission) between
        steps.  A slot still prefilling pins the current budget: returns
        False without changing anything."""
        chunk = int(chunk)
        if chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {chunk}")
        if chunk == self.prefill_chunk:
            return True
        if any(r is not None and r.prefilling for r in self._slots):
            return False
        self.prefill_chunk = chunk
        self._chunked = chunk > 0
        return True

    # ---- retirement ---------------------------------------------------
    def _retire_if_done(self, req: Request, last_tok: int):
        """EOS / max-new-tokens / capacity retirement."""
        full = self._slot_len[req.slot] + 1 >= self.max_seq_len
        if (last_tok == req.eos_id
                or len(req.generated) >= req.max_new_tokens or full):
            self._retire(req)

    def _deliver(self, req: Request):
        """The one place results and request records are written: every
        finished request (normal, deadline, drain-forced) goes through
        the bounded-history caps.  ``results`` is the delivery channel:
        a step()-driven server pops what it consumes."""
        self.results[req.rid] = np.asarray(req.generated, np.int32)
        self.request_stats[req.rid] = self._request_record(req)
        (self._m_req_to if req.timed_out else self._m_req_ok).inc()
        while len(self.request_stats) > self._request_stats_cap:
            self.request_stats.pop(next(iter(self.request_stats)))
        while len(self.results) > self._results_cap:
            self.results.pop(next(iter(self.results)))

    def _retire(self, req: Request):
        req.t_finish = time.perf_counter()
        # a deadline or drain can retire a still-prefilling slot, which
        # never went live
        if req.t_live is not None:
            req.active_s += req.t_finish - req.t_live
            if self._tracer.active:
                # the last activation's span closes the request's track
                self._span_request("decode", req, req.t_live, req.t_finish,
                                   tokens=len(req.generated),
                                   preemptions=req.preemptions,
                                   timed_out=req.timed_out)
        self._deliver(req)
        self._release_slot(req)

    def _request_record(self, req: Request) -> dict:
        n = len(req.generated)
        # inter-token gaps between delivery times (first token included)
        gaps = (np.diff(np.asarray(req.token_times)) * 1e3
                if len(req.token_times) > 1 else np.zeros(0, np.float64))
        return {
            "prompt_tokens": int(req.prompt.size),
            "tokens": n,
            # a queue-expired request never produced a token: no TTFT
            "ttft_ms": round((req.t_first - req.t_enqueue) * 1e3, 3)
            if req.t_first is not None else None,
            "queued_ms": round(req.queued_s * 1e3, 3),
            # over active decode time only, requeue waits excluded
            "decode_tokens_per_sec": round((n - 1) / req.active_s, 2)
            if n > 1 and req.active_s > 0 else None,
            "itl_ms_p50": round(float(np.percentile(gaps, 50)), 3)
            if gaps.size else None,
            "itl_ms_p99": round(float(np.percentile(gaps, 99)), 3)
            if gaps.size else None,
            # raw gaps (bounded), for a harness that corrects the first
            # one for arrival lateness and pools across requests
            "itl_gaps_ms": [round(float(g), 3) for g in gaps[:512]],
            "preemptions": req.preemptions,
            "timed_out": req.timed_out,
        }

    def expire_queued_request(self, req: Request, now: float):
        """Deliver a queued request as deadline-expired (it never took a
        slot, so nothing is freed)."""
        req.timed_out = True
        req.t_finish = now
        req.queued_s += now - req.t_queue_since
        self._timings["deadline_retirements"] += 1
        self._deliver(req)

    def _retire_expired(self):
        """The per-step deadline sweep, on the host clock alone: queued
        requests past their deadline are delivered empty, bound ones are
        retired with the tokens they have (slot and blocks freed)."""
        now = time.perf_counter()
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        for r in expired:
            self._queue.remove(r)
            self.expire_queued_request(r, now)
        for req in list(self._slots):
            if (req is not None and req.deadline is not None
                    and now >= req.deadline):
                req.timed_out = True
                self._timings["deadline_retirements"] += 1
                self._retire(req)

    # ---- the loop -----------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self.num_active > 0

    @property
    def blocks_in_use(self) -> Optional[int]:
        return self._alloc.num_in_use if self._alloc else None

    @property
    def _admitting(self) -> bool:
        """Admission gate: closed while draining (``drain()`` or a fired
        guard); in-flight slots finish, the queue waits."""
        return not self._draining and (
            self._guard is None or not self._guard.preempted)

    def _admit(self) -> int:
        """Admit queued requests into free slots in FIFO order; returns
        the admissions (each produced its first token unless chunked)."""
        admitted = 0
        if not self._admitting:
            return 0
        for slot in range(self.batch_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            head = self._queue[0]
            # the blocked head is not retried until blocks came free
            # (num_free grew) or became evictable (release epoch moved)
            if (self._alloc is not None and self._hol_block is not None
                    and self._hol_block[0] == head.rid
                    and self._alloc.num_free <= self._hol_block[1]
                    and self._release_epoch == self._hol_block[2]):
                break
            ok = (self._try_admit_chunked(head, slot) if self._chunked
                  else self._try_admit(head, slot))
            if not ok:
                if self._alloc is not None:
                    self._hol_block = (head.rid, self._alloc.num_free,
                                       self._release_epoch)
                break
            self._hol_block = None
            self._queue.popleft()
            admitted += 1
        return admitted

    def _live(self) -> int:
        """Slots that decode this step (bound and not still prefilling)."""
        return sum(r is not None and not r.prefilling for r in self._slots)

    def _stage_paged(self):
        """Copy the host block tables and lengths to their device mirrors
        through the pinned staging tensors, without a sync (the step's
        sync finishes the copy before the host writes them again)."""
        self._lens_np[:] = self._slot_len
        self._d_tables.copy_(self._h_tables, non_blocking=True)
        self._d_lens.copy_(self._h_lens, non_blocking=True)

    def step(self) -> int:
        """Admit queued requests, run a chunk tick when chunked, then
        decode one token (or run one spec tick) for every live slot.
        Returns the tokens produced this step (first tokens included)."""
        self._watchdog_beat()
        if self._retuner is not None:
            # a pending retune episode runs only on a quiesced engine
            self._retuner.on_tick()
        if self._profile is not None:
            # PADDLE_TPU_PROFILE=start:stop over decode ticks
            self._profile.on_step(self._timings["decode_steps"])
        self._m_queue.set(len(self._queue))
        produced = self._step()
        if self.watchdog is not None and not self.has_work:
            self.watchdog.idle()        # a quiet server is not a stall
        return produced

    def _watchdog_beat(self):
        """Start the stall watchdog on the first step when
        ``PADDLE_TPU_WATCHDOG_S`` arms it, then beat it."""
        if not self._wd_checked:
            self._wd_checked = True
            t = _watchdog.watchdog_seconds()
            if t is not None:
                self.watchdog = _watchdog.Watchdog(
                    t, label=f"decode_{self.telemetry_label}").arm()
        if self.watchdog is not None:
            self.watchdog.beat()

    def _step(self) -> int:
        self._retire_expired()
        t_admit = time.perf_counter()
        had_live = self._live() > 0
        admitted = self._admit()
        produced = 0
        if not self._chunked:
            produced = admitted
            if admitted and had_live:
                # live streams waited for these monolithic prefills
                self._timings["prefill_stall_ms"] += \
                    (time.perf_counter() - t_admit) * 1e3
        chunked_now = False
        # not gated on admission: a draining engine finishes the prompts
        # already bound to slots
        if self._chunked:
            ticks = self._timings["chunk_ticks"]
            produced += self._chunk_tick()
            chunked_now = self._timings["chunk_ticks"] > ticks
        if self._live() == 0:
            return produced
        if self._spec is not None:
            return produced + self._step_spec(chunked_now)
        paged = self.kv_layout == "paged"
        if paged:
            self._ensure_decode_room()
            # a preemption or capped retirement may have emptied slots
            if self._live() == 0:
                return produced
            self._timings["block_occupancy_sum"] += \
                self._alloc.num_in_use / self._alloc.capacity
        live = self._live()
        self._timings["occupancy_sum"] += live / self.batch_slots
        self._m_active.set(live)
        t0 = time.perf_counter()
        with torch.no_grad():
            with self._expert_stats():
                if paged:
                    self._stage_paged()
                    logits, _ = self.model.decode_step_paged(
                        self._d_next, self.cache, self._d_tables,
                        self._d_lens)
                else:
                    logits, _ = self.model.decode_step(
                        self._d_next, self.cache, self._d_active)
            nxt = self._sample(logits, self._d_temps, self._d_top_ps)
        # an idle row keeps its last token, as the JAX engine's host
        # mirror does (the row's routing counts in a MoE model's stats)
        self._d_next = torch.where(self._d_active > 0, nxt, self._d_next)
        # the ONE device->host copy of the step: the scheduler needs the
        # sampled ids for retirement
        nxt_host = nxt.tolist()
        self._note_decode_step(t0, chunked_now, ("decode", 0),
                               "megakernel_decode"
                               if self.model.gpt._megakernel_active()
                               else "decode")
        commit_now = time.perf_counter()
        for slot, req in enumerate(self._slots):
            # a still-prefilling row was inactive: its token is garbage
            if req is None or req.prefilling:
                continue
            tok = nxt_host[slot]
            self._slot_len[slot] += 1        # the token just appended
            req.generated.append(tok)
            req.token_times.append(commit_now)
            produced += 1
            self._timings["tokens_generated"] += 1
            self._retire_if_done(req, tok)
        self._note_tick("decode_tick", t0, live, active=live)
        return produced

    def _note_decode_step(self, t0: float, chunked_now: bool, key,
                          kind: str):
        ms = (time.perf_counter() - t0) * 1e3
        for slot, req in enumerate(self._slots):
            if req is not None and not req.prefilling:
                self._decode_rows_sum += 1
                self._decode_ctx_sum += int(self._slot_len[slot])
        self._timings["decode_host_syncs"] += 1
        record_host_sync()
        self._timings["decode_steps"] += 1
        self._timings["decode_steps_with_chunk"] += int(chunked_now)
        self._timings["decode_ms"] += ms
        self._exec(key, kind, ms)

    def _note_tick(self, kind: str, t0: float, tokens: int, **args):
        """A decode or spec tick's counters, its host span (``args`` as
        the span's) and its flight-recorder record."""
        self._m_ticks.inc()
        self._m_tokens.inc(tokens)
        now = time.perf_counter()
        if self._tracer.active:
            tr = self._tracer
            ts = tr.to_us(t0)
            tr.complete(kind, ts, tr.to_us(now) - ts, cat="serve", args=args)
        _flightrec.record(kind, dur_ms=(now - t0) * 1e3,
                          tick=self._timings["decode_steps"], tokens=tokens,
                          **args)
        _faults.maybe_hang(self._timings["decode_steps"])

    def _step_spec(self, chunked_now: bool) -> int:
        """One speculative tick for every live slot; commits each slot's
        accepted prefix plus one token, truncated at EOS and
        max_new_tokens.  One host sync."""
        k = self._spec.k
        # the window writes at slot_len .. slot_len + K: a slot without
        # room for it retires now, up to K tokens before a non-spec engine
        for req in list(self._slots):
            if (req is not None and not req.prefilling
                    and int(self._slot_len[req.slot]) + k + 1
                    > self.max_seq_len):
                self._timings["spec_capacity_retirements"] += 1
                self._retire(req)
        if self.kv_layout == "paged":
            self._ensure_decode_room(need_tokens=k + 1)
        live = self._live()
        if live == 0:
            return 0
        if self.kv_layout == "paged":
            self._timings["block_occupancy_sum"] += \
                self._alloc.num_in_use / self._alloc.capacity
        self._timings["occupancy_sum"] += live / self.batch_slots
        self._m_active.set(live)
        t0 = time.perf_counter()
        out = self._spec.tick().tolist()     # the tick's one host sync
        self._note_decode_step(t0, chunked_now, ("spec_tick", k),
                               "spec_verify")
        commit_now = time.perf_counter()
        self._timings["spec_ticks"] += 1
        self._timings["spec_slot_ticks"] += live
        produced = 0
        for slot, req in enumerate(list(self._slots)):
            if req is None or req.prefilling:
                continue
            n_emit = out[slot][k + 1]
            # the host mirrors the device advance (dense) or owns it
            # (paged); a truncation below retires the slot
            self._slot_len[slot] += n_emit
            emitted = []
            retired = False
            for tok in out[slot][:n_emit]:
                req.generated.append(tok)
                req.token_times.append(commit_now)
                emitted.append(tok)
                produced += 1
                self._timings["tokens_generated"] += 1
                if tok == req.eos_id or \
                        len(req.generated) >= req.max_new_tokens:
                    retired = True
                    self._retire(req)
                    break
            self._timings["spec_tokens_committed"] += len(emitted)
            if not retired and emitted:
                self._spec.after_commit(slot, emitted)
        self._note_tick("spec_tick", t0, produced, active=live,
                        committed=produced, k=k)
        return produced

    def step_or_raise(self) -> int:
        """``step()``, turning a wedged scheduler into an error: no
        progress, nothing active and a non-empty queue never resolves.
        Once an attached guard fired, it drains instead (in-flight slots
        finish, the queue parks in ``undelivered``), so a driver that
        only steps never spins on a preempted engine."""
        if (self._guard is not None and self._guard.preempted
                and not self._draining):
            self.undelivered.extend(self.drain(self._guard_timeout))
            return 0
        produced = self.step()
        if (produced == 0 and self.num_active == 0 and self._queue
                and self._admitting):
            raise RuntimeError("admission stalled: queued requests but no "
                               "free capacity and nothing active to retire")
        return produced

    def run(self) -> Dict[int, np.ndarray]:
        """Step until every queued request finished; returns
        ``{request id: generated token ids}``.  With a guard attached, a
        signal mid-run switches to a drain: in-flight slots finish and
        the still-queued requests land in ``undelivered``."""
        while self.has_work:
            if self._guard is not None and self._guard.preempted:
                self.undelivered.extend(self.drain(self._guard_timeout))
                break
            self.step_or_raise()
        return self.results

    def attach_preemption_guard(self, guard,
                                drain_timeout_s: Optional[float] = None):
        """Hook a ``distributed.resilience.PreemptionGuard``: once it
        fires, ``run``/``generate``/``step_or_raise`` stop admitting,
        finish the in-flight slots (bounded by ``drain_timeout_s``) and
        return."""
        self._guard = guard
        self._guard_timeout = drain_timeout_s
        return self

    def drain(self, timeout_s: Optional[float] = None) -> List[Request]:
        """Graceful shutdown: close admission, step until every in-flight
        slot retires (once ``timeout_s`` has passed the rest are
        force-retired with their partial output and flagged
        ``timed_out``), and return the still-queued requests in FIFO
        order.  Checks the pool leak-free (which flushes the prefix
        cache)."""
        self._draining = True
        t0 = time.perf_counter()
        try:
            while self.num_active > 0:
                if (timeout_s is not None
                        and time.perf_counter() - t0 > timeout_s):
                    for req in [r for r in self._slots if r is not None]:
                        self._timings["drain_forced_retirements"] += 1
                        req.timed_out = True
                        self._retire(req)
                    break
                self.step()
            leftover = list(self._queue)
            self._queue.clear()
            self.check_leak_free()
            return leftover
        finally:
            self._draining = False

    # ---- warmup ---------------------------------------------------------
    def warmup(self, buckets: Optional[List[int]] = None):
        """Run every kernel, library and lazy first-use step of the
        serving path once with throwaway tokens before traffic arrives:
        the prefill of each of ``buckets`` (default: the smallest; paged
        with a prefix cache also over a one-block prefix), or the chunk
        step when chunked; the samplers; the decode step (composed or
        megakernel); and, speculating, the draft's prefills and a tick.
        Loads each CUDA library (building it if missing), the int8 or
        e4m3 matmul's plans and the megakernel's tensor maps.  Leaves the
        engine clean: lengths 0, warmup blocks back in the pool and never
        in the radix cache."""
        if self.num_active or self._queue:
            raise RuntimeError("warmup() must run before traffic")
        with torch.no_grad():
            if self._chunked:
                self._warmup_chunked()
            elif self.kv_layout == "paged":
                self._warmup_paged(buckets)
            else:
                self._warmup_dense(buckets)
            if self._spec is not None:
                self._spec.warmup()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _zeros(self, *shape, dtype=torch.int64) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _warm_sample(self, logits):
        rows = logits.shape[0]
        self._sample(logits, self._zeros(rows, dtype=torch.float32),
                     torch.ones(rows, device=self.device))

    def _warm_decode(self):
        """A decode step and its sampler with every slot inactive (dense)
        or on all-null tables at length 0 (paged): the writes land above
        length 0 or in the null block."""
        b = self.batch_slots
        if self.kv_layout == "paged":
            self._stage_paged()
            logits, _ = self.model.decode_step_paged(
                self._zeros(b), self.cache, self._d_tables, self._d_lens)
        else:
            logits, _ = self.model.decode_step(self._zeros(b), self.cache,
                                               self._d_active)
        self._sample(logits, self._d_temps, self._d_top_ps)

    def _warmup_dense(self, buckets):
        for b in buckets or [self.buckets[0]]:
            logits, _ = self.model.prefill(self._zeros(1, b), self.cache, 0,
                                           1)
        self._warm_sample(logits)
        self._warm_decode()
        self.cache.lengths.zero_()

    def _warmup_paged(self, buckets):
        bs = self.block_size
        fit = min(self.blocks_per_slot, self._alloc.capacity)
        logits = None
        for b in buckets or [self.buckets[0]]:
            n = blocks_for(b, bs)
            # a bucket larger than the pool is never admitted
            if n > self._alloc.capacity:
                continue
            # the radix-hit prefill reads a one-block prefix first
            hit = self._prefix is not None and n + 1 <= fit
            blocks = self._alloc.alloc(n + hit)
            if blocks is None:
                raise RuntimeError("warmup needs an empty pool")
            row = np.zeros(self.blocks_per_slot, np.int32)
            row[:len(blocks)] = blocks
            row_d = torch.from_numpy(row).to(self.device)
            ids = self._zeros(1, b)
            logits, _ = self.model.prefill_paged(ids, self.cache, row_d, 0, 1)
            if hit:
                self.model.prefill_paged(ids, self.cache, row_d, bs, 1)
            self._alloc.decref(blocks)
        if logits is not None:
            self._warm_sample(logits)
        self._warm_decode()

    def _warmup_chunked(self):
        """The chunk step over all-zero tokens, advances and lengths (its
        writes land above length 0 or in the null block), the batch-wide
        graduation sampler and the decode step."""
        b, c = self.batch_slots, self.prefill_chunk
        toks = self._zeros(b, c)
        lens = self._zeros(b, dtype=torch.int32)
        adv = self._zeros(b, dtype=torch.int32)
        if self.kv_layout == "paged":
            logits, _ = self.model.prefill_chunk_paged(
                toks, self.cache, self._zeros(*self._tables.shape,
                                              dtype=torch.int32), lens, adv)
        else:
            logits, _ = self.model.prefill_chunk(toks, self.cache, lens, adv)
        self._sample(logits, self._d_temps, self._d_top_ps)
        self._warm_decode()

    # ---- paged pool upkeep --------------------------------------------
    def prefix_summary(self) -> Optional[dict]:
        """The radix cache's digest (fingerprint set, hit and eviction
        counters), or None without a prefix cache."""
        return self._prefix.summary() if self._prefix is not None else None

    def flush_prefix_cache(self) -> int:
        """Drop every radix-cache node (blocks a slot still uses survive
        under the slot's own reference).  Returns blocks released."""
        released = self._prefix.flush() if self._prefix is not None else 0
        if released:
            self._release_epoch += 1        # wake the head-of-line memo
        return released

    def check_leak_free(self):
        """Drained-engine invariant: with no active slots, no queue and a
        flushed prefix cache, every pool block is free."""
        assert self.num_active == 0 and not self._queue, \
            "leak check requires a drained engine"
        if self._alloc is not None:
            self.flush_prefix_cache()
            self._alloc.check_leak_free()

    def _moe_stats(self) -> dict:
        """The expert-balance columns of ``stats()``, as the JAX engine
        reports them: the load per expert, the assigned and dropped
        (capacity-overflow) assignments, the dropped rate and the
        max / mean skew.  One host read of the device accumulator."""
        load = self.moe_load()
        assigned = self._moe_assigned
        dropped = max(0.0, assigned - float(load.sum())) \
            if load is not None else 0.0
        s = {"moe_num_experts": int(self.model.cfg.moe_num_experts),
             "ep": 1,
             "moe_assigned_tokens": round(assigned, 3),
             "moe_dropped_tokens": round(dropped, 3),
             "moe_expert_load": [round(float(v), 1) for v in load]
             if load is not None else None,
             "moe_dropped_rate": round(dropped / assigned, 4)
             if assigned else 0.0,
             "moe_load_skew": None}
        if load is not None and float(load.sum()) > 0:
            s["moe_load_skew"] = round(
                float(load.max()) / max(float(load.mean()), 1e-9), 3)
        return s

    def stats(self) -> dict:
        """Cumulative wall-clock and counters.  Every step ends in a
        device-to-host copy, so the host clock measures device work."""
        t = self._timings
        s = dict(t)
        s.pop("block_occupancy_sum")
        s["slot_occupancy"] = round(t["occupancy_sum"]
                                    / max(t["decode_steps"], 1), 4)
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
        s["kv_layout"] = self.kv_layout
        s["kv_dtype"] = self.kv_dtype or "dense"
        s["chunked_prefill"] = self._chunked
        # whether decode steps run the fused per-layer op (one device: the
        # JAX engine's tp == 1 case; a MoE model keeps the composed step)
        s["decode_megakernel"] = self.model.gpt._megakernel_active()
        s["prefill_chunk"] = self.prefill_chunk
        spec_keys = ("spec_ticks", "spec_tokens_committed", "spec_slot_ticks",
                     "spec_capacity_retirements")
        if self._spec is not None:
            s["spec_k"] = self._spec.k
            # committed tokens per (tick x live slot): 1.0 is what a plain
            # decode step gives for its host sync, K + 1 the ceiling
            ticks = t["spec_slot_ticks"]
            s["accepted_tokens_per_tick"] = (
                t["spec_tokens_committed"] / ticks if ticks else 0.0)
            s["spec_acceptance_rate"] = (
                (t["spec_tokens_committed"] - ticks)
                / max(ticks * self._spec.k, 1))
        else:
            for key in spec_keys:
                s.pop(key)
        if self.kv_layout == "paged":
            s["kv_block_size"] = self.block_size
            s["kv_blocks_total"] = self._alloc.capacity
            s["kv_blocks_in_use"] = self._alloc.num_in_use
            s["block_occupancy"] = (t["block_occupancy_sum"]
                                    / max(t["decode_steps"], 1))
            if self._prefix is not None:
                s.update(self._prefix.stats)
        else:
            s.pop("preemptions")
            s.pop("memory_capped_retirements")
        if self._is_moe:
            s.update(self._moe_stats())
        # per-request records; a queue-expired request has no TTFT and is
        # counted, not averaged
        s["per_request"] = dict(self.request_stats)
        ttfts = [r["ttft_ms"] for r in self.request_stats.values()
                 if r["ttft_ms"] is not None]
        if ttfts:
            p50, p99 = np.percentile(ttfts, [50, 99])
            s["ttft_ms_p50"] = round(float(p50), 3)
            s["ttft_ms_p99"] = round(float(p99), 3)
        # inter-token gaps pooled across finished requests
        gaps = [g for r in self.request_stats.values()
                for g in r["itl_gaps_ms"]]
        if gaps:
            p50, p99 = np.percentile(gaps, [50, 99])
            s["itl_ms_p50"] = round(float(p50), 3)
            s["itl_ms_p99"] = round(float(p99), 3)
        # host dict reads, no device read: the roofline digest (None in
        # the port), the HBM ledger and the doctor's verdicts
        s["exec_profile"] = _exec_registry.profile(self._exec_component)
        s["hbm"] = _exec_registry.ledger().snapshot()
        s["doctor"] = _doctor.diagnose(s, kind="serve")
        return s
