"""Live retune tier, ``PADDLE_TPU_AUTOTUNE=live`` (counterpart of
``paddle_tpu/autotune/live.py``).

Narrower than the offline controller, since a live replica is serving:

- **edge-triggered, one episode a signal**: an SLO monitor's regression
  (or breach) verdict schedules an episode; a monitor still regressed
  at the next check schedules none (the latch resets on a healthy
  verdict), and a cooldown bounds the episode rate across signals;
- **quiesced engine only**: the pending episode runs from the engine's
  tick hook when no slot is active and the queue is empty;
- **hot-apply of table-only knobs**: the episode times each warmed
  prefill bucket on the live engine (the model's ``prefill`` /
  ``prefill_paged`` at that bucket, the kernels already built and
  loaded), merges the list by the pad-up rule and, when the merged
  subset lowers the mean prefill cost beyond the noise floor, writes it
  to ``engine.buckets`` (host state read by ``_bucket_for``: no
  restart, nothing built, no new step kind) and persists it to the
  tuning table (op ``prefill_buckets``) with autotune provenance;
- **rails**: a failing episode keeps the incumbent list and dumps an
  ``autotune-rollback`` bundle.  The engine serves on; the failure is
  in the bundle and in ``failures``.

:class:`TrainerRetuner` is advisory: train knobs rebuild the step, so a
sustained step-time regression runs the doctor once over the trainer's
host timings and ships its ranked verdicts as a flight-recorder event.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..observability import flightrec as _flightrec
from ..utils import tuning as _tuning

__all__ = ["LiveRetuner", "TrainerRetuner", "arm_engine", "arm_trainer",
           "PAD_UP_FACTOR", "LIVE_NOISE_FLOOR"]

# keep a bucket only when using it beats padding up to the next kept
# bucket by this factor
PAD_UP_FACTOR = 1.25
# a merged list must cut the mean measured prefill cost by more than
# this fraction to be applied
LIVE_NOISE_FLOOR = 0.02


class LiveRetuner:
    """SLO-triggered, quiesce-gated prefill-bucket retuner for a
    serving engine (see module docstring for the contract)."""

    def __init__(self, engine, *, cooldown_s: float = 300.0,
                 noise_floor: float = LIVE_NOISE_FLOOR,
                 repeats: int = 3):
        self.engine = engine
        self.cooldown_s = float(cooldown_s)
        self.noise_floor = float(noise_floor)
        self.repeats = max(1, int(repeats))
        self.episodes = 0
        self.applied: List[dict] = []
        self.failures: List[str] = []
        # the last episode's timings, merged list and improvement
        self.last_episode: Optional[dict] = None
        self._pending = False
        self._latched = False           # signal seen, not yet healthy
        self._last_episode_t: Optional[float] = None

    # -- signal side ----------------------------------------------------
    def notify_slo(self, verdict: dict) -> bool:
        """Feed one ``SLOMonitor.check()`` verdict (an ``add_listener``
        callback); True when this call scheduled an episode.  A monitor
        still regressed at every check schedules one episode (the latch),
        and none inside the cooldown."""
        bad = bool(verdict.get("regressed") or verdict.get("breached"))
        if not bad:
            self._latched = False
            return False
        if self._latched:
            return False
        self._latched = True
        now = time.monotonic()
        if self._last_episode_t is not None and \
                now - self._last_episode_t < self.cooldown_s:
            return False
        self._pending = True
        _flightrec.note_event("autotune_live_scheduled",
                              p99_ms=verdict.get("p99_ms"),
                              regressed=bool(verdict.get("regressed")),
                              breached=bool(verdict.get("breached")))
        return True

    # -- engine side ----------------------------------------------------
    def on_tick(self) -> bool:
        """The engine's tick hook: O(1) when nothing is pending; runs a
        scheduled episode only on a quiesced engine (no active slot, an
        empty queue), so trials never displace traffic."""
        if not self._pending:
            return False
        eng = self.engine
        if eng.num_active or len(getattr(eng, "_queue", ())):
            return False
        self._pending = False
        self._last_episode_t = time.monotonic()
        try:
            self._episode()
        except Exception as e:          # a retune must never kill serving
            self.failures.append(f"{type(e).__name__}: {e}")
            _flightrec.dump("autotune-rollback",
                            extra={"autotune": {
                                "tier": "live",
                                "reason": "episode-error",
                                "error": f"{type(e).__name__}: {e}"}})
        return True

    def _episode(self) -> None:
        """One retune episode: time warmed prefill buckets, re-merge,
        hot-apply an improved subset, persist with provenance."""
        self.episodes += 1
        eng = self.engine
        old = list(eng.buckets)
        _flightrec.note_event("autotune_live_episode",
                              episode=self.episodes, buckets=old)
        times = self._time_buckets(old)
        kept = self._merge(old, times)
        old_cost = self._mean_cost(old, times)
        new_cost = self._mean_cost(kept, times)
        improvement = 0.0 if old_cost <= 0 else \
            (old_cost - new_cost) / old_cost
        self.last_episode = {"old": old, "merged": kept,
                             "improvement": round(improvement, 6),
                             "times_ms": {b: round(t, 4)
                                          for b, t in times.items()}}
        if kept != old and improvement > self.noise_floor:
            # a subset of the warmed buckets: a host-side write (no
            # restart, nothing built)
            eng.buckets = kept
            rec = {"old": old, "new": kept,
                   "improvement": round(improvement, 6),
                   "times_ms": {str(b): round(t, 3)
                                for b, t in times.items()}}
            self.applied.append(rec)
            _flightrec.note_event("autotune_live_applied", **rec)
            try:
                _tuning.record(
                    "prefill_buckets",
                    (_tuning.device_kind(), eng.max_seq_len), kept,
                    source="autotune", run=f"live-{self.episodes}",
                    improvement=improvement)
            except Exception:
                pass                    # persistence is best-effort
        else:
            _flightrec.note_event("autotune_live_noop",
                                  episode=self.episodes,
                                  improvement=round(improvement, 6))

    # -- measurement ----------------------------------------------------
    def _time_buckets(self, buckets) -> dict:
        """Median wall ms of each warmed bucket's prefill on the live
        engine (its model, cache and pool): one throwaway prompt a call,
        written at length 0 of slot 0 (dense) or into blocks taken from
        the pool and given back (paged), synchronized on the card."""
        eng = self.engine
        model, dev = eng.model, eng.device
        out = {}
        with torch.no_grad():
            for b in buckets:
                ids = torch.zeros((1, b), dtype=torch.int64, device=dev)
                samples = []
                for _ in range(self.repeats):
                    t0 = time.perf_counter()
                    if eng.kv_layout == "paged":
                        from ..inference.paged_kv import blocks_for
                        n = blocks_for(b, eng.block_size)
                        blocks = eng._alloc.alloc(n)
                        if blocks is None:  # busier than quiesce said
                            raise RuntimeError("no free blocks for trial")
                        row = np.zeros(eng.blocks_per_slot, np.int32)
                        row[:n] = blocks
                        try:
                            model.prefill_paged(
                                ids, eng.cache,
                                torch.from_numpy(row).to(dev), 0, 1)
                            if dev.type == "cuda":
                                torch.cuda.synchronize(dev)
                        finally:
                            eng._alloc.decref(blocks)
                    else:
                        model.prefill(ids, eng.cache, 0, 1)
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                    samples.append((time.perf_counter() - t0) * 1e3)
                out[b] = float(np.median(samples))
        if eng.kv_layout != "paged":
            # the trial tokens at slot 0 stay masked, as after warmup()
            eng.cache.lengths.zero_()
        return out

    @staticmethod
    def _merge(buckets, times) -> list:
        """The pad-up rule: walk from the largest bucket down and keep a
        bucket only when it is more than ``PAD_UP_FACTOR`` cheaper than
        the next kept (larger) one; the largest stays (capacity)."""
        order = sorted(buckets)
        kept = [order[-1]]
        for b in reversed(order[:-1]):
            nxt = kept[0]
            if times[b] * PAD_UP_FACTOR < times[nxt]:
                kept.insert(0, b)
        return kept

    @staticmethod
    def _mean_cost(kept, times) -> float:
        """Expected prefill cost under uniform prompt lengths: each
        length pays the cheapest kept bucket that fits it, weighted by
        the fraction of lengths that land in it."""
        ks = sorted(kept)
        total, lo = 0.0, 0
        top = ks[-1]
        for b in ks:
            total += times[b] * (b - lo) / top
            lo = b
        return total


class TrainerRetuner:
    """Advisory live tier of ``SpmdTrainer``: a sustained step-time
    regression on the host step timer (no device read) runs the doctor
    once over the trainer's timings and ships its ranked verdicts,
    actions included, as a flight-recorder event.  One episode a
    regression (healthy-reset latch), a cooldown in steps."""

    def __init__(self, trainer, *, window: int = 32,
                 factor: float = 1.5, cooldown_steps: int = 256):
        self.trainer = trainer
        self.window = int(window)
        self.factor = float(factor)
        self.cooldown_steps = int(cooldown_steps)
        self.episodes = 0
        self.last_advice: Optional[list] = None
        self._recent: List[float] = []
        self._baseline_ms: Optional[float] = None
        self._steps = 0
        self._latched = False
        self._last_episode_step: Optional[int] = None

    def on_step(self, step_ms: Optional[float]) -> bool:
        """The per-step hook (host arithmetic only); True when this step
        fired an advisory episode."""
        self._steps += 1
        if step_ms is None:
            return False
        self._recent.append(float(step_ms))
        if len(self._recent) > self.window:
            self._recent.pop(0)
        if len(self._recent) < self.window:
            return False
        med = float(np.median(self._recent))
        if self._baseline_ms is None:
            self._baseline_ms = med     # the first full window
            return False
        self._baseline_ms = min(self._baseline_ms, med)
        if med <= self._baseline_ms * self.factor:
            self._latched = False
            return False
        if self._latched:
            return False
        self._latched = True
        if self._last_episode_step is not None and \
                self._steps - self._last_episode_step < \
                self.cooldown_steps:
            return False
        self._last_episode_step = self._steps
        self._episode(med)
        return True

    def _episode(self, median_ms: float) -> None:
        self.episodes += 1
        t = dict(getattr(self.trainer, "_timings", {}) or {})
        stats = {k: t.get(k) for k in
                 ("dispatch_ms", "sync_ms", "data_wait_ms", "h2d_ms",
                  "steps_timed") if t.get(k) is not None}
        from ..observability import doctor as _doctor
        try:
            self.last_advice = _doctor.diagnose(stats, "train")
        except Exception:
            self.last_advice = []
        _flightrec.note_event(
            "autotune_train_advice", episode=self.episodes,
            median_step_ms=round(median_ms, 3),
            baseline_step_ms=round(self._baseline_ms or 0.0, 3),
            advice=self.last_advice[:3])


def arm_engine(engine) -> Optional[LiveRetuner]:
    """A ``LiveRetuner`` for ``engine`` when ``PADDLE_TPU_AUTOTUNE=live``
    (the engine's constructor calls it), else None."""
    from . import autotune_mode
    if autotune_mode() != "live":
        return None
    return LiveRetuner(engine)


def arm_trainer(trainer) -> Optional[TrainerRetuner]:
    """A ``TrainerRetuner`` for ``trainer`` under the same tier, else
    None."""
    from . import autotune_mode
    if autotune_mode() != "live":
        return None
    return TrainerRetuner(trainer)
