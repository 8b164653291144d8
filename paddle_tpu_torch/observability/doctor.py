"""Rule-based bottleneck attribution (counterpart of
``paddle_tpu/observability/doctor.py``).

``diagnose(stats)`` runs a fixed rule table over the numbers a trainer,
an engine or a load report already carries and returns a ranked verdict
list::

    [{"bottleneck": "host-sync-bound",
      "evidence": {"host_syncs_measured": 20, "steps": 10,
                   "syncs_per_step": 2.0},
      "knob": "keep StepResult lazy ...", "score": 2.0,
      "action": {"op": None, "param": None, "env": None,
                 "candidates": []}}]

A rule fires only on evidence present in the dict (a missing or None
signal skips it), scores put each signal on a comparable "fraction of
the step it costs" scale, and the output is JSON-safe, so it rides
``trainer.stats['doctor']``, ``engine.stats()['doctor']`` and the load
report.  The rule table, thresholds, knob texts and actions are the JAX
package's: the same stats dict gives the same verdicts in both
packages.  The roofline rules read ``stats['exec_profile']``: the
registry's digest once its entries are analyzed
(``exec_registry.analyze_all``, the analytic costs of
``cost_model``), else None, and then the rules take their threshold
fallbacks.

The doctor reports; it enforces nothing.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

# one source for the registry's MFU target and the ledger's oom_risk line
from .exec_registry import MFU_TARGET as MFU_GAP_MIN
from .exec_registry import OOM_HEADROOM_MIN as HBM_HEADROOM_MIN

__all__ = ["diagnose", "RULES", "Rule"]

# thresholds, one place (tests build fixtures against these)
COMM_FRACTION_MIN = 0.25
DATA_WAIT_FRACTION_MIN = 0.25
H2D_FRACTION_MIN = 0.25
SYNCS_PER_STEP_MIN = 0.75
SYNC_MS_FRACTION_MIN = 0.25
# fraction rules need a real window behind them: a 3-step CPU smoke
# whose whole wall clock is a few ms must not read as "bound" on
# anything — the fractions are noise until the window has substance
MIN_WINDOW_MS = 50.0
BLOCK_OCCUPANCY_MIN = 0.85
SPEC_ACCEPTANCE_MIN = 0.3
PREFIX_HIT_RATE_MIN = 0.15
PREFIX_QUERIES_MIN = 20
SLOT_OCCUPANCY_MIN = 0.5
# chunked prefill: share of the decode window spent running
# monolithic prefills while decode-phase slots sat idle
PREFILL_STALL_FRACTION_MIN = 0.15
# expert-parallel MoE serving: capacity-overflow drop rate
# and max/mean expert-load skew past these read as imbalance; the rule
# stays silent until real routed traffic backs the window
MOE_DROP_RATE_MAX = 0.05
MOE_LOAD_SKEW_MAX = 2.0
MOE_ASSIGNED_MIN = 64.0
# roofline/ledger rules (exec registry evidence)
HBM_BW_FRAC_MIN = 0.5      # decode pushing >= half the HBM roof
# multi-slice (DCN) tier rules
SLICE_AGE_FRAC_MIN = 0.5   # heartbeat age past half the slice timeout
DCN_SHARE_MIN = 0.4        # DCN bytes >= this share of collective bytes
DCN_COMM_FRACTION_MIN = 0.15


def _num(stats: dict, key: str) -> Optional[float]:
    v = stats.get(key)
    return float(v) if isinstance(v, (int, float)) and not \
        isinstance(v, bool) else None


class Rule:
    """One named check: ``check(stats)`` returns (evidence, score) when
    it fires, None when the signal is absent or healthy.

    ``action`` is the MACHINE-readable form of ``knob``: a
    dict ``{"op", "param", "env", "candidates"}`` — or a callable
    ``(stats, evidence) -> dict`` when the advice depends on the
    evidence (e.g. spec_k candidates below the CURRENT k).  ``op`` is
    the tuning-table namespace a winner commits under (None for advice
    with no table entry), ``param`` the config axis an autotune
    controller mutates (None for purely behavioral advice), ``env`` the
    equivalent environment knob, ``candidates`` the suggested trial
    values ([] defers to the controller's own axis defaults)."""

    def __init__(self, bottleneck: str, kinds: tuple, knob: str,
                 check: Callable[[dict], Optional[tuple]],
                 action=None):
        self.bottleneck = bottleneck
        self.kinds = kinds
        self.knob = knob
        self.check = check
        self.action = action

    def action_for(self, stats: dict, evidence: dict) -> Optional[dict]:
        """Resolve the structured action for one firing (JSON-safe copy;
        None when the rule has no machine-actionable form)."""
        a = self.action
        if callable(a):
            try:
                a = a(stats, evidence)
            except Exception:
                return None
        if not isinstance(a, dict):
            return None
        return {"op": a.get("op"), "param": a.get("param"),
                "env": a.get("env"),
                "candidates": list(a.get("candidates") or [])}


# ---------------------------------------------------------------------------
# train rules
# ---------------------------------------------------------------------------
def _comm_bound(s: dict):
    cf = _num(s, "comm_fraction")
    if cf is None or cf < COMM_FRACTION_MIN:
        return None
    ev = {"comm_fraction": round(cf, 4)}
    by_op = s.get("comm_by_op")
    if isinstance(by_op, dict) and by_op:
        top = max(by_op, key=lambda op: by_op[op].get("bytes", 0))
        ev["top_op"] = top
        ev["top_op_bytes"] = int(by_op[top].get("bytes", 0))
    return ev, cf


def _data_starved(s: dict):
    wait = _num(s, "data_wait_ms")
    disp = _num(s, "dispatch_ms")
    if wait is None or disp is None or (wait + disp) < MIN_WINDOW_MS:
        return None
    frac = wait / (wait + disp)
    if frac < DATA_WAIT_FRACTION_MIN:
        return None
    return {"data_wait_ms": round(wait, 2),
            "dispatch_ms": round(disp, 2),
            "data_wait_fraction": round(frac, 4)}, frac


def _h2d_bound(s: dict):
    h2d = _num(s, "h2d_ms")
    disp = _num(s, "dispatch_ms")
    if h2d is None or disp is None or (h2d + disp) < MIN_WINDOW_MS:
        return None
    frac = h2d / (h2d + disp)
    if frac < H2D_FRACTION_MIN:
        return None
    return {"h2d_ms": round(h2d, 2), "dispatch_ms": round(disp, 2),
            "h2d_fraction": round(frac, 4)}, frac


def _host_sync_bound(s: dict):
    # preferred evidence: a measured sync count over a step window
    # (bench rows / the smoke fixture carry host_syncs_measured+steps);
    # fallback: the trainer's cumulative sync wall-time share
    syncs = _num(s, "host_syncs_measured")
    steps = _num(s, "steps") or _num(s, "steps_timed")
    if syncs is not None and steps and steps > 0:
        per_step = syncs / steps
        if per_step < SYNCS_PER_STEP_MIN:
            return None
        return {"host_syncs_measured": int(syncs), "steps": int(steps),
                "syncs_per_step": round(per_step, 3)}, min(per_step, 2.0)
    sync_ms = _num(s, "sync_ms")
    disp = _num(s, "dispatch_ms")
    if sync_ms is None or disp is None or \
            (sync_ms + disp) < MIN_WINDOW_MS:
        return None
    frac = sync_ms / (sync_ms + disp)
    if frac < SYNC_MS_FRACTION_MIN:
        return None
    return {"sync_ms": round(sync_ms, 2), "dispatch_ms": round(disp, 2),
            "sync_fraction": round(frac, 4)}, frac


def _recompile_churn(s: dict):
    # only the POST-WARMUP delta is evidence (engine-lifetime compile
    # counts legitimately include warmup); bench rows and the smokes
    # carry it as xla_compiles_measured
    n = _num(s, "xla_compiles_measured")
    if n is None or n <= 0:
        return None
    return {"xla_compiles_measured": int(n)}, min(1.0, 0.5 + n / 10.0)


# ---------------------------------------------------------------------------
# serve rules
# ---------------------------------------------------------------------------
def _kv_pressure(s: dict):
    occ = _num(s, "block_occupancy")
    pre = _num(s, "preemptions") or 0.0
    if (occ is None or occ < BLOCK_OCCUPANCY_MIN) and pre <= 0:
        return None
    ev = {}
    if occ is not None:
        ev["block_occupancy"] = round(occ, 4)
    if pre:
        ev["preemptions"] = int(pre)
    score = max(occ or 0.0, min(1.0, 0.5 + pre / 20.0))
    return ev, score


def _low_spec_acceptance(s: dict):
    acc = _num(s, "spec_acceptance_rate")
    if acc is None or acc >= SPEC_ACCEPTANCE_MIN:
        return None
    ev = {"spec_acceptance_rate": round(acc, 4)}
    apt = _num(s, "accepted_tokens_per_tick")
    if apt is not None:
        ev["accepted_tokens_per_tick"] = round(apt, 3)
    return ev, 1.0 - acc


def _prefix_cold(s: dict):
    hit = _num(s, "prefix_hit_rate")
    q = _num(s, "prefix_queries")
    if hit is None or q is None or q < PREFIX_QUERIES_MIN or \
            hit >= PREFIX_HIT_RATE_MIN:
        return None
    return {"prefix_hit_rate": round(hit, 4),
            "prefix_queries": int(q)}, 0.5 * (1.0 - hit)


def _prefill_stall(s: dict):
    """Monolithic prefill stalls running decodes: the engine's
    ``prefill_stall_ms`` counter accumulates the wall time prefill
    executables ran while decode-phase requests sat idle in their
    slots.  Evidence is the stall's share of the decode
    window; chunked mode zeroes the counter by construction, so the
    rule is structurally silent once its own advice is taken."""
    if s.get("chunked_prefill"):
        return None                     # the fix is already on
    stall = _num(s, "prefill_stall_ms")
    dec = _num(s, "decode_ms")
    if not stall or dec is None or (stall + dec) < MIN_WINDOW_MS:
        return None
    frac = stall / (stall + dec)
    if frac < PREFILL_STALL_FRACTION_MIN:
        return None
    ev = {"prefill_stall_ms": round(stall, 2),
          "decode_ms": round(dec, 2),
          "stall_fraction": round(frac, 4)}
    p99 = _num(s, "itl_ms_p99")
    if p99 is not None:
        ev["itl_ms_p99"] = round(p99, 3)
    return ev, frac


def _idle_slots(s: dict):
    occ = _num(s, "slot_occupancy")
    pre = _num(s, "preemptions") or 0.0
    if occ is None or occ >= SLOT_OCCUPANCY_MIN or pre > 0:
        # preemption-driven emptiness is kv-pressure's verdict, not
        # admission's
        return None
    steps = _num(s, "decode_steps")
    if steps is None or steps < 8:      # too few ticks to call it
        return None
    return {"slot_occupancy": round(occ, 4),
            "decode_steps": int(steps)}, 0.5 * (1.0 - occ)


def _exec_prof(s: dict, *kinds) -> Optional[dict]:
    """The exec-registry roofline digest riding stats['exec_profile']
    (observability.exec_registry.profile): first matching kind's row,
    or None.  Nominal-peak digests (host backends) are ignored unless
    PADDLE_TPU_ROOFLINE_DOCTOR=1 forces them — a CPU run must not read
    as a device roofline verdict."""
    prof = s.get("exec_profile")
    if not isinstance(prof, dict):
        return None
    peaks = prof.get("_peaks") or {}
    if peaks.get("peaks_nominal") and \
            os.environ.get("PADDLE_TPU_ROOFLINE_DOCTOR") != "1":
        return None
    for k in kinds:
        row = prof.get(k)
        if isinstance(row, dict):
            return row
    return None


def _hbm_heavy_decode(s: dict):
    """Roofline-aware decode verdict: with the exec registry analyzed,
    the evidence is the MEASURED bandwidth fraction ("decode achieves
    72% of peak HBM BW → bandwidth-bound"); without it, fall back to
    the old threshold heuristic (bytes/token with no byte-saver on)."""
    steps = _num(s, "decode_steps")
    if steps is None or steps < 8:
        return None
    kv = s.get("kv_dtype")
    mk = s.get("decode_megakernel")
    saver_on = kv not in (None, "dense") or bool(mk)
    row = _exec_prof(s, "decode", "megakernel_decode", "spec_verify")
    if row is not None and row.get("bound"):
        # measured roofline evidence is AUTHORITATIVE: a compute-bound
        # or below-the-floor decode must not fall through to the byte
        # heuristic and contradict the measurement
        if row["bound"] != "bandwidth" or \
                row.get("hbm_bw_frac") is None or \
                float(row["hbm_bw_frac"]) < HBM_BW_FRAC_MIN:
            return None
        frac = float(row["hbm_bw_frac"])
        ev = {"hbm_bw_frac": round(frac, 4),
              "achieved_hbm_gbps": row.get("achieved_hbm_gbps"),
              "arithmetic_intensity": row.get("arithmetic_intensity"),
              "ridge_ai": row.get("ridge_ai"),
              "bound": "bandwidth",
              "kv_dtype": kv or "dense",
              "decode_megakernel": bool(mk)}
        if row.get("mfu") is not None:
            ev["mfu"] = row["mfu"]
        # a byte-saver already on shrinks the verdict to informational
        return ev, (min(frac, 1.0) if not saver_on else 0.15)
    # threshold fallback (pre-registry evidence only)
    hbm = _num(s, "decode_hbm_bytes_per_tok")
    if hbm is None or saver_on:
        return None
    return {"decode_hbm_bytes_per_tok": int(hbm),
            "kv_dtype": kv or "dense",
            "decode_megakernel": bool(mk)}, 0.3


def _roofline_train(s: dict):
    """Train-step roofline attribution: the fused step's measured MFU
    against the 45% target, classified compute- vs bandwidth-bound so
    the knob is the right one (quantize/flash for compute, remat/batch
    for bandwidth)."""
    row = _exec_prof(s, "train_step", "pipeline_tick")
    if row is None or row.get("mfu") is None or not row.get("bound"):
        return None
    mfu = float(row["mfu"])
    if mfu >= MFU_GAP_MIN:
        return None                     # at/near target: nothing to say
    ev = {"mfu": round(mfu, 4), "bound": row["bound"],
          "arithmetic_intensity": row.get("arithmetic_intensity"),
          "ridge_ai": row.get("ridge_ai"),
          "mean_ms": row.get("mean_ms")}
    if row.get("hbm_bw_frac") is not None:
        ev["hbm_bw_frac"] = row["hbm_bw_frac"]
    if row.get("gap_share") is not None:
        ev["gap_share"] = row["gap_share"]
    return ev, min(1.0, (MFU_GAP_MIN - mfu) / MFU_GAP_MIN)


def _oom_risk(s: dict):
    """HBM-ledger headroom: tracked state + worst executable temp
    against device capacity.  Fires before the OOM does."""
    h = s.get("hbm")
    if not isinstance(h, dict):
        return None
    frac = h.get("headroom_frac")
    if not isinstance(frac, (int, float)) or frac >= HBM_HEADROOM_MIN:
        return None
    ev = {"headroom_frac": round(float(frac), 4),
          "tracked_bytes": h.get("tracked_bytes"),
          "capacity_bytes": h.get("capacity_bytes"),
          "exec_temp_bytes": h.get("exec_temp_bytes")}
    if h.get("exec_temp_worst"):
        ev["exec_temp_worst"] = h["exec_temp_worst"]
    return ev, min(1.0, 1.0 - float(frac))


# ---------------------------------------------------------------------------
# evidence-dependent actions (callables: (stats, evidence) -> action dict)
# ---------------------------------------------------------------------------
def _spec_k_action(s: dict, ev: dict) -> dict:
    """Candidates are spec_k values BELOW the current window — a low
    acceptance rate never argues for drafting further ahead."""
    cur = s.get("spec_k")
    cands: list = []
    if isinstance(cur, (int, float)) and not isinstance(cur, bool):
        k = int(cur)
        while k > 1:
            k //= 2
            cands.append(max(k, 1))
            if cands[-1] == 1:
                break
    return {"op": None, "param": "spec_k", "env": "PADDLE_TPU_SPEC_K",
            "candidates": cands or [1, 2]}


def _decode_bw_action(s: dict, ev: dict) -> dict:
    """First byte-saver not already on: megakernel, then int8 KV, then
    speculative decoding to amortize the streamed bytes."""
    if not s.get("decode_megakernel"):
        return {"op": "megakernel_blocks", "param": "decode_megakernel",
                "env": "PADDLE_TPU_DECODE_MEGAKERNEL",
                "candidates": [True]}
    if s.get("kv_dtype") in (None, "dense"):
        return {"op": None, "param": "kv_dtype",
                "env": "PADDLE_TPU_KV_DTYPE", "candidates": ["int8"]}
    return {"op": None, "param": "spec_k", "env": "PADDLE_TPU_SPEC_K",
            "candidates": [2, 4]}


def _mfu_action(s: dict, ev: dict) -> dict:
    """Compute-bound gap → cheaper math (quantize); bandwidth-bound →
    recompute less (remat policy A/B) so the bytes drop."""
    if ev.get("bound") == "compute":
        return {"op": "qmm_tiles", "param": "quantize",
                "env": "BENCH_QUANTIZE", "candidates": ["int8"]}
    return {"op": "remat_policy", "param": "remat_policy", "env": None,
            "candidates": ["off", "dots_no_batch", "dots", "full"]}


def _oom_action(s: dict, ev: dict) -> dict:
    """Serving evidence (kv_dtype/decode slots present) → shrink the KV;
    training → turn remat up."""
    if "kv_dtype" in s or "decode_steps" in s or "block_occupancy" in s:
        return {"op": None, "param": "kv_dtype",
                "env": "PADDLE_TPU_KV_DTYPE", "candidates": ["int8"]}
    return {"op": "remat_policy", "param": "remat_policy", "env": None,
            "candidates": ["full", "dots"]}


def _expert_imbalance(s: dict):
    """MoE serving routes tokens badly: capacity overflow is DROPPING
    token→expert assignments (quality loss — the dropped token skips
    its expert FFN), or the hottest expert carries a multiple of the
    mean load (its device bounds every a2a round-trip while the cold
    experts idle).  Evidence only on real traffic."""
    n_exp = _num(s, "moe_num_experts")
    assigned = _num(s, "moe_assigned_tokens")
    if not n_exp or assigned is None or assigned < MOE_ASSIGNED_MIN:
        return None
    drop = _num(s, "moe_dropped_rate") or 0.0
    skew = _num(s, "moe_load_skew")
    if drop < MOE_DROP_RATE_MAX and \
            (skew is None or skew < MOE_LOAD_SKEW_MAX):
        return None
    ev = {"moe_dropped_rate": round(drop, 4),
          "moe_num_experts": int(n_exp),
          "moe_assigned_tokens": round(assigned, 1)}
    if skew is not None:
        ev["moe_load_skew"] = round(skew, 3)
    ep = _num(s, "ep")
    if ep and ep > 1:
        ev["ep"] = int(ep)
    load = s.get("moe_expert_load")
    if isinstance(load, (list, tuple)) and load:
        ev["hottest_expert"] = max(range(len(load)),
                                   key=lambda i: load[i])
    score = max(drop / MOE_DROP_RATE_MAX,
                (skew or 0.0) / MOE_LOAD_SKEW_MAX) * 0.5
    return ev, min(score, 1.0)


def _moe_imbalance_action(s: dict, ev: dict) -> dict:
    """Overflow drops → more room per expert (capacity factor above
    the training default).  Pure skew with speculative decoding on →
    shrink the verify burst first (spec_k multiplies the tokens a hot
    expert sees per tick); otherwise the capacity raise still buys
    headroom for the hot expert."""
    if ev.get("moe_dropped_rate", 0.0) < MOE_DROP_RATE_MAX \
            and s.get("spec_k"):
        return _spec_k_action(s, ev)
    return {"op": None, "param": "moe_capacity_factor", "env": None,
            "candidates": [1.5, 2.0, 2.5]}


def _slice_unhealthy(s: dict):
    """A DCN slice's heartbeat is stale (past half its timeout) or
    already declared dead — the membership layer is about to (or did)
    escalate; evidence names the worst slice so an operator can find
    the sick hosts before the reform, not after."""
    ages = s.get("slice_heartbeat_ages")
    timeout = _num(s, "slice_timeout_s")
    if not isinstance(ages, dict) or not ages or not timeout \
            or timeout <= 0:
        return None
    worst_id, worst = None, -1.0
    for sid, age in ages.items():
        if isinstance(age, (int, float)) and not isinstance(age, bool) \
                and float(age) > worst:
            worst_id, worst = sid, float(age)
    dead = s.get("slices_dead") or []
    if worst_id is None and not dead:
        return None
    frac = (worst / timeout) if worst >= 0 else 0.0
    if frac < SLICE_AGE_FRAC_MIN and not dead:
        return None
    ev = {"timeout_s": timeout}
    if worst_id is not None:
        ev["slice"] = worst_id
        ev["heartbeat_age_s"] = round(worst, 3)
    if dead:
        ev["slices_dead"] = list(dead)
    reforms = _num(s, "mesh_reforms")
    if reforms:
        ev["mesh_reforms"] = int(reforms)
    score = max(frac, 1.0) if dead else frac
    return ev, min(score, 2.0)


def _dcn_bound(s: dict):
    """Cross-slice (DCN) all-reduce dominates the collective bytes AND
    communication is a real share of the step: the slow tier is the
    bottleneck — sync less often or move less across slices."""
    dcn_b = _num(s, "comm_bytes_dcn")
    total = _num(s, "comm_bytes")
    cf = _num(s, "comm_fraction")
    if not dcn_b or not total or total <= 0 or cf is None:
        return None
    share = dcn_b / total
    if share < DCN_SHARE_MIN or cf < DCN_COMM_FRACTION_MIN:
        return None
    ev = {"dcn_bytes": int(dcn_b), "comm_bytes": int(total),
          "dcn_share": round(share, 4), "comm_fraction": round(cf, 4)}
    return ev, min(cf * (1.0 + share), 2.0)


RULES: List[Rule] = [
    Rule("slice-unhealthy", ("train",),
         "a DCN slice's heartbeat is stale: check its hosts / expect an "
         "in-memory mesh reform (lost-slice reshard); tune "
         "PADDLE_TPU_SLICE_HB_TIMEOUT_S for the detection window",
         _slice_unhealthy,
         # behavioral/operational: no tuning-table axis moves this
         action={"op": None, "param": None,
                 "env": "PADDLE_TPU_SLICE_HB_TIMEOUT_S",
                 "candidates": []}),
    Rule("dcn-bound", ("train",),
         "cross-slice all-reduce dominates: gradient_merge (k_steps) to "
         "sync across slices less often / larger per-slice batch / keep "
         "overlap on (PADDLE_TPU_OVERLAP=1)",
         _dcn_bound,
         action={"op": None, "param": "k_steps", "env": None,
                 "candidates": [2, 4, 8]}),
    Rule("comm-bound", ("train",),
         "PADDLE_TPU_OVERLAP=1 / MoELayer a2a_chunks "
         "(PADDLE_TPU_MOE_A2A_CHUNKS) / revisit sharding stage",
         _comm_bound,
         action={"op": "moe_a2a_chunks", "param": "moe_a2a_chunks",
                 "env": "PADDLE_TPU_MOE_A2A_CHUNKS",
                 "candidates": [1, 2, 4, 8]}),
    Rule("data-starved", ("train",),
         "raise prefetch_depth (PADDLE_TPU_PREFETCH_DEPTH) / add "
         "DataLoader workers / check input storage",
         _data_starved,
         action={"op": None, "param": "prefetch_depth",
                 "env": "PADDLE_TPU_PREFETCH_DEPTH",
                 "candidates": [2, 4, 8]}),
    Rule("h2d-bound", ("train",),
         "keep DevicePrefetcher on (PADDLE_TPU_PREFETCH_DEPTH>0) / "
         "shrink host-side batch copies",
         _h2d_bound,
         action={"op": None, "param": "prefetch_depth",
                 "env": "PADDLE_TPU_PREFETCH_DEPTH",
                 "candidates": [2, 4]}),
    Rule("host-sync-bound", ("train", "serve"),
         "keep StepResult lazy (no per-step float(loss)/np.asarray); "
         "read stats at log boundaries; anomaly_policy=rollback costs "
         "1 sync/step",
         _host_sync_bound,
         # behavioral: no config axis turns this — the fix is in the
         # caller's code, so the controller must skip it
         action={"op": None, "param": None, "env": None,
                 "candidates": []}),
    Rule("recompile-churn", ("train", "serve"),
         "pin shapes: prefill buckets (PADDLE_TPU_PREFILL_BUCKETS), "
         "fixed batch/seq, persistent compile cache "
         "(PADDLE_TPU_COMPILE_CACHE)",
         _recompile_churn,
         action={"op": "prefill_buckets", "param": "prefill_buckets",
                 "env": "PADDLE_TPU_PREFILL_BUCKETS",
                 "candidates": []}),
    Rule("kv-pressure", ("serve",),
         "raise PADDLE_TPU_KV_BLOCKS / int8 KV "
         "(PADDLE_TPU_KV_DTYPE=int8) / lower max_new_tokens",
         _kv_pressure,
         action={"op": None, "param": "kv_dtype",
                 "env": "PADDLE_TPU_KV_DTYPE", "candidates": ["int8"]}),
    Rule("low-spec-acceptance", ("serve",),
         "lower spec_k (PADDLE_TPU_SPEC_K) / use a better-matched "
         "draft model",
         _low_spec_acceptance, action=_spec_k_action),
    Rule("prefix-cold", ("serve",),
         "enable the radix prefix cache (PADDLE_TPU_PREFIX_CACHE=1) / "
         "prefix-aware routing (Router policy='prefix')",
         _prefix_cold,
         action={"op": None, "param": "prefix_cache",
                 "env": "PADDLE_TPU_PREFIX_CACHE",
                 "candidates": [True]}),
    Rule("prefill-stall", ("serve",),
         "enable chunked prefill (PADDLE_TPU_CHUNKED_PREFILL=<chunk> / "
         "engine prefill_chunk=) so prompts are fed through the decode "
         "tick in fixed-budget chunks instead of stalling the batch",
         _prefill_stall,
         action={"op": None, "param": "prefill_chunk",
                 "env": "PADDLE_TPU_CHUNKED_PREFILL",
                 "candidates": [32, 64, 128]}),
    Rule("admission-bound", ("serve",),
         "raise batch_slots (PADDLE_TPU_DECODE_SLOTS) / check arrival "
         "rate vs capacity",
         _idle_slots,
         action={"op": None, "param": "batch_slots",
                 "env": "PADDLE_TPU_DECODE_SLOTS", "candidates": []}),
    Rule("expert-imbalance", ("serve",),
         "raise moe_capacity_factor (GPTConfig) so the capacity "
         "buckets stop dropping assignments / lower spec_k "
         "(PADDLE_TPU_SPEC_K) to shrink the verify burst a hot expert "
         "absorbs / rebalance gating (aux loss weight) upstream",
         _expert_imbalance, action=_moe_imbalance_action),
    Rule("bandwidth-bound-decode", ("serve",),
         "enable the decode megakernel (PADDLE_TPU_DECODE_MEGAKERNEL=1)"
         " / int8 KV (PADDLE_TPU_KV_DTYPE=int8) / speculative decoding "
         "(PADDLE_TPU_SPEC_K) to amortize the streamed bytes",
         _hbm_heavy_decode, action=_decode_bw_action),
    Rule("mfu-below-target", ("train",),
         "compute-bound: quantize=int8 (BENCH_QUANTIZE) / flash "
         "attention / remat off; bandwidth-bound: larger batch / "
         "fused_ce / scan_layers — see exec_profile gap_share for the "
         "executable owning the gap",
         _roofline_train, action=_mfu_action),
    Rule("oom-risk", ("train", "serve"),
         "int8 KV (PADDLE_TPU_KV_DTYPE=int8) / fewer decode slots "
         "(PADDLE_TPU_DECODE_SLOTS) or KV blocks (PADDLE_TPU_KV_BLOCKS)"
         " / smaller batch / remat on (strategy.recompute)",
         _oom_risk, action=_oom_action),
]


def diagnose(stats: dict, kind: Optional[str] = None) -> List[dict]:
    """Run the rule table over one stats dict; returns the ranked
    verdict list (empty = no bottleneck the rules can see).  `kind`
    restricts the table ('train' | 'serve'; loadgen reports pass
    'serve' — their columns are the serving ones); None runs every
    rule, letting the keys present decide."""
    out: List[Dict] = []
    for rule in RULES:
        if kind is not None and kind not in rule.kinds:
            continue
        try:
            hit = rule.check(stats)
        except Exception:               # a broken rule must never take
            continue                    # a stats read down
        if hit is None:
            continue
        evidence, score = hit
        verdict = {"bottleneck": rule.bottleneck,
                   "evidence": evidence,
                   "knob": rule.knob,
                   "score": round(float(score), 4)}
        action = rule.action_for(stats, evidence)
        if action is not None:
            verdict["action"] = action
        out.append(verdict)
    out.sort(key=lambda v: -v["score"])
    return out
