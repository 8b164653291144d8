"""Greedy coordinate-descent autotune controller (counterpart of
``paddle_tpu/autotune/controller.py``).

The loop::

    measure the incumbent -> the doctor ranks bottlenecks -> the top
    verdict's structured action names ONE knob axis -> trial that axis's
    candidates -> accept only a measured improvement beyond the noise
    floor -> commit the winner to the tuning table with provenance ->
    diagnose the new incumbent -> repeat until no verdict offers an
    untried move.

It measures O(knobs that matter), not the grid: only axes the doctor
implicates, and a trialed (axis, value) pair is never measured again.

Rails:

- every measurement runs in a flight-recorder-annotated trial window
  bracketed by ``utils.compile_counter`` snapshots, which count the
  port's compiles (kernel builds, ``torch.export`` captures, new step
  kinds);
- a trial that raises, compile-storms or regresses beyond the noise
  floor is rolled back to the incumbent and dumped as an
  ``autotune-rollback`` bundle.  The storm rail reads the measured row's
  ``xla_compiles_measured`` (the JAX key name, kept so rows read the
  same): the port's compiles counted inside the MEASURED window, after
  the measure function's warm-up, which must be 0;
- compiles outside trial windows are tallied as
  ``compiles_outside_trials``.

The controller owns no measurement: ``measure(config) -> row`` is
injected and returns the objective under ``objective_key``; ``doctor``
(ranked verdicts) and ``xla_compiles_measured`` ride along.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from ..observability import flightrec as _flightrec
from ..utils import compile_counter as _cc
from ..utils import tuning as _tuning
from .knobs import AXES, KnobAxis, axis_for_action, eligible

__all__ = ["AutotuneController", "noise_floor_default"]


def noise_floor_default() -> float:
    """Relative improvement a trial must beat to be accepted (2%
    default; PADDLE_TPU_AUTOTUNE_NOISE overrides)."""
    try:
        return float(os.environ.get("PADDLE_TPU_AUTOTUNE_NOISE", "0.02"))
    except ValueError:
        return 0.02


class AutotuneController:
    """One greedy coordinate-descent pass over a knob space.

    Parameters
    ----------
    measure:
        ``measure(config: dict) -> row: dict``.  Must return the
        objective under ``objective_key``; may raise (the trial is then
        rolled back).  Retries and resumes belong inside measure.
    kind:
        'train' | 'serve' — restricts both the doctor rule table and
        the eligible knob axes.
    objective_key / maximize:
        which row field is the objective and its direction (MFU: up;
        a latency: down).
    noise_floor:
        relative improvement an acceptance must exceed; a trial WORSE
        than the incumbent by more than this is a regression (rollback
        + flightrec bundle), in between is an indifferent reject.
    commit_keys:
        ``{param: (table_op, key_tuple)}`` — where an accepted value
        for that axis persists in the unified tuning table.  Supplied
        by the embedder (it knows the model/device identity); axes
        absent from the map are accepted in-config but not persisted.
    storm_compiles:
        measured-window compile budget per trial; a row whose
        ``xla_compiles_measured`` (the port's compiles in the measured
        window) exceeds it is a recompile-storm (rollback + bundle).
        Default 0: a measured window is past warm-up by construction.
    axes:
        eligible axis names (default: ``knobs.eligible(kind)``, every
        registry axis of ``kind`` with a meaning on one GPU).
    """

    def __init__(self, measure: Callable[[dict], dict], *,
                 kind: str = "train", objective_key: str = "mfu",
                 maximize: bool = True,
                 noise_floor: Optional[float] = None,
                 max_trials: Optional[int] = None,
                 run_id: str = "",
                 commit_keys: Optional[Dict[str, Tuple[str, tuple]]] = None,
                 storm_compiles: int = 0,
                 axes: Optional[List[str]] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.measure = measure
        self.kind = kind
        self.objective_key = objective_key
        self.maximize = bool(maximize)
        self.noise_floor = noise_floor_default() if noise_floor is None \
            else float(noise_floor)
        self.run_id = run_id or os.environ.get("BENCH_RUN", "") or \
            "autotune"
        self.commit_keys = dict(commit_keys or {})
        self.storm_compiles = int(storm_compiles)
        names = axes if axes is not None else eligible(kind)
        self.axes: Dict[str, KnobAxis] = \
            {n: AXES[n] for n in names if n in AXES}
        self.max_trials = int(max_trials) if max_trials is not None \
            else max(4, 3 * len(self.axes))
        self._log = log or (lambda s: None)
        # (axis, repr(value)) pairs ever trialed — accepted or rejected,
        # a pair is never measured twice (the never-revisit contract)
        self._tried: set = set()
        self.trials: List[dict] = []
        self.committed: List[dict] = []
        self._in_trial_compiles = 0

    # ------------------------------------------------------------------
    def _objective(self, row: Optional[dict]) -> Optional[float]:
        if not isinstance(row, dict):
            return None
        v = row.get(self.objective_key)
        return float(v) if isinstance(v, (int, float)) and not \
            isinstance(v, bool) else None

    def _improvement(self, incumbent: float, trial: float) -> float:
        """Signed relative improvement of trial over incumbent (>0 is
        better regardless of objective direction)."""
        if incumbent == 0:
            return 0.0
        rel = (trial - incumbent) / abs(incumbent)
        return rel if self.maximize else -rel

    def _verdicts(self, row: dict) -> List[dict]:
        v = row.get("doctor")
        if isinstance(v, list):
            return v
        from ..observability import doctor as _doctor
        try:
            return _doctor.diagnose(row, self.kind)
        except Exception:
            return []

    def _measure_window(self, config: dict, label: str) -> tuple:
        """One measurement inside a flight-recorder trial window
        bracketed by compile snapshots. Returns (row | None, compiles,
        error | None)."""
        _flightrec.note_event("autotune_trial", run=self.run_id,
                              label=label,
                              trial=len(self.trials))
        snap = _cc.snapshot()
        try:
            row = self.measure(dict(config))
            err = None
        except Exception as e:           # watchdog raise lands here too
            row, err = None, f"{type(e).__name__}: {e}"
        compiles = snap.new_compiles
        self._in_trial_compiles += compiles
        return row, compiles, err

    def _rollback(self, axis_name: str, value, reason: str,
                  detail: dict) -> None:
        """A failed trial: the incumbent stays, the evidence ships as a
        flight-recorder bundle (dump() never raises, caps itself)."""
        self._log(f"autotune: rollback {axis_name}={value!r} ({reason})")
        _flightrec.dump("autotune-rollback",
                        extra={"autotune": dict(detail, axis=axis_name,
                                                value=repr(value),
                                                reason=reason,
                                                run=self.run_id)})

    def _commit(self, axis: KnobAxis, value, improvement: float) -> None:
        """Persist an accepted winner into the unified tuning table with
        provenance (embedder-supplied key; no key → config-only win)."""
        dest = self.commit_keys.get(axis.name)
        if not dest:
            return
        op, key = dest
        _tuning.record(op, key, value, source="autotune",
                       run=self.run_id, improvement=improvement)
        self.committed.append({"op": op, "key": list(map(str, key)),
                               "value": value,
                               "improvement": round(improvement, 6)})
        self._log(f"autotune: committed {op}|{'|'.join(map(str, key))}"
                  f" = {value!r} (+{improvement * 100:.2f}%)")

    # ------------------------------------------------------------------
    def _candidate_moves(self, config: dict, verdicts: List[dict]):
        """Yield (axis, value, bottleneck) moves in verdict-rank order,
        untried pairs only — the coordinate-descent frontier."""
        for v in verdicts:
            axis = axis_for_action(v.get("action"))
            if axis is None or axis.name not in self.axes:
                continue
            suggested = (v.get("action") or {}).get("candidates")
            for val in axis.trial_values(config.get(axis.name),
                                         suggested):
                if (axis.name, repr(val)) in self._tried:
                    continue
                yield axis, val, v.get("bottleneck", "?")

    def run(self, base_config: dict) -> dict:
        """One full pass from ``base_config``; returns the summary dict
        (winning config, trial log, compile accounting)."""
        run_snap = _cc.snapshot()
        self._in_trial_compiles = 0
        incumbent = dict(base_config)
        inc_row, _, err = self._measure_window(incumbent, "incumbent")
        inc_obj = self._objective(inc_row)
        if inc_obj is None:
            return {"run": self.run_id, "error": err or
                    f"incumbent row lacks {self.objective_key!r}",
                    "config": incumbent, "trials": [],
                    "measured_trials": 0, "committed": [],
                    "compiles_outside_trials": 0, "converged": False}
        baseline_obj = inc_obj
        converged = False
        while len(self.trials) < self.max_trials:
            moved = False
            for axis, val, bottleneck in self._candidate_moves(
                    incumbent, self._verdicts(inc_row)):
                self._tried.add((axis.name, repr(val)))
                trial_cfg = dict(incumbent)
                trial_cfg[axis.name] = val
                row, compiles, err = self._measure_window(
                    trial_cfg, f"{axis.name}={val!r}")
                obj = self._objective(row)
                rec = {"axis": axis.name, "value": val,
                       "bottleneck": bottleneck,
                       "objective": obj, "compiles": compiles,
                       "incumbent_objective": inc_obj}
                if err is not None:
                    rec.update(outcome="rollback", reason="error",
                               error=err)
                    self._rollback(axis.name, val, "error", rec)
                elif obj is None:
                    rec.update(outcome="reject", reason="no-objective")
                elif row.get("xla_compiles_measured", 0) > \
                        self.storm_compiles:
                    rec.update(outcome="rollback",
                               reason="recompile-storm",
                               xla_compiles_measured=row[
                                   "xla_compiles_measured"])
                    self._rollback(axis.name, val, "recompile-storm",
                                   rec)
                else:
                    imp = self._improvement(inc_obj, obj)
                    rec["improvement"] = round(imp, 6)
                    if imp > self.noise_floor:
                        rec["outcome"] = "accept"
                        incumbent, inc_row, inc_obj = trial_cfg, row, obj
                        self._commit(axis, val, imp)
                        self._log(f"autotune: accept {axis.name}="
                                  f"{val!r} ({self.objective_key} "
                                  f"{inc_obj:.4g}, +{imp * 100:.2f}%)")
                    elif imp < -self.noise_floor:
                        rec.update(outcome="rollback",
                                   reason="regression")
                        self._rollback(axis.name, val, "regression",
                                       rec)
                    else:
                        rec.update(outcome="reject",
                                   reason="within-noise")
                self.trials.append(rec)
                if rec.get("outcome") == "accept" or \
                        len(self.trials) >= self.max_trials:
                    moved = rec.get("outcome") == "accept"
                    break
            else:
                # no verdict offered an untried move: descent is done
                converged = True
            if converged:
                break
            if not moved and len(self.trials) < self.max_trials:
                # the frontier existed but every move failed — the for
                # loop above only breaks on accept/budget; reaching
                # here without `moved` means the frontier is exhausted
                converged = True
                break
        total = run_snap.new_compiles
        return {"run": self.run_id, "objective": self.objective_key,
                "baseline": baseline_obj, "best": inc_obj,
                "improvement": round(
                    self._improvement(baseline_obj, inc_obj), 6),
                "config": incumbent,
                "trials": self.trials,
                "measured_trials": len(self.trials),
                "accepted": sum(1 for t in self.trials
                                if t.get("outcome") == "accept"),
                "rolled_back": sum(1 for t in self.trials
                                   if t.get("outcome") == "rollback"),
                "committed": self.committed,
                "compiles_total": total,
                "compiles_outside_trials": max(
                    0, total - self._in_trial_compiles),
                "converged": converged}
