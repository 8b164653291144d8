"""The trainer on one GPU (counterpart of ``paddle_tpu/distributed/spmd.py``
``SpmdTrainer`` on a one-device mesh).

The JAX trainer compiles forward, backward and the optimizer update into
one XLA executable; here one ``train_step`` runs them eagerly on the
model's device:
- under ``strategy.amp`` the floating parameters are cast to bf16 (or,
  with ``amp_configs['use_bf16'] = False``, fp16) copies of the f32
  masters and the floating inputs to the same dtype, and the model runs
  through ``torch.func.functional_call`` over those copies (not
  ``torch.autocast``, which casts per op and would not match the JAX
  package's numbers).  A tied embedding has one half-precision copy
  serving both its uses, so autograd sums its two gradients into the
  one f32 master;
- the loss (f32, plus the auxiliary losses the forward's MoE routers
  add through ``distributed.moe.collect_aux_losses``) goes backward into
  the masters' ``.grad`` and the optimizer updates them (``Optimizer.apply_gradients``);
- nothing is read back to the host: the step returns a lazy
  ``StepResult`` whose ``float()`` is the one counted host sync.

The JAX trainer's step variants, each a few device ops here:
- **gradient merge** (``strategy.gradient_merge``, ``k_steps`` k > 1):
  each step adds its gradients to f32 buffers (``buf + g``); every k-th
  step updates from them (times ``1/k`` under ``avg``) and zeroes them.
  The optimizer's step count is ``steps // k``;
- **fp16 dynamic loss scaling**: the loss is multiplied by the device
  scale before the backward, the gradients divided by it in f32 and
  checked for nan/inf in one pass; the update is selected per parameter
  (``Optimizer.apply_gradients(skip=found_inf)``) and the optimizer's
  step ``t`` does not advance on a skipped step; then the scale state
  machine (``(scale, good, bad, t, found_inf)``, JAX ``spmd.py:994``)
  moves on the device;
- **anomaly_policy='skip'**: the same select on a non-finite loss or
  gradient, with an on-device ``skipped`` counter;
- **anomaly_policy='rollback'**: before the first step, and then every
  ``PADDLE_TPU_ROLLBACK_EVERY`` (default 1) good steps, a copy of the
  parameters and optimizer state goes to one pinned host buffer; a
  non-finite step restores it and rewinds the step count and the
  device's default generator (dropout bits, a host-side state), so the
  steps after a rollback draw what a run without the bad batch draws.
  The flags are read every step, so a snapshot is always of a good
  state.  One host read per step;
- **FLAGS_check_nan_inf** (read when the trainer is built): one finite
  flag per checked tensor, read once per step, raising with the bad
  tensors' names.  Under fp16 only a non-finite unscaled loss raises
  (gradient overflow is the scaler's signal).

The merge, fp16 and skip paths read nothing back per step; rollback and
the nan guard read one flag vector.  ``loss_scale``, ``last_step_skipped``
and ``stats`` read the device state and count a host sync each.

Telemetry (``observability``, host arithmetic only, no device read): a
``StepTimer`` and the ``train_*`` metrics (label ``trainer="spmd"``); with
the span tracer armed the ``h2d``, ``dispatch`` and ``sync`` spans; a
flight-recorder record per step, and on a rollback an
``anomaly_rollback`` event and a ``rollback`` bundle; the stall watchdog
(``PADDLE_TPU_WATCHDOG_S``) beaten per step; a ``PADDLE_TPU_PROFILE``
capture window over steps; the step-kind registry and the HBM ledger's
params, optimizer-state, buffer and gradient-merge lines;
``stats["exec_profile"]``, ``["hbm"]`` and ``["doctor"]``.

Every enabled strategy flag is either supported or raises, as in the
JAX trainer.  Supported here: ``amp``, ``recompute`` (every policy of
``distributed.recompute``; with no ``recompute_configs['policy']`` the
tuning table's measured policy for this device and model shape,
``tuned_remat_policy``, else full recompute, as in the JAX trainer),
``qat`` (the model's ``enable_quantize(qat_configs['quantize'])``) and
``gradient_merge``.  Multi-device flags raise with a pointer to
ROADMAP.md.

Knobs read when the trainer is built, as the JAX trainer reads them:
``PADDLE_TPU_ANOMALY_POLICY`` (the policy when the argument is None)
and ``PADDLE_TPU_ROLLBACK_EVERY`` (rollback's snapshot every n good
steps, default 1; the first step always has one).  After every step the
fault points ``PADDLE_FAULT_SIGTERM_STEP`` and ``PADDLE_FAULT_HANG``
(``testing.faults``) run, and ``PADDLE_TPU_AUTOTUNE=live`` arms an
advisory ``autotune.live.TrainerRetuner`` fed each step's wall time.
``_exec_cost`` gives the registry the analytic cost of a step
(``observability.cost_model``) at the last batch's shape.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.errors import PreconditionNotMetError
from ..core.flags import GLOBAL_FLAGS
from ..core.selected_rows import dense_lookups
from ..observability import doctor as _doctor
from ..observability import exec_registry as _exec_registry
from ..observability import flightrec as _flightrec
from ..observability import metrics as _metrics
from ..observability import spans as _spans
from ..observability import watchdog as _watchdog
from ..observability.capture import ProfileWindow
from ..profiler import StepTimer
from ..testing import faults
from ..utils import compile_counter as _compile_counter
from ..utils import tuning as _tuning
from .async_dispatch import StepResult, record_host_sync
from .fleet.strategy import DistributedStrategy
from .moe import collect_aux_losses

__all__ = ["SpmdTrainer", "remat_policy_key", "tuned_remat_policy"]

# flags that need no work on one device (no collectives to fuse or
# reduce, no unused-parameter bookkeeping under autograd)
_MOOT = {"find_unused_parameters", "fuse_all_reduce_ops",
         "use_hierarchical_allreduce"}
_SUPPORTED = {"amp", "recompute", "qat", "gradient_merge"}
# one telemetry label per trainer
_TRAINER_IDS = itertools.count()


def remat_policy_key(cfg):
    """Tuning-table key of the measured remat policy: the device kind
    and the model dims that move the trade-off, ``(device_kind, hidden,
    layers, max_seq_len)``; None for a model without such a config."""
    h = getattr(cfg, "hidden_size", None)
    if not h:
        return None
    return (_tuning.device_kind(), int(h),
            int(getattr(cfg, "num_layers", 0) or 0),
            int(getattr(cfg, "max_seq_len", 0) or 0))


def tuned_remat_policy(model):
    """The tuning table's measured remat policy (op ``remat_policy``:
    'dots_no_batch' / 'dots' / 'full' / ...) for this device and model
    shape: the exact key, else the nearest tabled shape within a bounded
    distance (each dim within about 2x overall: a policy measured on a
    small model must not drive a much larger one).  'off' / 'none'
    entries (the winner ran without recompute) and an empty table give
    None."""
    key = remat_policy_key(getattr(model, "cfg", None))
    if key is None:
        return None
    val = _tuning.lookup_nearest("remat_policy", key, match_idx=(0,),
                                 near_idx=(1, 2, 3), max_dist=2.1)
    if not isinstance(val, str) or val.lower() in ("off", "none", ""):
        return None
    return val


def _detached(outs):
    if isinstance(outs, (tuple, list)):
        return type(outs)(_detached(o) for o in outs)
    return outs.detach() if torch.is_tensor(outs) else outs


class SpmdTrainer:
    """One training step = forward + backward + optimizer update on the
    model's device.

    Parameters
    ----------
    model : ``torch.nn.Module`` (its parameters are the f32 masters the
        optimizer updates in place).
    optimizer : ``paddle_tpu_torch.optimizer.Optimizer``.
    loss_fn : callable(outputs, *labels) -> scalar tensor.
    strategy : ``DistributedStrategy``; ``amp``, ``recompute``, ``qat``
        and ``gradient_merge`` are honored, any other enabled flag raises.
    anomaly_policy : ``'raise'`` (default: a non-finite loss is left for
        the caller to see, checked only under ``FLAGS_check_nan_inf``),
        ``'skip'`` or ``'rollback'``.
    """

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Callable,
                 strategy: Optional[DistributedStrategy] = None,
                 anomaly_policy: Optional[str] = None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.strategy = strategy or DistributedStrategy()
        # step-time breakdown (stats): waiting for data, placing it,
        # running the step's host code (the device runs behind it), and
        # blocked on read-backs
        self._timings = {"data_wait_ms": 0.0, "h2d_ms": 0.0,
                         "dispatch_ms": 0.0, "sync_ms": 0.0,
                         "steps_timed": 0}
        self._step_count = 0

        st = self.strategy
        for key, val in st.to_dict().items():
            if val is True and key not in _SUPPORTED | _MOOT:
                raise NotImplementedError(
                    f"DistributedStrategy.{key} is not supported by the "
                    f"port's single-GPU trainer yet (see ROADMAP.md); "
                    f"supported flags: {sorted(_SUPPORTED)}")
        self.k_steps = int(st.gradient_merge_configs.get("k_steps", 1)) \
            if st.gradient_merge else 1
        self.gm_avg = bool(st.gradient_merge_configs.get("avg", True))
        self.amp_enabled = bool(st.amp)
        ac = st.amp_configs
        self.fp16_scaling = self.amp_enabled and not ac.get("use_bf16", True)
        self.amp_dtype = torch.float16 if self.fp16_scaling \
            else torch.bfloat16
        self._scaler_cfg = {
            "init_loss_scaling": float(ac.get("init_loss_scaling", 2.**15)),
            "incr_ratio": float(ac.get("incr_ratio", 2.0)),
            "decr_ratio": float(ac.get("decr_ratio", 0.5)),
            "incr_every_n_steps": int(ac.get("incr_every_n_steps", 1000)),
            "decr_every_n_nan_or_inf": int(
                ac.get("decr_every_n_nan_or_inf", 2)),
            "min_loss_scaling": float(ac.get("min_loss_scaling", 1.0)),
        }
        if self.fp16_scaling and self.k_steps > 1:
            raise NotImplementedError(
                "fp16 loss scaling with gradient_merge (k_steps > 1) is "
                "not supported; use bf16 AMP or k_steps == 1")

        self._check_nan_inf = bool(GLOBAL_FLAGS.get("check_nan_inf"))
        self.anomaly_policy = (anomaly_policy or
                               os.environ.get("PADDLE_TPU_ANOMALY_POLICY")
                               or "raise")
        if self.anomaly_policy not in ("raise", "skip", "rollback"):
            raise ValueError(f"anomaly_policy must be raise|skip|rollback, "
                             f"got {self.anomaly_policy!r}")
        if self.anomaly_policy == "rollback" and (
                self.fp16_scaling or self.k_steps > 1):
            raise NotImplementedError(
                "anomaly_policy='rollback' is not supported with fp16 "
                "loss scaling or gradient_merge; use 'skip' (fp16 "
                "already skips overflowed steps)")
        if self.anomaly_policy != "raise":
            # the policy owns non-finite handling
            self._check_nan_inf = False
        # fp16's scaler already skips; the anomaly state drives f32/bf16
        self._anom_skip = (self.anomaly_policy == "skip" and
                           not self.fp16_scaling)
        self._anom_rollback = self.anomaly_policy == "rollback"
        self._rollback_count = 0
        self._rollback_every = int(os.environ.get(
            "PADDLE_TPU_ROLLBACK_EVERY", "1"))
        # rollback's host copy of the state to go back to: taken before
        # the first step and then every _rollback_every good steps
        self._snapshot = None
        self._fault_nan_step = faults.nan_poison_step()
        # train_step(return_outputs=True) keeps the forward's outputs
        self._keep_outputs = False
        self._outputs = None

        if st.recompute:
            if st.recompute_configs.get("scan_layers"):
                raise NotImplementedError(
                    "recompute_configs['scan_layers'] is a JAX compile-time "
                    "option with no counterpart in the port")
            if not hasattr(model, "enable_recompute"):
                raise NotImplementedError(
                    "strategy.recompute=True but the model has no "
                    "enable_recompute()")
            model.enable_recompute(st.recompute_configs.get("policy")
                                   or tuned_remat_policy(model) or "full")

        # quantization-aware training: every block linear runs the int8
        # or e4m3 fake-quant matmul (qat_configs['quantize']; quantized
        # forward, straight-through backward); parameters and optimizer
        # are untouched
        if st.qat:
            if not hasattr(model, "enable_quantize"):
                raise NotImplementedError(
                    "strategy.qat=True but the model has no "
                    "enable_quantize(); route its products through "
                    "paddle_tpu_torch.ops.fake_quant_matmul instead")
            model.enable_quantize(st.qat_configs.get("quantize", "int8"))

        self._params = dict(model.named_parameters())
        self._train = {n: p for n, p in self._params.items()
                       if p.requires_grad}
        first = next(iter(self._params.values()), None)
        self.device = first.device if first is not None \
            else torch.device("cpu")
        optimizer.init_state(self._train)

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=self.device)

        # the fp16 scaler's state lives on the device, so the whole
        # scale / unscale / check / update runs without a host read
        self._scaler_state = None
        if self.fp16_scaling:
            self._scaler_state = {
                "scale": scalar(self._scaler_cfg["init_loss_scaling"],
                                torch.float32),
                "good": scalar(0, torch.int32),
                "bad": scalar(0, torch.int32),
                # the optimizer's step count: not advanced on a skipped
                # step
                "t": scalar(0, torch.int32),
                "found_inf": scalar(False, torch.bool),
            }
        # skip's state (f32/bf16): the optimizer's step count and the
        # skipped steps.  A trainer holds either this or the scaler's, so
        # one device step count ``t`` at most
        self._anomaly_state = None
        if self._anom_skip:
            self._anomaly_state = {"t": scalar(0, torch.int32),
                                   "skipped": scalar(0, torch.int32)}
        # gradient merge's buffers, one per parameter
        self._grad_buf = None
        if self.k_steps > 1:
            self._grad_buf = {n: torch.zeros_like(p)
                              for n, p in self._params.items()}
        self._init_telemetry()
        # PADDLE_TPU_AUTOTUNE=live: advice on a sustained regression
        from ..autotune.live import arm_trainer
        self._retuner = arm_trainer(self)
        self._batch_shape = None

    def _init_telemetry(self):
        """The step timer, registry children bound once, the capture
        window over steps, the ledger's lines and the crash hooks; the
        watchdog starts on the first step when ``PADDLE_TPU_WATCHDOG_S``
        arms it."""
        self.step_timer = StepTimer(warmup=1)
        self.step_timer.start()
        self._profile = ProfileWindow.from_env(kind="train")
        lbl = {"trainer": "spmd"}
        self._m_steps = _metrics.counter(
            "train_steps_total", "completed train steps",
            labels=("trainer",)).labels(**lbl)
        self._m_step_ms = _metrics.gauge(
            "train_step_time_ms", "last per-step wall time (host)",
            labels=("trainer",)).labels(**lbl)
        self._m_step_hist = _metrics.histogram(
            "train_step_ms", "per-step wall time",
            labels=("trainer",)).labels(**lbl)
        _flightrec.install()
        self.watchdog: Optional[_watchdog.Watchdog] = None
        self._wd_checked = False
        self.telemetry_label = f"s{next(_TRAINER_IDS)}"
        self._exec_component = f"trainer:{self.telemetry_label}"
        label = self.telemetry_label
        tb = _exec_registry.tree_bytes
        _exec_registry.track_bytes(self, "params", label, tb(self._params))
        _exec_registry.track_bytes(
            self, "opt_state", label,
            tb([self.optimizer._accumulators[n] for n in self._train]))
        buffers = [b for _, b in self.model.named_buffers()]
        if buffers:
            _exec_registry.track_bytes(self, "buffers", label, tb(buffers))
        if self._grad_buf is not None:
            _exec_registry.track_bytes(self, "grad_buffer", label,
                                       tb(self._grad_buf))

    # ------------------------------------------------------------------
    @property
    def params(self):
        """The trained parameters (the model's own tensors) by name."""
        return {n: p.detach() for n, p in self._params.items()}

    def _put(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x if x.device == self.device else \
                x.to(self.device, non_blocking=True)
        return torch.from_numpy(np.asarray(x)).to(self.device)

    def shard_batch(self, batch):
        """Host arrays -> tensors on the trainer's device; tensors
        already there (a DevicePrefetcher's batches) pass through."""
        t0 = time.perf_counter()
        out = tuple(self._put(x) for x in batch)
        dt = (time.perf_counter() - t0) * 1e3
        self._timings["h2d_ms"] += dt
        self._span("h2d", dt)
        return out

    @staticmethod
    def _span(name: str, dt_ms: float, **args):
        """A train phase's host span of ``dt_ms`` ending now."""
        tr = _spans.tracer()
        if tr.active:
            now = tr.now_us()
            tr.complete(name, now - dt_ms * 1e3, dt_ms * 1e3, cat="train",
                        args=args or None)

    def _compute_params(self):
        """The parameters the forward runs on: half-precision copies of
        the floating masters under AMP (differentiable casts), else the
        masters themselves."""
        if not self.amp_enabled:
            return dict(self._params)
        return {n: p.to(self.amp_dtype) if p.is_floating_point() else p
                for n, p in self._params.items()}

    def _cast_inputs(self, inputs):
        if not self.amp_enabled:
            return inputs
        return tuple(x.to(self.amp_dtype) if x.is_floating_point() else x
                     for x in inputs)

    def _run(self, inputs, training: bool):
        was = self.model.training
        self.model.train(training)
        try:
            with dense_lookups():
                return torch.func.functional_call(
                    self.model, self._compute_params(),
                    self._cast_inputs(inputs))
        finally:
            self.model.train(was)

    def _grads(self, inputs, labels, scale=None):
        """Forward, loss and backward: ``(loss, {name: gradient})`` over
        the trainable parameters (zeros for one that got none).  With
        ``scale`` the backward runs on ``loss * scale`` and the gradients
        come back scaled.  The auxiliary losses the forward's layers
        add (MoE routers) join the f32 loss before any scaling, as in
        the JAX trainer."""
        for p in self._params.values():
            p.grad = None
        with collect_aux_losses() as aux:
            outs = self._run(inputs, training=True)
        if self._keep_outputs:
            self._outputs = _detached(outs)
        loss = self.loss_fn(outs, *labels).float()
        for a in aux:
            loss = loss + a.float()
        (loss if scale is None else loss * scale).backward()
        return loss.detach(), {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in self._train.items()}

    def _poison_grads(self, grads, step_no: int):
        """Fault injection (``PADDLE_FAULT_NAN_STEP``): NaN every floating
        gradient on the armed step.  The step number is host state, so
        only the armed step does any work."""
        if self._fault_nan_step is None or step_no != self._fault_nan_step:
            return grads
        for g in grads.values():
            if g.is_floating_point():
                g.fill_(float("nan"))
        return grads

    def _found_inf(self, grads, inv_scale=None) -> torch.Tensor:
        """Bool scalar: any gradient non-finite.  The gradients are
        multiplied by ``inv_scale`` in the same pass (by 1 without it,
        which leaves every value as it was)."""
        found = torch.zeros(1, dtype=torch.float32, device=self.device)
        inv = torch.ones(1, dtype=torch.float32, device=self.device) \
            if inv_scale is None else inv_scale.reshape(1)
        torch._amp_foreach_non_finite_check_and_unscale_(
            list(grads.values()), found, inv)
        return found[0] > 0

    def _nanguard_names(self) -> List[str]:
        return ["loss"] + [f"{n}@GRAD" for n in sorted(self._train)]

    def _nanguard_vec(self, loss, grads) -> torch.Tensor:
        """One bool per checked tensor (loss, then the gradients by
        sorted name): True = holds nan/inf."""
        flags = [~torch.isfinite(loss)]
        flags += [~torch.isfinite(grads[n]).all() for n in sorted(grads)]
        return torch.stack(flags)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """A counted host read of device state (a step's flags, the
        scaler, the skip counter)."""
        t0 = time.perf_counter()
        out = t.cpu().numpy()
        record_host_sync()
        dt = (time.perf_counter() - t0) * 1e3
        self._timings["sync_ms"] += dt
        self._span("sync", dt)
        return out

    def _raise_nonfinite(self, bad: np.ndarray, names: List[str]):
        if bad.any():
            names = [n for n, b in zip(names, bad) if b]
            raise PreconditionNotMetError(
                f"FLAGS_check_nan_inf: nan/inf detected in train step: "
                f"{names}")

    # ---- fp16 loss scaling -------------------------------------------
    def _next_scale(self, found_inf, t):
        """The dynamic scale state machine (JAX ``spmd.py:994-1016``): a
        streak of ``incr_every_n_steps`` finite steps multiplies the
        scale by ``incr_ratio`` unless that overflows f32;
        ``decr_every_n_nan_or_inf`` non-finite steps in a row multiply
        it by ``decr_ratio``, down to ``min_loss_scaling``."""
        cfg, sc = self._scaler_cfg, self._scaler_state
        scale = sc["scale"]
        good = torch.where(found_inf, 0, sc["good"] + 1)
        bad = torch.where(found_inf, sc["bad"] + 1, 0)
        incr = good >= cfg["incr_every_n_steps"]
        decr = bad >= cfg["decr_every_n_nan_or_inf"]
        grown = scale * cfg["incr_ratio"]
        grown = torch.where(torch.isfinite(grown), grown, scale)
        new_scale = torch.where(incr, grown, scale)
        new_scale = torch.where(
            decr, torch.clamp_min(scale * cfg["decr_ratio"],
                                  cfg["min_loss_scaling"]), new_scale)
        return {"scale": new_scale,
                "good": torch.where(incr, 0, good).to(torch.int32),
                "bad": torch.where(decr, 0, bad).to(torch.int32),
                "t": t.to(torch.int32), "found_inf": found_inf}

    # ---- anomaly_policy='rollback' -----------------------------------
    def _state_tensors(self) -> List[torch.Tensor]:
        """The tensors a rollback restores: every parameter, then every
        optimizer accumulator, in a fixed order."""
        out = list(self._params.values())
        for n in self._train:
            out += list(self.optimizer._accumulators[n].values())
        return out

    def _take_snapshot(self):
        """Queue copies of the training state into the host buffer
        (pinned on the card, so the copies run on the step's stream ahead
        of its update, without a host wait); the buffer is made on first
        use and then reused."""
        live = self._state_tensors()
        if self._snapshot is None:
            pin = self.device.type == "cuda"
            self._snapshot = {"tensors": [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                for t in live]}
        for h, t in zip(self._snapshot["tensors"], live):
            h.copy_(t.detach(), non_blocking=True)
        self._snapshot["step"] = self._step_count
        self._snapshot["rng"] = self._rng().get_state()

    def _rng(self) -> torch.Generator:
        """The device's default generator: the dropout layers' and the
        attention-dropout pairs' source."""
        if self.device.type == "cuda":
            return torch.cuda.default_generators[
                self.device.index if self.device.index is not None
                else torch.cuda.current_device()]
        return torch.default_generator

    def _restore_snapshot(self):
        snap = self._snapshot
        with torch.no_grad():
            for t, h in zip(self._state_tensors(), snap["tensors"]):
                t.copy_(h, non_blocking=True)
        self._step_count = snap["step"]
        self.optimizer._step_count = snap["step"]
        self._rng().set_state(snap["rng"])

    @property
    def snapshot_bytes(self) -> int:
        """Bytes of one rollback snapshot (the state it copies)."""
        return sum(t.numel() * t.element_size()
                   for t in self._state_tensors())

    # ------------------------------------------------------------------
    def train_step(self, inputs, labels, return_outputs: bool = False):
        """One step: forward, loss, backward, and the optimizer update
        (every ``k_steps``-th step under gradient merge).  inputs/labels:
        an array or tensor, or a tuple of them.  Returns a lazy
        ``StepResult``; with ``return_outputs`` also the forward's
        outputs, detached (``hapi.Model``'s metrics read them)."""
        self._watchdog_beat()
        if self._profile is not None:
            # PADDLE_TPU_PROFILE=start:stop over train steps
            self._profile.on_step(self._step_count)
        inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (tuple, list)) \
            else (labels,)
        batch = self.shard_batch(inputs + labels)
        inputs, labels = batch[:len(inputs)], batch[len(inputs):]
        self._batch_shape = tuple(inputs[0].shape)
        t0 = time.perf_counter()
        self._keep_outputs = return_outputs
        if self.k_steps == 1:
            key = ("fused", len(inputs), len(labels))
            loss, flags = self._fused_step(inputs, labels)
        else:
            key = ("accum", len(inputs), len(labels))
            loss, flags = self._merge_step(inputs, labels)
        dt = (time.perf_counter() - t0) * 1e3
        self._timings["dispatch_ms"] += dt
        self._timings["steps_timed"] += 1
        _exec_registry.registry().note_call(
            self._exec_component, key, "train_step", dt, owner=self,
            meta={"amp": self.amp_enabled, "k_steps": self.k_steps})
        self._span("dispatch", dt, key=str(key))
        if self._anom_rollback:
            # the policy's price: one host read a step
            if self._read(flags).any():
                self._rollback_count += 1
                # the bundle shows the state the anomaly was found in
                _flightrec.note_event("anomaly_rollback",
                                      step=self._step_count,
                                      rollback_count=self._rollback_count)
                _flightrec.dump("rollback")
                self._restore_snapshot()
        elif flags is not None:
            self._raise_nonfinite(
                self._read(flags),
                ["loss"] if self.fp16_scaling else self._nanguard_names())
        faults.maybe_sigterm(self._step_count)
        faults.maybe_hang(self._step_count)
        self._telemetry_step_end()
        result = StepResult(loss, timings=self._timings)
        if return_outputs:
            outs, self._outputs = self._outputs, None
            return result, outs
        return result

    def _watchdog_beat(self):
        """Start the stall watchdog on the first step when
        ``PADDLE_TPU_WATCHDOG_S`` arms it, then beat it."""
        if not self._wd_checked:
            self._wd_checked = True
            t = _watchdog.watchdog_seconds()
            if t is not None:
                self.watchdog = _watchdog.Watchdog(
                    t, label="spmd_train").arm()
        if self.watchdog is not None:
            self.watchdog.beat()

    def _telemetry_step_end(self):
        """The step's tail: the wall timer, its metrics and the
        flight-recorder record (host arithmetic on bound children)."""
        self.step_timer.tick()
        self._m_steps.inc()
        last = self.step_timer.last_ms
        if last is not None:
            self._m_step_ms.set(last)
            self._m_step_hist.observe(last)
        _flightrec.record("train_step", dur_ms=last, step=self._step_count)
        if self._retuner is not None:
            self._retuner.on_step(last)

    def _exec_cost(self, key, kind: str):
        """The analytic cost of one step at the last batch's shape (the
        registry's ``analyze``); None for a model without a GPT config
        or before a step."""
        cfg = getattr(self.model, "cfg", None)
        if kind != "train_step" or self._batch_shape is None or \
                len(self._batch_shape) != 2 or \
                not hasattr(cfg, "ffn_hidden_size"):
            return None
        from ..observability.cost_model import gpt_step_cost
        b, s = self._batch_shape
        return gpt_step_cost(cfg, "train_step", batch=b, seq=s)

    def _fused_step(self, inputs, labels):
        """forward + backward + update (k_steps == 1); returns the loss
        and the flags the host reads (None when it reads none)."""
        step_no = self._step_count + 1
        if self._anom_rollback and (
                self._snapshot is None or
                self._step_count % self._rollback_every == 0):
            self._take_snapshot()
        lr = self.optimizer.get_lr()
        flags = None
        if self.fp16_scaling or self._anom_skip:
            # the update is selected per parameter on the device and the
            # optimizer's step count held on a bad step: no host read
            state = self._scaler_state if self.fp16_scaling \
                else self._anomaly_state
            scale = state["scale"] if self.fp16_scaling else None
            loss, grads = self._grads(inputs, labels, scale=scale)
            grads = self._poison_grads(grads, step_no)
            if self.fp16_scaling:
                bad = self._found_inf(grads, 1.0 / scale)
            else:
                bad = self._found_inf(grads) | ~torch.isfinite(loss)
            t = torch.where(bad, state["t"], state["t"] + 1)
            self.optimizer.apply_gradients(self._train, grads, lr=lr,
                                           step=t, skip=bad)
            if self.fp16_scaling:
                self._scaler_state = self._next_scale(bad, t)
            else:
                self._anomaly_state = {
                    "t": t, "skipped": state["skipped"] + bad.to(torch.int32)}
            if self._check_nan_inf:
                # fp16 only: gradient overflow is the scaler's signal; a
                # non-finite unscaled loss is a real divergence
                flags = (~torch.isfinite(loss))[None]
        else:
            loss, grads = self._grads(inputs, labels)
            grads = self._poison_grads(grads, step_no)
            if self._check_nan_inf or self._anom_rollback:
                flags = self._nanguard_vec(loss, grads)
            # the step number lives on the optimizer, so its state_dict
            # carries it (Adam's bias corrections read it)
            self.optimizer.apply_gradients(self._train, grads, lr=lr,
                                           step=step_no)
        self._step_count = step_no
        self.optimizer._step_count = step_no
        return loss, flags

    def _merge_step(self, inputs, labels):
        """Gradient merge: add this step's gradients to the buffers; on
        every k-th step update from them and zero them."""
        loss, grads = self._grads(inputs, labels)
        flags = self._nanguard_vec(loss, grads) if self._check_nan_inf \
            else None
        buf = self._grad_buf
        with torch.no_grad():
            if self._anom_skip:
                # a non-finite micro-batch never enters the buffers; the
                # update still divides by k
                an = self._anomaly_state
                bad = self._found_inf(grads) | ~torch.isfinite(loss)
                for n, g in grads.items():
                    buf[n].copy_(torch.where(bad, buf[n], buf[n] + g))
                self._anomaly_state = {
                    "t": an["t"],
                    "skipped": an["skipped"] + bad.to(torch.int32)}
            else:
                for n, g in grads.items():
                    buf[n].add_(g)
        self._step_count += 1
        if self._step_count % self.k_steps == 0:
            with torch.no_grad():
                if self.gm_avg:
                    for n in grads:
                        buf[n].mul_(1.0 / self.k_steps)
                self.optimizer.apply_gradients(
                    self._train, {n: buf[n] for n in self._train},
                    lr=self.optimizer.get_lr(),
                    step=self._step_count // self.k_steps)
                for b in buf.values():
                    b.zero_()
            self.optimizer._step_count = self._step_count // self.k_steps
        return loss, flags

    @torch.no_grad()
    def eval_step(self, inputs):
        """Forward in eval mode (AMP casts as in training); returns the
        outputs.  An eval loop is progress too: it beats an armed
        watchdog (and never arms one)."""
        if self.watchdog is not None:
            self.watchdog.beat()
        inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) \
            else (inputs,)
        return self._run(self.shard_batch(inputs), training=False)

    # ---- state -------------------------------------------------------
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The parameters and buffers by name (the model's own
        tensors)."""
        sd = dict(self.params)
        sd.update({n: b for n, b in self.model.named_buffers()
                   if b is not None})
        return sd

    def save(self, path: str, extra=None, manifest: bool = False) -> str:
        """Checkpoint the whole training state (parameters, optimizer
        state, step count, LR scheduler, and the gradient-merge buffers,
        the fp16 scaler or the skip counters where they exist).
        ``manifest=True`` writes the checked directory format
        (``distributed.checkpoint.write_checkpoint``)."""
        from .checkpoint import save_trainer
        return save_trainer(self, path, extra=extra, manifest=manifest)

    def load(self, path: str) -> dict:
        """Restore a ``save()`` checkpoint (either format, also one the
        JAX package wrote); returns its ``extra`` dict."""
        from .checkpoint import load_trainer
        return load_trainer(self, path)

    def export_train_step(self, path: str, example_inputs,
                          example_labels) -> str:
        """Write the whole train step (forward, backward, update) as a
        program a non-Python runtime steps (``inference.capi_bridge``'s
        ``create_trainer`` / ``trainer_step``, ``PD_NewTrainer`` in C).

        The program is the pure function ``(params, opt_state, buffers,
        lr, step, *batch) -> (params', opt_state', buffers', loss)`` of
        the JAX trainer's fused step: the bf16 copies of the f32 masters
        under AMP, the forward in training mode (``func.functional_call``),
        the gradients (``torch.autograd.grad`` of the loss), then this
        optimizer's own ``apply_gradients`` (clip, decay, ``_update``) on
        clones of the tensors it is given.  The function is traced to ATen
        ops, backward included, by ``make_fx`` on fake tensors, and that
        graph is captured by ``torch.export``.  Random draws (dropout
        masks, the attention-dropout pair) are ops of the graph: every
        step draws afresh.  The attention kernels stay the
        ``torch.library`` custom ops, so stepping the program launches
        them.  Files: ``path + ".pdtrain"`` (``torch.export.save``) and
        ``path + ".pdtrainstate"`` (a pickle of numpy ``params``,
        ``opt_state``, ``buffers`` and ``lr``, ``step_count``: the JAX
        file's keys and layout; bf16 saved as f32)."""
        import os
        import pickle
        from torch.fx.experimental.proxy_tensor import make_fx
        from ..func import functional_call
        from ..jit.api import _to_numpy
        if self.fp16_scaling or self._check_nan_inf or \
                self.anomaly_policy != "raise":
            raise NotImplementedError(
                "export_train_step supports the standard bf16/fp32 step "
                "(no fp16 scaler state, no nan guard, no anomaly policy) "
                "for a stable serialized signature")
        inputs = tuple(example_inputs) if isinstance(
            example_inputs, (tuple, list)) else (example_inputs,)
        labels = tuple(example_labels) if isinstance(
            example_labels, (tuple, list)) else (example_labels,)
        batch = self.shard_batch(inputs + labels)
        n_in = len(inputs)
        trainer = self

        def step(params, opt_state, buffers, lr, step_no, *batch):
            xs, ys = batch[:n_in], batch[n_in:]
            train = {n: params[n] for n in trainer._train}
            new_buffers = {}

            def loss_of(train_params):
                full = {**params, **train_params}
                if trainer.amp_enabled:
                    full = {n: p.to(trainer.amp_dtype)
                            if p.is_floating_point() else p
                            for n, p in full.items()}
                with collect_aux_losses() as aux, dense_lookups():
                    outs, bufs = functional_call(
                        trainer.model, full, buffers,
                        *trainer._cast_inputs(xs), training=True)
                new_buffers.update(bufs)
                loss = trainer.loss_fn(outs, *ys).float()
                for a in aux:
                    loss = loss + a.float()
                return loss

            # leaves of the trace's autograd: make_fx records the
            # backward the engine runs (torch.func.grad cannot pass the
            # attention custom ops' registered autograd)
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in train.items()}
            with torch.enable_grad():
                loss = loss_of(leaves)
                got = torch.autograd.grad(loss, list(leaves.values()),
                                          allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(leaves.items(), got)}
            new_params = {n: p.clone() for n, p in params.items()}
            new_opt = {n: {k: v.clone() for k, v in acc.items()}
                       for n, acc in opt_state.items()}
            trainer.optimizer.apply_gradients(
                {n: new_params[n] for n in train}, grads, lr=lr,
                step=step_no, states=new_opt)
            return new_params, new_opt, new_buffers, loss.detach()

        params = {n: p.detach() for n, p in self._params.items()}
        # every parameter's accumulators, as the JAX state holds them
        # (a frozen parameter's stay at their start)
        opt_state = {n: {k: v.detach() for k, v in (
            self.optimizer._accumulators[n] if n in self._train
            else self.optimizer._init_accumulators(p)).items()}
            for n, p in self._params.items()}
        buffers = {n: b.detach() for n, b in self.model.named_buffers()
                   if b is not None}
        lr = torch.tensor(self.optimizer.get_lr(), dtype=torch.float32,
                          device=self.device)
        step_no = torch.tensor(self._step_count + 1, dtype=torch.int32,
                               device=self.device)
        args = (params, opt_state, buffers, lr, step_no, *batch)
        graph = make_fx(step, tracing_mode="fake")(*args)
        try:
            program = torch.export.export(graph, args)
        except Exception as e:
            raise RuntimeError(
                f"export_train_step: capturing the traced step with "
                f"torch.export failed ({type(e).__name__}: {e})") from e
        _compile_counter.note("capture", what="export_train_step")
        program.example_inputs = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path + ".pdtrain", "wb") as f:
            torch.export.save(program, f)

        def host(tree):
            return {k: host(v) if isinstance(v, dict) else _to_numpy(v)
                    for k, v in tree.items()}

        state = {"params": host(params), "opt_state": host(opt_state),
                 "buffers": host(buffers),
                 "lr": float(self.optimizer.get_lr()),
                 "step_count": self._step_count}
        with open(path + ".pdtrainstate", "wb") as f:
            pickle.dump(state, f, protocol=4)
        return path

    @property
    def loss_scale(self) -> Optional[float]:
        """The current dynamic loss scale (None unless fp16 AMP); reading
        it is a host sync."""
        if self._scaler_state is None:
            return None
        return float(self._read(self._scaler_state["scale"]))

    @property
    def last_step_skipped(self) -> bool:
        """True when the last fp16 step overflowed and was skipped;
        reading it is a host sync."""
        if self._scaler_state is None:
            return False
        return bool(self._read(self._scaler_state["found_inf"]))

    @property
    def stats(self) -> dict:
        """The anomaly policy, ``rollback_steps``, ``skipped_steps``
        (skip: the device counter; fp16: steps whose optimizer count did
        not advance; reading either is a host sync) and the step-time
        breakdown in milliseconds, cumulative since construction:
        ``data_wait_ms`` (consumer blocked on a prefetcher), ``h2d_ms``
        (host time placing batches), ``dispatch_ms`` (host time of the
        steps: the device runs behind it), ``sync_ms`` (blocked
        read-backs), ``steps_timed``; the step timer's ``step_time_ms``
        (last) and ``step_time_mean_ms``, the registry digest
        ``exec_profile``, the HBM ledger ``hbm`` and the ``doctor``'s
        verdicts."""
        s = {"anomaly_policy": self.anomaly_policy,
             "rollback_steps": self._rollback_count}
        if self._anomaly_state is not None:
            s["skipped_steps"] = int(
                self._read(self._anomaly_state["skipped"]))
        elif self._scaler_state is not None:
            s["skipped_steps"] = self._step_count - int(
                self._read(self._scaler_state["t"]))
        else:
            s["skipped_steps"] = 0
        s.update(self._timings)
        timer = self.step_timer
        s["step_time_ms"] = round(timer.last_ms, 3) \
            if timer.last_ms is not None else None
        s["step_time_mean_ms"] = round(timer.mean_ms, 3) \
            if timer.mean_ms is not None else None
        s["exec_profile"] = _exec_registry.profile(self._exec_component)
        s["hbm"] = _exec_registry.ledger().snapshot()
        s["doctor"] = _doctor.diagnose(s, kind="train")
        return s
