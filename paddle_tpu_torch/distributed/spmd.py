"""The trainer on one GPU (counterpart of ``paddle_tpu/distributed/spmd.py``
``SpmdTrainer`` on a one-device mesh).

The JAX trainer compiles forward, backward and the optimizer update into
one XLA executable; here one ``train_step`` runs them eagerly on the
model's device:
- under ``strategy.amp`` (bf16) the floating parameters are cast to
  bf16 copies of the f32 masters and the floating inputs to bf16, and
  the model runs through ``torch.func.functional_call`` over those
  copies (not ``torch.autocast``, which casts per op and would not
  match the JAX package's numbers).  A tied embedding has one bf16 copy
  serving both its uses, so autograd sums its two gradients into the
  one f32 master;
- the loss (f32) goes backward into the masters' ``.grad`` and the
  optimizer updates them (``Optimizer.apply_gradients``);
- nothing is read back to the host: the step returns a lazy
  ``StepResult`` whose ``float()`` is the one counted host sync.

Every enabled strategy flag is either supported or raises, as in the
JAX trainer.  Supported here: ``amp`` with bf16, ``recompute`` (full
recompute; a selective policy raises) and ``qat`` (the model's
``enable_quantize(qat_configs['quantize'])``: every block linear through
the int8 fake-quant matmul).  Multi-device flags, gradient merge and fp16
loss scaling raise with a pointer to ROADMAP.md, as do the ``skip`` and
``rollback`` anomaly policies.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from .async_dispatch import StepResult
from .fleet.strategy import DistributedStrategy

__all__ = ["SpmdTrainer"]

# flags that need no work on one device (no collectives to fuse or
# reduce, no unused-parameter bookkeeping under autograd)
_MOOT = {"find_unused_parameters", "fuse_all_reduce_ops",
         "use_hierarchical_allreduce"}


class SpmdTrainer:
    """One training step = forward + backward + optimizer update on the
    model's device.

    Parameters
    ----------
    model : ``torch.nn.Module`` (its parameters are the f32 masters the
        optimizer updates in place).
    optimizer : ``paddle_tpu_torch.optimizer.Optimizer``.
    loss_fn : callable(outputs, *labels) -> scalar tensor.
    strategy : ``DistributedStrategy``; ``amp`` (bf16), ``recompute`` and
        ``qat`` are honored, any other enabled flag raises.
    anomaly_policy : ``'raise'`` (default; a non-finite loss is left for
        the caller to see, with no per-step check and so no host sync).
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

        st = self.strategy
        for key, val in st.to_dict().items():
            if val is True and key not in {"amp", "recompute", "qat"} | _MOOT:
                raise NotImplementedError(
                    f"DistributedStrategy.{key} is not supported by the "
                    f"port's single-GPU trainer yet (see ROADMAP.md); "
                    f"supported flags: ['amp', 'recompute', 'qat']")
        self.amp_enabled = bool(st.amp)
        if self.amp_enabled and not st.amp_configs.get("use_bf16", True):
            raise NotImplementedError(
                "fp16 AMP with dynamic loss scaling is not ported yet (see "
                "ROADMAP.md); use bf16 (amp_configs use_bf16=True)")
        self.amp_dtype = torch.bfloat16

        self.anomaly_policy = anomaly_policy or "raise"
        if self.anomaly_policy not in ("raise", "skip", "rollback"):
            raise ValueError(f"anomaly_policy must be raise|skip|rollback, "
                             f"got {self.anomaly_policy!r}")
        if self.anomaly_policy != "raise":
            raise NotImplementedError(
                f"anomaly_policy={self.anomaly_policy!r} is not ported yet "
                f"(see ROADMAP.md); use 'raise'")

        if st.recompute:
            if st.recompute_configs.get("scan_layers"):
                raise NotImplementedError(
                    "recompute_configs['scan_layers'] is a JAX compile-time "
                    "option with no counterpart in the port")
            if not hasattr(model, "enable_recompute"):
                raise NotImplementedError(
                    "strategy.recompute=True but the model has no "
                    "enable_recompute()")
            model.enable_recompute(st.recompute_configs.get("policy"))

        # quantization-aware training: every block linear runs the int8
        # fake-quant matmul (quantized forward, straight-through backward);
        # parameters and optimizer are untouched
        if st.qat:
            if not hasattr(model, "enable_quantize"):
                raise NotImplementedError(
                    "strategy.qat=True but the model has no "
                    "enable_quantize(); route its products through "
                    "paddle_tpu_torch.ops.fake_quant_matmul instead")
            model.enable_quantize(st.qat_configs.get("quantize", "int8"))

        self._params = dict(model.named_parameters())
        first = next(iter(self._params.values()), None)
        self.device = first.device if first is not None \
            else torch.device("cpu")

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
        self._timings["h2d_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def _compute_params(self):
        """The parameters the forward runs on: bf16 copies of the
        floating masters under AMP (differentiable casts), else the
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
            return torch.func.functional_call(
                self.model, self._compute_params(), self._cast_inputs(inputs))
        finally:
            self.model.train(was)

    # ------------------------------------------------------------------
    def train_step(self, inputs, labels) -> StepResult:
        """One step: forward, loss, backward into the masters, optimizer
        update.  inputs/labels: an array or tensor, or a tuple of them.
        Returns a lazy ``StepResult`` (no host sync until it is read)."""
        inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (tuple, list)) \
            else (labels,)
        batch = self.shard_batch(inputs + labels)
        inputs, labels = batch[:len(inputs)], batch[len(inputs):]
        t0 = time.perf_counter()
        for p in self._params.values():
            p.grad = None
        outs = self._run(inputs, training=True)
        loss = self.loss_fn(outs, *labels).float()
        loss.backward()
        train = {n: p for n, p in self._params.items() if p.requires_grad}
        # the step number lives on the optimizer, so its state_dict
        # carries it (Adam's bias corrections read it)
        step = self.optimizer._step_count + 1
        self.optimizer.apply_gradients(
            train, {n: p.grad if p.grad is not None else torch.zeros_like(p)
                    for n, p in train.items()},
            lr=self.optimizer.get_lr(), step=step)
        self.optimizer._step_count = step
        self._timings["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
        self._timings["steps_timed"] += 1
        return StepResult(loss.detach(), timings=self._timings)

    @torch.no_grad()
    def eval_step(self, inputs):
        """Forward in eval mode (AMP casts as in training); returns the
        outputs."""
        inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) \
            else (inputs,)
        return self._run(self.shard_batch(inputs), training=False)

    @property
    def stats(self) -> dict:
        """Step-time breakdown in milliseconds, cumulative since
        construction: ``data_wait_ms`` (consumer blocked on a
        prefetcher), ``h2d_ms`` (host time placing batches),
        ``dispatch_ms`` (host time of the steps: the device runs behind
        it), ``sync_ms`` (blocked read-backs), ``steps_timed``."""
        s = {"anomaly_policy": self.anomaly_policy}
        s.update(self._timings)
        return s
