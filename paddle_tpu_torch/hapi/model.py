"""``hapi.Model``: prepare / fit / evaluate / predict / save / load
(counterpart of ``paddle_tpu/hapi/model.py``).

Two loops, as in the JAX package:
- **eager** (``prepare(optimizer, loss, metrics)``): each batch runs the
  network forward, ``loss.backward()`` and ``optimizer.step()`` /
  ``clear_grad()``; the caller's ``amp.auto_cast`` (or
  ``prepare(amp_configs=...)``) casts the functionals inside it;
- **trainer** (``prepare(..., strategy=DistributedStrategy(...))`` or
  ``mesh={"dp": 1}``): each batch is one ``distributed.SpmdTrainer``
  step (bf16 or fp16 AMP copies of the f32 masters, gradient merge,
  recompute where the network has it).  A mesh over more than one
  device waits for the multi-GPU slice (ROADMAP.md Queue 1 item 3.1).

Batches come from ``io.DataLoader`` (tensors on the current device) or
any iterable of tuples; inputs and labels are moved to the network's
device.  Metrics run ``compute`` on the outputs' device and keep their
totals there.  Losses are read back once per step in the eager loop
(Paddle's ``train_batch`` returns floats) and at ``log_freq`` in the
trainer loop.

``fit(save_dir=..., auto_resume=True)`` checkpoints the whole state
under ``save_dir/auto`` each ``save_freq`` epochs and resumes from the
newest valid one: the trainer loop through
``distributed.resilience.CheckpointManager``; the eager loop with JSON
markers naming the ``save_dir/{epoch}`` weights.  While it runs,
SIGTERM / SIGINT (``resilience.PreemptionGuard``) finish the step in
flight, save a final checkpoint with the position in the epoch, and
return.
"""
from __future__ import annotations

import contextlib
import inspect
import json
import os

import numpy as np
import torch

from ..amp.auto_cast import auto_cast
from ..device import current_device
from ..distributed.async_dispatch import StepResult
from ..framework.io import load as fload
from ..framework.io import save as fsave
from ..io import DataLoader
from ..metric.metrics import Metric
from . import callbacks as cbks_mod
from .model_summary import summary

__all__ = ["Model"]


class _Preempted(Exception):
    """SIGTERM / SIGINT arrived, the step in flight finished and a
    checkpoint was committed: unwind fit()."""


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _scalar(v):
    """A log value as a float (device scalars and step results are read
    here)."""
    if isinstance(v, StepResult) or torch.is_tensor(v):
        return float(v)
    if isinstance(v, list):
        return [_scalar(x) for x in v]
    return v


def _mesh_devices(mesh) -> int:
    if isinstance(mesh, dict):
        return int(np.prod(list(mesh.values()))) if mesh else 1
    return len(getattr(mesh, "devices", mesh) or [1])


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp = None
        self.stop_training = False
        self.preempted = False
        self._strategy = None
        self._compiled = False
        self._trainer = None
        self._ckpt_manager = None
        # train batches across resumes (names the eager auto markers)
        self._global_batch_count = 0

    # ---- setup -------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, mesh=None, strategy=None):
        """Set the optimizer, the loss (a callable of the outputs and the
        labels) and the metrics.  ``amp_configs`` (a level ``'O1'`` /
        ``'O2'`` or ``auto_cast``'s keywords) casts the eager loop's
        functionals; ``strategy`` (or a one-device ``mesh``) runs the
        trainer loop."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m} is not a paddle.metric.Metric")
        if isinstance(amp_configs, str):
            amp_configs = {"level": amp_configs}
        self._amp = amp_configs
        self._trainer = None
        strategy = strategy or getattr(optimizer, "user_defined_strategy",
                                       None)
        if mesh is not None and _mesh_devices(mesh) > 1:
            raise NotImplementedError(
                f"prepare(mesh={mesh!r}) spans more than one device: the "
                f"multi-GPU slice comes with a machine of more than one "
                f"GPU (ROADMAP.md Queue 1 item 3.1)")
        self._compiled = mesh is not None or strategy is not None
        self._strategy = strategy
        return self

    @property
    def compiled(self) -> bool:
        return self._compiled

    def _ensure_trainer(self):
        if self._trainer is None:
            from ..distributed.spmd import SpmdTrainer

            def loss_fn(outputs, *labels):
                return self._loss(*(_to_list(outputs) + list(labels)))

            opt = getattr(self._optimizer, "inner_opt", self._optimizer)
            self._trainer = SpmdTrainer(self.network, opt, loss_fn,
                                        strategy=self._strategy)
        return self._trainer

    def _cast_scope(self):
        return auto_cast(**self._amp) if self._amp else \
            contextlib.nullcontext()

    def _device(self) -> torch.device:
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else current_device()

    def _t(self, x):
        """A batch field as a tensor on the network's device."""
        dev = self._device()
        if torch.is_tensor(x):
            return x if x.device == dev else x.to(dev, non_blocking=True)
        arr = np.asarray(x)
        t = torch.from_numpy(arr)
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(dev)

    # ---- one batch ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One training batch; returns ``[loss]`` (and the metrics'
        running values when there are metrics)."""
        inputs = [self._t(i) for i in _to_list(inputs)]
        labels = [self._t(l) for l in _to_list(labels)]
        if self.compiled:
            if not update:
                raise NotImplementedError(
                    "accumulate_grad_batches > 1 in the trainer loop: use "
                    "strategy.gradient_merge")
            tr = self._ensure_trainer()
            if self._metrics:
                loss, outputs = tr.train_step(tuple(inputs), tuple(labels),
                                              return_outputs=True)
                metrics = self._update_metrics(outputs, labels)
                return [loss], metrics
            return [tr.train_step(tuple(inputs), tuple(labels))]
        self.network.train()
        with self._cast_scope():
            outputs = self.network(*inputs)
            losses = self._compute_loss(outputs, labels)
        losses.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        loss = float(losses.detach())
        return ([loss], metrics) if metrics else [loss]

    def eval_batch(self, inputs, labels=None):
        inputs = [self._t(i) for i in _to_list(inputs)]
        labels = [self._t(l) for l in _to_list(labels)]
        if self.compiled:
            outputs = self._ensure_trainer().eval_step(tuple(inputs))
        else:
            self.network.eval()
            with torch.no_grad(), self._cast_scope():
                outputs = self.network(*inputs)
        with torch.no_grad():
            losses = self._compute_loss(outputs, labels) \
                if self._loss is not None and labels else None
        metrics = self._update_metrics(outputs, labels)
        loss_list = [float(losses.detach())] if losses is not None else []
        return (loss_list, metrics) if metrics else loss_list

    def predict_batch(self, inputs):
        inputs = [self._t(i) for i in _to_list(inputs)]
        if self.compiled:
            return _to_list(self._ensure_trainer().eval_step(tuple(inputs)))
        self.network.eval()
        with torch.no_grad(), self._cast_scope():
            outputs = self.network(*inputs)
        return _to_list(outputs)

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("call prepare(loss=...) before training")
        return self._loss(*(_to_list(outputs) + list(labels)))

    def _update_metrics(self, outputs, labels):
        res = {}
        if not labels:
            return res
        outs = [o.detach() if torch.is_tensor(o) else o
                for o in _to_list(outputs)]
        for m in self._metrics:
            pre = m.compute(*(outs + list(labels)))
            val = m.update(*_to_list(pre))
            name = m.name()
            res[name[0] if isinstance(name, list) else name] = val
        return res

    # ---- loops -------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            auto_resume=False, prefetch_depth=None):
        """Train for ``epochs`` over ``train_data`` (a Dataset or a
        DataLoader), evaluating every ``eval_freq`` epochs and saving to
        ``save_dir/{epoch}`` every ``save_freq``.  ``prefetch_depth`` is
        accepted for the JAX signature: the port's DataLoader already
        hands out device tensors."""
        train_loader = self._as_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False, False,
                                      num_workers) \
            if eval_data is not None else None
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs,
            steps=self._try_len(train_loader), log_freq=log_freq,
            save_freq=save_freq, save_dir=save_dir, verbose=verbose,
            metrics=self._metrics_names())
        start_epoch, skip_steps = 0, 0
        auto_dir = os.path.join(save_dir, "auto") \
            if (auto_resume and save_dir) else None
        guard = None
        if auto_dir:
            start_epoch, skip_steps = self._auto_restore(auto_dir)
            from ..distributed.resilience import PreemptionGuard
            guard = PreemptionGuard().install()
        self.stop_training = False
        self.preempted = False
        try:
            cbks.on_begin("train")
            for epoch in range(start_epoch, epochs):
                cbks.on_epoch_begin(epoch)
                try:
                    logs = self._run_one_epoch(
                        train_loader, cbks, "train",
                        accumulate_grad_batches, num_iters,
                        skip_steps=(skip_steps if epoch == start_epoch
                                    else 0),
                        guard=guard, epoch=epoch, auto_dir=auto_dir,
                        log_freq=log_freq)
                except _Preempted:
                    self.preempted = True
                    self.stop_training = True
                    break
                cbks.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, verbose=0,
                                              _inner_cbks=cbks)
                    logs.update({"eval_" + k: v
                                 for k, v in eval_logs.items()})
                if save_dir is not None and (epoch + 1) % save_freq == 0:
                    self.save(os.path.join(save_dir, str(epoch)))
                    if auto_dir:
                        self._auto_save(auto_dir, epoch)
                if self.stop_training:
                    break
            if save_dir is not None and not self.preempted:
                self.save(os.path.join(save_dir, "final"))
            cbks.on_end("train")
        finally:
            if guard is not None:
                guard.uninstall()
            if self._ckpt_manager is not None:
                self._ckpt_manager.wait()

    # ---- auto checkpoint ---------------------------------------------
    _AUTO_KEEP = 2  # retained snapshots (newest + one fallback)

    def _ensure_ckpt_manager(self, auto_dir):
        from ..distributed.resilience import CheckpointManager
        if self._ckpt_manager is None or \
                self._ckpt_manager.directory != auto_dir:
            self._ckpt_manager = CheckpointManager(
                auto_dir, keep_last=self._AUTO_KEEP)
        return self._ckpt_manager

    def _eager_marker(self, auto_dir, epoch, batch_step, weights):
        """An eager auto checkpoint: a JSON marker named by the global
        batch count, pointing at saved weights and optimizer state."""
        os.makedirs(auto_dir, exist_ok=True)
        g = self._global_batch_count
        tmp = os.path.join(auto_dir, f"ckpt-{g}.tmp")
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "batch_step": batch_step,
                       "global_step": g, "mode": "eager",
                       "weights": weights}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(auto_dir, f"ckpt-{g}"))
        self._auto_prune(auto_dir)

    def _auto_save(self, auto_dir, epoch):
        if self.compiled:
            tr = self._ensure_trainer()
            self._ensure_ckpt_manager(auto_dir).save(
                tr, step=tr._step_count, extra={"epoch": epoch})
        else:
            weights = os.path.join(os.path.dirname(auto_dir), str(epoch))
            self._eager_marker(auto_dir, epoch, None, weights)

    def _preempt_save(self, auto_dir, epoch, step):
        if auto_dir is None:
            return
        if self.compiled:
            tr = self._ensure_trainer()
            self._ensure_ckpt_manager(auto_dir).save(
                tr, step=tr._step_count,
                extra={"epoch": epoch, "batch_step": step}, block=True)
        else:
            weights = os.path.join(os.path.dirname(auto_dir),
                                   f"preempt-{self._global_batch_count}")
            self.save(weights)
            self._eager_marker(auto_dir, epoch, step, weights)

    @staticmethod
    def _markers(auto_dir):
        out = []
        for name in os.listdir(auto_dir):
            if name.startswith("ckpt-") and not name.endswith(".tmp"):
                try:
                    out.append((int(name[len("ckpt-"):]), name))
                except ValueError:
                    continue
        return sorted(out)

    def _auto_prune(self, auto_dir):
        for _, name in self._markers(auto_dir)[:-self._AUTO_KEEP]:
            os.remove(os.path.join(auto_dir, name))

    def _auto_restore(self, auto_dir):
        """-> (start_epoch, skip_steps) from the newest valid auto
        checkpoint; skip_steps > 0 resumes mid-epoch (a preemption)."""
        from ..distributed.checkpoint import latest_checkpoint
        if not os.path.isdir(auto_dir):
            return 0, 0
        ck = latest_checkpoint(auto_dir, validate=False)
        if ck is None:
            return 0, 0
        ck_compiled = os.path.isdir(ck)
        if not ck_compiled:
            with open(ck, "rb") as f:
                ck_compiled = f.read(1) == b"\x80"
        if ck_compiled != self.compiled:
            raise RuntimeError(
                f"auto checkpoint {ck} was written by the "
                f"{'trainer' if ck_compiled else 'eager'} loop but this run "
                f"uses the {'trainer' if self.compiled else 'eager'} one; "
                f"prepare() as the interrupted run did (or remove the "
                f"auto/ directory)")
        if self.compiled:
            extra = self._ensure_ckpt_manager(auto_dir).restore_latest(
                self._ensure_trainer())
            if extra is None:
                return 0, 0
            epoch = int(extra.get("epoch", -1))
            batch_step = extra.get("batch_step")
            if batch_step is not None:
                return epoch, int(batch_step) + 1
            return epoch + 1, 0
        for _, name in reversed(self._markers(auto_dir)):
            try:
                with open(os.path.join(auto_dir, name)) as f:
                    meta = json.load(f)
                self.load(meta["weights"])
            except (OSError, ValueError, KeyError):
                continue
            self._global_batch_count = int(meta.get("global_step", 0))
            epoch = int(meta["epoch"])
            batch_step = meta.get("batch_step")
            if batch_step is not None:
                return epoch, int(batch_step) + 1
            return epoch + 1, 0
        return 0, 0

    @staticmethod
    def _resolve_logs(logs):
        for k, v in list(logs.items()):
            logs[k] = _scalar(v)
        return logs

    def _run_one_epoch(self, loader, cbks, mode, accum=1, num_iters=None,
                       skip_steps=0, guard=None, epoch=0, auto_dir=None,
                       log_freq=10):
        from ..observability import metrics as _obs_metrics
        from ..profiler import StepTimer
        logs = {}
        timer = StepTimer(warmup=1)
        timer.start()
        m_step = _obs_metrics.gauge(
            "fit_step_time_ms",
            "hapi fit per-step wall time (data wait included)",
            labels=("mode",)).labels(mode=mode)
        for m in self._metrics:
            m.reset()
        it = iter(loader)
        first_step = 0
        if mode == "train" and skip_steps:
            # mid-epoch resume: skip the batches consumed before the
            # preemption checkpoint, so the data order matches
            for _ in range(skip_steps):
                try:
                    next(it)
                except StopIteration:
                    break
                first_step += 1
        for step, batch in enumerate(it, start=first_step):
            if num_iters is not None and step >= num_iters:
                break
            cbks.on_batch_begin(mode, step, logs)
            ins, labs = self._split_batch(batch)
            if mode == "train":
                out = self.train_batch(ins, labs,
                                       update=(step + 1) % accum == 0)
                self._global_batch_count += 1
            else:
                out = self.eval_batch(ins, labs)
            loss_list, metrics = out if isinstance(out, tuple) \
                else (out, {})
            if loss_list:
                logs["loss"] = loss_list[0]
            logs.update(metrics)
            logs["batch_size"] = (labs[0].shape[0] if labs
                                  else ins[0].shape[0])
            timer.tick()
            if timer.last_ms is not None:
                logs["step_time_ms"] = round(timer.last_ms, 3)
                m_step.set(timer.last_ms)
            if step % log_freq == 0:
                self._resolve_logs(logs)
            cbks.on_batch_end(mode, step, logs)
            if mode == "train" and guard is not None and guard.preempted:
                self._preempt_save(auto_dir, epoch, step)
                raise _Preempted()
        return self._resolve_logs(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None,
                 _inner_cbks=None):
        """The mean loss of the last batch and every metric over
        ``eval_data``."""
        loader = self._as_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbks = _inner_cbks or cbks_mod.config_callbacks(
            callbacks, model=self, steps=self._try_len(loader),
            log_freq=log_freq, verbose=verbose,
            metrics=self._metrics_names())
        if _inner_cbks is None:
            cbks.on_begin("eval")
        logs = self._run_one_epoch(loader, cbks, "eval",
                                   num_iters=num_iters, log_freq=log_freq)
        if _inner_cbks is None:
            cbks.on_end("eval", logs)
        out = {}
        if "loss" in logs:
            out["loss"] = logs["loss"]
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            out.update(dict(zip(names, vals if isinstance(vals, list)
                                else [vals])))
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """The network's outputs over ``test_data`` as numpy arrays, one
        list per output (stacked with ``stack_outputs``)."""
        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, has_labels=False)
            outputs.append([o.detach().float().cpu().numpy()
                            if o.dtype == torch.bfloat16
                            else o.detach().cpu().numpy()
                            for o in self.predict_batch(ins)])
        grouped = list(zip(*outputs))
        if stack_outputs:
            return [np.concatenate(g, axis=0) for g in grouped]
        return [list(g) for g in grouped]

    # ---- persistence -------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's), in the JAX
        package's format."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path.pdparams`` (either package's); unknown, missing or
        mis-shaped names raise unless ``skip_mismatch``."""
        self.network.set_state_dict(fload(path + ".pdparams"),
                                    strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """``hapi.summary`` of the network."""
        return summary(self.network, input_size, dtypes=dtype)

    # ---- helpers -----------------------------------------------------
    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader) or \
                not hasattr(data, "__getitem__"):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    @staticmethod
    def _try_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    def _n_inputs(self):
        """Positional parameters of ``network.forward`` without a
        default."""
        try:
            sig = inspect.signature(self.network.forward)
            return len([p for p in sig.parameters.values()
                        if p.kind in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD)
                        and p.default is p.empty])
        except (TypeError, ValueError):
            return 1

    def _split_batch(self, batch, has_labels=True):
        if isinstance(batch, (list, tuple)):
            batch = list(batch)
            if len(batch) > 1:
                n_in = self._n_inputs()
                if has_labels:
                    n_in = min(n_in, len(batch) - 1)
                return batch[:n_in], (batch[n_in:] if has_labels else [])
            return batch, []
        return [batch], []

    def _metrics_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names
