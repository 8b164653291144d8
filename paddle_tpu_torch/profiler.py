"""Profiler: trace annotations, capture control, per-step timing
(counterpart of ``paddle_tpu/profiler.py``).

What the framework owns on top of the CUDA timeline that CUPTI records:
(1) host-side annotations that nest inside the device trace
(``RecordEvent`` over ``torch.profiler.record_function``; while the span
tracer is armed the same pair also lands in its buffer), (2) capture
control writing a Chrome trace that holds the device kernels
(``start_profiler``/``stop_profiler``/``profiler`` over
``torch.profiler.profile`` with CPU and, on the card, CUDA activities),
and (3) wall-clock step statistics (``StepTimer``).

``cost_stats`` and ``memory_stats`` (4) are the JAX package's analyses
of a compiled executable, made on what the port compiles or runs: a
``torch.export.ExportedProgram`` (its graph walked node by node, from
the shapes each node records; nothing runs), a ``jit.to_static``
function (its latest capture, walked the same way), or a callable with
example inputs (run once under a dispatch mode that sees every ATen or
custom op, ``fake=True`` on fake tensors, so nothing computes).  flops
are ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
attention; the flash ops register theirs in ``ops.flash_attention``);
``bytes_accessed`` sums the bytes of each op's tensor operands and
results, XLA's per-op convention.  Memory is argument + output bytes
plus, when the call runs on the card, the allocator's peak over it
above what was allocated at its start.  An object that cannot be
analysed gives ``{}`` and counts ``exec_analysis_failures_total
{stage}``; neither function raises.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import time
from typing import Optional

from .observability import spans as _spans

__all__ = ["RecordEvent", "record_event", "profiler", "start_profiler",
           "stop_profiler", "StepTimer", "default_log_dir", "cost_stats",
           "memory_stats"]

# the one live capture: (torch.profiler.profile, log_dir)
_ACTIVE = {"prof": None, "log_dir": None}
_SEQ = itertools.count()


def default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_profile")


class RecordEvent:
    """Host-side trace annotation, as a context manager or decorator:
    a ``record_function`` range in any live ``torch.profiler`` capture
    and, while the span tracer is armed, a span in its buffer."""

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name = name
        self.args = args
        self._rf = None
        self._t0_us = 0.0

    def __enter__(self):
        from torch.profiler import record_function
        self._rf = record_function(self.name)
        self._rf.__enter__()
        tr = _spans.tracer()
        if tr.active:
            self._t0_us = tr.now_us()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._rf = None
        tr = _spans.tracer()
        if tr.active:
            now = tr.now_us()
            tr.complete(self.name, self._t0_us, now - self._t0_us,
                        cat="record_event", args=self.args)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)
        return wrapped


record_event = RecordEvent


def start_profiler(log_dir: Optional[str] = None,
                   tracer_option: Optional[str] = None) -> str:
    """Begin a capture (CPU activity, and CUDA activity when a card is
    present) whose Chrome trace ``stop_profiler`` writes under
    ``log_dir``.  One capture at a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _ACTIVE["prof"] is not None:
        raise RuntimeError("profiler already started")
    log_dir = log_dir or default_log_dir()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _ACTIVE.update(prof=prof, log_dir=log_dir)
    _spans._CAPTURE["live"] = True
    return log_dir


def stop_profiler(sorted_key=None, profile_path: Optional[str] = None
                  ) -> Optional[str]:
    """End the capture and write its Chrome trace (``profile_path``, or
    ``<log_dir>/trace_<pid>_<n>.json``); returns the file's path, None
    when no capture was live."""
    prof, log_dir = _ACTIVE["prof"], _ACTIVE["log_dir"]
    if prof is None:
        return None
    _spans._CAPTURE["live"] = False
    _ACTIVE.update(prof=None, log_dir=None)
    prof.stop()
    path = profile_path or os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_SEQ)}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler(log_dir: Optional[str] = None, state=None,
             tracer_option=None, profile_path=None):
    """Capture the body of the ``with`` block."""
    start_profiler(log_dir, tracer_option)
    try:
        yield
    finally:
        stop_profiler(profile_path=profile_path)


class StepTimer:
    """Wall-clock step statistics: ``tick()`` after each step; read
    ``last_ms``, ``mean_ms``, ``p50_ms`` (the first ``warmup`` steps are
    not kept)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times_ms = []
        self._t0 = None
        self._seen = 0

    def start(self):
        self._t0 = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._t0 is not None:
            self._seen += 1
            if self._seen > self.warmup:
                self.times_ms.append((now - self._t0) * 1e3)
        self._t0 = now

    @property
    def last_ms(self):
        return self.times_ms[-1] if self.times_ms else None

    @property
    def mean_ms(self):
        return sum(self.times_ms) / len(self.times_ms) \
            if self.times_ms else None

    @property
    def p50_ms(self):
        if not self.times_ms:
            return None
        s = sorted(self.times_ms)
        return s[len(s) // 2]

    def summary(self):
        return {"steps": len(self.times_ms), "mean_ms": self.mean_ms,
                "p50_ms": self.p50_ms, "last_ms": self.last_ms}


# ---------------------------------------------------------------------------
# cost and memory analyses
# ---------------------------------------------------------------------------
def _analysis_degraded(stage: str) -> dict:
    """An object the analyses cannot read degrades to ``{}`` (the exec
    registry keeps its entry timing-only), and the failure is counted so
    a dashboard sees the blind spot."""
    try:
        from .observability import metrics as _metrics
        _metrics.counter(
            "exec_analysis_failures_total",
            "executable cost/memory analyses that degraded to "
            "timing-only", labels=("stage",)).labels(stage=stage).inc()
    except Exception:
        pass
    return {}


def _tensor_bytes(tree) -> int:
    import torch
    from torch.utils import _pytree as pytree
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree) if torch.is_tensor(t))


def _op_flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry
    f = flop_registry.get(getattr(func, "_overloadpacket", func))
    return int(f(*args, **kwargs, out_val=out)) if f is not None else 0


def _latest_program(obj):
    """The ExportedProgram to walk: ``obj`` itself, or a ``to_static``
    function's latest capture (None otherwise)."""
    import torch
    if isinstance(obj, torch.export.ExportedProgram):
        return obj
    exported = getattr(obj, "exported", None)
    if isinstance(exported, dict) and exported:
        return list(exported.values())[-1]
    return None


def _walk(ep):
    """``(flops, bytes, argument_bytes, output_bytes, flops by op)`` of an
    exported graph from the values its nodes record."""
    import torch
    from torch.utils import _pytree as pytree

    def val(a):
        return a.meta.get("val") if isinstance(a, torch.fx.Node) else a

    flops = nbytes = arg_bytes = out_bytes = 0
    by_op: dict = {}
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            arg_bytes += _tensor_bytes(node.meta.get("val"))
        elif node.op == "output":
            out_bytes += _tensor_bytes(
                pytree.tree_map(val, node.args))
        elif node.op == "call_function" and isinstance(
                node.target, torch._ops.OpOverload):
            args = pytree.tree_map(val, node.args)
            kwargs = pytree.tree_map(val, node.kwargs)
            out = node.meta.get("val")
            f = _op_flops(node.target, args, kwargs, out)
            if f:
                name = str(node.target.overloadpacket)
                by_op[name] = by_op.get(name, 0) + f
            flops += f
            nbytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
    return flops, nbytes, arg_bytes, out_bytes, by_op


def _run_counted(fn, args, kwargs, fake: bool):
    """Run ``fn(*args, **kwargs)`` once under a dispatch mode summing
    each op's flops and operand + result bytes.  Returns ``(out, flops,
    bytes, flops by op)``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    tally = {"flops": 0, "bytes": 0, "by_op": {}}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), k=None):
            k = k or {}
            out = func(*a, **k)
            f = _op_flops(func, a, k, out)
            if f:
                name = str(func.overloadpacket)
                tally["by_op"][name] = tally["by_op"].get(name, 0) + f
            tally["flops"] += f
            tally["bytes"] += _tensor_bytes((a, k)) + _tensor_bytes(out)
            return out

    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils import _pytree as pytree
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        args, kwargs = pytree.tree_map(
            lambda t: mode.from_tensor(t) if torch.is_tensor(t) else t,
            (args, kwargs))
        with mode, _Count():
            out = fn(*args, **kwargs)
    else:
        with _Count():
            out = fn(*args, **kwargs)
    return out, tally["flops"], tally["bytes"], tally["by_op"]


def cost_stats(obj, *args, fake: bool = False, **kwargs) -> dict:
    """``{"flops", "bytes_accessed", "flops_by_op"}`` of an
    ExportedProgram, a ``to_static`` function's latest capture, or
    ``obj(*args, **kwargs)`` run once (``fake=True``: on fake tensors);
    ``flops_by_op`` maps each op with flops (``"aten.mm"``,
    ``"paddle_tpu.flash_fwd"``) to its total.  ``{}`` (counted) when the
    object cannot be analysed."""
    try:
        ep = _latest_program(obj)
        if ep is not None:
            flops, nbytes, _, _, by_op = _walk(ep)
        elif callable(obj):
            _, flops, nbytes, by_op = _run_counted(obj, args, kwargs, fake)
        else:
            return _analysis_degraded("cost_analysis")
    except Exception:
        return _analysis_degraded("cost_analysis")
    return {"flops": float(flops), "bytes_accessed": float(nbytes),
            "flops_by_op": {k: float(v) for k, v in by_op.items()}}


def memory_stats(obj, *args, **kwargs) -> dict:
    """``{"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
    "peak_bytes"}``: argument and output bytes (an ExportedProgram's from
    its placeholders and outputs; a callable's from its inputs, a
    module's parameters and buffers, and its result), ``temp_bytes`` the
    allocator's peak over one call on the card above what was allocated
    at its start (0 for a graph walked without running, or on the CPU),
    ``peak_bytes`` their sum.  ``{}`` (counted) on failure."""
    import torch
    try:
        ep = _latest_program(obj)
        temp = 0
        if ep is not None:
            _, _, arg_bytes, out_bytes, _ = _walk(ep)
        elif callable(obj):
            arg_bytes = _tensor_bytes((args, kwargs))
            if isinstance(obj, torch.nn.Module):
                arg_bytes += _tensor_bytes(list(obj.parameters()) +
                                           list(obj.buffers()))
            on_card = any(t.is_cuda for t in
                          torch.utils._pytree.tree_leaves((args, kwargs))
                          if torch.is_tensor(t))
            if on_card:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            out = obj(*args, **kwargs)
            out_bytes = _tensor_bytes(out)
            if on_card:
                torch.cuda.synchronize()
                temp = max(0, torch.cuda.max_memory_allocated() - base -
                           out_bytes)
        else:
            return _analysis_degraded("memory_analysis")
    except Exception:
        return _analysis_degraded("memory_analysis")
    return {"argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
            "temp_bytes": int(temp), "alias_bytes": 0,
            "peak_bytes": int(arg_bytes + out_bytes + temp)}
