"""``paddle.static`` helpers (counterpart of
``paddle_tpu/static/helpers.py``): scopes, places, strategies, program
save / load, the debug and metric ops, and the gradient helpers.

Paddle backs these with its C++ Scope and ParallelExecutor; here a
program is a recorded graph that ``Executor.run`` replays, so the
classes keep the API's shape while the Executor does the work.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.tensor import Parameter
from ..device import CPUPlace, CUDAPlace, current_device
from ..jit.api import _to_numpy as _host
from ..nn.layer_base import ParamAttr
from .program import (Executor, Variable, default_main_program, maybe_record,
                      record_gradients)

__all__ = [
    "Scope", "global_scope", "scope_guard", "device_guard", "name_scope",
    "cpu_places", "cuda_places", "xpu_places", "tpu_places",
    "create_parameter", "create_global_var", "Print", "accuracy", "auc",
    "append_backward", "gradients", "BuildStrategy", "ExecutionStrategy",
    "CompiledProgram", "ParallelExecutor", "WeightNormParamAttr",
    "save", "load", "save_vars", "load_vars", "save_to_file",
    "load_from_file", "set_program_state", "load_program_state",
    "serialize_program", "deserialize_program", "serialize_persistables",
    "deserialize_persistables",
]


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------
class _ScopeVar:
    """A variable slot of a Scope: holds a numpy value reached through
    ``get_tensor()``."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def get_tensor(self):
        return self

    def set(self, value, place=None):
        self._value = np.asarray(value)

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._value)
        return a.astype(dtype) if dtype else a

    def shape(self):
        return tuple(np.asarray(self._value).shape)


class Scope:
    """A hierarchical name -> variable map (Paddle's ``Scope``)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, _ScopeVar] = {}
        self._parent = parent
        self._kids: List["Scope"] = []

    def var(self, name):
        if name not in self._vars:
            self._vars[name] = _ScopeVar(name)
        return self._vars[name]

    def find_var(self, name):
        if name in self._vars:
            return self._vars[name]
        return self._parent.find_var(name) if self._parent else None

    def new_scope(self):
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    def local_var_names(self):
        return list(self._vars)


_SCOPE_STACK: List[Scope] = [Scope()]


def global_scope() -> Scope:
    return _SCOPE_STACK[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _SCOPE_STACK.append(scope)
    try:
        yield
    finally:
        _SCOPE_STACK.pop()


# ---------------------------------------------------------------------------
# places / guards
# ---------------------------------------------------------------------------
def cpu_places(device_count=None):
    if device_count is None:
        device_count = int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(device_count)]


def cuda_places(device_ids=None):
    """One ``CUDAPlace`` per visible card (or per given id)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def xpu_places(device_ids=None):
    return []


def tpu_places(device_ids=None):
    return []


@contextlib.contextmanager
def device_guard(device=None):
    """Paddle's ``device_guard`` pins ops to a device for its pipeline
    pass; the port runs a program on its Executor's device, so this only
    annotates."""
    yield


_NAME_SCOPE: List[str] = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """Paddle's ``name_scope``: a prefix for recorded op names."""
    _NAME_SCOPE.append(prefix or "scope")
    try:
        yield
    finally:
        _NAME_SCOPE.pop()


def current_name_scope() -> str:
    return "/".join(_NAME_SCOPE)


# ---------------------------------------------------------------------------
# parameters / vars
# ---------------------------------------------------------------------------
def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A free-standing trainable Parameter on the current device (Xavier
    by default, zeros for a bias); None for ``attr=False``."""
    from ..core import random as prandom
    from ..core.dtype import convert_dtype
    from ..nn import initializer as I

    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = (attr.initializer if attr is not None and attr.initializer
            else default_initializer)
    if init is None:
        gw, gb = I.get_global_initializer()
        init = (gb or I.Constant(0.0)) if is_bias else \
            (gw or I.XavierUniform())
    device = current_device()
    data = torch.empty(tuple(int(s) for s in shape),
                       dtype=convert_dtype(dtype), device=device)
    with torch.no_grad():
        init(data, prandom.get_generator(device))
    p = Parameter(data, trainable=attr.trainable if attr is not None
                  else True)
    if name or (attr is not None and attr.name):
        p.name = name or attr.name
    if attr is not None:
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
    return p


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A persistable constant-filled tensor (not trained) that recorded
    graphs capture."""
    from ..core.dtype import convert_dtype
    t = torch.full(tuple(int(s) for s in shape), value,
                   dtype=convert_dtype(dtype), device=current_device())
    t.persistable = bool(persistable)
    if name:
        t.var_name = name
    return t


# ---------------------------------------------------------------------------
# debug / metric ops
# ---------------------------------------------------------------------------
def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Paddle's ``Print``: passes its input through and prints it when
    the op runs (each ``Executor.run`` in static mode)."""
    msg = message or ""

    def fn(a):
        print(msg, a)
        return a.clone()

    rec = maybe_record(fn, [input])
    return rec if rec is not None else fn(input)


def accuracy(input, label, k=1, correct=None, total=None):
    from ..metric.metrics import accuracy as _acc
    return _acc(input, label, k=k, correct=correct, total=total)


def _auc(x, lab, num_thresholds):
    pos = x[:, 1] if x.dim() == 2 and x.shape[1] == 2 else \
        x.reshape(x.shape[0], -1)[:, -1]
    lab = lab.reshape(-1).float()
    idx = (pos.float() * num_thresholds).to(torch.int64).clamp(
        0, num_thresholds)
    tp = torch.zeros(num_thresholds + 1, device=x.device).index_add(
        0, idx, lab)
    fp = torch.zeros(num_thresholds + 1, device=x.device).index_add(
        0, idx, 1.0 - lab)
    # cumulative from the highest threshold down
    tp_c = torch.cumsum(tp.flip(0), 0)
    fp_c = torch.cumsum(fp.flip(0), 0)
    tpr = tp_c / tp_c[-1].clamp_min(1.0)
    fpr = fp_c / fp_c[-1].clamp_min(1.0)
    return torch.trapezoid(tpr, fpr).float()


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Batch AUC (Paddle's ``auc`` op): a threshold-bucketed trapezoid
    over the positive-class score ``input[:, 1]``."""
    rec = maybe_record(_auc, [input, label, num_thresholds])
    return rec if rec is not None else _auc(input, label, num_thresholds)


# ---------------------------------------------------------------------------
# autodiff
# ---------------------------------------------------------------------------
def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Paddle's ``append_backward``: records the gradient of ``loss``
    with respect to every trainable Parameter feeding it; returns
    ``[(param, grad_variable)]``."""
    from .program import _collect
    if parameter_list is None:
        _, caps, _ = _collect([loss])
        parameter_list = [t for t in caps if isinstance(t, Parameter)
                          and t.trainable]
    no_grad = no_grad_set or set()
    parameter_list = [p for p in parameter_list
                      if getattr(p, "name", None) not in no_grad]
    if not parameter_list:
        return []
    grads = record_gradients([loss], parameter_list,
                             name="append_backward")
    return list(zip(parameter_list, grads))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Paddle's ``gradients``: d(sum targets)/d inputs, where inputs are
    graph inputs, intermediates or Parameters."""
    if target_gradients is not None:
        raise NotImplementedError(
            "target_gradients (custom output grads) is not supported; "
            "seed via a weighted sum of targets instead")
    return record_gradients(targets, inputs, name="gradients")


# ---------------------------------------------------------------------------
# strategies / compiled programs (the ParallelExecutor surface)
# ---------------------------------------------------------------------------
class BuildStrategy:
    """Paddle's build-strategy knobs: accepted and kept; the Executor
    replays the recorded ops as they are."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_sequential_execution = False
        self.fuse_broadcast_ops = False
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.enable_auto_fusion = False
        self.enable_inplace = False
        self.memory_optimize = None
        self.sync_batch_norm = False
        self.remove_unnecessary_lock = True
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """Paddle's scheduler knobs: kept for the API's shape."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_thread_barrier = True


class CompiledProgram:
    """Paddle's ``CompiledProgram``: wraps a Program (and a build
    strategy); ``Executor.run`` unwraps it.  ``with_data_parallel`` keeps
    the chained call's shape: the port runs one card."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._places = None
        self._loss_name = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._places = places
        return self


class ParallelExecutor:
    """Paddle's ``ParallelExecutor`` surface over the Executor."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self._program = main_program or default_main_program()
        self._exe = Executor(None if use_cuda else CPUPlace())
        self._loss_name = loss_name

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        return self._exe.run(self._program, feed=feed or feed_dict,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


class WeightNormParamAttr(ParamAttr):
    """Paddle's ``WeightNormParamAttr``: a ParamAttr with the weight-norm
    ``dim``."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         need_clip=need_clip)
        self.dim = dim


# ---------------------------------------------------------------------------
# program state save / load
# ---------------------------------------------------------------------------
def _program_params(program) -> List[torch.Tensor]:
    """The persistables a program reads: trainable Parameters and
    persistable tensors (batch-norm moving statistics), in graph order."""
    from .program import _collect
    roots = [v for n in program.nodes for v in n.outputs]
    if not roots:
        return []
    _, caps, _ = _collect(roots)
    return [t for t in caps
            if isinstance(t, Parameter) or getattr(t, "persistable", False)]


_AUTO_NAME = re.compile(r"^param_\d+$")


def _canonical_pairs(program) -> List[tuple]:
    """``[(name, tensor)]`` in graph order; an auto-generated name (a
    global counter's) or a missing one becomes ``_param_<position>``, so
    a checkpoint loads into another process's program."""
    pairs = []
    for i, p in enumerate(_program_params(program)):
        name = getattr(p, "name", None) if isinstance(p, Parameter) \
            else getattr(p, "var_name", None)
        if name is None or _AUTO_NAME.match(name):
            name = f"_param_{i}"
        pairs.append((name, p))
    return pairs


def _reject_duplicates(pairs):
    seen = set()
    for name, _ in pairs:
        if name in seen:
            raise ValueError(
                f"duplicate parameter name {name!r} in program: saving "
                f"would silently drop one of them; give the parameters "
                f"distinct ParamAttr names")
        seen.add(name)
    return pairs


def _canonical_named_params(program) -> Dict[str, torch.Tensor]:
    return dict(_reject_duplicates(_canonical_pairs(program)))




def _assign(p, value):
    a = torch.as_tensor(np.asarray(value))
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(a.to(p.device, p.dtype))


def save(program, model_path, protocol=4):
    """``paddle.static.save``: the program's persistables as numpy
    arrays in ``model_path + '.pdparams'``."""
    from ..framework.fs import open_for_write
    state = {name: _host(p)
             for name, p in _canonical_named_params(program).items()}
    with open_for_write(model_path + ".pdparams") as f:
        pickle.dump(state, f, protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    """``paddle.static.load``: restore what ``save`` wrote."""
    set_program_state(program, load_program_state(model_path, var_list))


def load_program_state(model_path, var_list=None):
    from ..framework.fs import open_for_read
    path = model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"
    with open_for_read(path) as f:
        state = pickle.load(f)
    if var_list is not None:
        names = {getattr(v, "name", v) for v in var_list}
        state = {k: v for k, v in state.items() if k in names}
    return state


def set_program_state(program, state_dict):
    params = _canonical_named_params(program)
    missing = sorted(set(state_dict) - set(params))
    for name, p in params.items():
        raw = getattr(p, "name", None)
        if name not in state_dict and raw in state_dict:
            # a checkpoint keyed by the raw auto name
            name = raw
            missing = [m for m in missing if m != name]
        if name in state_dict:
            try:
                _assign(p, state_dict[name])
            except ValueError as e:
                raise ValueError(f"set_program_state: {name}: {e}") from e
    if missing:
        import warnings
        warnings.warn(f"set_program_state: {len(missing)} entries had no "
                      f"matching parameter: {missing[:5]}...")


def _selected_named_params(program, vars=None, predicate=None):
    items = _canonical_pairs(program)
    if vars is not None:
        names = {getattr(v, "name", v) for v in vars}
        items = [(n, p) for n, p in items
                 if n in names or getattr(p, "name", None) in names]
    if predicate is not None:
        items = [(n, p) for n, p in items if predicate(p)]
    return _reject_duplicates(items)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """``save_vars``: one file per variable, or one combined
    ``filename``."""
    program = main_program or default_main_program()
    items = _selected_named_params(program, vars, predicate)
    from ..framework.fs import get_fs, open_for_write
    get_fs(dirname).makedirs(dirname)
    if filename:
        with open_for_write(os.path.join(dirname, filename)) as f:
            pickle.dump({n: _host(p) for n, p in items}, f)
    else:
        for n, p in items:
            with open_for_write(os.path.join(dirname, n)) as f:
                pickle.dump(_host(p), f)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    program = main_program or default_main_program()
    items = _selected_named_params(program, vars, predicate)
    from ..framework.fs import open_for_read
    if filename:
        with open_for_read(os.path.join(dirname, filename)) as f:
            state = pickle.load(f)
        for n, p in items:
            if n in state:
                _assign(p, state[n])
    else:
        for n, p in items:
            with open_for_read(os.path.join(dirname, n)) as f:
                _assign(p, pickle.load(f))


def save_to_file(path, content: bytes):
    from ..framework.fs import open_for_write
    with open_for_write(path) as f:
        f.write(content)


def load_from_file(path) -> bytes:
    from ..framework.fs import open_for_read
    with open_for_read(path) as f:
        return f.read()


def serialize_persistables(feed_vars, fetch_vars) -> bytes:
    """The Parameters of the program feeding ``fetch_vars``, pickled as
    numpy arrays by name."""
    from .program import _collect
    fetch_vars = [fetch_vars] if isinstance(fetch_vars, Variable) \
        else list(fetch_vars)
    _, caps, _ = _collect(fetch_vars)
    return pickle.dumps({t.name: _host(t) for t in caps
                         if isinstance(t, Parameter)})


def deserialize_persistables(program, data: bytes, executor=None):
    set_program_state(program, pickle.loads(data))


def serialize_program(feed_vars, fetch_vars) -> bytes:
    """The program feeding ``fetch_vars`` as bytes: the files
    ``save_inference_model`` writes."""
    import tempfile
    from .program import save_inference_model as _sim
    feed_vars = [feed_vars] if isinstance(feed_vars, Variable) \
        else list(feed_vars)
    fetch_vars = [fetch_vars] if isinstance(fetch_vars, Variable) \
        else list(fetch_vars)
    with tempfile.TemporaryDirectory() as d:
        _sim(os.path.join(d, "prog"), feed_vars, fetch_vars)
        payload = {}
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn), "rb") as f:
                payload[fn] = f.read()
    return pickle.dumps(payload)


def deserialize_program(data: bytes):
    """Inverse of ``serialize_program``: an ``InferenceProgram`` that
    ``Executor.run`` executes."""
    import tempfile
    from .program import load_inference_model as _lim
    payload = pickle.loads(data)
    with tempfile.TemporaryDirectory() as d:
        for fn, blob in payload.items():
            with open(os.path.join(d, fn), "wb") as f:
                f.write(blob)
        prog, _, _ = _lim(os.path.join(d, "prog"))
        return prog
