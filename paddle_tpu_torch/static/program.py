"""Static-graph surface: Program / Variable / Executor / program_guard
(counterpart of ``paddle_tpu/static/program.py``).

The classic static workflow::

    paddle.enable_static()
    x = paddle.static.data('x', [None, 4])
    loss = mean(net(x))
    opt.minimize(loss)
    exe = paddle.static.Executor()
    exe.run(paddle.static.default_startup_program())
    exe.run(main_program, feed={'x': a}, fetch_list=[loss])

The JAX package records a node at each op of its tape.  The port has no
tape: a ``Variable`` is a ``torch.Tensor`` subclass over a ``meta``
tensor, and its ``__torch_function__`` records every torch call that
reaches it as a node ``(func, args, kwargs)`` of the default Program.
The node's outputs are new Variables whose shapes come from running
``func`` on meta tensors (a ``None`` dim counts as 1, as
``maybe_record`` does).  A call whose result holds no tensor (``.shape``,
``.dtype``, ``.dim()``) is answered from the meta tensor and not
recorded; a call that needs a value on the host (``.item()``, a Python
branch on a tensor) raises, as ``jax.eval_shape`` does.

Parameters made in static mode are real tensors on their device; the
graph captures them and reads them when it runs.  An in-place update of
a captured tensor (batch norm's running statistics) is not executed
while recording: it becomes a rider, a Variable written back into the
tensor after every ``Executor.run`` whose fetches reach it
(``program._updates``).  An in-place update of a Variable records the
out-of-place value and the Variable stands for it from then on.

``Executor.run`` replays the recorded nodes in order on the feeds (on
the card unless the Executor was given the CPU).  With a ``minimize``
hook it computes the gradients of the loss with ``torch.autograd.grad``
and applies the port's optimizer.  ``save_inference_model`` captures
the pruned subgraph, parameters frozen, with ``torch.export``.
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import current_device, resolve_device
from ..jit.api import _example, _move_program

__all__ = ["Variable", "Program", "Executor", "program_guard",
           "default_main_program", "default_startup_program",
           "enable_static", "disable_static", "in_static_mode",
           "save_inference_model", "load_inference_model",
           "InferenceProgram", "record_gradients", "install_minimize"]

_state = threading.local()


def _tls():
    if not hasattr(_state, "mode"):
        _state.mode = False
        _state.main = Program()
        _state.startup = Program()
    return _state


def enable_static():
    _tls().mode = True


def disable_static():
    _tls().mode = False


def in_static_mode() -> bool:
    return getattr(_state, "mode", False)


def default_main_program() -> "Program":
    return _tls().main


def default_startup_program() -> "Program":
    return _tls().startup


class program_guard:
    """Swap the default programs (Paddle's ``program_guard``)."""

    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        t = _tls()
        self._saved = (t.main, t.startup)
        t.main = self.main
        if self.startup is not None:
            t.startup = self.startup
        return self.main

    def __exit__(self, *exc):
        t = _tls()
        t.main, t.startup = self._saved
        return False


# in-place operators and their out-of-place values
_INPLACE_DUNDER = {"__iadd__", "__isub__", "__imul__", "__itruediv__",
                   "__ifloordiv__", "__imod__", "__ipow__", "__iand__",
                   "__ior__", "__ixor__", "__ilshift__", "__irshift__",
                   "__setitem__"}


# shape rules for calls whose own checks read the None dims' stand-in 1
# (training batch norm wants more than one value per channel)
_META_FORMS = {torch.nn.functional.batch_norm:
               lambda input, *a, **k: torch.empty_like(input)}


def _is_inplace(func) -> bool:
    name = getattr(func, "__name__", "")
    return name in _INPLACE_DUNDER or (name.endswith("_") and
                                       not name.endswith("__"))


def _outplace(func):
    """The value an in-place ``func(target, ...)`` leaves in target, as a
    function that does not touch target."""
    def value(target, *args, **kwargs):
        out = target.clone()
        func(out, *args, **kwargs)
        return out
    value.__name__ = f"{getattr(func, '__name__', 'op')}(out-of-place)"
    return value


class Variable(torch.Tensor):
    """Symbolic graph value (Paddle's ``Variable``): a graph input made by
    ``static.data`` or the output of a recorded op.  It is a tensor on
    the ``meta`` device (None dims as 1) whose ``device`` reads as the
    device it was recorded for."""

    @staticmethod
    def __new__(cls, shape, dtype, name=None, producer=None, out_index=0,
                program=None, meta=None):
        if meta is None:
            meta = torch.empty([1 if s in (None, -1) else int(s)
                                for s in shape], dtype=dtype, device="meta")
        v = torch.Tensor._make_subclass(cls, meta, False)
        v.__dict__["_meta"] = meta
        return v

    _counter = 0

    def __init__(self, shape, dtype, name=None, producer=None, out_index=0,
                 program=None, meta=None):
        if name is None:
            Variable._counter += 1
            name = f"_var_{Variable._counter}"
        self.__dict__.update(
            _name=name, decl_shape=tuple(shape), producer=producer,
            out_index=out_index, program=program,
            _device=current_device())

    # TensorBase.name is read-only: the Variable keeps its own
    @property
    def name(self):
        return self.__dict__["_name"]

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def device(self):
        return self._device

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _record(func, args, kwargs or {})

    def __repr__(self):
        kind = "data" if self.producer is None else "op"
        return (f"Variable(name={self.name}, shape={self.decl_shape}, "
                f"dtype={self.dtype}, {kind})")

    def __hash__(self):
        return id(self)

    def __reduce_ex__(self, proto):
        raise TypeError("a static Variable cannot be pickled: save the "
                        "program with save_inference_model")

    def __deepcopy__(self, memo):
        return self


class _Node:
    """One recorded call: ``func(*args, **kwargs)`` over Variables,
    captured tensors and constants; ``out_leaves`` are its result's
    leaves (Variables for its tensors), ``outputs`` those Variables."""

    __slots__ = ("func", "args", "kwargs", "name", "outputs", "out_leaves",
                 "grad")

    def __init__(self, func, args, kwargs, name):
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.name = name
        self.outputs: List[Variable] = []
        self.out_leaves: List[Any] = []
        self.grad = torch.is_grad_enabled()

    @property
    def inputs(self):
        return pytree.tree_leaves((self.args, self.kwargs))

    def __repr__(self):
        return f"_Node({self.name})"


class Program:
    """An ordered list of recorded nodes, the graph inputs, the riders and
    the training hook ``minimize`` installs."""

    def __init__(self):
        self.nodes: List[_Node] = []
        self.inputs: Dict[str, Variable] = {}
        # (loss_var, [(param, name)], optimizer) once minimize ran
        self._train: Optional[Tuple] = None
        # (captured tensor, variable): written back after each run
        self._updates: List[Tuple] = []
        # id(captured tensor) -> the Variable an in-place update made of it
        self._aliases: Dict[int, Variable] = {}
        self._for_test = False
        self._version = 0

    def _add_input(self, var: Variable):
        self.inputs[var.name] = var
        self._version += 1

    def _add_node(self, node: _Node):
        self.nodes.append(node)
        self._version += 1

    def global_block(self):
        return self

    @property
    def ops(self):
        return self.nodes

    def clone(self, for_test=False):
        import copy
        p = Program()
        p.nodes = list(self.nodes)
        p.inputs = dict(self.inputs)
        p._aliases = dict(self._aliases)
        if not for_test:
            # a test clone keeps the ops and drops the riders and the
            # training hook (Paddle's clone(for_test=True))
            p._updates = list(self._updates)
            p._train = copy.copy(self._train)
        p._for_test = bool(for_test) or self._for_test
        return p

    def __repr__(self):
        return (f"Program(ops={len(self.nodes)}, "
                f"inputs={sorted(self.inputs)})")


def record_data(name, shape, dtype) -> Variable:
    prog = default_main_program()
    var = Variable(shape, dtype, name=name, program=prog)
    prog._add_input(var)
    return var


def _to_meta(a, aliases):
    if isinstance(a, Variable):
        return a._meta
    if torch.is_tensor(a):
        if id(a) in aliases:
            return aliases[id(a)]._meta
        return a.detach().to("meta")
    return a


def _alias(a, aliases):
    if torch.is_tensor(a) and not isinstance(a, Variable) and \
            id(a) in aliases:
        return aliases[id(a)]
    return a


def _replace_refs(prog, old, new):
    """Every recorded reference to Variable ``old`` now names ``new``."""
    def sub(a):
        return new if a is old else a
    for n in prog.nodes:
        n.args, n.kwargs = pytree.tree_map(sub, (n.args, n.kwargs))
    prog._updates = [(t, new if v is old else v) for t, v in prog._updates]
    for k, v in list(prog.inputs.items()):
        if v is old:
            prog.inputs[k] = new


def _record(func, args, kwargs, out_meta=None, force=False):
    """Record ``func(*args, **kwargs)`` on the default Program.  Returns
    its result with Variables for its tensors, or the plain result of a
    call that yields no tensor."""
    prog = default_main_program()
    leaves, spec = pytree.tree_flatten((args, kwargs))
    name = getattr(func, "__name__", type(func).__name__)
    if out_meta is None:
        metas = [_to_meta(a, prog._aliases) for a in leaves]
        margs, mkwargs = pytree.tree_unflatten(metas, spec)
        try:
            with torch._C.DisableTorchFunctionSubclass():
                out = _META_FORMS.get(func, func)(*margs, **mkwargs)
        except Exception as e:
            raise RuntimeError(
                f"static mode: {name} cannot run on symbolic Variables "
                f"(an op that reads a value on the host, such as .item() "
                f"or a Python branch on a tensor, has no static form): "
                f"{e}") from e
    else:
        out = out_meta
    target = args[0] if args else None
    inplace = _is_inplace(func) and torch.is_tensor(target)
    out_leaves, out_spec = pytree.tree_flatten(out)
    if not force and not inplace and \
            not any(torch.is_tensor(o) for o in out_leaves):
        return out
    if inplace:
        func = _outplace(func)
        meta_t = _to_meta(target, prog._aliases)
        out_leaves, out_spec = pytree.tree_flatten(meta_t)
    args, kwargs = pytree.tree_map(lambda a: _alias(a, prog._aliases),
                                   (args, kwargs))
    node = _Node(func, args, kwargs, name)
    outs = []
    for i, o in enumerate(out_leaves):
        if torch.is_tensor(o):
            v = Variable(o.shape, o.dtype, producer=node, out_index=i,
                         program=prog, meta=o)
            outs.append(v)
            node.outputs.append(v)
        else:
            outs.append(o)
    node.out_leaves = list(outs)
    if inplace and isinstance(target, Variable):
        _rebind(prog, target, node)
        return target
    if inplace:
        # a captured tensor: later reads in this program see the new
        # value, and a run writes it back (a rider)
        prog._aliases[id(target)] = outs[0]
        prog._updates.append((target, outs[0]))
    prog._add_node(node)
    return outs[0] if inplace else pytree.tree_unflatten(outs, out_spec)


def _rebind(prog, target, node):
    """After an in-place ``node`` on Variable ``target``: the Python object
    stands for the updated value from now on, and the references recorded
    so far move to a stand-in for the old one."""
    old = Variable(target.shape, target.dtype, name=target.name,
                   producer=target.producer, out_index=target.out_index,
                   program=prog, meta=target._meta)
    if target.producer is not None:
        prod = target.producer
        prod.outputs = [old if v is target else v for v in prod.outputs]
        prod.out_leaves = [old if v is target else v
                           for v in prod.out_leaves]
    _replace_refs(prog, target, old)
    node.args, node.kwargs = pytree.tree_map(
        lambda a: old if a is target else a, (node.args, node.kwargs))
    target.__dict__.update(producer=node, out_index=0)
    node.outputs = node.out_leaves = [target]
    prog._add_node(node)


def maybe_record(fn, args, kwargs=None, out_meta=None, force=False):
    """Record ``fn(*args, **kwargs)`` when an argument is a Variable (or
    ``force``); returns the result's Variables, or None when nothing is
    recorded.  ``out_meta`` gives the result's meta tensors where running
    ``fn`` on meta tensors cannot (a gradient node)."""
    kwargs = kwargs or {}
    if not force and not any(isinstance(a, Variable) for a in
                             pytree.tree_leaves((args, kwargs))):
        return None
    return _record(fn, tuple(args), kwargs, out_meta=out_meta, force=True)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------
def _collect(fetch_vars: Sequence[Variable]):
    """The nodes feeding the fetches in recording order, the captured
    tensors they read and the graph inputs they need."""
    needed, inputs, stack = set(), [], list(fetch_vars)
    seen_vars = set()
    while stack:
        v = stack.pop()
        if id(v) in seen_vars:
            continue
        seen_vars.add(id(v))
        if v.producer is None:
            inputs.append(v)
            continue
        if id(v.producer) in needed:
            continue
        needed.add(id(v.producer))
        stack.extend(a for a in v.producer.inputs
                     if isinstance(a, Variable))
    prog_nodes = fetch_vars[0].program.nodes if fetch_vars and \
        fetch_vars[0].program is not None else []
    nodes = [n for n in prog_nodes if id(n) in needed]
    if len(nodes) != len(needed):      # fetches from several programs
        nodes = _order_nodes(fetch_vars, needed)
    caps, seen_caps = [], set()
    for n in nodes:
        for a in n.inputs:
            if torch.is_tensor(a) and not isinstance(a, Variable) and \
                    id(a) not in seen_caps:
                seen_caps.add(id(a))
                caps.append(a)
    inputs.sort(key=lambda v: v.name)
    return nodes, caps, inputs


def _order_nodes(fetch_vars, needed):
    order, done = [], set()

    def visit(n):
        if id(n) in done:
            return
        done.add(id(n))
        for a in n.inputs:
            if isinstance(a, Variable) and a.producer is not None:
                visit(a.producer)
        order.append(n)

    for v in fetch_vars:
        if v.producer is not None:
            visit(v.producer)
    return order


def _run_graph(nodes, inputs, fetch_vars, feed_vals, cap_vals=None,
               env=None):
    """Replay ``nodes`` on concrete tensors: ``feed_vals`` for
    ``inputs``, ``cap_vals`` (id -> tensor) in place of captured
    tensors; returns the fetches' values."""
    env = dict(env or {})
    for v, a in zip(inputs, feed_vals):
        env.setdefault(id(v), a)
    cap_vals = cap_vals or {}

    def val(a):
        if isinstance(a, Variable):
            return env[id(a)]
        if torch.is_tensor(a):
            return cap_vals.get(id(a), a)
        return a

    for n in nodes:
        if all(id(o) in env for o in n.outputs):
            continue
        args, kwargs = pytree.tree_map(val, (n.args, n.kwargs))
        if n.grad:
            out = n.func(*args, **kwargs)
        else:
            with torch.no_grad():
                out = n.func(*args, **kwargs)
        for v, o in zip(n.out_leaves, pytree.tree_leaves(out)):
            if isinstance(v, Variable):
                env.setdefault(id(v), o)
    return [env[id(v)] for v in fetch_vars]


def _riders(program, roots):
    """The riders that go along with a run of ``roots``: those whose
    subgraph meets the fetches' (a node of it, or a Variable one of its
    nodes makes) and needs no feed the fetches do not.  A branch without
    batch norm neither needs its feeds nor moves its statistics."""
    nodes, _, inputs = _collect(roots)
    in_closure = {id(n) for n in nodes}
    made = {id(o) for n in nodes for o in n.outputs}
    fed = {id(v) for v in inputs}
    out = []
    for t, v in program._updates:
        if v.producer is None:
            continue
        r_nodes, _, r_inputs = _collect([v])
        meets = any(id(n) in in_closure or any(
            isinstance(a, Variable) and id(a) in made for a in n.inputs)
            for n in r_nodes)
        if meets and all(id(x) in fed for x in r_inputs):
            out.append((t, v))
    return out


def _feed_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def _place(place) -> torch.device:
    return resolve_device(None if place is None else place)


class Executor:
    """Paddle's ``Executor``: ``run(program, feed, fetch_list)`` on its
    device (the card unless ``place`` is the CPU)."""

    def __init__(self, place=None):
        self.place = place
        self.device = _place(place)
        self._cache: Dict[tuple, Any] = {}

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        from .helpers import CompiledProgram
        if isinstance(program, CompiledProgram):
            program = program._program
        program = program or default_main_program()
        feed = feed or {}
        if isinstance(program, InferenceProgram):
            outs = program.run(feed, device=self.device)
            return [o.detach().cpu().numpy() for o in outs] \
                if return_numpy else outs
        fetch_list = list(fetch_list or [])
        if not fetch_list and not program._train and not program.nodes:
            return []  # startup program: parameters exist already
        for v in fetch_list:
            if not isinstance(v, Variable):
                raise TypeError(f"fetch_list entries must be static "
                                f"Variables, got {type(v)}")
        train = program._train
        loss_var = train[0] if train else None
        base = fetch_list + ([loss_var] if train else [])
        key = (id(program), program._version, tuple(id(v) for v in base),
               bool(train))
        plan = self._cache.get(key)
        if plan is None:
            updates = _riders(program, base)
            fetch_vars = fetch_list + [v for _, v in updates]
            roots = fetch_vars + ([loss_var] if train else [])
            nodes, caps, input_vars = _collect(roots)
            plan = self._cache[key] = (updates, fetch_vars, nodes, caps,
                                       input_vars)
        updates, fetch_vars, nodes, caps, input_vars = plan
        missing = [v.name for v in input_vars if v.name not in feed]
        if missing:
            raise ValueError(f"feed is missing graph inputs: {missing}")
        feeds = [_feed_tensor(feed[v.name], self.device, v.dtype)
                 for v in input_vars]
        cap_vals = {id(t): t.to(self.device) for t in caps
                    if t.device != self.device}
        if program._for_test:
            # a test clone normalizes with the moving statistics: every
            # batch-norm training flag reads 0
            cap_vals.update({id(t): torch.zeros_like(t) for t in caps
                             if getattr(t, "_bn_train_flag", False)})
        if train:
            outs = self._train_step(train, nodes, input_vars, fetch_vars,
                                    feeds, cap_vals)
        else:
            with torch.no_grad():
                outs = _run_graph(nodes, input_vars, fetch_vars, feeds,
                                  cap_vals)
        if updates:
            n_fetch = len(outs) - len(updates)
            with torch.no_grad():
                for (t, _), val in zip(updates, outs[n_fetch:]):
                    t.copy_(val.detach().to(t.device, t.dtype))
            outs = outs[:n_fetch]
        outs = [o.detach() for o in outs]
        if return_numpy:
            outs = [o.cpu().numpy() for o in outs]
        return outs

    def _train_step(self, train, nodes, input_vars, fetch_vars, feeds,
                    cap_vals):
        loss_var, params, optimizer = train
        trained = [p for p, _ in params]
        for p in trained:
            if p.device != self.device:
                raise ValueError(
                    f"Executor on {self.device} cannot train parameter "
                    f"{p.name} on {p.device}: build the program on the "
                    f"executor's device")
        with torch.enable_grad():
            vals = _run_graph(nodes, input_vars, fetch_vars + [loss_var],
                              feeds, cap_vals)
            total = vals[-1].float().sum()
            grads = torch.autograd.grad(total, trained, allow_unused=True)
        optimizer._step_static(trained, grads)
        return vals[:-1]


def record_gradients(targets, wrt, name="gradients"):
    """Record a node computing d(sum(targets))/d(wrt) (Paddle's
    ``gradients`` / ``append_backward``): one node that replays the
    targets' subgraph and calls ``torch.autograd.grad``.  ``wrt`` entries
    are graph Variables (inputs or intermediates: the dependency is cut
    there) or captured tensors; returns one gradient Variable each."""
    targets = [targets] if isinstance(targets, Variable) else list(targets)
    wrt = [wrt] if torch.is_tensor(wrt) else list(wrt)
    nodes, caps, input_vars = _collect(targets)
    cap_ids = {id(c) for c in caps}
    for w in wrt:
        if not isinstance(w, Variable) and id(w) not in cap_ids:
            raise ValueError(f"gradients: tensor {getattr(w, 'name', w)} "
                             f"does not feed the target(s)")
    n_in = len(input_vars)

    def grad_fn(*vals):
        feeds, leaves_in = vals[:n_in], vals[n_in:]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in leaves_in]
            env = {id(w): leaf for w, leaf in zip(wrt, leaves)
                   if isinstance(w, Variable)}
            cap_vals = {id(w): leaf for w, leaf in zip(wrt, leaves)
                        if not isinstance(w, Variable)}
            outs = _run_graph(nodes, input_vars, targets, feeds, cap_vals,
                              env)
            total = sum(o.float().sum() for o in outs)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        return tuple(torch.zeros_like(leaf) if g is None else g.to(
            leaf.dtype) for g, leaf in zip(grads, leaves))

    metas = tuple((w._meta if isinstance(w, Variable) else
                   w.detach().to("meta")).clone() for w in wrt)
    outs = maybe_record(grad_fn, list(input_vars) + list(wrt),
                        out_meta=metas, force=True)
    for w, g in zip(wrt, outs):
        g.name = f"{getattr(w, 'name', 'x')}@GRAD"
    return list(outs)


def install_minimize(program: Program, loss: Variable, optimizer):
    """``Optimizer.minimize`` on a Variable lands here: the training hook
    over every trainable Parameter the loss reads."""
    _, caps, _ = _collect([loss])
    from ..core.tensor import Parameter
    params = [(t, t.name) for t in caps
              if isinstance(t, Parameter) and t.requires_grad]
    frozen = [t for t in caps if t.grad_fn is not None]
    if frozen:
        # an op on Parameters alone ran while recording: the program
        # holds its result, which no update would ever reach
        raise ValueError(
            f"minimize(loss): the loss reads {len(frozen)} tensor(s) "
            f"computed from Parameters while the program was recorded "
            f"({', '.join(type(t.grad_fn).__name__ for t in frozen)}); "
            f"their Parameters would not train.  Compute them from a "
            f"Variable or inside an op that takes one")
    if not params:
        raise ValueError(
            "minimize(loss): no trainable Parameters feed this loss")
    program._train = (loss, params, optimizer)
    program._version += 1


# ---------------------------------------------------------------------------
# save / load of the inference program
# ---------------------------------------------------------------------------
class _Replay(torch.nn.Module):
    """The pruned graph as a module: feeds in, fetches out, the captured
    tensors frozen as its buffers."""

    def __init__(self, nodes, caps, input_vars, feed_vars, fetch_vars):
        super().__init__()
        self._graph = (nodes, input_vars, feed_vars, fetch_vars,
                       [id(t) for t in caps])
        for i, t in enumerate(caps):
            self.register_buffer(f"c{i}", t.detach().clone())

    def forward(self, *feeds):
        nodes, input_vars, feed_vars, fetch_vars, cap_ids = self._graph
        by_id = {id(v): a for v, a in zip(feed_vars, feeds)}
        cap_vals = {cid: getattr(self, f"c{i}")
                    for i, cid in enumerate(cap_ids)}
        return tuple(_run_graph(nodes, input_vars, fetch_vars,
                                [by_id[id(v)] for v in input_vars],
                                cap_vals))


class InferenceProgram:
    """A loaded ``save_inference_model`` artifact: the exported program
    ``Executor.run`` executes (Paddle's pruned inference Program)."""

    def __init__(self, exported, feed_names, n_outputs):
        self.exported = exported
        self.feed_names = list(feed_names)
        self.n_outputs = int(n_outputs)
        self._module = exported.module()
        self._device = None

    def run(self, feed, device=None):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError(f"feed is missing inputs: {missing}")
        dev = _place(device)
        if self._device != dev:
            self._module = _move_program(self.exported, dev).module()
            self._device = dev
        args = [_feed_tensor(feed[n], dev) for n in self.feed_names]
        with torch.no_grad():
            out = self._module(*args)
        return list(out) if isinstance(out, (tuple, list)) else [out]


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, **configs) -> str:
    """Capture the subgraph feeding ``fetch_vars`` with ``torch.export``,
    parameters frozen at save time, and write ``<prefix>.pdmodel`` (the
    exported program) and ``<prefix>.pdmeta`` (feed names and the number
    of fetches).  A ``None`` dim of a feed is a dynamic dim."""
    feed_vars = [feed_vars] if isinstance(feed_vars, Variable) \
        else list(feed_vars)
    fetch_vars = [fetch_vars] if isinstance(fetch_vars, Variable) \
        else list(fetch_vars)
    nodes, caps, input_vars = _collect(fetch_vars)
    declared = {id(v) for v in feed_vars}
    extra = [v.name for v in input_vars if id(v) not in declared]
    if extra:
        raise ValueError(
            f"fetch_vars depend on inputs not in feed_vars: {extra}")
    dev = _place(getattr(executor, "place", None)) if executor is not None \
        else (caps[0].device if caps else current_device())
    module = _Replay(nodes, caps, input_vars, feed_vars, fetch_vars).to(dev)
    from . import InputSpec
    examples, dynamic = zip(*[_example(InputSpec(v.decl_shape, v.dtype), dev)
                              for v in feed_vars])
    with torch.no_grad():
        # forward(*feeds): the varargs take one tuple of specs
        exported = torch.export.export(module, tuple(examples),
                                       dynamic_shapes=(tuple(dynamic),))
    exported.example_inputs = None
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        torch.export.save(exported, f)
    meta = {"feed_names": [v.name for v in feed_vars],
            "n_outputs": len(fetch_vars)}
    with open(path_prefix + ".pdmeta", "wb") as f:
        pickle.dump(meta, f)
    return path_prefix


def load_inference_model(path_prefix: str, executor=None):
    """``(InferenceProgram, feed_names, fetch_count)``, Paddle's
    ``[program, feed_target_names, fetch_targets]`` shape."""
    with open(path_prefix + ".pdmodel", "rb") as f:
        exported = torch.export.load(f)
    with open(path_prefix + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    prog = InferenceProgram(exported, meta["feed_names"], meta["n_outputs"])
    return prog, prog.feed_names, prog.n_outputs
