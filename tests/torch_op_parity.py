"""Shared harness of the op library's parity tests
(``test_torch_tensor_*.py``): one call of a JAX package op and of the
port's op of the same name on the same seeded numpy inputs, the outputs
compared, and the VJP of the first output under one seeded cotangent.

The JAX side runs under ``jax.jit`` (inputs as arguments, the backward
inside), except the ops in ``JAX_EAGER`` (host code or data-dependent
shapes); a test module's table of ``Case``s gets its JAX references from
one ``jax.jit`` over all of them (``JaxRefs``), one compile for the
module.  Tolerances are relative to each output's scale (its largest
magnitude): f32 1e-5 elementwise (``EW``), 1e-4 for reductions and
linear algebra (``RED``), bf16 1e-2 (``BF16``); integer, bool and index
outputs are equal, 32-bit against 64-bit being the only dtype difference
allowed (JAX runs with x64 off).
"""
from __future__ import annotations

import jax
import numpy as np
import torch

import paddle_tpu as jp

EW, RED, BF16 = 1e-5, 1e-4, 1e-2

JAX_EAGER = {"unique", "unique_consecutive", "masked_select", "nonzero",
             "histogram", "bincount", "lu", "eig", "eigvals", "cond",
             "lstsq", "mode", "sequence_pad", "sequence_unpad",
             "sequence_expand", "sequence_concat", "sequence_slice",
             "where1", "increment", "scatter_",
             "reshape_", "squeeze_", "unsqueeze_", "tanh_"}


# f32 ops of the case tables whose VJP is not compared, and why; a table
# case with f32 inputs and a float output must compare its VJP unless its
# op is listed here (``run_case`` enforces it)
NO_VJP = {
    "floor_divide": "piecewise constant; torch defines no derivative",
    "heaviside": "piecewise constant; torch defines no derivative",
    "nextafter": "not differentiable",
    "histogram": "counts, off the JAX tape",
    "put_along_axis": "reduce='multiply': JAX has no gradient of scatter_mul",
    "unique": "off the JAX tape (jnp.unique outside apply)",
    "zeros_like": "a constant", "ones_like": "a constant",
    "full_like": "a constant", "empty_like": "a constant",
    "assign": "off the JAX tape", "to_tensor": "off the JAX tape",
    "norm": "p=0 counts non-zero entries (piecewise constant)",
    "dist": "p=0 counts non-zero entries (piecewise constant)",
    "cond": "host numpy in JAX", "lstsq": "host numpy in JAX",
    "increment": "in place, off the tape", "tanh_": "in place",
    "sequence_expand": "host numpy in JAX", "mode": "host scipy in JAX",
    "cast": "to float16: the two sides round the cotangent differently",
    "view": "to float16 (a cast): as cast",
}


def arr(rng, shape, kind="normal", dtype=np.float32):
    """Seeded inputs in an op's domain."""
    if kind == "normal":
        a = rng.randn(*shape)
    elif kind == "pos":
        a = rng.uniform(0.5, 2.0, shape)
    elif kind == "unit":
        a = rng.uniform(-0.9, 0.9, shape)
    elif kind == "gt1":
        a = rng.uniform(1.1, 3.0, shape)
    elif kind == "prob":
        a = rng.uniform(0.05, 0.95, shape)
    elif kind == "int":
        a = rng.randint(-9, 10, shape)
    elif kind == "posint":
        a = rng.randint(1, 20, shape)
    elif kind == "bool":
        a = rng.rand(*shape) > 0.5
    else:
        raise ValueError(kind)
    return np.asarray(a).astype(dtype)


def _is_arr(a):
    return isinstance(a, np.ndarray)


def _jax_tensor(a, diff):
    return jp.Tensor(a, stop_gradient=not diff)


def _traced(op, args, kw, diff, cot, arrs):
    """``op`` over JAX Tensors of ``arrs`` (the array entries of
    ``args``): its outputs and the gradients of ``sum(out[0] * cot)``
    with respect to ``args[i]`` for ``i`` in ``diff``."""
    pos = [i for i, a in enumerate(args) if _is_arr(a)]
    full = list(args)
    ts = {}
    for i, a in zip(pos, arrs):
        ts[i] = _jax_tensor(a, i in diff)
        full[i] = ts[i]
    out = op(*full, **kw)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    outs = tuple(o if isinstance(o, jp.Tensor) else jp.Tensor(
        np.asarray(o)) for o in outs)
    grads = []
    if diff:
        (outs[0] * jp.Tensor(cot)).sum().backward()
        grads = [ts[i].grad.data for i in diff]
    return [o.data for o in outs], grads


def jax_run(op, args, kw, diff, cot, eager=False):
    """Outputs (numpy) and the gradients of ``sum(out[0] * cot)`` with
    respect to ``args[i]`` for ``i`` in ``diff``, under ``jax.jit``
    unless ``eager``."""
    inputs = [_jax_input(a) for a in args if _is_arr(a)]

    def run(*arrs):
        return _traced(op, args, kw, diff, cot, arrs)

    outs, grads = run(*inputs) if eager else jax.jit(run)(*inputs)
    return [to_np(o) for o in outs], [to_np(g) for g in grads]


def _jax_input(a):
    if a.dtype == np.dtype("bfloat16") or str(a.dtype) == "bfloat16":
        return jax.numpy.asarray(a)
    return a


def port_run(op, args, kw, diff, cot, device="cpu"):
    full = list(args)
    ts = {}
    for i, a in enumerate(args):
        if _is_arr(a):
            t = from_np(a).to(device)
            if i in diff:
                t.requires_grad_(True)
            ts[i] = t
            full[i] = t
    out = op(*full, **kw)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    outs = tuple(o if torch.is_tensor(o) else torch.tensor(o) for o in outs)
    grads = []
    if diff:
        (outs[0] * from_np(cot).to(device).to(outs[0].dtype)).sum().backward()
        grads = [ts[i].grad for i in diff]
    return [to_np(o) for o in outs], [to_np(g) for g in grads]


def from_np(a):
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a copy: in-place ops stay local


def to_np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.resolve_conj().numpy()
    x = np.asarray(x)
    if str(x.dtype) == "bfloat16":
        return x.astype(np.float32)
    return x


def close(got, want, tol, what=""):
    """``got`` equal to ``want`` (integers, bools) or within ``tol`` of
    its scale (floats, complex)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs " \
        f"{want.shape}"
    kinds = {got.dtype.kind, want.dtype.kind}
    if kinds <= {"i", "u", "b"}:
        if "b" in kinds:
            assert got.dtype.kind == want.dtype.kind, \
                f"{what}: dtype {got.dtype} vs {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype.kind in "fc" and want.dtype.kind in "fc", \
        f"{what}: dtype {got.dtype} vs {want.dtype}"
    g = got.astype(np.complex128 if "c" in kinds else np.float64)
    w = want.astype(g.dtype)
    nan = np.isnan(w)
    assert (np.isnan(g) == nan).all(), f"{what}: NaNs differ"
    inf = np.isinf(w)
    assert (g[inf] == w[inf]).all(), f"{what}: infinities differ"
    fin = ~(nan | inf)
    if not fin.any():
        return
    scale = max(float(np.abs(w[fin]).max()), 1e-30)
    err = float(np.abs(g[fin] - w[fin]).max())
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} x {scale:.3g}"


def _cotangent(got, diff, seed):
    rng = np.random.RandomState(seed + 1000)
    return np.asarray(rng.randn(*got[0].shape), np.float32) if diff \
        else None


class Case:
    """One op call: ``jop`` / ``top`` (the JAX and the port function) on
    ``args`` with ``kw``; gradients for the inputs at ``diff``."""

    def __init__(self, name, jop, top, args, kw=None, diff=(0,), tol=EW,
                 eager=None, outs=None):
        self.name, self.jop, self.top = name, jop, top
        self.args, self.kw, self.diff, self.tol = args, kw or {}, diff, tol
        self.eager = name in JAX_EAGER if eager is None else eager
        self.outs = outs


class JaxRefs:
    """The JAX references (outputs, gradients, cotangent) of many cases
    from ONE ``jax.jit`` (one compile instead of one a case); the eager
    cases run on their own.  Computed at the first ``get``."""

    def __init__(self, cases):
        self.cases = cases
        self._refs = None

    def _compute(self):
        refs, batch = {}, []
        for cid, c in self.cases.items():
            got, _ = port_run(c.top, c.args, c.kw, (), None)
            cot = _cotangent(got, c.diff, 0)
            if c.eager:
                refs[cid] = (*jax_run(c.jop, c.args, c.kw, c.diff, cot,
                                      True), cot)
            else:
                batch.append((cid, c, cot))
        arrays = [[_jax_input(a) for a in c.args if _is_arr(a)]
                  for _, c, _ in batch]

        def run(all_arrays):
            return [_traced(c.jop, c.args, c.kw, c.diff, cot, arrs)
                    for (_, c, cot), arrs in zip(batch, all_arrays)]

        for (cid, _, cot), (outs, grads) in zip(batch,
                                                jax.jit(run)(arrays)):
            refs[cid] = ([to_np(o) for o in outs], [to_np(g) for g in grads],
                         cot)
        self._refs = refs

    def get(self, cid):
        if self._refs is None:
            self._compute()
        return self._refs[cid]


def run_case(cid, case, refs):
    """Compare the port's run of ``case`` with its JAX reference."""
    want, jg, cot = refs.get(cid)
    got, _ = port_run(case.top, case.args, case.kw, (), None)
    f32_in = [a for a in case.args if _is_arr(a) and a.dtype == np.float32]
    if not case.diff and f32_in and got[0].dtype.kind == "f":
        assert case.name in NO_VJP, \
            f"{cid}: a float output without a VJP check, not in NO_VJP"
    _compare(case.name, got, want, case.outs, case.tol)
    if case.diff:
        _, tg = port_run(case.top, case.args, case.kw, case.diff, cot)
        for i, a, b in zip(case.diff, tg, jg):
            close(a, b, case.tol, f"{case.name} grad {i}")


def _compare(name, got, want, outs, tol):
    assert len(got) == len(want), f"{name}: {len(got)} outputs vs " \
        f"{len(want)}"
    for i in (range(len(want)) if outs is None else outs):
        close(got[i], want[i], tol, f"{name} output {i}")


def check(name, jop, top, args, kw=None, diff=(0,), tol=EW, gtol=None,
          eager=None, seed=0, outs=None):
    """Run ``jop`` and ``top`` on ``args`` and compare outputs (all, or
    those at ``outs``) and, for ``diff`` inputs, gradients."""
    kw = kw or {}
    eager = name in JAX_EAGER if eager is None else eager
    got, tg = port_run(top, args, kw, (), None)
    cot = _cotangent(got, diff, seed)
    want, jg = jax_run(jop, args, kw, diff, cot, eager)
    _compare(name, got, want, outs, tol)
    if diff:
        _, tg = port_run(top, args, kw, diff, cot)
        for i, a, b in zip(diff, tg, jg):
            close(a, b, gtol or tol, f"{name} grad {i}")
