"""The port's op library, math / logic / attribute part
(``paddle_tpu_torch.tensor``), against the JAX package's
(``paddle_tpu.tensor``) on the CPU: each op one case on seeded numpy
inputs, its outputs and (for every op the JAX tape differentiates) its
VJP under one seeded cotangent.  Tolerances are ``torch_op_parity``'s:
f32 1e-5 of the output's scale elementwise, 1e-4 for reductions, bf16
1e-2; integer, bool and index outputs equal.
"""
from torch_cpu import unoptimized_jax_compiles  # noqa: F401  (one thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.tensor as J
import paddle_tpu_torch as tp
import paddle_tpu_torch.tensor as T
from torch_op_parity import (BF16, EW, RED, Case, JaxRefs, arr, check,
                             run_case)

S = (4, 6)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tp.set_device("cpu")
    yield


UNARY = {
    "sqrt": "pos", "rsqrt": "pos", "square": "normal", "exp": "normal",
    "expm1": "normal", "log": "pos", "log2": "pos", "log10": "pos",
    "log1p": "pos", "abs": "normal", "ceil": "normal", "floor": "normal",
    "round": "normal", "trunc": "normal", "frac": "normal", "sign": "normal",
    "neg": "normal", "reciprocal": "pos", "sin": "normal", "cos": "normal",
    "tan": "unit", "asin": "unit", "acos": "unit", "atan": "normal",
    "sinh": "normal", "cosh": "normal", "tanh": "normal", "asinh": "normal",
    "acosh": "gt1", "atanh": "unit", "erf": "normal", "erfinv": "unit",
    "lgamma": "pos", "digamma": "pos", "i0": "normal", "i1": "normal",
    "deg2rad": "normal", "rad2deg": "normal", "isnan": "normal",
    "isinf": "normal", "isfinite": "normal", "logit": "prob",
    "sigmoid": "normal", "stanh": "normal",
}
BOOL_OUT = {"isnan", "isinf", "isfinite"}
BF16_UNARY = ["sqrt", "exp", "log", "tanh", "sigmoid", "sin", "abs",
              "reciprocal", "erf", "square", "rsqrt", "floor"]
BINARY = {
    "add": ("normal", "normal"), "subtract": ("normal", "normal"),
    "multiply": ("normal", "normal"), "divide": ("normal", "pos"),
    "floor_divide": ("normal", "pos"), "remainder": ("normal", "pos"),
    "mod": ("normal", "pos"), "floor_mod": ("normal", "pos"),
    "pow": ("pos", "normal"), "maximum": ("normal", "normal"),
    "minimum": ("normal", "normal"), "fmax": ("normal", "normal"),
    "fmin": ("normal", "normal"), "atan2": ("normal", "normal"),
    "heaviside": ("normal", "normal"), "hypot": ("normal", "normal"),
    "logaddexp": ("normal", "normal"), "nextafter": ("normal", "normal"),
    "copysign": ("normal", "normal"),
    "elementwise_add": ("normal", "normal"),
    "elementwise_sub": ("normal", "normal"),
    "elementwise_mul": ("normal", "normal"),
    "elementwise_div": ("normal", "pos"),
}
# not differentiable on the JAX tape (or integer-valued steps)
NO_VJP = {"floor_divide", "heaviside", "nextafter"}
INT_BINARY = ["floor_divide", "remainder", "gcd", "lcm", "maximum",
              "bitwise_and", "bitwise_or", "bitwise_xor", "add",
              "multiply"]
CMP = ["equal", "not_equal", "greater_than", "greater_equal", "less_than",
       "less_equal"]


def _nans(a, inf=False):
    a = a.copy()
    a.reshape(-1)[::5] = np.nan
    if inf:
        a.reshape(-1)[1::7] = np.inf
        a.reshape(-1)[2::9] = -np.inf
    return a


def _cases():
    """Every op call of the table: ``{id: Case}`` on seeded inputs."""
    c = {}
    n, p, b16 = "normal", "pos", jnp.bfloat16

    def add(cid, name, args, kw=None, diff=(0,), tol=RED):
        c[cid] = Case(name, getattr(J, name), getattr(T, name), args, kw,
                      diff, tol)

    for i, (name, kind) in enumerate(sorted(UNARY.items())):
        r = np.random.RandomState(i)
        add(f"unary-{name}", name, [arr(r, S, kind)], {},
            () if name in BOOL_OUT else (0,), EW)
    for name in BF16_UNARY:
        r = np.random.RandomState(3)
        add(f"unary-bf16-{name}", name, [arr(r, S, UNARY[name]).astype(b16)],
            {}, (), BF16)
    for i, (name, (kx, ky)) in enumerate(sorted(BINARY.items())):
        r = np.random.RandomState(100 + i)
        add(f"binary-{name}", name, [arr(r, S, kx), arr(r, (S[1],), ky)], {},
            () if name in NO_VJP else (0, 1), EW)   # y broadcasts
    for name in ["add", "multiply", "divide", "maximum", "pow", "subtract"]:
        r = np.random.RandomState(4)
        kx, ky = BINARY[name]
        add(f"binary-bf16-{name}", name, [arr(r, S, kx).astype(b16),
                                          arr(r, S, ky).astype(b16)], {}, (),
            BF16)
    for name, scalar in [("add", 2.5), ("multiply", 3), ("pow", 2.0),
                         ("divide", 4.0)]:
        r = np.random.RandomState(5)
        add(f"scalar-{name}", name, [arr(r, S, p), scalar], {}, (0,), EW)
    for name in INT_BINARY:
        r = np.random.RandomState(6)
        add(f"int32-{name}", name, [arr(r, S, "int", np.int32),
                                    arr(r, S, "posint", np.int32)], {}, ())
    for name in ["abs", "neg", "sign", "square"]:
        r = np.random.RandomState(8)
        add(f"int32-{name}", name, [arr(r, S, "int", np.int32)], {}, ())

    r = np.random.RandomState(11)
    add("sum", "sum", [arr(r, S, n)])
    add("sum-axis", "sum", [arr(r, S, n)], {"axis": 1})
    add("sum-axes-keepdim", "sum", [arr(r, (3, 4, 5), n)],
        {"axis": [0, 2], "keepdim": True})
    add("sum-int-dtype", "sum", [arr(r, S, "int", np.int32)],
        {"axis": 0, "dtype": "int32"}, ())
    add("mean", "mean", [arr(r, S, n)], {"axis": -1})
    add("mean-all-keepdim", "mean", [arr(r, S, n)], {"keepdim": True})
    add("max", "max", [arr(r, S, n)], {"axis": 1})
    add("max-all", "max", [arr(r, S, n)])
    add("min", "min", [arr(r, S, n)], {"axis": [0, 1]})
    add("amax", "amax", [arr(r, S, n)], {"axis": 0, "keepdim": True})
    add("amin", "amin", [arr(r, S, n)], {"axis": 1})
    add("prod", "prod", [arr(r, S, p)], {"axis": 1})
    add("prod-axes", "prod", [arr(r, (3, 4, 2), p)],
        {"axis": [0, 2], "keepdim": True})
    add("logsumexp", "logsumexp", [arr(r, S, n)], {"axis": 1})
    add("logsumexp-all", "logsumexp", [arr(r, S, n)])
    add("all", "all", [arr(r, S, "bool", bool)], {"axis": 1}, ())
    add("all-none", "all", [arr(r, S, "bool", bool)], {"keepdim": True}, ())
    add("any", "any", [arr(r, S, "bool", bool)], {"axis": 0}, ())
    add("count_nonzero", "count_nonzero",
        [arr(r, S, "int", np.int32) // 4], {"axis": 1}, ())
    add("cumsum", "cumsum", [arr(r, S, n)], {"axis": 1})
    add("cumsum-flat", "cumsum", [arr(r, S, n)])
    add("cumprod", "cumprod", [arr(r, S, p)], {"dim": 1})
    add("cummax", "cummax", [arr(r, S, n)], {"axis": 1})
    add("cummin-flat", "cummin", [arr(r, S, n)])
    add("diff", "diff", [arr(r, S, n)])
    add("trace", "trace", [arr(r, (5, 5), n)], {"offset": 1})
    add("kron", "kron", [arr(r, (2, 3), n), arr(r, (3, 2), n)], {}, (0, 1),
        EW)
    add("inner", "inner", [arr(r, S, n), arr(r, (3, 6), n)], {}, (0, 1))
    add("outer", "outer", [arr(r, (4,), n), arr(r, (5,), n)], {}, (0, 1),
        EW)
    add("matmul", "matmul", [arr(r, (2, 4, 5), n), arr(r, (5, 3), n)], {},
        (0, 1))
    add("matmul-transposed", "matmul", [arr(r, (5, 4), n),
                                        arr(r, (3, 5), n)],
        {"transpose_x": True, "transpose_y": True}, (0, 1))
    add("mm", "mm", [arr(r, (4, 5), n), arr(r, (5, 3), n)], {}, (0, 1))
    add("bmm", "bmm", [arr(r, (2, 4, 5), n), arr(r, (2, 5, 3), n)], {},
        (0, 1))
    add("dot-rows", "dot", [arr(r, S, n), arr(r, S, n)], {}, (0, 1))
    add("dot-1d", "dot", [arr(r, (6,), n), arr(r, (6,), n)], {}, (0, 1))
    add("mv", "mv", [arr(r, S, n), arr(r, (6,), n)], {}, (0, 1))
    add("addmm", "addmm", [arr(r, (4, 3), n), arr(r, (4, 5), n),
                           arr(r, (5, 3), n)],
        {"beta": 0.5, "alpha": 2.0}, (0, 1, 2))
    add("std", "std", [arr(r, S, n)], {"axis": 1})
    add("var-biased", "var", [arr(r, S, n)],
        {"unbiased": False, "keepdim": True})
    add("median-even-all", "median", [arr(r, S, n)])
    add("median-even-axis", "median", [arr(r, S, n)],
        {"axis": 1, "keepdim": True})
    add("median-odd-axis", "median", [arr(r, (5, 4), n)], {"axis": 0})
    add("nanmedian", "nanmedian", [_nans(arr(r, S, n))], {"axis": 1})
    add("nanmean", "nanmean", [_nans(arr(r, S, n))], {"axis": 1})
    add("nansum", "nansum", [_nans(arr(r, S, n))], {"axis": 0})
    add("quantile", "quantile", [arr(r, S, n)], {"q": 0.3, "axis": 1})
    add("quantile-list", "quantile", [arr(r, S, n)],
        {"q": [0.25, 0.5, 0.9], "keepdim": True, "axis": 0})
    add("histogram", "histogram", [arr(r, (50,), n)], {"bins": 7}, ())
    add("histogram-range", "histogram", [arr(r, (50,), n)],
        {"bins": 5, "min": -1, "max": 1}, ())
    add("bincount", "bincount", [arr(r, (30,), "posint", np.int32)],
        {"minlength": 25}, ())
    add("clip_by_norm", "clip_by_norm", [arr(r, S, n)], {"max_norm": 1.5})
    add("logcumsumexp", "logcumsumexp", [arr(r, S, n)], {"axis": 1})
    add("logcumsumexp-flat", "logcumsumexp", [arr(r, S, n)])
    add("trapezoid-x", "trapezoid", [arr(r, S, n), np.sort(arr(r, S, n), 1)],
        {}, (0, 1))
    add("trapezoid-dx", "trapezoid", [arr(r, S, n)], {"dx": 0.5, "axis": 0})
    add("renorm", "renorm", [arr(r, (3, 4, 5), n)],
        {"p": 2.0, "axis": 1, "max_norm": 2.0})
    add("clip", "clip", [arr(r, S, n)], {"min": -0.5, "max": 0.7}, (0,), EW)
    add("clip-min-only", "clip", [arr(r, S, n)], {"min": 0.1}, (0,), EW)
    add("nan_to_num", "nan_to_num", [_nans(arr(r, S, n), inf=True)],
        {"nan": 1.5, "posinf": 9.0}, (0,), EW)
    add("scale", "scale", [arr(r, S, n)],
        {"scale": 2.0, "bias": 0.5, "bias_after_scale": False}, (0,), EW)
    add("scale-act", "scale", [arr(r, S, n)],
        {"scale": 2.0, "bias": -0.5, "act": "relu"}, (0,), EW)
    add("lerp", "lerp", [arr(r, S, n), arr(r, S, n)], {"weight": 0.3},
        (0, 1), EW)
    add("lerp-tensor-weight", "lerp", [arr(r, S, n), arr(r, S, n),
                                       arr(r, S, "prob")], {}, (0, 1, 2), EW)

    r = np.random.RandomState(12)
    for name, kw in [("sum", {"axis": 1}), ("mean", {}), ("max", {"axis": 0}),
                     ("logsumexp", {"axis": 1}), ("cumsum", {"axis": 1}),
                     ("median", {"axis": 1}), ("prod", {"axis": 1}),
                     ("cumprod", {"dim": 1})]:
        add(f"bf16-{name}", name, [arr(r, (8, 16)).astype(b16)], kw, (),
            BF16)
    add("bf16-matmul", "matmul", [arr(r, (8, 32)).astype(b16),
                                  arr(r, (32, 16)).astype(b16)], {}, (),
        BF16)

    # logic
    r = np.random.RandomState(16)
    for name in CMP:
        add(f"cmp-int32-{name}", name, [arr(r, S, "int", np.int32) // 3,
                                        arr(r, (6,), "int", np.int32) // 3],
            {}, ())
        add(f"cmp-bf16-scalar-{name}", name, [arr(r, S).astype(b16), 0.25],
            {}, ())
    for name in ["logical_and", "logical_or", "logical_xor", "bitwise_and",
                 "bitwise_or", "bitwise_xor"]:
        add(f"bool-{name}", name, [arr(r, S, "bool", bool),
                                   arr(r, S, "bool", bool)], {}, ())
    for name in ["logical_not", "bitwise_not"]:
        add(f"bool-{name}", name, [arr(r, S, "bool", bool)], {}, ())
        add(f"int32-{name}", name, [arr(r, S, "int", np.int32)], {}, ())
    return c


CASES = _cases()


@pytest.fixture(scope="module")
def refs():
    return JaxRefs(CASES)


@pytest.mark.parametrize("cid", list(CASES))
def test_op(cid, refs):
    run_case(cid, CASES[cid], refs)


def test_diff_with_prepend_and_append():
    r = np.random.RandomState(22)
    x, pre, app = arr(r, S), arr(r, (4, 1)), arr(r, (4, 2))
    check("diff", lambda a, b, c: J.diff(a, 2, 1, prepend=b, append=c),
          lambda a, b, c: T.diff(a, 2, 1, prepend=b, append=c),
          [x, pre, app], diff=(0,))


def test_median_averages_the_two_middle_values():
    """An even count: the mean of the middle pair (torch.median would
    give the lower one)."""
    x = np.array([[4.0, 1.0, 3.0, 2.0], [7.0, 5.0, 8.0, 6.0]], np.float32)
    check("median", J.median, T.median, [x], {"axis": 1})
    got = T.median(torch.tensor(x), axis=1)
    assert got.tolist() == [2.5, 6.5]
    assert T.median(torch.tensor(x)).item() == 4.5


def test_add_n_and_multiplex():
    r = np.random.RandomState(14)
    a, b, c = (arr(r, S) for _ in range(3))
    check("add_n", lambda *ts: J.add_n(list(ts)),
          lambda *ts: T.add_n(list(ts)), [a, b, c], diff=(0, 1, 2))
    idx = np.array([[1], [0], [2], [1]], np.int32)
    check("multiplex", lambda i, *ts: J.multiplex(list(ts), i),
          lambda i, *ts: T.multiplex(list(ts), i), [idx, a, b, c],
          diff=(1, 2, 3))


def test_increment_and_tanh_in_place():
    x = np.array([3.0], np.float32)
    check("increment", J.increment, T.increment, [x], {"value": 2.0}, ())
    y = arr(np.random.RandomState(15), S)
    check("tanh_", J.tanh_, T.tanh_, [y], {}, ())
    t = torch.tensor(y)
    assert T.tanh_(t) is t
    with pytest.raises(ValueError, match="1-element"):
        T.increment(torch.zeros(2))


# --------------------------------------------------------------------------
# logic
# --------------------------------------------------------------------------

def test_equal_all_allclose_isclose():
    r = np.random.RandomState(19)
    a = arr(r, S)
    b = a + np.float32(1e-7) * arr(r, S)
    for name in ("equal_all", "allclose", "isclose"):
        check(name, getattr(J, name), getattr(T, name), [a, b], diff=())
        check(name, getattr(J, name), getattr(T, name), [a, a + 1], diff=())
    check("isclose", J.isclose, T.isclose, [a, b],
          {"rtol": 0.0, "atol": 1e-8}, diff=())
    assert not T.equal_all(torch.zeros(2), torch.zeros(3)).item()
    assert T.is_empty(torch.zeros(0, 3)).item()
    assert not T.is_empty(torch.zeros(1)).item()
    assert T.is_tensor(torch.zeros(1)) and not T.is_tensor([1.0])


# --------------------------------------------------------------------------
# attribute
# --------------------------------------------------------------------------

def test_shape_rank_and_kind_queries():
    x = arr(np.random.RandomState(20), (2, 3, 4))
    check("shape", J.shape, T.shape, [x], diff=())
    check("rank", J.rank, T.rank, [x], diff=())
    for t, kinds in ((torch.zeros(2), (True, False, False)),
                     (torch.zeros(2, dtype=torch.int32), (False, True, False)),
                     (torch.zeros(2, dtype=torch.complex64),
                      (False, False, True))):
        assert (T.is_floating_point(t), T.is_integer(t),
                T.is_complex(t)) == kinds
    assert not T.is_integer(torch.zeros(2, dtype=torch.bool))


@pytest.mark.parametrize("name", ["real", "imag", "conj", "angle"])
def test_complex_parts(name):
    r = np.random.RandomState(21)
    z = (arr(r, S) + 1j * arr(r, S)).astype(np.complex64)
    check(name, getattr(J, name), getattr(T, name), [z], diff=())
    check(name, getattr(J, name), getattr(T, name), [arr(r, S)], diff=())


def test_set_printoptions_sets_torch_print_options():
    before = torch._tensor_str.PRINT_OPTS.precision
    try:
        T.set_printoptions(precision=2, sci_mode=False)
        assert "0.33" in str(torch.tensor([1 / 3]))
        assert "0.333" not in str(torch.tensor([1 / 3]))
    finally:
        torch.set_printoptions(precision=before, sci_mode=None)
