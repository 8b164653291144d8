"""The port's op library, manipulation / search / creation / array /
einsum part, against the JAX package's on the CPU (``torch_op_parity``'s
harness and tolerances), with the tie rules of the sorts, the methods
the port binds on ``torch.Tensor`` and the namespace's names.
"""
from torch_cpu import unoptimized_jax_compiles  # noqa: F401  (one thread)

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu.tensor as J
import paddle_tpu_torch as tp
import paddle_tpu_torch.tensor as T
from torch_op_parity import EW, RED, Case, JaxRefs, arr, check, run_case

ROOT = Path(__file__).resolve().parent.parent
S = (4, 6)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tp.set_device("cpu")
    yield


def _cases():
    n = "normal"
    c = {}

    def add(cid, name, make, kw=None, diff=(0,), tol=EW, eager=None):
        c[cid] = Case(name, getattr(J, name), getattr(T, name),
                      make(np.random.RandomState(31)), kw, diff, tol, eager)

    i32 = np.int32
    x3 = lambda r: [arr(r, (2, 3, 4), n)]  # noqa: E731
    add("reshape", "reshape", x3, {"shape": [6, -1]})
    add("flatten", "flatten", x3, {"start_axis": 1})
    add("transpose", "transpose", x3, {"perm": [2, 0, 1]})
    add("t", "t", lambda r: [arr(r, S, n)])
    add("moveaxis", "moveaxis", x3, {"source": 0, "destination": 2})
    add("swapaxes", "swapaxes", x3, {"axis0": 0, "axis1": 2})
    add("squeeze", "squeeze", lambda r: [arr(r, (1, 4, 1, 3), n)],
        {"axis": [0, 1]})
    add("squeeze-all", "squeeze", lambda r: [arr(r, (1, 4, 1, 3), n)])
    add("unsqueeze", "unsqueeze", lambda r: [arr(r, S, n)],
        {"axis": [0, 2]})
    add("flip", "flip", x3, {"axis": [0, 2]})
    add("rot90", "rot90", lambda r: [arr(r, S, n)], {"k": 3})
    add("roll", "roll", x3, {"shifts": [1, -2], "axis": [0, 2]})
    add("roll-flat", "roll", x3, {"shifts": 5})
    add("tile", "tile", lambda r: [arr(r, S, n)], {"repeat_times": [2, 1, 3]})
    add("expand", "expand", lambda r: [arr(r, (1, 6), n)],
        {"shape": [3, 4, -1]})
    add("broadcast_to", "broadcast_to", lambda r: [arr(r, (1, 6), n)],
        {"shape": [4, 6]})
    add("cast", "cast", lambda r: [arr(r, S, n)], {"dtype": "float16"}, (),
        1e-3)
    add("cast-int", "cast", lambda r: [arr(r, S, n) * 4], {"dtype": "int32"},
        ())
    add("gather", "gather", lambda r: [arr(r, S, n),
                                       np.array([3, 0, 3, -1], i32)])
    add("gather-axis1-2d", "gather", lambda r: [arr(r, S, n),
                                                np.array([[1, 5], [0, 2]],
                                                         i32)],
        {"axis": 1})
    add("gather_nd", "gather_nd", lambda r: [arr(r, (3, 4, 5), n),
                                             np.array([[0, 1], [2, 3],
                                                       [1, -1]], i32)])
    add("scatter-overwrite", "scatter", lambda r: [
        arr(r, S, n), np.array([2, 0], i32), arr(r, (2, 6), n)], {},
        (0, 2))
    add("scatter-accumulate", "scatter", lambda r: [
        arr(r, S, n), np.array([2, 0, 2], i32), arr(r, (3, 6), n)],
        {"overwrite": False}, (0, 2))
    add("scatter_nd", "scatter_nd", lambda r: [
        np.array([[0, 1], [2, 3], [0, 1]], i32), arr(r, (3,), n)],
        {"shape": [3, 4]}, (1,))
    add("scatter_nd_add", "scatter_nd_add", lambda r: [
        arr(r, (3, 4, 2), n), np.array([[0, 1], [2, 3], [0, 1]], i32),
        arr(r, (3, 2), n)], {}, (0, 2))
    add("index_select", "index_select", lambda r: [
        arr(r, S, n), np.array([4, 1, 1], i32)], {"axis": 1})
    add("index_sample", "index_sample", lambda r: [
        arr(r, S, n), np.array([[0, 5], [1, 1], [2, 0], [5, 4]], i32)])
    add("index_add", "index_add", lambda r: [
        arr(r, S, n), np.array([1, 3, 1], i32), 1, arr(r, (4, 3), n)], {},
        (0, 3))
    add("take_along_axis", "take_along_axis", lambda r: [
        arr(r, S, n), np.array([[0], [5], [2], [1]], i32), 1])
    add("put_along_axis", "put_along_axis", lambda r: [
        arr(r, S, n), np.array([[0], [5], [2], [1]], i32),
        arr(r, (4, 1), n), 1], {}, (0, 2))
    add("put_along_axis-add", "put_along_axis", lambda r: [
        arr(r, S, n), np.array([[0, 0], [5, 1]], i32), arr(r, (2, 2), n), 1],
        {"reduce": "add"}, (0, 2))
    add("put_along_axis-mul", "put_along_axis", lambda r: [
        arr(r, S, n), np.array([[0, 3], [5, 1]], i32), arr(r, (2, 2), n), 1],
        {"reduce": "multiply"}, ())   # JAX: no gradient of scatter_mul
    add("slice", "slice", x3, {"axes": [1, 2], "starts": [-2, 1],
                               "ends": [10, -1]})
    add("strided_slice", "strided_slice", x3, {
        "axes": [1, 2], "starts": [0, 3], "ends": [3, 0],
        "strides": [2, -1]})
    add("shard_index", "shard_index", lambda r: [
        np.array([[1], [6], [12], [19]], i32)],
        {"index_num": 20, "nshards": 2, "shard_id": 1}, ())
    add("unique", "unique", lambda r: [np.array([[3, 1, 3], [0, 1, 7]],
                                                i32)],
        {"return_index": True, "return_inverse": True,
         "return_counts": True}, ())
    add("unique-plain", "unique", lambda r: [np.array([2.5, -1.0, 2.5],
                                                      np.float32)], {}, ())
    add("unique_consecutive", "unique_consecutive", lambda r: [
        np.array([1, 1, 2, 2, 2, 1, 3, 3], i32)],
        {"return_inverse": True, "return_counts": True}, ())
    add("masked_select", "masked_select", lambda r: [
        arr(r, S, n), arr(r, S, "bool", bool)])
    add("masked_fill", "masked_fill", lambda r: [
        arr(r, S, n), arr(r, (6,), "bool", bool)], {"value": 2.5})
    add("pad-constant", "pad", lambda r: [arr(r, (2, 3, 4, 5), n)],
        {"pad": [1, 2, 0, 1], "value": 0.5})
    add("pad-reflect", "pad", lambda r: [arr(r, (2, 3, 4, 5), n)],
        {"pad": [1, 2, 2, 1], "mode": "reflect"})
    add("pad-all-dims", "pad", lambda r: [arr(r, S, n)],
        {"pad": [1, 0, 2, 1]})
    add("repeat_interleave", "repeat_interleave", lambda r: [arr(r, S, n)],
        {"repeats": 2, "axis": 1})
    add("tensordot", "tensordot", lambda r: [arr(r, (3, 4, 5), n),
                                             arr(r, (4, 5, 2), n)],
        {"axes": 2}, (0, 1), RED)
    add("tensordot-lists", "tensordot", lambda r: [arr(r, (3, 4, 5), n),
                                                   arr(r, (5, 3), n)],
        {"axes": [[0, 2], [1, 0]]}, (0, 1), RED)
    add("as_complex", "as_complex", lambda r: [arr(r, (3, 2), n)], {}, ())
    add("as_real", "as_real", lambda r: [(arr(r, S, n) + 1j * arr(r, S, n))
                                         .astype(np.complex64)], {}, ())
    add("view-shape", "view", lambda r: [arr(r, S, n)],
        {"shape_or_dtype": [3, 8]})
    add("view-dtype", "view", lambda r: [arr(r, S, n)],
        {"shape_or_dtype": "float16"}, (), 1e-3)
    add("atleast_1d", "atleast_1d", lambda r: [np.full((), 2.5,
                                                       np.float32)])
    add("atleast_2d", "atleast_2d", lambda r: [arr(r, (5,), n)])
    add("atleast_3d", "atleast_3d", lambda r: [arr(r, S, n)])
    add("crop", "crop", x3, {"shape": [1, -1, 2], "offsets": [1, 1, 2]})
    add("crop_tensor", "crop_tensor", x3, {"shape": [2, 2, 2],
                                           "offsets": [0, 1, 1]})
    add("expand_as", "expand_as", lambda r: [arr(r, (1, 6), n),
                                             arr(r, S, n)])
    # search
    add("argmax", "argmax", lambda r: [arr(r, S, n)], {"axis": 1}, ())
    add("argmax-flat-keepdim", "argmax", lambda r: [arr(r, S, n)],
        {"keepdim": True}, ())
    add("argmin", "argmin", lambda r: [arr(r, S, n)],
        {"axis": 0, "dtype": "int32"}, ())
    add("argsort", "argsort", lambda r: [arr(r, S, n)], {"axis": 1}, ())
    add("argsort-desc", "argsort", lambda r: [arr(r, S, n)],
        {"axis": 0, "descending": True}, ())
    add("sort", "sort", lambda r: [arr(r, S, n)], {"axis": 1})
    add("sort-desc", "sort", lambda r: [arr(r, S, n)], {"descending": True})
    add("topk", "topk", lambda r: [arr(r, S, n)], {"k": 3})
    add("topk-smallest-axis0", "topk", lambda r: [arr(r, S, n)],
        {"k": 2, "axis": 0, "largest": False})
    add("kthvalue", "kthvalue", lambda r: [arr(r, S, n)],
        {"k": 2, "axis": 1})
    add("kthvalue-keepdim", "kthvalue", lambda r: [arr(r, S, n)],
        {"k": 3, "axis": 0, "keepdim": True})
    add("mode", "mode", lambda r: [arr(r, (5, 9), "int", i32) // 4],
        {"axis": 1}, ())
    add("mode-keepdim-axis0", "mode", lambda r: [
        (arr(r, (9, 3), "int", i32) // 5).astype(np.float32)],
        {"axis": 0, "keepdim": True}, ())
    add("where", "where", lambda r: [arr(r, S, "bool", bool), arr(r, S, n),
                                     arr(r, S, n)], {}, (1, 2))
    add("nonzero", "nonzero", lambda r: [arr(r, S, "int", i32) // 5], {},
        ())
    add("nonzero-tuple", "nonzero", lambda r: [arr(r, S, "int", i32) // 5],
        {"as_tuple": True}, ())
    add("searchsorted", "searchsorted", lambda r: [
        np.sort(arr(r, (10,), n)), arr(r, S, n)], {"right": True}, ())
    add("bucketize", "bucketize", lambda r: [
        arr(r, S, n), np.sort(arr(r, (10,), n))], {"out_int32": True}, ())
    # creation
    add("diag-vector", "diag", lambda r: [arr(r, (4,), n)],
        {"offset": 1, "padding_value": 9.0})
    add("diag-matrix", "diag", lambda r: [arr(r, (4, 5), n)],
        {"offset": -1})
    add("diagflat", "diagflat", lambda r: [arr(r, (2, 2), n)],
        {"offset": 1})
    add("diag_embed", "diag_embed", lambda r: [arr(r, (2, 3), n)])
    add("diag_embed-dims", "diag_embed", lambda r: [arr(r, (2, 3), n)],
        {"offset": -1, "dim1": 0, "dim2": 2})
    add("tril", "tril", lambda r: [arr(r, (4, 5), n)], {"diagonal": 1})
    add("triu", "triu", lambda r: [arr(r, (2, 4, 5), n)],
        {"diagonal": -1})
    add("zeros_like", "zeros_like", lambda r: [arr(r, S, n)], {}, ())
    add("ones_like", "ones_like", lambda r: [arr(r, S, n)],
        {"dtype": "int32"}, ())
    add("full_like", "full_like", lambda r: [arr(r, S, n)],
        {"fill_value": 2.5}, ())
    add("empty_like", "empty_like", lambda r: [arr(r, S, n)], {}, ())
    add("clone", "clone", lambda r: [arr(r, S, n)])
    add("assign", "assign", lambda r: [arr(r, S, n)], {}, ())
    add("numel", "numel", lambda r: [arr(r, (3, 5), n)], {}, ())
    add("complex", "complex", lambda r: [arr(r, S, n), arr(r, S, n)], {},
        ())
    add("to_tensor", "to_tensor", lambda r: [arr(r, S, n)], {}, ())
    return c


CASES = _cases()


@pytest.fixture(scope="module")
def refs():
    return JaxRefs(CASES)


@pytest.mark.parametrize("cid", list(CASES))
def test_op(cid, refs):
    run_case(cid, CASES[cid], refs)


NO_ARGS = [
    ("zeros", {"shape": [2, 3]}), ("ones", {"shape": 4, "dtype": "int32"}),
    ("full", {"shape": [2, 2], "fill_value": 7.0}),
    ("empty", {"shape": [3]}), ("arange", {"start": 7}),
    ("arange", {"start": 1, "end": 3, "step": 0.25}),
    ("linspace", {"start": -1.0, "stop": 2.0, "num": 7}),
    ("logspace", {"start": 0.0, "stop": 2.0, "num": 5, "base": 2.0}),
    ("eye", {"num_rows": 3, "num_columns": 5}),
    ("tril_indices", {"row": 4, "col": 5, "offset": 1}),
    ("triu_indices", {"row": 4, "col": 3, "offset": -1}),
]


@pytest.mark.parametrize("name,kw", NO_ARGS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(NO_ARGS)])
def test_creation(name, kw):
    check(name, getattr(J, name), getattr(T, name), [], kw, ())


def test_list_input_ops():
    r = np.random.RandomState(32)
    a, b, c = arr(r, S), arr(r, S), arr(r, S)
    for name, kw, args, diff in (
            ("concat", {"axis": 1}, [a, b, c], (0, 1, 2)),
            ("stack", {"axis": 1}, [a, b, c], (0, 1, 2)),
            ("broadcast_tensors", {}, [a, b[:1], c[:, :1]], (0,))):
        check(name, lambda *ts: getattr(J, name)(list(ts), **kw),
              lambda *ts: getattr(T, name)(list(ts), **kw), args, diff=diff)
    check("meshgrid", lambda *ts: J.meshgrid(*ts),
          lambda *ts: T.meshgrid(*ts), [a[0], b[:2, 0]],
          diff=())   # the JAX meshgrid is off the tape
    for name in ("unstack", "unbind"):
        check(name, getattr(J, name), getattr(T, name), [a], {"axis": 1})
    assert T.broadcast_shape([4, 1], [3]) == J.broadcast_shape([4, 1], [3])


@pytest.mark.parametrize("sections", [3, [1, -1, 2], [2, 2, 2]])
def test_split_and_chunk(sections):
    x = arr(np.random.RandomState(33), (4, 6))
    check("split", J.split, T.split, [x], {"num_or_sections": sections,
                                           "axis": 1}, diff=(0,))
    if isinstance(sections, int):
        check("chunk", J.chunk, T.chunk, [x], {"chunks": sections,
                                               "axis": 1}, diff=(0,))
        with pytest.raises(T.InvalidArgumentError):
            T.split(torch.zeros(4, 5), sections, axis=1)


def test_descending_sort_ties_follow_the_jax_rule():
    """Tied keys: a descending sort without ``stable`` is the flip of a
    stable ascending sort (ties in reverse index order); ``stable=True``
    keeps index order; topk takes the lower index first."""
    x = np.array([[2.0, 1.0, 2.0, 3.0, 1.0, 2.0]], np.float32)
    got = T.argsort(torch.tensor(x), descending=True)
    assert got.tolist() == [[3, 5, 2, 0, 4, 1]]
    got = T.argsort(torch.tensor(x), descending=True, stable=True)
    assert got.tolist() == [[3, 0, 2, 5, 1, 4]]
    for kw in ({"descending": True}, {"descending": True, "stable": True},
               {"stable": True}):
        check("argsort", J.argsort, T.argsort, [x], kw, ())
        check("sort", J.sort, T.sort, [x], kw, ())
    check("topk", J.topk, T.topk, [x], {"k": 4}, ())
    check("topk", J.topk, T.topk, [x], {"k": 3, "largest": False}, ())
    check("kthvalue", J.kthvalue, T.kthvalue, [x], {"k": 3}, ())


def test_scatter_in_place_and_where_of_one_argument():
    r = np.random.RandomState(34)
    x, u = arr(r, S), arr(r, (2, 6))
    idx = np.array([3, 1], np.int32)
    check("scatter_", J.scatter_, T.scatter_, [x, idx, u], {}, ())
    t = torch.tensor(x)
    assert T.scatter_(t, torch.tensor(idx), torch.tensor(u)) is t
    cond = arr(r, S, "bool", bool)
    check("where1", lambda c: J.where(c), lambda c: T.where(c), [cond], {},
          ())
    check("index_put", lambda a, i0, i1, v: J.index_put(a, [i0, i1], v),
          lambda a, i0, i1, v: T.index_put(a, [i0, i1], v),
          [x, np.array([0, 2], np.int32), np.array([5, -1], np.int32),
           np.array([1.5, 2.5], np.float32)], {}, (0, 3))


@pytest.mark.parametrize("name,kw", [("reshape_", {"shape": [3, 8]}),
                                     ("squeeze_", {"axis": 0}),
                                     ("unsqueeze_", {"axis": [0, 3]})])
def test_in_place_shape_ops(name, kw):
    x = arr(np.random.RandomState(35), (1, 4, 6))
    check(name, getattr(J, name), getattr(T, name), [x], kw, ())
    t = torch.tensor(x)
    assert getattr(T, name)(t, **kw) is t


def test_einsum():
    r = np.random.RandomState(36)
    a, b = arr(r, (2, 3, 4)), arr(r, (2, 4, 5))
    check("einsum", lambda x, y: J.einsum("bij,bjk->bik", x, y),
          lambda x, y: T.einsum("bij,bjk->bik", x, y), [a, b], {}, (0, 1),
          RED)
    check("einsum", lambda x: J.einsum("bii->b", x),
          lambda x: T.einsum("bii->b", x), [arr(r, (2, 3, 3))], {}, (0,),
          RED)


def test_tensor_array():
    xs = [torch.full((2,), float(i)) for i in range(3)]
    arr_ = T.create_array("float32", xs[:1])
    assert isinstance(arr_, T.TensorArray) and arr_.dtype == "float32"
    T.array_write(xs[1], torch.tensor(1), arr_)
    T.array_write(xs[2], 2, arr_)
    T.array_write(xs[0] + 5, 1, arr_)
    assert T.array_length(arr_).item() == 3
    assert T.array_read(arr_, 1).tolist() == [5.0, 5.0]
    with pytest.raises(IndexError):
        T.array_write(xs[0], 5, arr_)
    with pytest.raises(IndexError):
        T.array_read(arr_, 3)
    j = J.create_array("float32")
    J.array_write(J.to_tensor(np.ones(2, np.float32)), 0, j)
    assert int(J.array_length(j).item()) == \
        T.array_length(T.array_write(torch.ones(2), 0)).item()


def test_namespace_has_every_public_name_of_the_jax_one():
    import inspect
    import paddle_tpu.linalg as JL
    import paddle_tpu_torch.linalg as TL
    names = {n for n in dir(J) if not n.startswith("_")
             and callable(getattr(J, n))
             and not inspect.ismodule(getattr(J, n))}
    assert len(names) == 311
    missing = sorted(names - set(dir(T)))
    assert not missing, missing
    assert set(T.__all__) == names
    jl = {n for n in dir(JL) if not n.startswith("_")
          and callable(getattr(JL, n))}
    assert not sorted(jl - set(dir(TL))), sorted(jl - set(dir(TL)))
    # re-exported at the top level, without shadowing the port's own names
    assert tp.concat is T.concat and tp.linalg is TL
    from paddle_tpu_torch.core.random import set_seed
    from paddle_tpu_torch.framework.io import load, save
    assert tp.seed is set_seed and tp.save is save and tp.load is load
    assert tp.grad is tp.autograd.grad and tp.float32 is torch.float32


def test_methods_bind_only_names_torch_lacks():
    from paddle_tpu_torch.tensor import tensor_methods as M
    x = torch.tensor(arr(np.random.RandomState(37), S))
    assert "astype" in M.BOUND and x.astype("float16").dtype == torch.float16
    assert torch.equal(x.scatter_nd_add(torch.tensor([[1]]),
                                        torch.ones(1, 6)),
                       T.scatter_nd_add(x, torch.tensor([[1]]),
                                        torch.ones(1, 6)))
    assert x.gather_nd(torch.tensor([[2, 3]])).item() == x[2, 3].item()
    assert torch.equal(x.take_along_axis(torch.tensor([[0]]), 1), x[:, :1])
    # torch's own methods and operators keep their meaning
    for name in ("sum", "max", "split", "gather", "topk", "sort", "t",
                 "view", "reshape", "__add__", "__eq__", "abs"):
        assert name not in M.BOUND
        assert getattr(getattr(torch.Tensor, name), "__module__", None) \
            != "paddle_tpu_torch.tensor.math"
    assert x.max(1).indices.dtype == torch.int64   # torch's max


def test_importing_the_port_replaces_no_torch_tensor_attribute():
    code = ("import torch\n"
            "before = {n: getattr(torch.Tensor, n) for n in "
            "dir(torch.Tensor)}\n"
            "import paddle_tpu_torch\n"
            "changed = sorted(n for n, v in before.items() "
            "if getattr(torch.Tensor, n) is not v and "
            "getattr(torch.Tensor, n) != v)\n"
            "added = sorted(set(dir(torch.Tensor)) - set(before))\n"
            "print(changed)\nprint(len(added), 'astype' in added)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    changed, added = out.stdout.strip().splitlines()
    assert changed == "[]"
    assert int(added.split()[0]) > 50 and added.endswith("True")
